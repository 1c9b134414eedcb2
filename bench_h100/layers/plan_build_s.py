"""Seconds of the ``FmmPlan`` constructor (the host build: tree, lists,
M2L classes, near store), by the host clock."""


def read(run):
    return run.op.plan_build_s
