"""The control on the card: the program with TF32 switched on for its
matmuls comes out not correct, where the program as configured comes
out correct, at a size a test run holds (8,192 panels, 65,536 points).

Marked ``card``: skips without one.  ``control.py`` reads the same at
the cells' own sizes."""

import pytest

from bench_h100 import control

SMALL = {
    "laplace_sphere_131k.relaxed_pc": {"geometry": {"recursions": 6}},
    "laplace_sphere_131k.second_kind_pc": {"geometry": {"recursions": 6}},
    "points_cube_1m.apply": {"geometry": {"n": 65536}},
}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_tf32_control_is_not_correct(cell, card):
    recs = list(control.readings(cell, [1, 2], ["f32", "tf32"], 2.0,
                                 config_over=SMALL[cell], device=card))
    f32 = [r for r in recs if r["mode"] == "f32"]
    tf32 = [r for r in recs if r["mode"] == "tf32"]
    assert all(not r["over_limit"] for r in f32), f32
    assert all(r["over_limit"] for r in tf32), tf32
