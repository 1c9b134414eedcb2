"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go into
``build/`` at the root of the checkout, keyed by a hash of the source
and the flags, and are built at first use: nothing is compiled when a
module is imported.  A plan on the GPU starts the builds of the kernels
its matvec will load as it is constructed (``start``), so a fresh
checkout's ``nvcc`` runs beside the plan's host build, all at once,
rather than one after another at the first matvec.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS = {}
#: builds started and not yet waited for: name -> (library, temporary
#: file, ``nvcc`` process)
_PENDING = {}
#: compiler output (register / shared-memory report) of the builds this
#: process ran, by kernel name
build_logs = {}


def _nvcc():
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda): "
        "the CUDA kernels of fmm_bem_tpu_torch are built from source at "
        "first use and need the CUDA toolkit"
    )


def source_path(name):
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name):
    with open(source_path(name), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def start(names, nvcc=None):
    """Start one ``nvcc`` process for every library of ``names`` that is
    neither built nor building, and return at once; ``build`` waits for
    them.  Without a CUDA toolkit nothing starts (``build`` says so)."""
    todo = [n for n in names
            if n not in _PENDING and not os.path.exists(library_path(n))]
    if not todo:
        return
    if nvcc is None:
        try:
            nvcc = _nvcc()
        except RuntimeError:
            return
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not _PENDING:
        atexit.register(_finish)
    for n in todo:
        so = library_path(n)
        tmp = f"{so}.{os.getpid()}.tmp"
        _PENDING[n] = (so, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(n)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))


def _wait(name):
    """Wait for the started build of ``name``; returns an error message
    or None."""
    so, tmp, proc = _PENDING.pop(name)
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return f"{name}: nvcc exited {proc.returncode}\n{out}"
    os.replace(tmp, so)  # atomic: no reader sees a partial file
    return None


def _finish():
    """At exit: finish the builds that nothing waited for, so no
    temporary file is left and the next process finds the library."""
    for name in list(_PENDING):
        _wait(name)


def build(names):
    """Compile every missing library of ``names``, one ``nvcc`` process
    per source, all started together (or earlier, by ``start``).
    Returns the library paths."""
    paths = {n: library_path(n) for n in names}
    missing = [n for n, so in paths.items() if not os.path.exists(so)]
    if missing:
        start(missing, nvcc=_nvcc())
    failed = [e for e in (_wait(n) for n in missing if n in _PENDING) if e]
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return paths


def load(name):
    """The ``ctypes`` library of ``csrc/<name>.cu`` (built on first use)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build([name])[name])
    return _LIBS[name]
