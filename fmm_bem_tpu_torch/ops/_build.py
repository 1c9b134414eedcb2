"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go into
``build/`` at the root of the checkout, keyed by a hash of the source
and the flags, and are built at first use: nothing is compiled when a
module is imported.
"""

from __future__ import annotations

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


def build(names):
    """Compile every missing library of ``names``, one ``nvcc`` process
    per source, all started together.  Returns the library paths."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, so in paths.items():
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[n] = (
            tmp,
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(n)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
        )
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, paths[n])  # atomic: no reader sees a partial file
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return paths


def load(name):
    """The ``ctypes`` library of ``csrc/<name>.cu`` (built on first use)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build([name])[name])
    return _LIBS[name]
