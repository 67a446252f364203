"""Build and load the hand-written CUDA kernels, and the launch helpers
their wrappers share.

Each source ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into a
shared library with a plain C interface, at first use, into ``_build/``
beside this file (listed in ``.gitignore``); :func:`build` starts one
``nvcc`` per source, all together.  A library's name carries a hash of
its source and the flags, so an edited source builds anew and a built
one is reused.  It is loaded with ``ctypes``; no PyTorch headers are
compiled, which keeps a build to seconds.

Nothing here runs at import: the CPU-only test environment imports
every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                      "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Library (source stem) → entry point → argtypes; every entry point
# returns the launch's cudaError_t as an int.
SIGNATURES = {
    "publish_gather": {
        "sidecar_publish_board": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                                  _P, _P, _P],
        "sidecar_board_row_gather": [_P, _P, _P, _I, _LL, _I, _I, _P, _P,
                                     _P],
        "sidecar_fused_publish_gather": [_P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, _I, _I, _P, _P, _P, _P],
    },
    "scatter_max": {
        "sidecar_scatter_max_apply": [_P, _P, _P, _P, _P, _P, _LL, _I, _I,
                                      _P],
        "sidecar_rmw_max": [_P, _P, _LL, _P],
    },
}

_libs: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: the toolkit PyTorch itself found
    (``torch.utils.cpp_extension.CUDA_HOME``), else ``nvcc`` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return found


def source_path(name: str) -> pathlib.Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(source_path(name).read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=tuple(SIGNATURES)) -> dict:
    """Compile the libraries not built yet, one ``nvcc`` per source, all
    started together; returns ``{name: path}``.  ``nvcc``'s report
    (``-Xptxas -v``: registers, shared memory, spills per kernel) is
    kept beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(source_path(name))]
        running[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (cmd, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        out = library_path(name)
        out.with_suffix(".so.log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def build_log(name: str) -> str:
    """``nvcc``'s report from the build of ``name``'s current source."""
    return library_path(name).with_suffix(".so.log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use), with the
    ``argtypes`` of its entry points declared."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build((name,))[name]))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        _libs[name] = lib
    return _libs[name]


# -- launch helpers shared by the wrappers ------------------------------------

def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")
