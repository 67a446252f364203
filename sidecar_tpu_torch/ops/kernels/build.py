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
                                  _P, _P, _P, _P],
        "sidecar_board_row_gather": [_P, _P, _P, _I, _LL, _I, _I, _P, _P,
                                     _P],
        "sidecar_fused_publish_gather": [_P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, _I, _I, _P, _P, _P, _P,
                                         _P],
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


def library_path(name: str, defines=()) -> pathlib.Path:
    """Where ``name`` built with the macro definitions ``defines`` (such
    as ``("-DX=1",)``) lies."""
    digest = hashlib.sha256(source_path(name).read_bytes()
                            + " ".join(FLAGS + tuple(defines)).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=tuple(SIGNATURES), variants=()) -> dict:
    """Compile the libraries not built yet, one ``nvcc`` per source, all
    started together; returns ``{name: path}``.  ``variants`` adds
    ``(name, defines)`` builds of a source with macro definitions,
    started with the rest (their paths: :func:`library_path`).
    ``nvcc``'s report (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name, defines in [(n, ()) for n in names] + list(variants):
        out = library_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, *defines, "-o", str(tmp),
               str(source_path(name))]
        running.append((cmd, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        out.with_suffix(".so.log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def build_log(name: str) -> str:
    """``nvcc``'s report from the build of ``name``'s current source."""
    return library_path(name).with_suffix(".so.log").read_text()


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library ``name`` (built with ``defines`` on first
    use), with the ``argtypes`` of its entry points declared."""
    key = (name, tuple(defines)) if defines else name
    if key not in _libs:
        build((), [(name, tuple(defines))])
        lib = ctypes.CDLL(str(library_path(name, defines)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        _libs[key] = lib
    return _libs[key]


# -- launch helpers shared by the wrappers ------------------------------------
#
# On the paths of small kernels (the exact round, the sharded round at
# d=4) a wrapper's host time is what a launch costs.  So the wrappers
# compare ``get_device()`` integers rather than ``torch.device`` objects
# in their checks, hand ctypes plain integers for pointers (the declared
# c_void_p argtypes convert them), pass the current stream's raw handle
# without building a ``torch.cuda.Stream``, and switch the current device
# only where it is not the tensors' (:func:`launch`).


def launch(what: str, fn, index: int, *args) -> None:
    """Call the entry point ``fn(*args, stream)`` with CUDA device
    ``index`` current and the raw handle of its current stream; raise if
    the launch reports an error."""
    if torch._C._cuda_getDevice() == index:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name(index)})")
