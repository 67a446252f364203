"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles ``csrc/publish_gather.cu`` into a shared library with
a plain C interface, at first use, into ``_build/`` beside this file
(listed in ``.gitignore``).  The library's name carries a hash of the
source and the flags, so an edited source builds anew and a built one
is reused.  It is loaded with ``ctypes``; no PyTorch headers are
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

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "publish_gather.cu"
BUILD_DIR = _HERE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                      "-fPIC", "-Xptxas", "-v")

_lib = None


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


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"publish_gather-{digest}.so"


def build() -> pathlib.Path:
    """Compile the library if it is not built yet; returns its path.
    ``nvcc``'s report (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside it as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """``nvcc``'s report from the build of the current source."""
    return library_path().with_suffix(".so.log").read_text()


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with the
    ``argtypes`` of its three entry points declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sidecar_publish_board.argtypes = [
            p, p, p, i, i, i, i, i, i, p, p, p, p]
        lib.sidecar_publish_board.restype = i
        lib.sidecar_board_row_gather.argtypes = [
            p, p, p, i, ll, i, i, p, p, p]
        lib.sidecar_board_row_gather.restype = i
        lib.sidecar_fused_publish_gather.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p]
        lib.sidecar_fused_publish_gather.restype = i
        _lib = lib
    return _lib
