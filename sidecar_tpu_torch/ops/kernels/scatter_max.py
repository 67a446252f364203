"""The exact round's scatter-max apply and the in-place max — plain
PyTorch versions, the hand-written CUDA kernels' wrappers, and the
dispatch between them.

* ``scatter_max_apply`` — ``known[rows, cols] = max(known[rows, cols],
  vals)`` in place, dropping an entry out of range on either axis, and,
  when ``sent`` is given, ``sent[rows, cols] = 0`` in place where
  ``advanced``: the two scatters of the reference's ``apply_updates``
  (``sidecar_tpu/ops/gossip.py``), ``.at[].max(mode="drop")`` and
  ``.at[].set(0, mode="drop")``.  Plain version
  :func:`scatter_max_apply_torch`; kernel ``scatter_max_apply_kernel``
  in ``csrc/scatter_max.cu`` (replaces ``make_pallas_scatter(...).apply``
  of ``benchmarks/pallas_scatter.py``).
* ``rmw_max`` — ``known = max(known, other)`` in place over the whole
  buffer.  Plain version :func:`rmw_max_torch`; kernel
  ``rmw_max_kernel`` (replaces ``pallas_rmw_max``).

Both update ``known`` (and ``sent``) in place and return them: the
reference donates these buffers, and a copy of the exact model's
``known`` is 671 MB at the bench shape.  Dispatch is by the tensors'
device and nothing else: a CUDA tensor launches the kernel (or the call
raises), a CPU tensor takes the plain version.  Each CUDA wrapper counts
its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from sidecar_tpu_torch.ops.kernels.build import launch, load


def _in_range(known, rows, cols):
    n, m = known.shape
    return (rows >= 0) & (rows < n) & (cols >= 0) & (cols < m)


# -- plain PyTorch versions ---------------------------------------------------

def scatter_max_apply_torch(known, rows, cols, vals, sent=None,
                            advanced=None):
    """The scatter-max (and the optional ``sent`` reset) on the in-range
    entries: ``scatter_reduce_(…, "amax")`` on the flattened ``known``
    and an index store of 0 into ``sent``.  Returns ``(known, sent)``."""
    m = known.shape[1]
    ok = _in_range(known, rows, cols)
    flat = rows.to(torch.int64) * m + cols.to(torch.int64)
    known.view(-1).scatter_reduce_(0, flat[ok], vals[ok], "amax")
    if sent is not None:
        sent.view(-1)[flat[ok & advanced]] = 0
    return known, sent


def rmw_max_torch(known, other):
    """``known = max(known, other)``, written into ``known``."""
    return torch.maximum(known, other, out=known)


# -- CUDA wrappers ------------------------------------------------------------

def _check(name, t, dtype, dim, index):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or t.dim() != dim:
        raise ValueError(f"{name} must be a {dim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.get_device() != index:
        raise ValueError(f"{name} is on {t.device}, known on cuda:{index}")


def scatter_max_apply_cuda(known, rows, cols, vals, sent=None,
                           advanced=None):
    """Launch ``scatter_max_apply_kernel`` (four triples a thread,
    grid-stride) on the current stream.  Returns ``(known, sent)``."""
    index = known.get_device()
    _check("known", known, torch.int32, 2, index)
    u = rows.shape[0] if rows.dim() == 1 else -1
    for name, t, dtype in (("rows", rows, torch.int32),
                           ("cols", cols, torch.int32),
                           ("vals", vals, torch.int32)):
        _check(name, t, dtype, 1, index)
        if t.shape[0] != u:
            raise ValueError(f"{name} has {t.shape[0]} entries, rows {u}")
    if sent is not None:
        _check("sent", sent, torch.int8, 2, index)
        if sent.shape != known.shape:
            raise ValueError(f"sent {tuple(sent.shape)} must match known "
                             f"{tuple(known.shape)}")
        _check("advanced", advanced, torch.bool, 1, index)
        if advanced.shape[0] != u:
            raise ValueError(f"advanced has {advanced.shape[0]} entries, "
                             f"rows {u}")
    if u == 0:
        return known, sent
    n, m = known.shape
    launch("scatter_max_apply_kernel launch",
           load("scatter_max").sidecar_scatter_max_apply, index,
           known.data_ptr(), None if sent is None else sent.data_ptr(),
           rows.data_ptr(), cols.data_ptr(), vals.data_ptr(),
           None if sent is None else advanced.data_ptr(), u, n, m)
    scatter_max_apply_cuda.launches += 1
    return known, sent


scatter_max_apply_cuda.launches = 0


def rmw_max_cuda(known, other):
    """Launch ``rmw_max_kernel`` (a tile of 512 × 8 16-byte vectors of
    each buffer a block) on the current stream.  Returns ``known``."""
    index = known.get_device()
    _check("known", known, torch.int32, known.dim(), index)
    _check("other", other, torch.int32, known.dim(), index)
    if other.shape != known.shape:
        raise ValueError(f"other {tuple(other.shape)} must match known "
                         f"{tuple(known.shape)}")
    if known.numel() == 0:
        return known
    launch("rmw_max_kernel launch", load("scatter_max").sidecar_rmw_max,
           index, known.data_ptr(), other.data_ptr(), known.numel())
    rmw_max_cuda.launches += 1
    return known


rmw_max_cuda.launches = 0


# -- device dispatch ----------------------------------------------------------

def scatter_max_apply(known, rows, cols, vals, sent=None, advanced=None):
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if known.is_cuda:
        return scatter_max_apply_cuda(known, rows, cols, vals, sent,
                                      advanced)
    return scatter_max_apply_torch(known, rows, cols, vals, sent, advanced)


def rmw_max(known, other):
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if known.is_cuda:
        return rmw_max_cuda(known, other)
    return rmw_max_torch(known, other)
