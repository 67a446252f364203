"""The publish selection and board row gather of the compressed round —
plain PyTorch versions, the hand-written CUDA kernels' wrappers, and the
dispatch between them.

Three functions, each with both forms:

* ``publish_board`` — each row's top-``budget`` freshest eligible cache
  lines as a message board (``bval``/``bslot``, unselected lines zeroed
  or -1) plus the transmit-count bump ``sent``.  Plain version
  :func:`publish_board_torch` (the reference's ``publish_board_xla``);
  kernel ``publish_board_kernel`` in ``csrc/publish_gather.cu``
  (replaces ``publish_board_pallas``).  ``row_ids`` gives each row its
  global id (the sparse round publishes a compacted row set).
* ``fused_publish_gather`` — the own rows' ``sent`` plus, for each
  receiver row r and leg f, the board of peer ``src[r, f]`` with the
  staleness gate applied (``pv``/``ps`` [N, F, K]).  Plain version
  :func:`fused_publish_gather_torch` (``fused_publish_gather_xla``);
  two kernels launched by one call (replacing
  ``fused_publish_gather_pallas``): ``fused_publish_select_kernel``
  selects each row once and writes ``sent`` and a selection bit mask
  (K bits a row) in place of the [N, K] board, then
  ``fused_publish_gather_kernel`` walks the requests in windows of
  rows and publishes each named row from the cache and its mask.
* ``board_row_gather`` — the node-sharded round's delivery gather: from
  a board block whose row 0 is global node ``base``, the rows of the
  sampled peers ``src[r, f]`` (global ids), ``(0, -1)`` for a peer
  outside the block.  Plain version :func:`board_row_gather_torch`
  (``board_row_gather_xla``); kernel ``board_row_gather_kernel``
  (replaces ``board_row_gather_pallas``).

Dispatch is by the tensors' device and nothing else: a CUDA tensor
launches the kernel (or the call raises), a CPU tensor takes the plain
version.  Each CUDA wrapper counts its launches in a plain integer
attribute, ``<wrapper>.launches``.

The selection, on one row of K lines with ``B = min(budget, K)``:
``priority = eligible ? val : 0``; the threshold ``t`` is the B-th
largest priority counting repeats; lines above ``t`` are selected, and
ties at ``t`` (with ``t > 0``) are admitted in a per-row rotated order
— the rotation ``rot = (gid · 2654435761 mod 2³²) & (K−1)`` — while
their rotated rank is ``≤ B − #above``; ``sent = min(sent + fanout ·
selected, limit)`` as int8.  All integer; kernels and plain versions
are held equal with ``torch.equal``.
"""

from __future__ import annotations

import torch

from sidecar_tpu_torch.ops.kernels.build import launch, load
from sidecar_tpu_torch.ops.merge import staleness_mask
from sidecar_tpu_torch.ops.status import MASK32, PHASE_MULT


def eligible_lines(cache_slot, cache_sent, limit: int):
    """Publish eligibility of a cache line: occupied AND transmits left
    (memberlist TransmitLimited semantics)."""
    return (cache_slot >= 0) & (cache_sent.to(torch.int32) < limit)


# -- plain PyTorch versions ---------------------------------------------------

def publish_board_torch(cache_val, cache_slot, cache_sent, *, budget: int,
                        limit: int, fanout: int, cache_lines: int,
                        row_offset: int = 0, row_ids=None):
    """The publish selection in plain PyTorch — the op sequence of the
    reference's ``publish_board_xla``: ``topk`` threshold plus the
    rotated prefix-sum tie admission.  The tie rotation is seeded by
    each row's global id: ``row_offset + r``, or ``row_ids[r]`` (int32
    ``[N]``) when given.  Returns ``(bval, bslot, sent)``."""
    k = cache_lines
    n = cache_val.shape[0]
    dev = cache_val.device
    eligible = eligible_lines(cache_slot, cache_sent, limit)
    priority = torch.where(eligible, cache_val, 0)
    budget = min(budget, k)
    thresh = torch.topk(priority, budget, dim=1).values[:, -1:]
    above = priority > thresh
    tie = (priority == thresh) & (priority > 0)
    n_above = above.sum(dim=1, keepdim=True, dtype=torch.int32)

    if row_ids is not None:
        rows = row_ids.to(dev, torch.int64) & MASK32
    else:
        rows = torch.arange(n, dtype=torch.int64, device=dev) + row_offset
    rot = (((rows * PHASE_MULT) & MASK32) & (k - 1))[:, None]
    s = torch.cumsum(tie.to(torch.int32), dim=1, dtype=torch.int32)
    total = s[:, -1:]
    base = torch.where(
        rot > 0, torch.gather(s, 1, torch.clamp(rot - 1, min=0)), 0)
    cols = torch.arange(k, dtype=torch.int64, device=dev)[None, :]
    rank = torch.where(cols >= rot, s - base, s + total - base)
    admit = tie & (rank <= budget - n_above)

    selected = above | admit
    bval = torch.where(selected, cache_val, 0)
    bslot = torch.where(selected, cache_slot, -1)
    sent = torch.clamp(
        cache_sent.to(torch.int32) + torch.where(selected, fanout, 0),
        max=limit).to(torch.int8)
    return bval, bslot, sent


def fused_publish_gather_torch(cache_val, cache_slot, cache_sent, src,
                               now: int, *, stale_ticks: int, budget: int,
                               limit: int, fanout: int, cache_lines: int):
    """Publish, staleness-filter the board, gather the sampled rows —
    the reference's ``fused_publish_gather_xla``.  ``ps`` keeps its slot
    where the gate zeroes ``pv`` (the merge masks it later).  Returns
    ``(sent, pv, ps)``."""
    bval, bslot, sent = publish_board_torch(
        cache_val, cache_slot, cache_sent, budget=budget, limit=limit,
        fanout=fanout, cache_lines=cache_lines)
    bval = torch.where(staleness_mask(bval, now, stale_ticks), 0, bval)
    rows = src.to(torch.int64)
    return sent, bval[rows], bslot[rows]


def board_row_gather_torch(bval, bslot, src, base: int = 0):
    """``pv[r, f] = bval[src[r, f] - base]`` (and ``ps`` from ``bslot``)
    where the row lies in the ``[R, K]`` block, else ``(0, -1)`` — the
    reference's ``board_row_gather_xla``.  Returns ``(pv, ps)``, each
    ``[nl, F, K]`` int32."""
    rows_total = bval.shape[0]
    rel = src.to(torch.int64) - base
    in_block = ((rel >= 0) & (rel < rows_total))[:, :, None]
    rows = torch.clamp(rel, 0, rows_total - 1)
    pv = torch.where(in_block, bval[rows], 0)
    ps = torch.where(in_block, bslot[rows], -1)
    return pv, ps


# -- CUDA wrappers ------------------------------------------------------------

def _check_cache(cache_val, cache_slot, cache_sent, cache_lines: int):
    index = cache_val.get_device()
    for name, t, dtype in (("cache_val", cache_val, torch.int32),
                           ("cache_slot", cache_slot, torch.int32),
                           ("cache_sent", cache_sent, torch.int8)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or t.shape != cache_val.shape:
            raise ValueError(f"{name} must be [N, K] like cache_val, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.get_device() != index:
            raise ValueError(f"{name} is on {t.device}, "
                             f"cache_val on {cache_val.device}")
    k = cache_val.shape[1]
    if k != cache_lines:
        raise ValueError(f"cache width {k} != cache_lines {cache_lines}")
    if k < 1 or k > 1024 or k & (k - 1):
        raise ValueError(f"cache_lines must be a power of two in "
                         f"[1, 1024], got {k}")
    return index


def publish_board_cuda(cache_val, cache_slot, cache_sent, *, budget: int,
                       limit: int, fanout: int, cache_lines: int,
                       row_offset: int = 0, row_ids=None):
    """Launch ``publish_board_kernel`` (a warp per row, eight rows a
    block) on the current stream; ``row_ids``, when given, is a
    contiguous int32 ``[N]`` tensor on the cache's device.  Returns
    ``(bval, bslot, sent)``."""
    index = _check_cache(cache_val, cache_slot, cache_sent, cache_lines)
    n, k = cache_val.shape
    ids = None
    if row_ids is not None:
        if not row_ids.is_cuda or row_ids.get_device() != index:
            raise ValueError(f"row_ids is on {row_ids.device}, "
                             f"cache_val on {cache_val.device}")
        if row_ids.dtype != torch.int32 or row_ids.shape != (n,):
            raise ValueError(f"row_ids must be int32 [{n}], got "
                             f"{row_ids.dtype} {tuple(row_ids.shape)}")
        if not row_ids.is_contiguous():
            raise ValueError("row_ids must be contiguous")
        ids = row_ids.data_ptr()
    bval = torch.empty_like(cache_val)
    bslot = torch.empty_like(cache_slot)
    sent = torch.empty_like(cache_sent)
    launch("publish_board_kernel launch",
           load("publish_gather").sidecar_publish_board, index,
           cache_val.data_ptr(), cache_slot.data_ptr(),
           cache_sent.data_ptr(), n, k, min(budget, k), limit, fanout,
           row_offset, ids, bval.data_ptr(), bslot.data_ptr(),
           sent.data_ptr())
    publish_board_cuda.launches += 1
    return bval, bslot, sent


publish_board_cuda.launches = 0


def fused_publish_gather_cuda(cache_val, cache_slot, cache_sent, src,
                              now: int, *, stale_ticks: int, budget: int,
                              limit: int, fanout: int, cache_lines: int):
    """Launch the select pass (a warp per row: ``sent`` and the rows'
    selection masks, in a scratch ``[N, max(1, K/32)]`` int32 tensor)
    and then the gather pass (the board row gather's windowed walk over
    ``src``, each named row published from the cache and its mask) on
    the current stream; one count in ``launches`` for the pair.
    Returns ``(sent, pv, ps)``."""
    index = _check_cache(cache_val, cache_slot, cache_sent, cache_lines)
    if src.dtype != torch.int32 or src.dim() != 2 or \
            src.shape[0] != cache_val.shape[0]:
        raise ValueError(f"src must be int32 [N, F], got {src.dtype} "
                         f"{tuple(src.shape)}")
    if src.get_device() != index or not src.is_contiguous():
        raise ValueError("src must be contiguous on the cache's device")
    n, k = cache_val.shape
    f = src.shape[1]
    sent = torch.empty_like(cache_sent)
    mask = cache_val.new_empty((n, max(1, k // 32)))
    pv = cache_val.new_empty((n, f, k))
    ps = torch.empty_like(pv)
    launch("fused publish gather launch",
           load("publish_gather").sidecar_fused_publish_gather, index,
           cache_val.data_ptr(), cache_slot.data_ptr(),
           cache_sent.data_ptr(), src.data_ptr(), n, f, k, min(budget, k),
           limit, fanout, now, stale_ticks, mask.data_ptr(),
           sent.data_ptr(), pv.data_ptr(), ps.data_ptr())
    fused_publish_gather_cuda.launches += 1
    return sent, pv, ps


fused_publish_gather_cuda.launches = 0


def board_row_gather_cuda(bval, bslot, src, base: int = 0):
    """Launch ``board_row_gather_kernel`` (blocks in passes over windows
    of board rows, so that each named row comes from device memory once)
    on the current stream.  Returns ``(pv, ps)``."""
    index = bval.get_device()
    for name, t in (("bval", bval), ("bslot", bslot), ("src", src)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.get_device() != index:
            raise ValueError(f"{name} is on {t.device}, bval on "
                             f"{bval.device}")
    if bslot.shape != bval.shape:
        raise ValueError(f"bslot {tuple(bslot.shape)} must match bval "
                         f"{tuple(bval.shape)}")
    rows_total, k = bval.shape
    nl, f = src.shape
    pv = bval.new_empty((nl, f, k))
    ps = bval.new_empty((nl, f, k))
    if pv.numel() == 0:
        return pv, ps
    launch("board_row_gather_kernel launch",
           load("publish_gather").sidecar_board_row_gather, index,
           bval.data_ptr(), bslot.data_ptr(), src.data_ptr(), rows_total,
           nl * f, k, int(base), pv.data_ptr(), ps.data_ptr())
    board_row_gather_cuda.launches += 1
    return pv, ps


board_row_gather_cuda.launches = 0


# -- device dispatch ----------------------------------------------------------

def publish_board(cache_val, cache_slot, cache_sent, **kw):
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if cache_val.is_cuda:
        return publish_board_cuda(cache_val, cache_slot, cache_sent, **kw)
    return publish_board_torch(cache_val, cache_slot, cache_sent, **kw)


def fused_publish_gather(cache_val, cache_slot, cache_sent, src, now,
                         **kw):
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if cache_val.is_cuda:
        return fused_publish_gather_cuda(cache_val, cache_slot, cache_sent,
                                         src, now, **kw)
    return fused_publish_gather_torch(cache_val, cache_slot, cache_sent,
                                      src, now, **kw)


def board_row_gather(bval, bslot, src, base: int = 0):
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if bval.is_cuda:
        return board_row_gather_cuda(bval, bslot, src, base)
    return board_row_gather_torch(bval, bslot, src, base)
