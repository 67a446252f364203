"""Sparse-frontier round execution — the port of
``sidecar_tpu/ops/sparse.py``: the mode resolution shared by both
models (:func:`resolve_sparse`, :func:`resolve_request`), the bounded
row compaction the compacted rounds run on (:func:`compact_rows`), the
``[3]`` stats layout, and the host-side dense/sparse chunk arbiter
(:class:`SparseArbiter`).

A sparse round compacts the rows that can change this round — senders
(rows with an eligible cache line or record), and on the compressed
model the receivers that sampled one and the announcers — into
``[C]``-row views, runs the round's publish, pull, merge and announce
on them, and writes back by gather and select.  Rows outside the
frontiers are provably unchanged by the dense round, so a sparse round
equals the dense one bit for bit.  A round whose frontier exceeds its
cap runs the dense round instead (the overflow fallback).

Modes come from the constructor argument only: ``None`` is ``"auto"``
(the reference's default with its environment variable unset), and
``"on"``/``"off"`` are aliases of ``"1"``/``"0"``.  The process registry
(``sidecar_tpu_torch/metrics.py``) counts each resolution
(``sparse.mode.<mode>``) and the arbiter's chunks (``sparse.rounds``,
``sparse.overflow``, ``sparse.switches``, the ``sparse.frontier_size``
gauge) from the host ints it already holds; the per-run view is
:meth:`SparseArbiter.snapshot`.

:func:`compact_rows` runs without a host sync: ``jnp.nonzero(mask,
size=cap, fill_value=n)`` becomes a running count (``cumsum``) and a
scatter of the row ids into a ``[cap + 1]`` buffer pre-filled with
``n`` whose last slot takes every row past the cap.
"""

from __future__ import annotations

from typing import Optional

import torch

from sidecar_tpu_torch import metrics

SPARSE_MODES = ("auto", "0", "1")

# The stats vector every sparse step and run reports, int32 [3]:
# rounds run on the compacted path, rounds that overflowed to the dense
# fallback, and the frontier high-water mark.
STAT_SPARSE_ROUNDS = 0
STAT_OVERFLOW_ROUNDS = 1
STAT_FRONTIER_HWM = 2


def resolve_sparse(explicit: Optional[str] = None, *,
                   record: bool = True) -> str:
    """The sparse-execution mode of a sim, ``"auto" | "0" | "1"``, from
    its constructor argument (None is ``"auto"``), counted as
    ``sparse.mode.<mode>`` unless ``record`` is False (a per-request
    resolution, as the bridge's)."""
    mode = "auto" if explicit is None else explicit
    mode = {"on": "1", "off": "0"}.get(mode, mode)
    if mode not in SPARSE_MODES:
        raise ValueError(
            f"sparse mode must be one of {SPARSE_MODES}, got {explicit!r}")
    if record:
        metrics.incr(f"sparse.mode.{mode}")
    return mode


def resolve_request(mode: str, sparse, supports_sparse: bool = True) -> bool:
    """Per-dispatch resolution: ``sparse=None`` follows the sim's mode
    (on only under ``"1"``, and off on a sim without the path); an
    explicit ``True`` raises under mode ``"0"`` or on a sim that cannot
    run it."""
    if sparse is None:
        sparse = mode == "1"
        if sparse and not supports_sparse:
            return False
    if sparse and (mode == "0" or not supports_sparse):
        raise ValueError(
            "sparse execution is disabled or unsupported on this sim "
            f"(mode={mode!r}, supports_sparse={supports_sparse})")
    return bool(sparse)


def default_frontier_cap(n: int) -> int:
    """The automatic frontier width: wide enough to give the arbiter's
    entry rule slack, narrow enough that the compacted round is much
    cheaper than the dense one."""
    return min(n, max(128, n // 16))


def compact_rows(mask, cap: int):
    """Bounded static-width row compaction of a bool ``[N]`` mask.

    Returns ``(idx, row, valid, pos)``:

    * ``idx``   int32 ``[cap]`` — the first ``cap`` set rows in
      ascending order, padded with ``n``;
    * ``row``   int32 ``[cap]`` — ``min(idx, n - 1)``, always in range
      (pad rows repeat row ``n - 1``; callers mask their results);
    * ``valid`` bool ``[cap]`` — True at real entries;
    * ``pos``   int32 ``[N]`` — the inverse map: ``pos[g]`` is g's
      compacted index where ``mask[g]`` (and 0 elsewhere, which callers
      mask with ``mask``).

    No host sync: each set row's place is its running count, rows past
    the cap land in an overflow slot, and the pad id ``n`` lands in a
    dropped slot of the inverse map."""
    n = mask.shape[0]
    dev = mask.device
    place = torch.cumsum(mask.to(torch.int32), 0) - 1
    slot = torch.where(mask & (place < cap), place, cap).to(torch.int64)
    buf = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
    buf.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=dev))
    idx = buf[:cap]
    row = torch.clamp(idx, max=n - 1)
    valid = idx < n
    pos = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    pos.scatter_(0, idx.to(torch.int64),
                 torch.arange(cap, dtype=torch.int32, device=dev))
    return idx, row, valid, pos[:n]


def zero_stats() -> torch.Tensor:
    """An all-zero stats vector (int32 ``[3]``, on the host: the sparse
    rounds know their stats on the host, from the one read a round)."""
    return torch.zeros(3, dtype=torch.int32)


def accumulate_stats(acc, step_stats) -> torch.Tensor:
    """Fold one round's stats into the running ones: the counters add,
    the high-water mark takes the max."""
    return torch.stack([
        acc[STAT_SPARSE_ROUNDS] + step_stats[STAT_SPARSE_ROUNDS],
        acc[STAT_OVERFLOW_ROUNDS] + step_stats[STAT_OVERFLOW_ROUNDS],
        torch.maximum(acc[STAT_FRONTIER_HWM],
                      step_stats[STAT_FRONTIER_HWM]),
    ]).to(torch.int32)


class SparseArbiter:
    """Host-side dense/sparse chunk arbiter.

    It sits at the chunk boundary of a run loop that already reads a
    census sample per chunk (the behind count) and turns it into the
    next chunk's mode:

    * ``mode="0"`` — always dense; ``mode="1"`` — always sparse (each
      round's overflow fallback still guards the caps);
    * ``mode="auto"`` — a hysteresis band: enter sparse when the census
      falls to ``enter_below``, leave only when it rises above
      ``exit_above``; a chunk that reports overflow rounds forces dense
      for ``cooldown`` decisions.

    Per-run counters live on the instance (:meth:`snapshot`) and
    :meth:`new_trajectory` zeroes them; the process registry keeps
    adding up across runs."""

    @classmethod
    def for_census(cls, mode: str, n: int) -> "SparseArbiter":
        """The run loops' shared policy: enter sparse when the behind
        census falls to ``n`` (under one behind cell a node on average,
        the tail where the frontier fits its cap)."""
        return cls(mode, enter_below=float(n))

    def __init__(self, mode: str = "auto", *, enter_below: float,
                 exit_above: Optional[float] = None, cooldown: int = 2):
        if mode not in SPARSE_MODES:
            raise ValueError(f"mode must be one of {SPARSE_MODES}")
        if exit_above is None:
            exit_above = 2.0 * enter_below
        if exit_above < enter_below:
            raise ValueError("exit_above must be >= enter_below "
                             "(the hysteresis band)")
        self.mode = mode
        self.enter_below = float(enter_below)
        self.exit_above = float(exit_above)
        self.cooldown = int(cooldown)
        self.new_trajectory()

    def new_trajectory(self) -> None:
        """Reset the per-run view (a new run from a fresh state)."""
        self.run_sparse_rounds = 0
        self.run_dense_rounds = 0
        self.run_overflow_rounds = 0
        self.run_switches = 0
        self.run_frontier_hwm = 0
        self._cooldown_left = 0
        self._sparse = self.mode == "1"
        metrics.set_gauge("sparse.frontier_size", 0.0)

    def snapshot(self) -> dict:
        """The per-run record."""
        return {
            "sparse_rounds": self.run_sparse_rounds,
            "dense_rounds": self.run_dense_rounds,
            "overflow_rounds": self.run_overflow_rounds,
            "switches": self.run_switches,
            "frontier_hwm": self.run_frontier_hwm,
        }

    @property
    def sparse(self) -> bool:
        """The mode of the chunk about to be dispatched."""
        return self._sparse

    def dispatch_kwargs(self) -> dict:
        """The run keywords of the next chunk; ``sparse`` is passed
        either way, so a dense decision is never overridden by a sim
        whose own mode is ``"1"``."""
        return {"sparse": self._sparse}

    def record_chunk(self, rounds: int, stats=None) -> None:
        """Account a finished chunk: ``stats`` is the run's ``[3]``
        stats vector for a sparse chunk, None for a dense one."""
        if stats is None:
            self.run_dense_rounds += rounds
            return
        sparse_rounds = int(stats[STAT_SPARSE_ROUNDS])
        overflow = int(stats[STAT_OVERFLOW_ROUNDS])
        frontier = int(stats[STAT_FRONTIER_HWM])
        self.run_sparse_rounds += sparse_rounds
        self.run_dense_rounds += rounds - sparse_rounds
        self.run_overflow_rounds += overflow
        self.run_frontier_hwm = max(self.run_frontier_hwm, frontier)
        if sparse_rounds:
            metrics.incr("sparse.rounds", sparse_rounds)
        if overflow:
            metrics.incr("sparse.overflow", overflow)
            if self.mode == "auto":
                self._cooldown_left = self.cooldown
                self._switch(False)
        metrics.set_gauge("sparse.frontier_size", float(frontier))

    def update_census(self, census: float) -> bool:
        """Feed the latest census sample; returns the next chunk's
        mode."""
        if self.mode != "auto":
            return self._sparse
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return self._sparse
        if not self._sparse and census <= self.enter_below:
            self._switch(True)
        elif self._sparse and census > self.exit_above:
            self._switch(False)
        return self._sparse

    def _switch(self, to_sparse: bool) -> None:
        if self._sparse != to_sparse:
            self._sparse = to_sparse
            self.run_switches += 1
            metrics.incr("sparse.switches")
