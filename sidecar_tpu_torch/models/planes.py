"""The telemetry planes that ride a run — the flight recorder
(``ops/trace.py``), the coherence digest (``ops/digest.py``), the delta
batches (``ops/delta.py``) and provenance (``ops/provenance.py``) — as
observers of the models' round loop (``ExactSim._run``,
``CompressedSim._run``).

A plane sees each round twice: :meth:`before` with the pre-round state
and the round's draws, and :meth:`after` with what ``before`` returned,
the post-round state and the sparse step's stats (None on a dense
round).  Everything a plane needs of the pre-round state is taken in
``before``, because the exact round rewrites ``known`` and ``sent`` in
place; the model decides what that is (``_trace_before``,
``_delta_belief``, ``_delta_batch``, ``_prov_belief``;
``_prov_channels`` reads the
post-round state, whose liveness is the one the round sampled with,
after a scenario hook ran).  A plane
never writes the round's tensors and draws nothing, so a traced run
consumes the generator as an untraced one does and ends in the same
state.  An untraced run builds no plane.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sidecar_tpu_torch.ops import delta as delta_ops
from sidecar_tpu_torch.ops import digest as digest_ops
from sidecar_tpu_torch.ops import provenance as prov_ops
from sidecar_tpu_torch.ops import trace as trace_ops


class TracePlane:
    """One flight-recorder record a round into a ``cap``-row buffer."""

    def __init__(self, sim, cap: int):
        self.sim = sim
        self.result = trace_ops.zero_trace(cap, sim.device)

    def before(self, state, draws):
        return self.sim._trace_before(state)

    def after(self, prev, nxt, stats):
        self.result = trace_ops.append_record(
            self.result, self.sim._trace_record(prev, nxt, stats))


class DigestPlane:
    """One coherence record a round, over the post-round belief."""

    def __init__(self, sim, cap: int, idents, buckets: int):
        self.sim, self.idents, self.buckets = sim, idents, buckets
        self.result = digest_ops.zero_digest(cap, sim.device)

    def before(self, state, draws):
        return None

    def after(self, _, nxt, stats):
        self.result = digest_ops.append_digest(
            self.result, self.sim._digest_record(nxt, self.idents,
                                                 self.buckets))


class DeltaPlane:
    """One :class:`~sidecar_tpu_torch.ops.delta.DeltaBatch` a round —
    the belief after the round against the one carried from the round
    before — stacked along a leading round axis in :attr:`result`."""

    def __init__(self, sim, state, cap: int):
        self.sim, self.cap = sim, cap
        self.belief = sim._delta_belief(state)
        self.batches = []

    def before(self, state, draws):
        return None

    def after(self, _, nxt, stats):
        bel = self.sim._delta_belief(nxt)
        self.batches.append(self.sim._delta_batch(self.belief, bel,
                                                  self.cap))
        self.belief = bel

    @property
    def result(self):
        return delta_ops.DeltaBatch(**{
            f.name: torch.stack([getattr(b, f.name) for b in self.batches])
            for f in dataclasses.fields(delta_ops.DeltaBatch)})


class ProvPlane:
    """Provenance of the ``tracked`` slots: holders before and after
    each round and the round's channels, folded into the carried
    :class:`~sidecar_tpu_torch.ops.provenance.ProvTrace`."""

    def __init__(self, sim, prov, tracked):
        self.sim = sim
        self.result = prov
        self.tracked = torch.as_tensor(tracked, dtype=torch.int32,
                                       device=sim.device)

    def before(self, state, draws):
        cols = prov_ops.holders(self.result,
                                self.sim._prov_belief(state, self.tracked))
        return cols, draws

    def after(self, pre, nxt, stats):
        cols, draws = pre
        pushes, pulls = self.sim._prov_channels(nxt, draws)
        self.result = prov_ops.observe(
            self.result, cols,
            prov_ops.holders(self.result,
                             self.sim._prov_belief(nxt, self.tracked)),
            nxt.round_idx, pushes, pulls)


def check_tracked(tracked, m: int) -> tuple:
    """``tracked`` as a tuple of slot ints, each in ``[0, m)``."""
    tracked = tuple(int(s) for s in tracked)
    if not tracked:
        raise ValueError("provenance needs at least one tracked slot")
    for slot in tracked:
        if not 0 <= slot < m:
            raise ValueError(f"tracked slot {slot} outside [0, {m})")
    return tracked


def start_prov(sim, state, tracked: tuple, cap: int, prov):
    """The carry a provenance run starts from: ``prov`` when a chunked
    caller passes the previous chunk's, else an empty trace seeded from
    ``state``."""
    if prov is not None:
        return prov
    prov = prov_ops.zero_prov(len(tracked), sim.p.n, cap, sim.device)
    tr = torch.as_tensor(tracked, dtype=torch.int32, device=sim.device)
    return prov_ops.seed(prov, sim._prov_belief(state, tr), state.round_idx)


def digest_idents(idents, m: int, device):
    """The digest identity table as uint32 values in an int64 tensor:
    the caller's, or the sim-slot default."""
    if idents is None:
        idents = digest_ops.default_idents(m)
    if isinstance(idents, torch.Tensor):
        return idents.to(device, torch.int64) & 0xFFFFFFFF
    return torch.as_tensor(np.asarray(idents, np.uint32).astype(np.int64),
                           device=device)
