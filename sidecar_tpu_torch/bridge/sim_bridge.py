"""The live-catalog ⇄ simulator bridge — the port of
``sidecar_tpu/bridge/sim_bridge.py``: "simulate my cluster forward N
rounds" from a catalog snapshot, the capacity sweep and the autopilot,
as a library (:class:`SimBridge`) and over HTTP (:func:`serve_bridge`).

Mapping:

* each catalog server becomes a simulator node and each (server,
  service) a slot, the slots padded to a uniform width a node;
* the nanosecond ``Updated`` stamps become ticks of the simulator's
  clock, order kept: ``max(1, (updated − t0) // tick_ns + 1)``;
* the results map back as per-node agreement and a projected catalog
  view (which records every node would know after N rounds).

A request runs on the bridge's device: the card unless the caller asks
for the CPU.  The reference's environment variables and device mesh are
constructor arguments here: ``shards`` (the shard count of
``sharded=True``; None is one a visible card), ``topology`` (the
sweep's default overlay) and ``apply_armed`` (the autopilot's apply
gate).  ``sparse=None`` resolves to ``"auto"``, and ``board_exchange=
None`` to ``parallel/mesh.resolve_board_exchange``'s default.  A
dispatch is annotated as ``sidecar.bridge.dispatch`` for
``torch.profiler`` (the reference's ``telemetry/profiling.py`` is not
ported; the annotation costs nothing without a profiler).

Long requests run in chunks of :attr:`SimBridge.CHUNK_ROUNDS`, chunk
i+1 dispatched before chunk i is read back, with one generator (or one
list of draws) carried through them all, so a chunked request equals
one long run.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch import service as svc_mod
from sidecar_tpu_torch.models import common
from sidecar_tpu_torch.models.exact import ExactSim, SimParams, SimState
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import digest as digest_ops
from sidecar_tpu_torch.ops import provenance as prov_ops
from sidecar_tpu_torch.ops import sparse as sparse_ops
from sidecar_tpu_torch.ops import topology as topo_mod
from sidecar_tpu_torch.ops import trace as trace_ops
from sidecar_tpu_torch.ops.status import STATUS_BITS, STATUS_MASK, pack
from sidecar_tpu_torch.ops.suspicion import ProtocolParams

log = logging.getLogger(__name__)

# Each status code's name, by code (status_string of 0..7).
_STATUS_NAMES = tuple(svc_mod.status_string(c)
                      for c in range(STATUS_MASK + 1))


@dataclasses.dataclass
class BridgeMapping:
    """Index maps from a catalog snapshot."""

    hostnames: list[str]                   # node index → hostname
    slots: list[list[Optional[str]]]       # node index → slot → service id
    t0_ns: int                             # wall-clock origin
    tick_ns: int                           # ns per simulator tick


@dataclasses.dataclass
class SimulationReport:
    """One ``simulate`` answer; the optional blocks are None unless the
    request asked for them (see :meth:`SimBridge.simulate`)."""

    rounds: int
    seconds_simulated: float
    convergence: list[float]               # per-round cluster-wide fraction
    eps_round: Optional[int]               # first round ≥ 1-eps
    node_agreement: dict[str, float]       # hostname → final agreement
    projected: dict                        # host → {service id → status name}
    deltas: Optional[list] = None          # per-round changes (deltas_cap)
    board_exchange: Optional[str] = None   # sharded=True: the exchange …
    devices: Optional[int] = None          # … and the shard count
    sparse: Optional[dict] = None          # the per-run arbiter counters
    trace: Optional[dict] = None           # flight-recorder records
    robustness: Optional[dict] = None      # protocol + damping prediction
    provenance: Optional[dict] = None      # record-level provenance
    digest: Optional[dict] = None          # coherence-digest stream

    def to_json(self) -> dict:
        """The report as a dict — ``dataclasses.asdict``'s content
        without its deep copy (the ``projected`` block holds one entry
        per node and record)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class _Request:
    """One ``simulate`` call's context, carried from chunk to chunk."""

    sim: ExactSim
    params: SimParams
    mapping: BridgeMapping
    arbiter: sparse_ops.SparseArbiter
    generator: Optional[torch.Generator]
    draws: Optional[list]
    deltas_cap: int
    trace: int
    digest: int
    digest_buckets: int
    dig_idents: Optional[np.ndarray]
    tracked: tuple
    prov_cap: int
    prov: object = None                    # the chained ProvTrace
    delta_stream: Optional[list] = None
    trace_rounds: Optional[list] = None
    digest_rounds: Optional[list] = None
    conv_parts: list = dataclasses.field(default_factory=list)

    @property
    def prov_on(self) -> bool:
        return bool(self.tracked)


class SimBridge:
    # Rounds per dispatch: a long request runs in chunks, chunk i+1
    # dispatched before chunk i's results are read back.
    CHUNK_ROUNDS = 150

    def __init__(self, state, timecfg: TimeConfig = TimeConfig(), *,
                 device="cuda", shards: Optional[int] = None,
                 topology: Optional[str] = None,
                 apply_armed: bool = False) -> None:
        self.state = state
        self.t = timecfg
        self.device = common.resolve_device(device, "SimBridge")
        self.shards = shards
        self.topology = topology
        self.apply_armed = bool(apply_armed)

    def _shard_count(self) -> int:
        """The shards of ``sharded=True``: ``shards``, else one a visible
        card (one on the CPU)."""
        if self.shards is not None:
            return int(self.shards)
        if self.device.type == "cuda":
            return max(1, torch.cuda.device_count())
        return 1

    # -- state mapping -----------------------------------------------------

    def snapshot(self, sharded: bool = False,
                 board_exchange: Optional[str] = None,
                 timecfg: Optional[TimeConfig] = None
                 ) -> tuple[SimState, SimParams, BridgeMapping, ExactSim]:
        """Freeze the catalog into simulator tensors on the bridge's
        device.  Every node starts knowing the whole snapshot (the
        catalog is this node's view, converged from its side).

        ``sharded=True`` builds the node-sharded twin over
        :meth:`_shard_count` shards (the catalog's node count must divide
        it), with ``board_exchange`` its exchange mode.  ``timecfg``
        overrides the bridge's clock for this snapshot (the per-request
        ``protocol``)."""
        cfg = timecfg if timecfg is not None else self.t
        with self.state._lock:
            servers = {h: dict(server.services)
                       for h, server in self.state.servers.items()}
        if not servers:
            raise ValueError("empty catalog: nothing to simulate")

        hostnames = sorted(servers)
        spn = max(len(svcs) for svcs in servers.values())
        n = len(hostnames)

        t0 = min(svc.updated
                 for svcs in servers.values()
                 for svc in svcs.values())
        tick_ns = int(cfg.round_ticks / cfg.ticks_per_second * 1e9
                      / cfg.round_ticks)  # 1 tick in ns (1 ms default)

        slots: list[list[Optional[str]]] = []
        owned_vals = np.zeros((n, spn), dtype=np.int64)
        for ni, hostname in enumerate(hostnames):
            row: list[Optional[str]] = []
            for si, (sid, svc) in enumerate(sorted(servers[hostname]
                                                   .items())):
                # Ticks start at 1 (0 is the unknown sentinel).
                tick = max(1, (svc.updated - t0) // tick_ns + 1)
                owned_vals[ni, si] = pack(int(tick), int(svc.status))
                row.append(sid)
            row.extend([None] * (spn - len(row)))
            slots.append(row)

        params = SimParams(n=n, services_per_node=spn)
        if sharded:
            from sidecar_tpu_torch.parallel.sharded import ShardedSim

            d = self._shard_count()
            if n % d:
                raise ValueError(f"n={n} must divide the {d}-device mesh")
            sim = ShardedSim(params, topo_mod.complete(n), cfg, d=d,
                             board_exchange=board_exchange,
                             device=self.device)
        else:
            sim = ExactSim(params, topo_mod.complete(n), cfg,
                           device=self.device)
        state = sim.init_state()
        # Overwrite the cold-start rows: every node knows the snapshot.
        known = np.tile(owned_vals.reshape(-1).astype(np.int32), (n, 1))
        state = dataclasses.replace(state, known=self._put_known(sim, known))
        mapping = BridgeMapping(hostnames=hostnames, slots=slots,
                                t0_ns=t0, tick_ns=tick_ns)
        return state, params, mapping, sim

    @staticmethod
    def _put_known(sim, known: np.ndarray) -> torch.Tensor:
        """A host belief matrix as the sim's ``known`` (int32, on its
        device; the shards share that device)."""
        return torch.as_tensor(np.ascontiguousarray(known, np.int32),
                               device=sim.device)

    # -- the RPC -----------------------------------------------------------

    def simulate(self, rounds: int, seed: int = 0,
                 cold_nodes: Optional[list[str]] = None,
                 eps: float = 0.01,
                 deltas_cap: int = 0,
                 sharded: bool = False,
                 board_exchange: Optional[str] = None,
                 sparse: Optional[bool] = None,
                 trace: int = 0,
                 digest: int = 0,
                 digest_buckets: int = 0,
                 protocol=None,
                 provenance: Optional[dict] = None,
                 draws=None) -> SimulationReport:
        """Run the catalog forward ``rounds`` gossip rounds.

        * ``cold_nodes`` — hostnames whose knowledge is blanked to their
          own records first (fresh joiners);
        * ``deltas_cap`` > 0 — the per-round changed beliefs, mapped to
          (hostname, service id, status) triples (``run_with_deltas``);
        * ``sharded=True`` — the node-sharded twin (``board_exchange``
          its mode); not with ``deltas_cap`` or damping;
        * ``sparse`` — force the sparse-frontier round on or off; None
          lets a per-request ``SparseArbiter`` pick each chunk's mode
          from the previous chunks' convergence;
        * ``trace`` > 0 — flight-recorder records of the first ``trace``
          rounds;
        * ``digest`` > 0 — the coherence-digest stream of the first
          ``digest`` rounds over the catalog's (hostname, service id)
          identities, ``digest_buckets`` buckets (0 is the default; a
          power of two), and a final summary;
        * ``protocol`` — a :class:`ProtocolParams` or its dict: the
          request's suspicion window, future bound and origin defences,
          and with ``damping_threshold`` > 0 the ``robustness`` block's
          prediction of what this node's flap damper would suppress;
        * ``provenance`` — ``{"count": T}`` or ``{"services": [{"node":
          host, "service": id}, ...]}``, optional ``"cap"``: the
          record-level tracer's report, rounds absolute across chunks.

        One run carries one extra stream, so ``deltas_cap`` (and the
        damping prediction, which reads the delta stream), ``trace``,
        ``digest`` and ``provenance`` exclude each other.  ``draws``
        (one ``RoundDraws`` a round) replaces the generator seeded with
        ``seed``."""
        if protocol is not None and not isinstance(protocol,
                                                   ProtocolParams):
            protocol = ProtocolParams.from_json(protocol)
        damping_on = protocol is not None and \
            protocol.damping_threshold > 0
        if sharded and damping_on:
            raise ValueError(
                "damping prediction consumes the delta stream and is "
                "single-chip only (like deltas_cap); drop sharded=True "
                "or the damping_threshold")
        if sharded and deltas_cap > 0:
            raise ValueError(
                "deltas_cap > 0 is not supported with sharded=True "
                "(delta extraction runs on the single-chip model)")
        if trace > 0 and deltas_cap > 0:
            raise ValueError(
                "trace and deltas_cap are mutually exclusive "
                "(one scan streams one record kind)")
        if trace > 0 and damping_on:
            raise ValueError(
                "trace and damping prediction are mutually exclusive "
                "(damping consumes the delta stream; one scan streams "
                "one record kind)")
        prov_on = provenance is not None
        if prov_on and not isinstance(provenance, dict):
            raise ValueError(
                "'provenance' must be an object: {\"count\": T} or "
                "{\"services\": [{\"node\": ..., \"service\": ...}]}, "
                "optional \"cap\"")
        if prov_on and deltas_cap > 0:
            raise ValueError(
                "provenance and deltas_cap are mutually exclusive "
                "(one scan carries one extra stream)")
        if prov_on and trace > 0:
            raise ValueError(
                "provenance and trace are mutually exclusive "
                "(one scan carries one extra stream)")
        if prov_on and damping_on:
            raise ValueError(
                "provenance and damping prediction are mutually "
                "exclusive (damping consumes the delta stream; one "
                "scan carries one extra stream)")
        if digest > 0:
            # Fail fast on a bad bucket count (a power of two).
            digest_buckets = digest_buckets or digest_ops.DEFAULT_BUCKETS
            digest_ops.bucket_ids_np(np.zeros(1, np.uint32),
                                     digest_buckets)
        if digest > 0 and deltas_cap > 0:
            raise ValueError(
                "digest and deltas_cap are mutually exclusive "
                "(one scan streams one record kind)")
        if digest > 0 and trace > 0:
            raise ValueError(
                "digest and trace are mutually exclusive "
                "(one scan streams one record kind)")
        if digest > 0 and prov_on:
            raise ValueError(
                "digest and provenance are mutually exclusive "
                "(one scan carries one extra stream)")
        if digest > 0 and damping_on:
            raise ValueError(
                "digest and damping prediction are mutually exclusive "
                "(damping consumes the delta stream; one scan streams "
                "one record kind)")
        # Damping prediction reads the per-round change stream even when
        # the caller did not ask for deltas in the report.
        report_deltas = deltas_cap > 0
        if damping_on and deltas_cap == 0:
            deltas_cap = 4096
        t_req = time.perf_counter()
        state, params, mapping, sim = self.snapshot(
            sharded=sharded, board_exchange=board_exchange,
            timecfg=(protocol.timecfg(self.t)
                     if protocol is not None else None))

        if cold_nodes:
            known = state.known.cpu().numpy().copy()
            spn = params.services_per_node
            for hostname in cold_nodes:
                if hostname not in mapping.hostnames:
                    raise KeyError(hostname)
                ni = mapping.hostnames.index(hostname)
                own = known[ni, ni * spn:(ni + 1) * spn].copy()
                known[ni, :] = 0
                known[ni, ni * spn:(ni + 1) * spn] = own
            state = dataclasses.replace(state,
                                        known=self._put_known(sim, known))

        tracked: tuple = ()
        prov_cap = 0
        if prov_on:
            tracked, prov_cap = self._resolve_tracked(
                provenance, params, mapping, rounds)

        # Digest identities from the snapshot's (hostname, service id)
        # mapping, as the live catalog names its records; padding slots
        # get synthetic names (their cells stay unknown).
        dig_idents = None
        if digest > 0:
            dig_idents = digest_ops.catalog_idents(
                (hostname, sid if sid is not None else f"\x00pad{si}")
                for ni, hostname in enumerate(mapping.hostnames)
                for si, sid in enumerate(mapping.slots[ni]))

        sizes = []
        left = rounds
        while left > 0:
            sizes.append(min(self.CHUNK_ROUNDS, left))
            left -= sizes[-1]

        # A per-request arbiter: its counters are this run's.
        if sparse is None:
            sparse_mode = sparse_ops.resolve_sparse(None, record=False)
        else:
            sparse_mode = "1" if sparse else "0"
        req = _Request(
            sim=sim, params=params, mapping=mapping,
            arbiter=sparse_ops.SparseArbiter.for_census(sparse_mode,
                                                        params.n),
            generator=None if draws is not None
            else sim.default_generator(seed),
            draws=None if draws is None else list(draws),
            deltas_cap=deltas_cap, trace=trace, digest=digest,
            digest_buckets=digest_buckets, dig_idents=dig_idents,
            tracked=tracked, prov_cap=prov_cap,
            delta_stream=[] if deltas_cap > 0 else None,
            trace_rounds=[] if trace > 0 else None,
            digest_rounds=[] if digest > 0 else None)

        # Each pending chunk carries its own start round.
        pend, pend_start, pend_n = self._dispatch(req, state, sizes[0],
                                                  0), 0, sizes[0]
        done = sizes[0]
        for n_rounds in sizes[1:]:
            nxt = self._dispatch(req, pend[0][0], n_rounds, done)
            consume_args = (pend, pend_start, pend_n)
            pend, pend_start, pend_n = nxt, done, n_rounds
            done += n_rounds
            self._consume(req, *consume_args)
        final = self._consume(req, pend, pend_start, pend_n)
        conv = np.concatenate(req.conv_parts)
        known = final.known.cpu().numpy()

        truth = known.max(axis=0)
        agree = (known == truth[None, :]).mean(axis=1)
        node_agreement = {h: float(agree[i])
                          for i, h in enumerate(mapping.hostnames)}
        projected = self._project(known, mapping, params)

        robustness = None
        if protocol is not None:
            robustness = {"protocol": protocol.to_json()}
            if damping_on:
                robustness.update(self._predict_damping(
                    protocol, req.delta_stream, mapping))

        prov_doc = None
        if prov_on:
            prov_doc = self._prov_report(req.prov, tracked, params,
                                         mapping)

        digest_doc = None
        if digest > 0:
            digest_doc = self._digest_report(
                digest, digest_buckets, req.digest_rounds, known,
                final.node_alive.cpu().numpy(), dig_idents, mapping)

        hits = np.nonzero(conv >= 1.0 - eps)[0]
        metrics.histogram_since("bridge.simulate", t_req)
        return SimulationReport(
            rounds=rounds,
            seconds_simulated=rounds * sim.t.round_ticks
            / sim.t.ticks_per_second,
            convergence=[float(c) for c in conv],
            eps_round=int(hits[0]) + 1 if hits.size else None,
            node_agreement=node_agreement,
            projected=projected,
            deltas=req.delta_stream if report_deltas else None,
            board_exchange=sim.board_exchange if sharded else None,
            devices=sim.d if sharded else None,
            sparse={"mode": sparse_mode, **req.arbiter.snapshot()},
            trace=(None if req.trace_rounds is None
                   else {"requested": trace, "rounds": req.trace_rounds}),
            robustness=robustness,
            provenance=prov_doc,
            digest=digest_doc,
        )

    def _dispatch(self, req: _Request, st, n_rounds: int, start: int):
        """Launch one chunk of ``n_rounds`` from round ``start``: the
        plain run, or the run with the request's stream.  The mode is
        passed explicitly either way (the arbiter's decision).  Returns
        ``(out, sparse stats or None, (traced, digested))``."""
        sim, arbiter = req.sim, req.arbiter
        use_sparse = arbiter.sparse
        kw = dict(arbiter.dispatch_kwargs(), start_round=start,
                  generator=req.generator,
                  draws=None if req.draws is None
                  else req.draws[start:start + n_rounds])
        # Rounds of this chunk inside the trace/digest budget.
        traced_n = max(0, min(req.trace - start, n_rounds)) \
            if req.trace > 0 else 0
        digested_n = max(0, min(req.digest - start, n_rounds)) \
            if req.digest > 0 else 0
        with torch.profiler.record_function("sidecar.bridge.dispatch"):
            if req.prov_on:
                # The ProvTrace chains chunk to chunk.
                out = sim.run_with_provenance(
                    st, n_rounds, req.tracked, cap=req.prov_cap,
                    prov=req.prov, **kw)
                req.prov = out[1]
            elif req.deltas_cap > 0:
                out = sim.run_with_deltas(st, n_rounds, req.deltas_cap,
                                          **kw)
            elif traced_n > 0:
                out = sim.run_with_trace(st, n_rounds, cap=traced_n, **kw)
            elif digested_n > 0:
                out = sim.run_with_digest(
                    st, n_rounds, cap=digested_n,
                    buckets=req.digest_buckets, idents=req.dig_idents,
                    **kw)
            else:
                out = sim.run(st, n_rounds, **kw)
        stats = sim.last_sparse_stats if use_sparse else None
        return out, stats, (traced_n > 0, digested_n > 0)

    def _consume(self, req: _Request, pending, start: int,
                 n_rounds: int) -> SimState:
        """Read one dispatched chunk back: its stream, its convergence,
        and the arbiter's accounting and census.  Returns the chunk's
        final state."""
        out, stats, (traced, digested) = pending
        t0 = time.perf_counter()
        if req.deltas_cap > 0:
            final, batches, conv = out
            req.delta_stream.extend(self._map_deltas(
                batches, req.mapping, req.params, len(conv),
                start_round=start))
        elif traced:
            final, tr, conv = out
            req.trace_rounds.extend(trace_ops.trace_to_dicts(tr))
        elif digested:
            final, dtr, conv = out
            req.digest_rounds.extend(digest_ops.digest_to_dicts(dtr))
        elif req.prov_on:
            # The cumulative trace is req.prov; a chunk adds its curve.
            final, _pv, conv = out
        else:
            final, conv = out
        conv_h = conv.cpu().numpy()
        req.conv_parts.append(conv_h)
        req.arbiter.record_chunk(
            n_rounds, None if stats is None else stats.cpu().numpy())
        nm = float(req.params.n) * float(req.params.m)
        req.arbiter.update_census((1.0 - float(conv_h[-1])) * nm)
        metrics.histogram_since("bridge.chunk", t0)
        return final

    @staticmethod
    def _project(known: np.ndarray, mapping: BridgeMapping,
                 params: SimParams) -> dict:
        """The projected catalog: for every node, ``{service id: status
        name}`` over the real records it holds (ts > 0), in slot order —
        one NumPy pass over the held mask and the status codes."""
        spn = params.services_per_node
        cols, sids = [], []
        for oi, row in enumerate(mapping.slots):
            for si, sid in enumerate(row):
                if sid is not None:
                    cols.append(oi * spn + si)
                    sids.append(sid)
        cells = known[:, np.asarray(cols, np.int64)]
        held = (cells >> STATUS_BITS) > 0
        names = np.asarray(_STATUS_NAMES, dtype=object)[cells & STATUS_MASK]
        sid_arr = np.empty(len(sids), dtype=object)
        sid_arr[:] = sids
        return {hostname: dict(zip(sid_arr[held[ni]].tolist(),
                                   names[ni, held[ni]].tolist()))
                for ni, hostname in enumerate(mapping.hostnames)}

    @staticmethod
    def _digest_report(requested: int, buckets: int, rounds_doc: list,
                       known: np.ndarray, alive: np.ndarray, idents,
                       mapping: BridgeMapping) -> dict:
        """The report's ``digest`` block: the per-round stream and a
        summary of the final belief by the NumPy digest — agreement
        against the alive-max truth, per-node differing buckets, and
        the quorum digest in its wire form."""
        digs = digest_ops.node_digests_np(known, idents, buckets)
        truth = np.where(alive[:, None], known, 0).max(
            axis=0, keepdims=True)
        ref = digest_ops.node_digests_np(truth, idents, buckets)[0]
        diffs = digest_ops.diff_counts_np(digs, ref)
        alive_n = int(alive.sum())
        agree = int(((diffs == 0) & alive).sum())
        return {
            "requested": requested,
            "buckets": buckets,
            "rounds": rounds_doc,
            "final": {
                "agreement": (agree / alive_n) if alive_n else 1.0,
                "diff_total": int(diffs[alive].sum()),
                "diff_max": int(diffs[alive].max()) if alive_n else 0,
                "quorum_hex": digest_ops.digest_to_hex(ref),
                "node_diff_buckets": {
                    h: int(diffs[i])
                    for i, h in enumerate(mapping.hostnames)},
            },
        }

    @staticmethod
    def _resolve_tracked(req: dict, params: SimParams,
                         mapping: BridgeMapping,
                         rounds: int) -> tuple[tuple, int]:
        """A wire ``provenance`` object as (tracked slots, coverage
        cap): ``{"count": T}`` spreads T tracers evenly over the real
        records, ``{"services": [...]}`` names them."""
        unknown = set(req) - {"count", "services", "cap"}
        if unknown:
            raise ValueError(
                f"provenance: unknown key(s) {sorted(unknown)}; "
                "expected 'count' or 'services', optional 'cap'")
        cap = int(req.get("cap", 0))
        if cap < 0:
            raise ValueError(f"provenance.cap={cap} must be >= 0")
        cap = cap or rounds
        spn = params.services_per_node
        if "services" in req:
            ents = req["services"]
            if not isinstance(ents, list) or not ents:
                raise ValueError(
                    "provenance.services must be a non-empty list of "
                    "{\"node\": hostname, \"service\": id} objects")
            slots = set()
            for ent in ents:
                host, sid = ent["node"], ent["service"]
                if host not in mapping.hostnames:
                    raise KeyError(host)
                ni = mapping.hostnames.index(host)
                if sid not in mapping.slots[ni]:
                    raise KeyError(f"{host}/{sid}")
                slots.add(ni * spn + mapping.slots[ni].index(sid))
            return tuple(sorted(slots)), cap
        count = int(req.get("count", 8))
        if count < 1:
            raise ValueError(
                f"provenance.count={count} must be >= 1")
        real = [ni * spn + si
                for ni in range(len(mapping.hostnames))
                for si, sid in enumerate(mapping.slots[ni])
                if sid is not None]
        picks = prov_ops.default_tracked(len(real),
                                         min(count, len(real)))
        return tuple(sorted({real[p] for p in picks})), cap

    @staticmethod
    def _prov_report(prov, tracked: tuple, params: SimParams,
                     mapping: BridgeMapping) -> dict:
        """The finished ProvTrace as the report block: the summary and
        the tree, each tracked slot named by (hostname, service id)."""
        spn = params.services_per_node
        doc = prov_ops.summarize(prov, tracked, spn)
        for rec in doc["records"]:
            slot = rec["slot"]
            rec["node"] = mapping.hostnames[slot // spn]
            rec["service"] = mapping.slots[slot // spn][slot % spn]
        doc["tree"] = prov_ops.tree_to_dict(prov, tracked)
        return doc

    def _predict_damping(self, protocol, delta_stream,
                         mapping: BridgeMapping) -> dict:
        """Replay the simulated change stream, as this node sees it,
        through the flap damper (``catalog/damping.py``) on a clock of
        simulated ticks.  A delta round that overflowed its cap carries
        no changes; such rounds are counted in
        ``delta_overflow_rounds``."""
        from sidecar_tpu_torch.catalog.damping import (
            FlapDamper,
            TransitionReplay,
        )

        observer = self.state.hostname \
            if self.state.hostname in mapping.hostnames \
            else mapping.hostnames[0]
        # Codes 0..5 have distinct names; higher codes alias to the
        # "Tombstone" fallback and must not clobber the real code 1.
        code_of = {svc_mod.status_string(c): c for c in range(6)}

        end_ns = mapping.t0_ns
        damper = FlapDamper.from_protocol(
            protocol, now_fn=lambda: end_ns)
        replay = TransitionReplay(damper)

        # The initial view and record ownership, from the catalog.
        owner_of: dict[str, str] = {}
        with self.state._lock:
            for host, server in self.state.servers.items():
                for sid, svc in server.services.items():
                    replay.prime(sid, svc.status)
                    owner_of[sid] = host

        overflow_rounds = 0
        for round_doc in delta_stream or ():
            if round_doc.get("overflow"):
                overflow_rounds += 1
                continue
            for ch in round_doc.get("changes", ()):
                if ch["node"] != observer:
                    continue
                sid = ch["service"]
                st = code_of.get(ch["status"])
                if st is None:
                    continue
                now_ns = mapping.t0_ns + ch["tick"] * mapping.tick_ns
                end_ns = max(end_ns, now_ns)
                replay.see(owner_of.get(sid, observer), sid, st, now_ns)

        damped = sorted(f"{h}/{sid}" for h, sid in damper.damped(end_ns))
        return {"observer": observer, "damped": damped,
                "flaps": replay.flaps,
                "delta_overflow_rounds": overflow_rounds}

    @staticmethod
    def _map_deltas(batches, mapping: BridgeMapping, params: SimParams,
                    rounds: int, start_round: int = 0) -> list:
        """A ``DeltaBatch`` stream ``[rounds, cap]`` as per-round
        (hostname, service id, status) change lists; padded slots have
        no service id and are dropped.  ``start_round`` offsets the
        round numbers of a chunk."""
        spn = params.services_per_node
        count = batches.count.cpu().numpy()
        node = batches.node.cpu().numpy()
        slot = batches.slot.cpu().numpy()
        val = batches.val.cpu().numpy()
        overflow = batches.overflow.cpu().numpy()
        out = []
        for r in range(rounds):
            if bool(overflow[r]):
                out.append({"round": start_round + r + 1, "overflow": True,
                            "count": int(count[r])})
                continue
            changes = []
            for ni, si, v in zip(node[r].tolist(), slot[r].tolist(),
                                 val[r].tolist()):
                if ni < 0:
                    continue
                sid = mapping.slots[si // spn][si % spn]
                if sid is None:
                    continue
                changes.append({
                    "node": mapping.hostnames[ni],
                    "service": sid,
                    "status": _STATUS_NAMES[v & STATUS_MASK],
                    "tick": v >> STATUS_BITS,
                })
            out.append({"round": start_round + r + 1, "overflow": False,
                        "count": int(count[r]), "changes": changes})
        return out

    # -- the capacity-planning sweep ---------------------------------------

    def sweep(self, axes: dict, *, rounds: int = 200, eps: float = 0.01,
              n: Optional[int] = None, services_per_node: int = 4,
              fanout: int = 3, budget: int = 15, seed: int = 0,
              conv_every: int = 1, stop: bool = True,
              base: Optional[dict] = None,
              max_batch: Optional[int] = None,
              provenance: int = 8, slo=None) -> dict:
        """Evaluate a protocol-configuration grid in batched fleet
        dispatches (``fleet/``) on the bridge's device and return the
        Pareto table.

        ``axes`` maps axis names (``fleet/grid.KNOWN_AXES``) to value
        lists; ``base`` fixes spec fields every point shares.  The
        scenarios are cold-start clusters of ``n`` nodes (default: the
        catalog's node count, at least 8) on the exact model; points
        without a ``topology`` take the bridge's ``topology`` overlay.
        Each row reports rounds and seconds to ε and the exchange bytes
        spent; ``pareto_front`` lists the non-dominated rows on
        (rounds_to_eps, exchange_bytes) and ``pareto_excluded`` the rows
        that never reached ε.  ``provenance`` tracers (0 disables) add
        the ``p99_lag_rounds`` column; ``slo`` (a list of
        ``telemetry/slo.py`` rules) adds a verdict block a row.
        Malformed requests raise ``ValueError`` before any dispatch.
        The phases record the spans ``bridge.sweep.expand``,
        ``.build``, ``.run`` and ``.pareto``."""
        from sidecar_tpu_torch.fleet import expand_grid
        from sidecar_tpu_torch.fleet.grid import pareto_front
        from sidecar_tpu_torch.telemetry.span import span as _span

        if n is None:
            with self.state._lock:
                n = len(self.state.servers)
            n = max(n, 8)
        if rounds < 1:
            raise ValueError(f"rounds={rounds} must be >= 1")
        if conv_every < 1 or rounds % conv_every:
            raise ValueError(
                f"rounds={rounds} must be a positive multiple of "
                f"conv_every={conv_every}")
        base = dict(base or {})
        base.setdefault("seed", seed)
        # The bridge's default overlay for points that name none; an
        # explicit base or axis value wins.
        if self.topology and "topology" not in axes:
            base.setdefault("topology", self.topology)
        # Overlay names are checked before the grid expands.
        tvals = axes.get("topology")
        tvals = list(tvals) if isinstance(tvals, (list, tuple)) else []
        if base.get("topology"):
            tvals.append(base["topology"])
        for t_name in dict.fromkeys(tvals):
            topo_mod.from_name(str(t_name), int(n))  # ValueError → 400
        # So are the cadence axes.
        for ax, floor in (("tick_period", 1), ("tick_phase", 0)):
            vals = axes.get(ax)
            vals = list(vals) if isinstance(vals, (list, tuple)) else []
            if base.get(ax) is not None:
                vals.append(base[ax])
            for v in vals:
                if isinstance(v, bool) or not isinstance(v, int) \
                        or v < floor:
                    raise ValueError(
                        f"{ax}={v!r} must be an int >= {floor} "
                        "(per-node gossip cadence in rounds, "
                        "docs/pipeline.md)")
        # Library-only axes get a named rejection: the wire has no way
        # to supply a FaultPlan or select the compressed family.
        wire_only = {"fault_seed", "mint_frac"} & (set(axes) | set(base))
        if wire_only:
            raise ValueError(
                f"axis(es) {sorted(wire_only)} are library-only: "
                "fault_seed needs a shared FaultPlan structure and "
                "mint_frac the compressed family — build a "
                "ScenarioBatch directly (sidecar_tpu/fleet, "
                "docs/sweep.md); POST /sweep runs the plain exact "
                "family")
        if provenance < 0:
            raise ValueError(
                f"provenance={provenance} must be >= 0 (tracer count; "
                "0 disables the lag column)")
        # SLO rules parse before any dispatch.
        evaluator = None
        if slo is not None:
            from sidecar_tpu_torch.telemetry.slo import SloEvaluator
            if not isinstance(slo, (list, tuple)) or not slo or \
                    not all(isinstance(r, str) for r in slo):
                raise ValueError(
                    "'slo' must be a non-empty list of rule strings "
                    "(telemetry/slo.py grammar, e.g. "
                    "'converge <= 5 s', 'agreement >= 0.99')")
            evaluator = SloEvaluator(slo)   # ValueError → 400
        t_req = time.perf_counter()
        with _span("bridge.sweep.expand"):
            specs = expand_grid(axes, base)
        params = SimParams(n=int(n),
                           services_per_node=int(services_per_node),
                           fanout=int(fanout), budget=int(budget))
        tracked = prov_ops.default_tracked(
            params.m, int(provenance)) if provenance else ()
        # The cold-start study clock: refresh pinned out, so rounds to ε
        # measure the epidemic spread alone.
        cfg = dataclasses.replace(self.t, refresh_interval_s=10_000.0)
        # The grid size of a request (a count histogram).
        metrics.histogram("bridge.sweep.points", float(len(specs)))

        table: list = [None] * len(specs)
        batches = 0
        run_kw = dict(num_rounds=rounds, conv_every=conv_every, eps=eps,
                      stop=stop, tracked=tracked)
        with _span("bridge.sweep.build"):
            built = list(self._build_sweep_batches(
                specs, params, cfg, max_batch))
        for batch, idxs in built:
            with _span("bridge.sweep.run"):
                _fleet, run = self._run_sweep_batch(batch, run_kw)
                rows = run.table(cfg.round_ticks, cfg.ticks_per_second)
            for j, src_idx in enumerate(idxs):
                rows[j]["config"] = batch.specs[j].axes()
                if evaluator is not None:
                    rows[j]["slo"] = evaluator.evaluate_row(
                        rows[j], lag=run.lag_summary(j),
                        seconds_per_round=(cfg.round_ticks
                                           / cfg.ticks_per_second),
                        publish=False)
                table[src_idx] = rows[j]
            batches += 1
        with _span("bridge.sweep.pareto"):
            front = pareto_front(table)
        wall = time.perf_counter() - t_req
        metrics.histogram_since("bridge.sweep", t_req)
        return {
            "points": len(specs),
            "batches": batches,
            "provenance": int(provenance),
            "n": int(n),
            "services_per_node": int(services_per_node),
            "rounds": rounds,
            "eps": eps,
            "stop": bool(stop),
            "wall_seconds": round(wall, 3),
            "scenarios_per_sec": round(len(specs) / wall, 2)
            if wall > 0 else None,
            "table": table,
            "pareto_front": list(front),
            "pareto_excluded": {"count": len(front.excluded),
                                "indices": list(front.excluded)},
            **({"slo_rules": [r.text() for r in evaluator.rules]}
               if evaluator is not None else {}),
        }

    def _build_sweep_batches(self, specs, params, cfg, max_batch):
        from sidecar_tpu_torch.fleet import build_batches
        from sidecar_tpu_torch.fleet.grid import DEFAULT_MAX_BATCH

        return build_batches(
            specs, params, cfg, family="exact",
            max_batch=max_batch or DEFAULT_MAX_BATCH, device=self.device)

    @staticmethod
    def _run_sweep_batch(batch, run_kw: dict, inputs=None):
        """One fleet dispatch of a sweep batch: ``(FleetSim, FleetRun)``.
        ``inputs`` — ``(draws, fault_draws, perturb)``, as
        ``fleet.cpu_inputs`` gives them — replaces the batch's own draws
        and churn hook."""
        from sidecar_tpu_torch.fleet import FleetSim

        draws, faults, perturb = inputs or (None, None, None)
        fleet = FleetSim(batch, perturb=perturb)
        run = fleet.run(fleet.init_states(), draws=draws,
                        fault_draws=faults, **run_kw)
        return fleet, run

    # -- the autopilot loop ------------------------------------------------

    def autopilot_recommend(self, req: dict) -> dict:
        """``POST /autopilot/recommend``: one pass of the autopilot
        (``autopilot/``) on the bridge's device — fit the conditions (or
        take the request's ``estimate``), search the knob space against
        ``rules``, replay the winner, recommend; apply only when the
        bridge was built with ``apply_armed``.  Malformed requests raise
        ``ValueError``."""
        from sidecar_tpu_torch.autopilot import AutopilotController

        allowed = {"rules", "axes", "estimate", "rounds", "eps", "n",
                   "services_per_node", "fanout", "budget", "seed",
                   "seed_grid", "generations", "population", "elites",
                   "apply", "provenance"}
        bad = set(req) - allowed
        if bad:
            raise ValueError(
                f"unknown autopilot field(s) {sorted(bad)}; expected "
                f"a subset of {sorted(allowed)}")
        # Omitted counts take the controller's defaults.
        optional = {k: int(req[k]) for k in ("rounds", "n", "generations",
                                             "population")
                    if req.get(k) is not None}
        ctl = AutopilotController(bridge=self, apply_armed=self.apply_armed)
        return ctl.recommend(
            rules=req.get("rules"),
            axes=req.get("axes"),
            estimate=req.get("estimate"),
            eps=float(req.get("eps", 0.01)),
            services_per_node=int(req.get("services_per_node", 4)),
            fanout=int(req.get("fanout", 3)),
            budget=int(req.get("budget", 15)),
            seed=int(req.get("seed", 0)),
            seed_grid=int(req.get("seed_grid", 2)),
            elites=int(req.get("elites", 2)),
            apply=bool(req.get("apply", False)),
            provenance=int(req.get("provenance", 0)),
            device=self.device, **optional)


def serve_bridge(bridge: SimBridge, bind: str = "127.0.0.1",
                 port: int = 7778,
                 background: bool = True) -> ThreadingHTTPServer:
    """Serve ``bridge`` over HTTP (``port=0`` picks a free port;
    ``server.server_address[1]`` names it):

    * ``POST /simulate`` — :meth:`SimBridge.simulate`'s keywords as a
      JSON object (``rounds``, ``seed``, ``cold_nodes``, ``eps``,
      ``deltas_cap``, ``sharded``, ``board_exchange``, ``sparse``,
      ``trace``, ``digest``, ``digest_buckets``, ``protocol``,
      ``provenance``);
    * ``POST /sweep`` — :meth:`SimBridge.sweep`'s (``axes``, ``rounds``,
      ``eps``, ``n``, ``services_per_node``, ``fanout``, ``budget``,
      ``seed``, ``conv_every``, ``stop``, ``base``, ``provenance``,
      ``slo``);
    * ``POST /autopilot/recommend`` — :meth:`SimBridge.
      autopilot_recommend`'s request.

    A malformed body or request answers 400 with ``{"message": ...}``;
    an unknown route 404.  With ``background`` the server runs on a
    daemon thread; stop it with ``server.shutdown()``."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            log.debug("bridge: " + a[0], *a[1:])

        def _reply(self, status: int, doc: dict) -> None:
            body = json.dumps(doc).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _do_simulate(self, req: dict) -> dict:
            sparse_req = req.get("sparse")
            report = bridge.simulate(
                rounds=int(req.get("rounds", 50)),
                seed=int(req.get("seed", 0)),
                cold_nodes=req.get("cold_nodes"),
                eps=float(req.get("eps", 0.01)),
                deltas_cap=int(req.get("deltas_cap", 0)),
                sharded=bool(req.get("sharded", False)),
                board_exchange=req.get("board_exchange"),
                sparse=(None if sparse_req is None
                        else bool(sparse_req)),
                trace=int(req.get("trace", 0)),
                digest=int(req.get("digest", 0)),
                digest_buckets=int(req.get("digest_buckets", 0)),
                protocol=req.get("protocol"),
                provenance=req.get("provenance"))
            return report.to_json()

        def _do_sweep(self, req: dict) -> dict:
            axes = req.get("axes")
            if not isinstance(axes, dict) or not axes:
                raise ValueError(
                    "sweep request needs a non-empty 'axes' object "
                    "(axis name -> list of values)")
            base = req.get("base")
            if base is not None and not isinstance(base, dict):
                raise ValueError("'base' must be an object")
            n = req.get("n")
            return bridge.sweep(
                axes,
                rounds=int(req.get("rounds", 200)),
                eps=float(req.get("eps", 0.01)),
                n=None if n is None else int(n),
                services_per_node=int(req.get("services_per_node", 4)),
                fanout=int(req.get("fanout", 3)),
                budget=int(req.get("budget", 15)),
                seed=int(req.get("seed", 0)),
                conv_every=int(req.get("conv_every", 1)),
                stop=bool(req.get("stop", True)),
                base=base,
                provenance=int(req.get("provenance", 8)),
                slo=req.get("slo"))

        def _do_autopilot(self, req: dict) -> dict:
            return bridge.autopilot_recommend(req)

        def do_POST(self):
            route = self.path.split("?")[0]
            handlers = {"/simulate": self._do_simulate,
                        "/sweep": self._do_sweep,
                        "/autopilot/recommend": self._do_autopilot}
            if route not in handlers:
                self._reply(404, {"message": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body: not an object")
                doc = handlers[route](req)
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as exc:
                self._reply(400, {"message": str(exc)})
                return
            self._reply(200, doc)

    server = ThreadingHTTPServer((bind, port), Handler)
    if background:
        threading.Thread(target=server.serve_forever, name="sim-bridge",
                         daemon=True).start()
    else:
        server.serve_forever()
    return server
