#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two models through their entry points and checks
them: the compressed model's dense lockstep round — the bench's
north-star workload — on one device and over node shards, its
sparse-frontier and software-pipelined rounds, and the exact
record-level model's dense round — the bench's headline ``value``
workload — with its execution modes and over node shards, the chaos
round and the partition hooks (config 5 and config 6 of the port's
``sim/scenarios.py``), the scenario fleet of all three families, the
autopilot's closed loop, the scenario configs and a checkpoint resume,
the simulator bridge over HTTP, the exact model against the NumPy
oracle, the live catalog and the live node's gossip transport, plus
the scatter experiment of ``benchmarks/pallas_scatter.py``:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — ``nvcc`` builds the kernels from
   ``sidecar_tpu_torch/ops/kernels/csrc`` (one ``nvcc`` per source, all
   started together) and reports registers, shared memory and spills
   (``-Xptxas -v``);
3. kernels  — each CUDA kernel against its plain PyTorch version on the
   same CUDA tensors, ``torch.equal`` on every output (integer outputs,
   no tolerance), over adversarial shapes and the main paths' shapes;
   the publish kernel also with explicit global row ids (the sparse
   round's compacted publish: ids padded with n, one row, ``arange``
   against the ``row_offset=0`` launch, and timed at the north star's
   compacted shape of 6,250 rows);
   then each timed with CUDA events beside its bound and the library
   call that computes the same function, where there is one (the
   scatter-max and in-place max kernels in alternating turns with
   theirs); the fused publish gather in alternating turns with the
   unfused path's publish kernel and gather for the same outputs, with
   uniform and with the north star's ER(8) peers, and each of its two
   passes' device time; the publish kernel also at the d=4 shard's
   shape; the scatter-max kernel and the library scatter also
   device-only, warm
   and after an L2 flush, in both orders; and the host µs per call of
   the scatter-max and row-gather wrappers beside the library calls';
   then (``row_gather_windows``) the row-gather kernel built with each
   of seven row windows, each held against its plain version and timed
   at the sharded north star's shapes;
4. lockstep — n=4096, K=256, ER(8, seed 3), 50 rounds from one set of
   injected draws three ways: on the card with the fused kernel, on the
   card with the publish-only kernel, and on the CPU with the plain
   versions; every state field and the behind curve must be equal;
   then the execution modes, card against CPU from one set of draws
   (``lockstep_modes``): the forced-sparse round for 150 rounds at its
   default cap (the early rounds overflow), the pipelined round, and
   per-node tick periods on a staggered graph — states, curves and
   sparse stats equal, and each kernel launched as the rounds say;
5. north star — ER(8, seed 3) at n=100,000 and M=1,000,000, K=256, the
   bench's 0.1 % burst, ``run_behind(every=25)`` until the behind count
   crosses ε=1e-4 of the unsettled set (at most 600 rounds), once with
   each kernel; the two runs must agree and each kernel's launch count
   must equal the rounds run; then each path's kernel on its run's
   cache at round 100 and at its end, held against its plain version
   and timed (the fused one beside the unfused pair); then the
   execution modes of the same run (``north_star_mode``), from the same
   generator seed: the forced-sparse run, the run whose mode
   ``SparseArbiter.for_census("auto", n)`` decides chunk by chunk (both
   must equal the dense run: curve, crossings, every field; the publish
   kernel once a compacted round, the fused one once any other), and
   the pipelined run (chunks chained by the ``inflight`` carry; the
   publish kernel once a tick plus the prime; its crossings beside the
   dense run's), with what the sparse path costs on overflowing rounds
   (its frontier masks and one host read) and saves in the tail;
6. sharded  — the same run through the node-sharded twin in every
   board-exchange mode at d ∈ {1, 4} shards, from the same generator
   seed: each must reach ε in the same rounds with the same behind
   curve and final state as the single-device unfused run, drop no
   pull, and launch the publish and board-row-gather kernels d times a
   round; then the twin's execution modes at d = 4
   (``sharded_mode``): forced sparse in ``ring`` and ``all_to_all``,
   each equal to the same run, with the compacted round's kernels (the
   publish kernel with global row ids, the board row gather) held
   against their plain versions and timed on a shard of its tail, and
   the pipelined twin equal to the single-device pipelined run for 100
   rounds;
7. scatter  — ``benchmarks/pallas_scatter.py``'s experiment at its
   shape (4,096 × 40,960, U = n·45 + m updates, ``default_rng(0)``):
   the scatter-max kernel must equal the library scatter, then four
   points are timed — an elementwise pass, the in-place max kernel (the
   ceiling), the library scatter and the scatter-max kernel — and then
   the two scatters, and the in-place max kernel with
   ``torch.maximum(…, out=known)``, in alternating turns and
   device-only, warm and after an L2 flush, in both orders;
8. exact lockstep — the exact model, ER(8, seed 3), n=1,024 × 10
   services (the two-stage select), loss 0.1, push-pull and the sweep
   firing, 30 rounds from one set of draws on the card and on the CPU:
   every state field equal, the convergence curve within 1e-6;
9. exact    — ``bench.py``'s ``value`` workload at full size: n=4,096
   × 10 services, fanout 3, budget 15, the default ``TimeConfig``,
   ER(8, seed 3), ``run_fast`` 200 warm rounds then 200 timed, with the
   scatter-max kernel launched once a round; rounds/s, peak memory, the
   device profile and each phase's device time;
10. exact modes — ``benchmarks/pipeline.py``'s exact rows at the
   ``value`` size and its protocol: ms a round of the lockstep,
   pipelined and forced-sparse rounds (the last equal to the lockstep
   run field for field), rounds to 1 − 1e-3 from a cold start lockstep
   against pipelined, and uniform period 1 against per-node periods
   {1, 2, 4}; the scatter-max kernel once a round of every run;
11. telemetry — the planes that ride the run loop
   (``models/planes.py``): on the ``value`` workload each of
   ``run_with_trace``, ``run_with_digest`` (64 buckets),
   ``run_with_deltas`` (its cap the median of the trace's ``admitted``
   column, which each batch's count must equal) and
   ``run_with_provenance`` (8 tracers), 20 rounds from the untraced
   run's seed, must end in its state and curve bit for bit, with ms a
   round in turns against it, peak memory, and where each synchronises
   (``set_sync_debug_mode``); on the north star the trace and
   provenance (64 of the burst's records) over the fused run's rounds,
   equal to it, the trace's ``behind`` equal to its curve, and the d=4
   ``ring`` twin's trace equal to the single device's; the compressed
   digest and deltas at n=4,096 (sparse streams equal to dense); and
   card against CPU, dense and sparse, every stream field equal: the
   exact model at n=512 × 10 (20 rounds, all planes), the compressed
   trace and provenance at n=4,096 (30 rounds), its digest and deltas at
   n=1,024 (10 rounds).  ``north_star_mode`` also holds the registry's
   ``sparse.*`` counters against the arbiter's;
12. sharded exact — the node-sharded exact twin (``ShardedSim``) on the
   ``value`` workload at full size, its shards sharing the card, in
   every board-exchange mode at d ∈ {1, 4}: 200 warm rounds then 200
   timed, rounds/s, a 5-round profile, peak memory and the exchange
   bytes, the scatter-max kernel once a shard a round, and every cell's
   final state and convergence curve equal to the d = 1 ``all_gather``
   run's; then the forced-sparse ``ring`` and the digest-gated ``zoned``
   rounds at d = 4 equal to it, the pipelined twin equal to
   ``ExactSim``'s pipelined run (100 rounds), every mode at d = 4 equal
   to ``ExactSim`` with push-pull past the horizon (50 rounds, the same
   draws), and the card equal to the CPU at n=1,024 × 10 (loss 0.1,
   push-pull every 10 rounds, 30 rounds).  The kernels phase also holds
   the scatter-max kernel on the d = 4 shard's row slice of ``known``
   against its plain version;
13. chaos — ``ChaosExactSim`` and the partition hooks, three parts, each
   its own line: (a) the chaos round at the ``value`` size (nothing cut,
   the defences on) under a config6-shaped plan scaled to 4,096 nodes
   (A→B loss, a split over rounds 20–80, a B→A delay ring with
   duplicates, a pause, a crash, a skewed clock, a tombstone bomb and
   the side-A churn hook), 200 rounds: rounds/s, a 5-round profile,
   peak memory, the injection counts, the convergence at rounds 20, 80,
   120 and 200 and the host syncs a round (0), with an empty plan equal
   to ``ExactSim``, 100 + 100 chunked rounds equal to 200 straight, two
   driver seeds on one set of fault draws, the card equal to the CPU
   at n = 1,024 × 10 for 30 rounds, and the scatter-max kernel held
   against its plain version, and timed beside it, on one round's own
   triples (immediate, matured-ring with the sentinel rows, announce)
   taken from the end of the 200-round run; (b) config6 at its own size (n =
   256, the complete graph), 200 rounds, the card equal to the CPU, and
   the round at which ε = 1e-3 is reached; (c) config5's split and heal
   at the declared 1,000,000 nodes (``mesh2d(1000, 1000)``, K = 64): 150
   split rounds with the cut and the sides, 450 heal rounds without,
   fused, the split's peak convergence below 1, the heal's round to ε =
   1e-5, each stage's rounds/s, profile and peak memory, and the fused
   publish gather at this shape in turns with the unfused pair (its own
   peak memory apart); then, each 50 rounds
   with the cut and the sides, fused equal to unfused equal to the CPU
   on ``mesh2d(64, 64)``, the compressed twin at d = 4 (``ring``,
   ``all_to_all``) equal to one device, and ``ShardedSim`` at d = 4
   (every mode) equal to d = 1 on ``mesh2d(32, 32)``;
14. fleet — the scenario fleet (``sidecar_tpu_torch/fleet``), four parts,
   each its own line: (a) ``benchmarks/sweep.py``'s 64-point grid
   (push-pull × suspicion × loss × limit) as one batch at n = 1,024 × 10
   services, 100 rounds: rounds/s and scenarios/s of the batch, peak
   memory, a 5-round profile and each part of a round alone, the same
   64 points as unbatched ``ExactSim`` runs from the same generators
   (every row equal; the sequential wall and the ratio), the scatter-max
   kernel held against its plain version on a fleet round's own batched
   triples (dropped rows at ``S·N``), and the run with early exit (rounds
   saved, host reads); (b) four chaos scenarios (fault seeds 7–10) under
   the config6-shaped plan at n = 4,096 × 10, each row equal to its
   unbatched ``ChaosExactSim`` run, rings and counters included; (c)
   eight north-star scenarios of the compressed model (the fused publish
   gather once per scenario a round), two rows equal to their unbatched
   runs, and the kernel held on one scenario's slice of the stacked
   cache; (d) a small batch of each family card against CPU, with and
   without early exit.
15. autopilot — ``benchmarks/autopilot.py``'s closed loop through the
   port (``sidecar_tpu_torch/autopilot``) at n = 4,096 × 4 services: the
   config6-shaped live cluster of ``sim/scenarios.py`` on the status-quo
   clock traced for 240 rounds from a warm start and fitted
   (``fit_from_trace``, its paused share at most 1 %; the fits of 120
   rounds from a cold and a warm start printed beside it), then
   ``recommend`` with the default axes and the rules ``converge <= 30
   rounds`` and ``agreement >= 0.99`` (60 rounds, seed 6, 2 generations
   of 6): the estimate, the baseline's and the winner's scores and SLO
   verdicts, evaluations against the exhaustive grid, the winner's
   unbatched replay (identical), the wall of the trace, the fit, each
   dispatch, the scoring and the host digest apart, and the replay,
   scenarios/s, peak memory, a 5-round profile of one dispatch, K4a once
   a round of every trace, every dispatch and the replay; then the card
   against the CPU at n = 64 from one set of inputs (estimate, every
   candidate's row and score, the winner);
16. scenarios — ``sim/scenarios.py``'s configs 1–4 and 6 through the
   port's module at their declared sizes (config5 runs once, in
   ``chaos``): each ``summary()`` with its rounds/s, peak memory and
   launches (K1 once a round of config4, K4a once a round of the
   others), config4's BA(3) graph build alone; then config3 saved at
   round 600 with its generator (``sim/checkpoint.py``), loaded into a
   fresh sim and run to round 1,200, equal to the straight run;
17. bridge — the simulator bridge (``sidecar_tpu_torch/bridge``) served
   over HTTP on 127.0.0.1 from a catalog of 1,024 hosts × 4 services
   made with numpy and loaded through ``catalog.decode``: a 300-round
   ``/simulate`` (two chunks) with 20 cold nodes, 60-round requests
   with ``deltas_cap`` and a damping ``protocol``, with ``digest``, with
   ``provenance`` and with ``trace`` and ``sparse``, ``sharded`` on a
   4-shard bridge equal to the unsharded answer, an 8-point ``/sweep``
   (100 rounds, one SLO rule), ``/autopilot/recommend`` with a given
   estimate and a malformed request (400); each request's wall split
   into dispatch, read-back, projection, JSON encode and HTTP, its
   bytes, peak memory and K4a launches (once a simulated round, a
   shard's round on the sharded bridge); then the same requests at 64
   hosts, card against CPU, equal reports;
18. oracle — the card's exact model against the sequential NumPy oracle
   (``sim/oracle.py``) at 64 × 4 services, 40 rounds on a fast clock:
   the plain round on the complete graph and ER(8), the suspicion
   window with the future bound and the origin budget, a clock-only
   chaos plan and an adversary with the defences on, every round; the
   pipelined oracle against ``step_pipelined`` and the provenance
   oracle against ``run_with_provenance``;
19. live — the live catalog (``catalog/``, ``query/``, ``transport/``):
   ``ChaosExactSim`` at the ``value`` shape (4,096 × 10, ER(8, seed 3),
   the refresh clock at 10,000 s) under a partition of the two halves
   held for 60 rounds with ``run_with_digest``; node 0's and node
   4,095's beliefs rebuilt as live catalogs through
   ``add_service_entry`` (stamp ``packed >> 3``), one healed from the
   other by a ``reconcile`` session over a ``LoopbackChannel`` (mode
   ``digest``, coherent), and the healed digest equal at every ladder
   level to ``ops/digest.ladder_digests`` on the card over the merged
   beliefs; the writer's records/s, the session's levels, records,
   bytes beside a full body's and its wall, K4a once a round; then the
   ``bridge`` phase's 1,024 × 4 catalog built through ``update_service``
   and a writer thread with a query hub and a ``UrlListener`` posting
   to a local HTTP server, and a 60-round ``/simulate`` on it equal to
   the same request on ``decode(state.encode())`` (K4a once a round of
   each); the hub's versions, the listener's POSTs and the writer's
   rate;
20. gossip — the live node's transport (``transport/gossip.py``,
   ``runtime/scheduler.py``, ``chaos/live_inject.py``, ``web/``): the
   native engine built with ``g++`` from ``native/transport.cc`` (its
   compiler and seconds); ``tests/test_chaos.py``'s cross-validation
   plan (a split of node a from b and c over rounds 10–50, 20 % loss and
   a 20 % one-round delay on (b, c) → a) on three live port nodes on
   loopback and on the card's ``ChaosExactSim`` (n = 3, the complete
   graph, 100 rounds, K4a once a round), b draining and c re-minting at
   round 20: both end at [ALIVE, DRAINING, ALIVE] with a's mid-split
   view of b stale, and the live injector's counters move; then 16 port
   nodes × 10 services in this process at the reference's protocol
   constants (gossip every 0.2 s to 3 nodes, 15 messages), each with a
   ``Scheduler`` driving ``broadcast_services_step`` and
   ``broadcast_tombstones_step`` over its static list: the wall and the
   gossip rounds from the last write until every node holds one catalog
   set (the wait ends two push-pull periods after 99 % of the (node,
   record) pairs are held), the seconds until half, nine tenths and
   99 % are held, each node's engine packets and bytes, the threads a
   node; node 0's catalog through the
   bridge on the card (its round-0 projection equal to node 0's
   statuses; the rounds to ε predicted from every node cold beside the
   live rounds; K4a once a simulated round); and the HTTP API on node 0
   (``/api/state.json`` decodes to its catalog, ``/api/metrics`` carries
   the ``engine.*`` and ``transport.*`` series, the latter from a join
   to a dead seed);
21. dist — the twins and the fleet's scenario and node axes over a
   ``torch.distributed`` group on the one card (``parallel/dist.py``,
   started by ``parallel/launch.spawn_group``): NCCL with one rank
   holding d = 4 shards — the exact twin at the ``value`` shape in
   every mode (50 rounds) and the compressed twin at the north star's
   shape in every mode (25 rounds, from the 0.1 % burst) — then gloo
   with two ranks of two shards sharing the card, every exchanged
   tensor copied through the host — the exact twin in ``all_gather``
   and ``ring`` (50 rounds), the compressed twin at n = 16,384 in
   ``all_gather`` and ``all_to_all`` (25 rounds), the 64-point grid
   at n = 1,024 over the two ranks (50 rounds), and the fleet's node
   axis: that grid and the ``fleet`` phase's chaos batch at 4,096 × 10
   (50 rounds) with each scenario's nodes split over the two ranks.
   Then, on each group,
   the twins' other paths (50 rounds each): the exact twin's trace,
   digest and provenance in one run beside the untraced run, the
   compressed twin's trace (the north star on NCCL, 16,384 on gloo) and
   deltas (4,096), both pipelined rounds, and config5 at its declared
   1M × 64 (NCCL, its split and 150 heal rounds against that prefix of
   the ``chaos`` phase's single-device run) or
   config4 at 16,384 × 10 (gloo, 100 rounds).  Each job's final state
   (SHA-256 of each rank's part) and curve, every stream field, each
   rank's part of a pipelined carry, or every row of the grid's table,
   must equal the same run through ``LocalShardGroup`` in this process
   (a node-axis job: the one-process fleet, the chaos batch's counters
   summed over the ranks),
   and each rank must launch its kernels as ``dist_expected`` says; per
   rank its wall, rounds/s (a traced job: ms a round traced and
   untraced), a 5-round profile (busy ms and idle share a round) of the
   first exact and compressed job and of the node-axis chaos job, peak
   memory, the bytes it sent and gloo's host staging bytes.  On one
   card this measures launches and host staging, not a link between
   cards.

Each phase prints one JSON line; then a ``walls`` line (each phase's
seconds and the script's), the ``kernels`` line, the card's
``nvidia-smi`` name and power limit, and, last, the device line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line, as does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

PHASES = ("device", "build", "kernels", "row_gather_windows", "lockstep",
          "north_star", "sharded", "scatter", "exact_lockstep", "exact",
          "exact_modes", "telemetry", "sharded_exact", "chaos", "fleet",
          "autopilot", "scenarios", "bridge", "oracle", "live", "gossip",
          "dist")
# Board rows a pass of the row-gather kernel covers, at K = 256 (2 KiB of
# bval and bslot a row); the kernel ships with 1,536 (3 MiB).
ROW_GATHER_WINDOWS = (384, 768, 1024, 1536, 2048, 4096, 8000)
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
DEVICE = "cuda"                   # where the script makes its own tensors
CSRC = "sidecar_tpu_torch/ops/kernels/csrc/"
# Kernel → (source, the TPU kernel it replaces).
KERNELS = {
    "publish_board": ("publish_gather.cu",
                      "sidecar_tpu/ops/kernels/publish_gather.py:193"),
    "fused_publish_gather": ("publish_gather.cu",
                             "sidecar_tpu/ops/kernels/publish_gather.py:371"),
    "board_row_gather": ("publish_gather.cu",
                         "sidecar_tpu/ops/kernels/publish_gather.py:265"),
    "scatter_max_apply": ("scatter_max.cu",
                          "benchmarks/pallas_scatter.py:106"),
    "rmw_max": ("scatter_max.cu", "benchmarks/pallas_scatter.py:144"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions ---------------------------

def random_cache(rng, n, k, *, occupancy=0.7, tie_value=None,
                 sent_ceiling=8, status=0):
    """A plausible cache triple (numpy): packed values, slot ids,
    transmit counts — the generator of tests/test_kernels.py."""
    import numpy as np

    if tie_value is not None:
        ts = np.full((n, k), tie_value, dtype=np.int64)
    else:
        ts = rng.integers(1, 1 << 20, (n, k), dtype=np.int64)
    cv = ((ts << 3) | status).astype(np.int32)
    occupied = rng.random((n, k)) < occupancy
    cs = np.where(occupied, rng.integers(0, n * 8, (n, k)), -1)
    cv = np.where(cs >= 0, cv, 0).astype(np.int32)
    se = rng.integers(0, sent_ceiling, (n, k)).astype(np.int8)
    return cv, cs.astype(np.int32), se


def positive_rows(rng, n, k, positive):
    """A cache triple (numpy) whose rows each hold exactly ``positive``
    eligible lines, with small priorities."""
    import numpy as np

    cv, cs, se = (np.zeros((n, k), np.int32), np.full((n, k), -1, np.int32),
                  np.zeros((n, k), np.int8))
    for r in range(n):
        cols = rng.choice(k, positive, replace=False)
        cv[r, cols] = rng.integers(1, 40, cols.size) << 3
        cs[r, cols] = rng.integers(0, 512, cols.size)
    return cv, cs, se


def board_cases():
    """(label, cache triple, kwargs) for publish_board."""
    import numpy as np

    cases = []
    for n, k in ((7, 8), (20, 64), (33, 16), (64, 256), (130, 32),
                 (37, 1024), (300, 1024)):
        rng = np.random.default_rng(n * 1000 + k)
        cases.append((f"random n={n} k={k}", random_cache(rng, n, k),
                      dict(budget=5, limit=6, fanout=3)))
    rng = np.random.default_rng(0)
    cases.append(("tie-heavy", random_cache(rng, 50, 32, occupancy=1.0,
                                            tie_value=17, sent_ceiling=2),
                  dict(budget=6, limit=6, fanout=3)))
    rng = np.random.default_rng(11)
    cases.append(("tie-heavy k=1024",
                  random_cache(rng, 40, 1024, occupancy=0.9, tie_value=5,
                               sent_ceiling=2),
                  dict(budget=15, limit=6, fanout=3)))
    rng = np.random.default_rng(1)
    cv, cs, se = random_cache(rng, 19, 16)
    cases.append(("all ineligible", (cv, cs, np.full_like(se, 100)),
                  dict(budget=4, limit=6, fanout=2)))
    rng = np.random.default_rng(2)
    cases.append(("tombstone-only", random_cache(rng, 21, 32, status=1),
                  dict(budget=5, limit=8, fanout=3)))
    cases.append(("empty cache", (np.zeros((12, 16), np.int32),
                                  np.full((12, 16), -1, np.int32),
                                  np.zeros((12, 16), np.int8)),
                  dict(budget=5, limit=6, fanout=3)))
    rng = np.random.default_rng(3)
    cases.append(("row_offset", random_cache(rng, 24, 32, tie_value=9,
                                             occupancy=1.0, sent_ceiling=2),
                  dict(budget=4, limit=6, fanout=2, row_offset=13)))
    rng = np.random.default_rng(4)
    cases.append(("budget > K", random_cache(rng, 9, 8),
                  dict(budget=64, limit=6, fanout=2)))
    # The warp-per-row kernel's own corners: K below a warp, budget 1 and
    # budget K, rows with exactly B and B - 1 positive priorities (the
    # t = 0 shortcut's edge), priorities with bit 30 set, every line tied,
    # and a row_offset above 2^30.
    for k, budget in ((1, 1), (2, 2), (4, 1), (32, 32), (256, 1)):
        rng = np.random.default_rng(40 + k)
        cases.append((f"k={k} budget={budget}",
                      random_cache(rng, 37, k, occupancy=0.9),
                      dict(budget=budget, limit=6, fanout=3, row_offset=5)))
    for short in (0, 1):
        rng = np.random.default_rng(50 + short)
        cases.append((f"{15 - short} positive of B=15",
                      positive_rows(rng, 64, 256, 15 - short),
                      dict(budget=15, limit=6, fanout=3)))
    rng = np.random.default_rng(52)
    cv, cs, se = random_cache(rng, 33, 256)
    cases.append(("bit 30 set", (np.where(cs >= 0, cv | (1 << 30), 0)
                                 .astype(np.int32), cs, se),
                  dict(budget=15, limit=6, fanout=3)))
    rng = np.random.default_rng(53)
    cases.append(("every line tied", random_cache(
        rng, 33, 256, occupancy=1.0, tie_value=40, sent_ceiling=1),
        dict(budget=15, limit=6, fanout=3, row_offset=(1 << 30) + 12345)))
    return cases


def row_ids_cases(n_ids: int = 100_000):
    """(label, cache triple, row ids) for publish_board with explicit
    global row ids — the sparse round's compacted publish — at small
    shapes: ascending ids padded with ``n_ids``, one row, ``arange(N)``
    (held against the ``row_offset=0`` launch too), and K = 32."""
    import numpy as np

    rng = np.random.default_rng(60)
    tied = dict(tie_value=9, occupancy=0.9, sent_ceiling=2)
    ids = np.full(64, n_ids, np.int32)
    ids[:50] = np.sort(rng.choice(n_ids, 50, replace=False))
    small = np.full(40, n_ids, np.int32)
    small[:33] = np.sort(rng.choice(n_ids, 33, replace=False))
    return [("ascending ids, 14 pads", random_cache(rng, 64, 256, **tied),
             ids),
            ("one row", random_cache(rng, 1, 256, **tied),
             np.array([77_777], np.int32)),
            ("ids arange(300)", random_cache(rng, 300, 256, **tied),
             np.arange(300, dtype=np.int32)),
            ("ascending ids k=32", random_cache(rng, 40, 32, **tied),
             small)]


def compacted_ids(rng, n: int, cap: int, real: int):
    """A sparse round's sender ids at the north star: ``real`` sorted
    distinct ids of ``n`` padded with ``n`` to ``cap``."""
    import numpy as np

    ids = np.full(cap, n, np.int32)
    ids[:real] = np.sort(rng.choice(n, real, replace=False))
    return ids


def gather_cases():
    """(label, cache triple, src, now, kwargs) for fused_publish_gather."""
    import numpy as np

    cases = []
    for n, k, f in ((20, 16, 3), (33, 64, 2), (7, 8, 4), (50, 1024, 3),
                    (1000, 256, 3)):
        rng = np.random.default_rng(n + k + f)
        cache = random_cache(rng, n, k)
        src = rng.integers(0, n, (n, f)).astype(np.int32)
        cases.append((f"random n={n} k={k} f={f}", cache, src, 1 << 19,
                      dict(stale_ticks=1 << 18, budget=5, limit=6,
                           fanout=f)))
    rng = np.random.default_rng(7)
    n, k, f = 16, 16, 3
    ts = rng.integers(1, 100, (n, k), dtype=np.int64)
    cache = ((ts << 3).astype(np.int32),
             rng.integers(0, n * 4, (n, k)).astype(np.int32),
             np.zeros((n, k), np.int8))
    src = rng.integers(0, n, (n, f)).astype(np.int32)
    cases.append(("staleness gate fires", cache, src, 90,
                  dict(stale_ticks=40, budget=6, limit=6, fanout=f)))
    rng = np.random.default_rng(8)
    cache = random_cache(rng, 64, 32, occupancy=1.0, tie_value=3,
                         sent_ceiling=2)
    src = rng.integers(0, 64, (64, 3)).astype(np.int32)
    cases.append(("tie-heavy", cache, src, 1 << 10,
                  dict(stale_ticks=1 << 20, budget=6, limit=6, fanout=3)))
    # The two-pass kernel's corners: K from 1 to 1024 with budget 1 and
    # budget K (K < 4 takes the gather pass's scalar path, K < 32 one mask
    # word a row); at K = 256 rows with exactly B and B - 1 positive
    # priorities, bit 30 set, every line tied, F = 1, a hot row that every
    # request names, self-sends, the staleness boundary (ts one below
    # now - stale_ticks, at it, one above, and 0; budget K publishes the
    # stale lines too) and N over two and a half 3 MiB windows of the
    # gather pass.  N = 43 elsewhere: not a multiple of the 8 rows a
    # select block takes.
    def corner(label, cache, f=3, budget=15, now=1 << 19, stale=1 << 18,
               src=None, seed=0):
        n = cache[0].shape[0]
        if src is None:
            src = np.random.default_rng(seed).integers(0, n, (n, f))
        cases.append((label, cache, src.astype(np.int32), now,
                      dict(stale_ticks=stale, budget=budget, limit=6,
                           fanout=3)))

    for k in (1, 2, 4, 8, 32, 256, 1024):
        for budget in sorted({1, k}):
            rng = np.random.default_rng(70 + k)
            corner(f"k={k} budget={budget}",
                   random_cache(rng, 43, k, occupancy=0.9), budget=budget,
                   seed=k)
    rng = np.random.default_rng(80)
    for positive in (15, 14):
        corner(f"{positive} positive of B=15",
               positive_rows(rng, 43, 256, positive), seed=positive)
    cv, cs, se = random_cache(rng, 43, 256)
    corner("bit 30 set", (np.where(cs >= 0, cv | (1 << 30), 0)
                          .astype(np.int32), cs, se), seed=1)
    corner("every line tied", random_cache(rng, 43, 256, occupancy=1.0,
                                           tie_value=40, sent_ceiling=1),
           seed=2)
    corner("f=1", random_cache(rng, 43, 256), f=1, seed=3)
    corner("hot row", random_cache(rng, 43, 256),
           src=np.full((43, 3), 7))
    corner("self-sends", random_cache(rng, 43, 256),
           src=np.repeat(np.arange(43)[:, None], 3, axis=1))
    cv, cs, se = random_cache(rng, 43, 256)
    ts = rng.choice([599, 600, 601, 0], cv.shape)
    corner("staleness boundary",
           (np.where(cs >= 0, (ts << 3) | rng.integers(0, 8, cv.shape), 0)
            .astype(np.int32), cs, se), budget=256, now=1000, stale=400,
           seed=4)
    corner("n over 2.5 windows", random_cache(rng, 5 * 1536 // 2 + 3, 256),
           seed=5)
    return cases


def row_gather_cases():
    """(label, bval, bslot, src, base) for board_row_gather: ragged
    request counts, blocks at an offset with src overshooting them on
    both sides, every row out of block, K from 1 to 1024 (K = 1, 2 and 6
    take the scalar path, K = 1024 copies a row in chunks), F = 1, every
    request naming one row, a block at an offset named with duplicates,
    and request counts that are not a multiple of the warps in a
    block."""
    import numpy as np

    cases = []
    for n, k, f, rows, base, hi in (
            (13, 16, 3, 13, 0, 18), (20, 32, 2, 5, 10, 20),
            (33, 8, 4, 11, 22, 38), (7, 128, 2, 7, 0, 12),
            (9, 1024, 1, 4, 3, 12), (31, 64, 3, 7, 50, 70),
            (1000, 256, 3, 1000, 0, 1000), (777, 256, 1, 250, 500, 1000),
            (37, 1, 3, 9, 4, 15), (29, 2, 3, 12, 0, 14),
            (41, 4, 3, 10, 5, 17), (23, 6, 1, 8, 2, 12),
            (301, 1024, 3, 200, 0, 260), (50_001, 256, 3, 30_000, 10_000,
                                          45_000)):
        rng = np.random.default_rng(n * 100 + k + f)
        cases.append((f"n={n} k={k} f={f} rows={rows} base={base}",
                      rng.integers(0, 1 << 20, (rows, k)).astype(np.int32),
                      rng.integers(-1, 4 * rows, (rows, k)).astype(np.int32),
                      rng.integers(0, hi, (n, f)).astype(np.int32), base))
    rng = np.random.default_rng(5)
    cases.append(("all rows out of block",
                  rng.integers(0, 99, (6, 64)).astype(np.int32),
                  rng.integers(-1, 24, (6, 64)).astype(np.int32),
                  rng.integers(0, 100, (10, 3)).astype(np.int32), 100))
    for n, k in ((43, 4), (100_000, 256)):
        rng = np.random.default_rng(n + k)
        cases.append((f"every request names row 7, n={n} k={k}",
                      rng.integers(0, 1 << 20, (16, k)).astype(np.int32),
                      rng.integers(-1, 64, (16, k)).astype(np.int32),
                      np.full((n, 3), 7 + 40, np.int32), 40))
    rng = np.random.default_rng(6)
    src = rng.integers(60, 75, (123, 3)).astype(np.int32)
    src[::5] = 66                                   # duplicates of one row
    cases.append(("block at an offset, duplicates",
                  rng.integers(0, 1 << 20, (12, 32)).astype(np.int32),
                  rng.integers(-1, 48, (12, 32)).astype(np.int32), src, 62))
    return cases


def to_cuda(arrays):
    import torch

    return [torch.as_tensor(a).to(DEVICE) for a in arrays]


def max_abs_diff(got, want) -> int:
    import torch

    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def ptxas_report(log: str, kernel: str) -> list:
    """Registers and spills of each instantiation of ``kernel`` in
    ``nvcc -Xptxas -v``'s report ``log``, with its integer and bool
    template arguments (``[8, 1]`` for ``<8, true>``) and its mangled
    template arguments (``4int4`` for ``<int4>``)."""
    import re

    out, name, spills = [], None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            spills = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = {"spill_stores": int(m.group(1)),
                      "spill_loads": int(m.group(2))}
        m = re.search(r"Used (\d+) registers", line)
        if m:
            args = re.search(kernel + r"I(.*)EEv", name)
            out.append({"template": [int(x) for x in re.findall(
                r"L[a-z](\d+)E", args.group(1))] if args else [],
                        "mangled_template": args.group(1) if args else "",
                        "registers": int(m.group(1)), **spills})
            name = None
    return out


def board_search_stats(cv, cs, se, budget: int, limit: int) -> dict:
    """How the publish kernel's threshold search goes on a cache: the
    share of rows with fewer than B positive priorities (t = 0, no
    search) and the mean bit-search steps of the others (the bit length
    of the row's largest priority)."""
    import torch

    from sidecar_tpu_torch.ops.kernels.publish_gather import eligible_lines

    pri = torch.where(eligible_lines(cs, se, limit), cv, 0)
    zero = (pri > 0).sum(dim=1) < min(budget, cv.shape[1])
    top = pri.max(dim=1).values[~zero]
    steps = sum(((top >> b) > 0).to(torch.int64) for b in range(31))
    return {"t0_share": float(zero.to(torch.float64).mean()),
            "mean_search_steps": float(steps.to(torch.float64).mean())
            if top.numel() else 0.0}


def check_board(label, cache, kw, failures) -> int:
    """The publish kernel against its plain version on one cache
    (``torch.equal`` on every output; ``label`` joins ``failures`` where
    they differ); returns the largest difference."""
    import torch

    from sidecar_tpu_torch.ops.kernels import publish_gather as pg

    got = pg.publish_board_cuda(*cache, **kw)
    want = pg.publish_board_torch(*cache, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        failures.append(f"publish_board {label}")
    return max_abs_diff(got, want)


def board_point(label, cache, bkw, failures, iters: int = 20) -> dict:
    """The publish kernel on one cache: :func:`check_board`, then timed
    beside its bound (9 B read and 9 B written a line), with
    :func:`board_search_stats`."""
    from sidecar_tpu_torch.ops.kernels import publish_gather as pg

    err = check_board(label, cache, bkw, failures)
    nbytes = cache[0].numel() * 18
    return dict(rows=cache[0].shape[0],
                row_offset=bkw.get("row_offset", 0), max_abs_err=err,
                ms=cuda_time_ms(lambda: pg.publish_board_cuda(*cache, **bkw),
                                iters),
                bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                **board_search_stats(*cache, bkw["budget"], bkw["limit"]))


def unfused_pair(cache, src, now: int, gkw):
    """The unfused path's publish and gather for the fused kernel's
    outputs: the publish kernel, then the gated board's rows ``src``
    (``bval[idx]`` and ``bslot[idx]``).  Returns ``(sent, pv, ps)``."""
    import torch

    from sidecar_tpu_torch.ops.kernels import publish_gather as pg
    from sidecar_tpu_torch.ops.merge import staleness_mask

    bkw = {k: v for k, v in gkw.items() if k != "stale_ticks"}
    bval, bslot, sent = pg.publish_board_cuda(*cache, **bkw)
    bval = torch.where(staleness_mask(bval, now, gkw["stale_ticks"]), 0,
                       bval)
    idx = src.to(torch.int64)
    return sent, bval[idx], bslot[idx]


def device_ms_by_kernel(fn, iters: int = 20) -> dict:
    """Device ms a call of ``fn`` by activity name: the durations of the
    device activities ``torch.profiler`` records over ``iters`` calls
    (after 3 warm-ups), summed by name and divided by ``iters``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / iters
    return out


def fused_gather_point(label, cache, src, now: int, gkw, failures,
                       iters: int = 20) -> dict:
    """The fused publish gather on one cache and request set: the kernel
    and the unfused pair (:func:`unfused_pair`) each held against the
    plain version (``label`` joins ``failures`` where one differs), then
    both timed in alternating turns (medians), each pass's device time
    (profiler), and the bytes: the single-pass bound's (the cache read
    once, src, sent and pv/ps written once) and what the two passes must
    move on this data (the select pass: the cache, sent and the mask; the
    gather pass: src, and of each named row its mask and the 32-byte
    sectors of val and slot that hold a selected line, and pv/ps)."""
    import torch

    from sidecar_tpu_torch.ops.kernels import publish_gather as pg

    fused = lambda: pg.fused_publish_gather_cuda(*cache, src, now, **gkw)
    pair = lambda: unfused_pair(cache, src, now, gkw)
    want = pg.fused_publish_gather_torch(*cache, src, now, **gkw)
    errs = []
    for name, fn in (("kernel", fused), ("unfused pair", pair)):
        got = fn()
        torch.cuda.synchronize()
        errs.append(max_abs_diff(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            failures.append(f"fused_publish_gather {label} ({name})")
        del got
    n, k = cache[0].shape
    bkw = {key: v for key, v in gkw.items() if key != "stale_ticks"}
    selected = pg.publish_board_torch(*cache, **bkw)[1] >= 0
    del want
    named = torch.unique(src.reshape(-1).to(torch.int64))
    sectors = int(selected[named].view(named.numel(), -1, min(k, 8))
                  .any(dim=2).sum())
    words = max(1, k // 32)
    line = n * k
    out_bytes = 2 * src.numel() * k * 4
    nbytes = line * 10 + src.numel() * 4 + out_bytes
    select_bytes = line * 10 + n * words * 4
    gather_bytes = src.numel() * 4 + named.numel() * words * 4 + \
        2 * sectors * min(k, 8) * 4 + out_bytes
    turns = paired_ms({"ms": fused, "unfused_pair_ms": pair}, iters=iters)
    passes = {}
    for name, ms in device_ms_by_kernel(fused, iters).items():
        key = ("select_pass_ms" if "fused_publish_select_kernel" in name
               else "gather_pass_ms" if "fused_publish_gather_kernel" in name
               else "other_ms")
        passes[key] = passes.get(key, 0.0) + ms
    return dict(rows=n, requests=src.numel(), rows_named=named.numel(),
                selected_lines=int(selected.sum()),
                selected_sectors_of_named_rows=sectors,
                max_abs_err=errs[0], unfused_pair_max_abs_err=errs[1],
                **turns, device_ms_by_pass=passes or "not measured",
                bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                two_pass_bytes=select_bytes + gather_bytes,
                two_pass_bound_ms=(select_bytes + gather_bytes)
                / PEAK_BYTES_PER_S * 1e3,
                select_pass_bound_ms=select_bytes / PEAK_BYTES_PER_S * 1e3,
                gather_pass_bound_ms=gather_bytes / PEAK_BYTES_PER_S * 1e3)


def er8_src(topo, seed: int = 21):
    """Requests as the north-star round draws them: the bench's fanout
    of peers a node from the ER(8) graph ``topo`` (``sample_peers``,
    every node alive)."""
    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.ops import gossip as gossip_ops

    sim = CompressedSim(bench_params(topo.n), topo, bench_time())
    draws = sim.draw(sim.default_generator(seed), 1)
    return gossip_ops.sample_peers(draws.peer_slot, topo.n, nbrs=sim._nbrs)


def cuda_time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


PAIRED_REPS = 5


def paired_ms(fns, reps: int = PAIRED_REPS, iters: int = 20) -> dict:
    """The median over ``reps`` turns of :func:`cuda_time_ms` for each
    function of ``fns`` (name → function), the order reversed every
    other turn: where the host's launch time sets the number, drift of
    the host's speed during the run then weighs on each alike."""
    names = list(fns)
    times = {name: [] for name in names}
    for turn in range(reps):
        for name in names if turn % 2 == 0 else names[::-1]:
            times[name].append(cuda_time_ms(fns[name], iters))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def device_time_ms(fn, iters: int = 20):
    """The device time of one call of ``fn``: the summed durations of
    the device activities ``torch.profiler`` records over ``iters``
    calls (after 3 warm-ups), divided by ``iters``
    (:func:`device_ms_by_kernel`); None where it recorded none (it
    sometimes misses a call of a few microseconds whole).  Unlike
    :func:`cuda_time_ms` it leaves out the gaps where the device waits
    for the host, which dominate such a call."""
    return sum(device_ms_by_kernel(fn, iters).values()) or None


L2_FLUSH_BYTES = 256 << 20        # five times the H100's 50 MB L2
SPIN_CYCLES = 200_000             # ~0.1 ms of device time on an H100
HOST_CALLS = 1000


def device_event_ms(fn, before=None, iters: int = 20) -> float:
    """The device time of one call of ``fn``: the median over ``iters``
    calls (after 3 warm-ups) of CUDA events recorded right around it,
    each call queued behind device work — ``before()`` where given (an
    L2 flush, a restore of the input), else a spin of the device — so
    the device reaches the first event only once the host has queued
    the call, and the host's launch time stays out of the window.
    ``before`` itself is not timed."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if before is not None:
            before()
        else:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def waited_ms(fn, before, iters: int = 20) -> float:
    """As a caller waits for one call of ``fn`` on fresh input: the
    median over ``iters`` calls (after 3 warm-ups) of CUDA events right
    around it, each call made once ``before()`` (a restore of the input)
    has finished and the device is idle, so the window holds the host's
    launch of the call and its device time.  ``before`` is not timed."""
    import torch

    for _ in range(3):
        before()
        fn()
    times = []
    for _ in range(iters):
        before()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def l2_flush():
    """A function that writes a 256 MB buffer, evicting the L2."""
    import torch

    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEVICE)
    return lambda: buf.fill_(1)


def device_times_both_orders(kernel, library, flush, iters: int = 20):
    """Device-only ms of a kernel and of the library call that computes
    the same function on the same data, warm and after an L2 flush, in
    both orders (kernel first, then library first)."""
    out = {}
    for order in (("kernel", "library"), ("library", "kernel")):
        fns = {"kernel": kernel, "library": library}
        out["_then_".join(order)] = {
            name: {"warm_ms": device_event_ms(fns[name], None, iters),
                   "l2_cold_ms": device_event_ms(fns[name], flush, iters)}
            for name in order}
    return out


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host µs per call of ``fn``: ``time.perf_counter`` over ``calls``
    calls with no synchronize among them.  The callers pass small
    inputs, so the device never holds the host back and this is the
    launch path's own cost."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def host_times():
    """Host µs per call of the K4a and K3 wrappers beside one library
    call each (``scatter_reduce_``; the unmasked ``index_select`` pair),
    on small inputs: 4,096 in-range triples into 64 × 640, and 192
    requests into a 256 × 256 board."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.ops.kernels import publish_gather as pg
    from sidecar_tpu_torch.ops.kernels import scatter_max as sm

    rng = np.random.default_rng(9)
    n, m, u = 64, 640, 4096
    known, rows, cols, vals, sent, adv = to_cuda((
        rng.integers(1, 1 << 20, (n, m)).astype(np.int32),
        rng.integers(0, n, u).astype(np.int32),
        rng.integers(0, m, u).astype(np.int32),
        rng.integers(1, 1 << 22, u).astype(np.int32),
        rng.integers(0, 10, (n, m)).astype(np.int8), rng.random(u) < 0.5))
    flat = rows.to(torch.int64) * m + cols.to(torch.int64)
    bval, bslot, src = to_cuda((
        rng.integers(0, 1 << 20, (256, 256)).astype(np.int32),
        rng.integers(-1, 1024, (256, 256)).astype(np.int32),
        rng.integers(0, 256, (64, 3)).astype(np.int32)))
    idx = src.to(torch.int64).reshape(-1)
    return {
        "scatter_max_apply_us": host_us(lambda: sm.scatter_max_apply_cuda(
            known, rows, cols, vals, sent, adv)),
        "scatter_max_apply_without_reset_us": host_us(
            lambda: sm.scatter_max_apply_cuda(known, rows, cols, vals)),
        "scatter_reduce_us": host_us(lambda: known.view(-1).scatter_reduce_(
            0, flat, vals, "amax")),
        "board_row_gather_us": host_us(lambda: pg.board_row_gather_cuda(
            bval, bslot, src, 0)),
        "index_select_pair_us": host_us(lambda: (
            torch.index_select(bval, 0, idx),
            torch.index_select(bslot, 0, idx))),
    }


def phase_kernels(ns_n: int, ns_k: int, ns_f: int, ex_n: int, ex_m: int,
                  topo=None):
    """Every kernel against its plain version; returns the partial
    ``kernels`` records (times and errors).  The publish and gather
    kernels run at the north star's shapes (``ns_*``), the fused one
    also with the north star's ER(8) peers where ``topo`` is given, the
    scatter kernels at the exact model's (``ex_*``)."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.ops.kernels import publish_gather as pg

    worst = {"publish_board": 0, "fused_publish_gather": 0,
             "board_row_gather": 0}
    failures = []
    # Each case, and a cache whose three buffers start one element past
    # an aligned address: the publish kernel's scalar path at K = 256.
    rng = np.random.default_rng(54)
    misaligned = [torch.as_tensor(np.concatenate(
        [a.reshape(-1)[:1], a.reshape(-1)])).to(DEVICE)[1:].view(a.shape)
        for a in random_cache(rng, 45, 256)]
    for label, cache, kw in board_cases() + [
            ("misaligned cache k=256", misaligned,
             dict(budget=15, limit=6, fanout=3, row_offset=9))]:
        cache = to_cuda(cache)
        worst["publish_board"] = max(worst["publish_board"], check_board(
            label, cache, dict(kw, cache_lines=cache[0].shape[1]),
            failures))
    del misaligned
    # And a fused case whose four inputs start one element past an
    # aligned address: both passes' scalar paths at K = 256.
    rng = np.random.default_rng(55)
    cache = random_cache(rng, 45, 256)
    src = rng.integers(0, 45, (45, 3)).astype(np.int32)
    misaligned = [torch.as_tensor(np.concatenate(
        [a.reshape(-1)[:1], a.reshape(-1)])).to(DEVICE)[1:].view(a.shape)
        for a in (*cache, src)]
    for label, cache, src, now, kw in gather_cases() + [
            ("misaligned inputs k=256", misaligned[:3], misaligned[3],
             1 << 19, dict(stale_ticks=1 << 18, budget=15, limit=6,
                           fanout=3))]:
        cv, cs, se, sr = to_cuda((*cache, src))
        k = cv.shape[1]
        got = pg.fused_publish_gather_cuda(cv, cs, se, sr, now,
                                           cache_lines=k, **kw)
        want = pg.fused_publish_gather_torch(cv, cs, se, sr, now,
                                             cache_lines=k, **kw)
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        worst["fused_publish_gather"] = max(worst["fused_publish_gather"],
                                            err)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            failures.append(f"fused_publish_gather {label}")

    # The north-star shape: parity, then time beside the bound.
    rng = np.random.default_rng(20)
    cv, cs, se = to_cuda(random_cache(rng, ns_n, ns_k))
    (src,) = to_cuda((rng.integers(0, ns_n, (ns_n, ns_f)).astype(np.int32),))
    bkw = dict(budget=15, limit=20, fanout=ns_f, cache_lines=ns_k)
    gkw = dict(bkw, stale_ticks=10_860_000)
    now = 1 << 22
    worst["publish_board"] = max(worst["publish_board"], check_board(
        "north-star shape", (cv, cs, se), bkw, failures))
    # K2 with explicit row ids: the small cases, then the north star's
    # compacted shape — cs_cap = 6,250 rows of the cache, 6,000 of them
    # real senders — held against the plain version and timed.
    for label, cache, ids in row_ids_cases(ns_n):
        cache, (ids,) = to_cuda(cache), to_cuda((ids,))
        kw = dict(budget=15, limit=6, fanout=3,
                  cache_lines=cache[0].shape[1])
        worst["publish_board"] = max(worst["publish_board"], check_board(
            label, cache, dict(kw, row_ids=ids), failures))
        if label.startswith("ids arange"):
            got = pg.publish_board_cuda(*cache, row_ids=ids, **kw)
            plain = pg.publish_board_cuda(*cache, row_offset=0, **kw)
            if not all(torch.equal(g, w) for g, w in zip(got, plain)):
                failures.append(f"publish_board {label} != row_offset 0")
    from sidecar_tpu_torch.ops.sparse import default_frontier_cap

    cap = default_frontier_cap(ns_n)
    (ids,) = to_cuda((compacted_ids(np.random.default_rng(61), ns_n, cap,
                                    cap * 24 // 25),))
    rows = torch.clamp(ids, max=ns_n - 1).long()
    compact = (cv[rows], cs[rows], se[rows])
    board_points = {"compacted north star": board_point(
        "compacted north star", compact, dict(bkw, row_ids=ids), failures)}
    board_points["compacted north star"]["bytes"] += ids.numel() * 4
    board_points["compacted north star"]["bound_ms"] = \
        board_points["compacted north star"]["bytes"] / PEAK_BYTES_PER_S * 1e3
    del compact, rows
    # K1 with uniform peers and, where the graph is given, with the
    # north star's ER(8) peers: parity, the unfused pair, times.
    srcs = {"uniform": src}
    if topo is not None:
        srcs["er8"] = er8_src(topo)
    fused_points = {label: fused_gather_point(
        f"north-star shape, {label} peers", (cv, cs, se), s, now, gkw,
        failures) for label, s in srcs.items()}
    del srcs
    for point in fused_points.values():
        worst["fused_publish_gather"] = max(worst["fused_publish_gather"],
                                            point["max_abs_err"])
    torch.cuda.synchronize()

    def check_row_gather(label, bv, bs, sr, base):
        got = pg.board_row_gather_cuda(bv, bs, sr, base)
        want = pg.board_row_gather_torch(bv, bs, sr, base)
        torch.cuda.synchronize()
        worst["board_row_gather"] = max(worst["board_row_gather"],
                                        max_abs_diff(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            failures.append(f"board_row_gather {label}")

    for label, bval, bslot, src_c, base in row_gather_cases():
        check_row_gather(label, *to_cuda((bval, bslot, src_c)), base)
    # A board one int32 past a 16-byte boundary: the scalar path at K=256.
    rng = np.random.default_rng(203)
    bv, bs = (torch.as_tensor(rng.integers(-1, 1 << 20, 150 * 256 + 1)
                              .astype(np.int32)).to(DEVICE)[1:].view(150, 256)
              for _ in range(2))
    (sr,) = to_cuda((rng.integers(0, 190, (203, 3)).astype(np.int32),))
    check_row_gather("misaligned board k=256", bv, bs, sr, 20)

    board_bytes = ns_n * ns_k * (4 + 4 + 1) * 2
    fused = fused_points["uniform"]
    records = {
        "publish_board": dict(
            ms=cuda_time_ms(lambda: pg.publish_board_cuda(cv, cs, se,
                                                          **bkw)),
            plain_ms=cuda_time_ms(lambda: pg.publish_board_torch(cv, cs, se,
                                                                 **bkw)),
            bytes=board_bytes,
            bound_ms=board_bytes / PEAK_BYTES_PER_S * 1e3,
            **board_search_stats(cv, cs, se, bkw["budget"], bkw["limit"])),
        # The unfused pair is not one call: no library call computes
        # the rotated-tie selection.
        "fused_publish_gather": dict(fused, plain_ms=cuda_time_ms(
            lambda: pg.fused_publish_gather_torch(cv, cs, se, src, now,
                                                  **gkw))),
    }
    for name, rec in records.items():
        rec.update(max_abs_err=worst[name], library_ms=None)
    # The publish kernel at the d=4 shard's shape: shard 2's rows, at
    # row_offset 2·nl.
    nl = ns_n // 4
    blk = slice(2 * nl, 3 * nl)
    board_points["d=4 shard"] = board_point(
        "d=4 shard", (cv[blk], cs[blk], se[blk]),
        dict(bkw, row_offset=2 * nl), failures)
    worst["publish_board"] = max(
        worst["publish_board"],
        *(b["max_abs_err"] for b in board_points.values()))
    records["publish_board"]["max_abs_err"] = worst["publish_board"]

    # The board row gather at the sharded north star's two shapes, on a
    # published board: d=1 (all_gather: the whole board at base 0) and
    # d=4 (shard 2's own block at base 2·nl, its rows' sampled peers).
    bval, bslot, _ = pg.publish_board_cuda(cv, cs, se, **bkw)
    del cv, cs, se
    shapes = {"d=1": (bval, bslot, src, 0),
              "d=4": (bval[blk], bslot[blk], src[blk], 2 * nl)}
    rg = {}
    for label, (bv, bs, sr, base) in shapes.items():
        got = pg.board_row_gather_cuda(bv, bs, sr, base)
        want = pg.board_row_gather_torch(bv, bs, sr, base)
        worst["board_row_gather"] = max(worst["board_row_gather"],
                                        max_abs_diff(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            failures.append(f"board_row_gather north-star {label}")
        del got, want
        rel = sr.to(torch.int64) - base
        inb = (rel >= 0) & (rel < bv.shape[0])
        # Each input read once: src, and every in-block row some request
        # names; each output written once.
        rows_named = int(torch.unique(rel[inb]).numel())
        out_bytes = 2 * sr.numel() * ns_k * 4
        nbytes = sr.numel() * 4 + out_bytes + 2 * rows_named * ns_k * 4
        per_request = sr.numel() * 4 + out_bytes + \
            2 * int(inb.sum()) * ns_k * 4
        # The gather without the mask: no single call computes the
        # masked one.
        flat = torch.clamp(rel, 0, bv.shape[0] - 1).reshape(-1)
        rg[label] = dict(
            rows=bv.shape[0], base=base, requests=sr.numel(),
            in_block=int(inb.sum()), rows_named=rows_named,
            ms=cuda_time_ms(lambda: pg.board_row_gather_cuda(bv, bs, sr,
                                                             base)),
            plain_ms=cuda_time_ms(lambda: pg.board_row_gather_torch(
                bv, bs, sr, base)),
            library_ms=cuda_time_ms(lambda: (
                torch.index_select(bv, 0, flat),
                torch.index_select(bs, 0, flat))),
            bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
            per_request_bytes=per_request,
            per_request_bound_ms=per_request / PEAK_BYTES_PER_S * 1e3)
        # Faster than a copy per request could be: rows named again did
        # not all come from device memory again.
        rg[label]["under_per_request_bound"] = \
            rg[label]["ms"] < rg[label]["per_request_bound_ms"]
    records["board_row_gather"] = dict(rg["d=1"],
                                       max_abs_err=worst["board_row_gather"])
    del bval, bslot, src
    scatter_records, scatter_failures, scatter_cases = \
        check_scatter_kernels(ex_n, ex_m)
    host = host_times()
    records.update(scatter_records)
    failures += scatter_failures
    emit({"phase": "kernels", "cases": len(board_cases())
          + len(row_ids_cases()) + len(gather_cases())
          + len(row_gather_cases()) + 9 + len(fused_points)
          + scatter_cases,
          "failures": failures,
          "shape": {"n": ns_n, "k": ns_k, "f": ns_f},
          "scatter_shape": {"n": ex_n, "m": ex_m},
          "kernels": records, "publish_board_points": board_points,
          "fused_publish_gather_points": fused_points,
          "board_row_gather_shapes": rg, "host_us_per_call": host})
    if failures:
        raise SystemExit(f"kernel parity failed: {failures}")
    return records


# -- the scatter kernels (K4a, K4b) against their plain versions -------------

def scatter_cases():
    """(label, known, sent, rows, cols, vals, advanced) numpy cases for
    the scatter-max apply: rows up to N and columns up to M (padding,
    with an (r, M) entry that a flat index would alias to (r+1, 0)),
    one cell hit four times with different values, U = 0 and U = 1, a
    U that leaves a scalar tail after the int4 vectors, and values that
    advance no cell or every cell they reach."""
    import numpy as np

    cases = []
    for n, m, u, regime in ((16, 24, 300, "mixed"), (33, 130, 5000, "mixed"),
                            (7, 13, 1, "mixed"), (7, 13, 0, "mixed"),
                            (256, 2560, 40_000, "mixed"),
                            (45, 77, 4099, "mixed"), (64, 640, 8000, "none"),
                            (64, 640, 8003, "all")):
        rng = np.random.default_rng(n * m + u)
        rows = rng.integers(0, n + 1, u).astype(np.int32)
        cols = rng.integers(0, m + 1, u).astype(np.int32)
        if u >= 16:
            rows[:4], cols[:4] = 2, m        # (2, M) aliases (3, 0) flat
            rows[4:8], cols[4:8] = 1, 5      # one cell, four values
            rows[8:12], cols[8:12] = n, 3    # the padding row N
        known_lo, vals_lo, vals_hi = {"mixed": (1, 1, 1 << 22),
                                      "none": (1 << 21, 1, 1 << 21),
                                      "all": (1, 1 << 21, 1 << 22)}[regime]
        cases.append((f"n={n} m={m} u={u} {regime} advance",
                      rng.integers(known_lo, known_lo + (1 << 20),
                                   (n, m)).astype(np.int32),
                      rng.integers(0, 10, (n, m)).astype(np.int8), rows,
                      cols, rng.integers(vals_lo, vals_hi, u).astype(np.int32),
                      rng.random(u) < 0.5))
    return cases


RMW_CASES = (((8, 40), 0), ((7, 13), 0), ((1, 3), 0), ((33, 100), 1),
             ((1000, 4099), 0))


def check_scatter_kernels(ex_n: int, ex_m: int):
    """K4a and K4b against their plain versions (``torch.equal``) on
    the cases above, the in-place max on whole vectors, a 1–3 element
    tail and a misaligned buffer, and both at the exact model's shape
    (``ex_n`` × ``ex_m``, U = n·45 + m); then each timed there beside its
    bound, its plain version and the library call.  Returns ``(records,
    failures, cases)``."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.ops.kernels import scatter_max as sm

    worst = {"scatter_max_apply": 0, "rmw_max": 0}
    failures = []

    def check_apply(label, known, sent, rows, cols, vals, adv):
        for with_reset in (True, False):
            s = sent if with_reset else None
            want = sm.scatter_max_apply_torch(
                known.clone(), rows, cols, vals,
                None if s is None else s.clone(), adv)
            got = sm.scatter_max_apply_cuda(
                known.clone(), rows, cols, vals,
                None if s is None else s.clone(), adv)
            torch.cuda.synchronize()
            pairs = [(g, w) for g, w in zip(got, want) if g is not None]
            worst["scatter_max_apply"] = max(
                worst["scatter_max_apply"],
                max_abs_diff(*zip(*pairs)))
            if not all(torch.equal(g, w) for g, w in pairs):
                failures.append(f"scatter_max_apply {label} "
                                f"reset={with_reset}")

    def check_rmw(label, known, other):
        want = torch.maximum(known, other)
        got = sm.rmw_max_cuda(known.clone(), other)
        torch.cuda.synchronize()
        worst["rmw_max"] = max(worst["rmw_max"],
                               max_abs_diff([got], [want]))
        if not torch.equal(got, want):
            failures.append(f"rmw_max {label}")

    for label, *arrays in scatter_cases():
        check_apply(label, *to_cuda(arrays))
    # Triples one element past a 16-byte boundary: the scalar path.
    label, known, sent, rows, cols, vals, adv = scatter_cases()[4]
    rows, cols, vals = (torch.as_tensor(np.concatenate(
        [np.zeros(1, np.int32), a])).to(DEVICE)[1:] for a in (rows, cols, vals))
    check_apply(f"{label} misaligned", *to_cuda((known, sent)), rows, cols,
                vals, *to_cuda((adv,)))
    for shape, offset in RMW_CASES:
        rng = np.random.default_rng(shape[1])
        size = shape[0] * shape[1] + offset
        known, other = (torch.as_tensor(
            rng.integers(1, 1 << 20, size).astype(np.int32)).to(DEVICE)
            [offset:].view(shape) for _ in range(2))
        check_rmw(f"{shape} offset={offset}", known, other)

    # The exact model's shape, made on the card.
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    u = ex_n * 45 + ex_m

    def draw(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=DEVICE,
                             dtype=dtype)

    known = draw(1, 1 << 20, (ex_n, ex_m))
    sent = draw(0, 10, (ex_n, ex_m), torch.int8)
    rows, cols = draw(0, ex_n + 1, (u,)), draw(0, ex_m + 1, (u,))
    vals = draw(1, 1 << 22, (u,))
    adv = torch.rand(u, generator=gen, device=DEVICE) < 0.5
    other = draw(1, 1 << 20, (ex_n, ex_m))
    check_apply("exact-model shape", known, sent, rows, cols, vals, adv)
    check_rmw("exact-model shape", known, other)
    # The d = 4 exact twin's shard: the kernel on the row slice
    # known[r0:r0 + nl] of the whole buffer, local row nl the dropped
    # pad, as many triples as a shard's all_gather round; the rows
    # outside the slice must stay as they were.
    nl = ex_n // 4
    r0 = nl
    u_s = ex_n * 45 + nl * (ex_m // ex_n)
    shard_in = (draw(0, nl + 1, (u_s,)), draw(0, ex_m + 1, (u_s,)),
                draw(1, 1 << 22, (u_s,)),
                torch.rand(u_s, generator=gen, device=DEVICE) < 0.5)
    want_k, want_s = known.clone(), sent.clone()
    sm.scatter_max_apply_torch(want_k[r0:r0 + nl], *shard_in[:3],
                               want_s[r0:r0 + nl], shard_in[3])
    got_k, got_s = known.clone(), sent.clone()
    sm.scatter_max_apply_cuda(got_k[r0:r0 + nl], *shard_in[:3],
                              got_s[r0:r0 + nl], shard_in[3])
    torch.cuda.synchronize()
    worst["scatter_max_apply"] = max(
        worst["scatter_max_apply"],
        max_abs_diff([got_k, got_s], [want_k, want_s]))
    if not (torch.equal(got_k, want_k) and torch.equal(got_s, want_s)):
        failures.append("scatter_max_apply d=4 shard row slice")
    shard_ms = cuda_time_ms(lambda: sm.scatter_max_apply_cuda(
        got_k[r0:r0 + nl], *shard_in[:3], got_s[r0:r0 + nl], shard_in[3]))
    del want_k, want_s, got_k, got_s

    # Times, at the exact model's shape.  Bounds from these inputs: the
    # scatter reads each triple once and each 32-byte sector of known it
    # touches (and of sent, where it resets) once, and writes it once;
    # the in-place max reads both buffers and writes one.
    ok = (rows < ex_n) & (cols < ex_m)
    flat = rows.to(torch.int64) * ex_m + cols.to(torch.int64)
    sectors = int(torch.unique(flat[ok] // 8).numel()) + \
        int(torch.unique(flat[ok & adv] // 32).numel())
    apply_bytes = u * (4 + 4 + 4 + 1) + 2 * 32 * sectors
    flat_in, vals_in = flat[ok], vals[ok]
    k_a, s_a = known.clone(), sent.clone()
    # The kernel with and without the reset and the library scatter (no
    # reset: no single call does both) in turns, medians.
    event = paired_ms({
        "ms": lambda: sm.scatter_max_apply_cuda(k_a, rows, cols, vals, s_a,
                                                adv),
        "ms_without_reset": lambda: sm.scatter_max_apply_cuda(
            k_a, rows, cols, vals),
        "library_ms": lambda: k_a.view(-1).scatter_reduce_(
            0, flat_in, vals_in, "amax")})
    rec_apply = dict(
        max_abs_err=worst["scatter_max_apply"], updates=u,
        in_range=int(ok.sum()), sectors=sectors, **event,
        plain_ms=cuda_time_ms(lambda: sm.scatter_max_apply_torch(
            k_a, rows, cols, vals, s_a, adv)),
        device_ms=device_time_ms(lambda: sm.scatter_max_apply_cuda(
            k_a, rows, cols, vals, s_a, adv)),
        device_ms_without_reset=device_time_ms(
            lambda: sm.scatter_max_apply_cuda(k_a, rows, cols, vals)),
        library_device_ms=device_time_ms(
            lambda: k_a.view(-1).scatter_reduce_(0, flat_in, vals_in,
                                                 "amax")),
        bytes=apply_bytes, bound_ms=apply_bytes / PEAK_BYTES_PER_S * 1e3,
        d4_shard_row_slice={"rows": nl, "row_offset": r0, "updates": u_s,
                            "ms": shard_ms})
    # Device-only times, warm and after an L2 flush, in both orders; and
    # after a restore of known (also a 671 MB pass that evicts the L2),
    # where every triple that reaches a cell advances it again.
    flush = l2_flush()
    kernel = lambda: sm.scatter_max_apply_cuda(k_a, rows, cols, vals)
    library = lambda: k_a.view(-1).scatter_reduce_(0, flat_in, vals_in,
                                                   "amax")
    restore = lambda: k_a.copy_(known)
    rec_apply.update(
        device_only=device_times_both_orders(kernel, library, flush),
        device_only_with_reset={
            "warm_ms": device_event_ms(lambda: sm.scatter_max_apply_cuda(
                k_a, rows, cols, vals, s_a, adv)),
            "l2_cold_ms": device_event_ms(lambda: sm.scatter_max_apply_cuda(
                k_a, rows, cols, vals, s_a, adv), flush)},
        device_only_after_restore={"kernel_ms": device_event_ms(
            kernel, restore), "library_ms": device_event_ms(library, restore)},
        # As a caller waits, one call at a time on the restored input.
        waited_after_restore={
            "kernel_ms": waited_ms(kernel, restore),
            "kernel_with_reset_ms": waited_ms(
                lambda: sm.scatter_max_apply_cuda(k_a, rows, cols, vals, s_a,
                                                  adv),
                lambda: (k_a.copy_(known), s_a.copy_(sent))),
            "library_ms": waited_ms(library, restore)},
        advancing_after_restore=int((vals[ok] > known.view(-1)[flat_in])
                                    .sum()))
    del k_a, s_a, flush
    rmw_bytes = 3 * known.numel() * 4
    rec_rmw = dict(
        max_abs_err=worst["rmw_max"], elements=known.numel(),
        # The kernel and the library call in turns, medians.
        **paired_ms({"ms": lambda: sm.rmw_max_cuda(known, other),
                     "library_ms": lambda: torch.maximum(known, other,
                                                         out=known)}),
        plain_ms=cuda_time_ms(lambda: sm.rmw_max_torch(known, other)),
        device_ms=device_time_ms(lambda: sm.rmw_max_cuda(known, other)),
        library_device_ms=device_time_ms(
            lambda: torch.maximum(known, other, out=known)),
        bytes=rmw_bytes, bound_ms=rmw_bytes / PEAK_BYTES_PER_S * 1e3)
    n_cases = 2 * (len(scatter_cases()) + 2) + len(RMW_CASES) + 2
    return ({"scatter_max_apply": rec_apply, "rmw_max": rec_rmw},
            failures, n_cases)


# -- phase 4: three-way lockstep -----------------------------------------------

def bench_params(n, **kw):
    from sidecar_tpu_torch.models.compressed import CompressedParams

    return CompressedParams(n=n, services_per_node=10, fanout=3, budget=15,
                            cache_lines=256, fold_quorum=0.995,
                            deep_sweep_every=0, **kw)


def bench_time():
    from sidecar_tpu_torch.models.timecfg import TimeConfig

    return TimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=4.0)


def burst(m: int, frac: float):
    import numpy as np

    rng = np.random.default_rng(7)
    return np.sort(rng.choice(m, size=max(1, int(m * frac)),
                              replace=False)).astype(np.int32)


def _wrappers():
    from sidecar_tpu_torch.ops import kernels as k

    return {"publish_board": k.publish_board_cuda,
            "fused_publish_gather": k.fused_publish_gather_cuda,
            "board_row_gather": k.board_row_gather_cuda,
            "scatter_max_apply": k.scatter_max_apply_cuda,
            "rmw_max": k.rmw_max_cuda}


def reset_launches():
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def launches():
    return {name: w.launches for name, w in _wrappers().items()}


def expected(**counts):
    """Every kernel's launch count: the given ones, 0 for the rest."""
    return {name: counts.get(name, 0) for name in KERNELS}


def states_equal(a, b) -> list:
    """Names of the fields where two port states differ."""
    import torch

    from sidecar_tpu_torch import convert

    x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
    return [f for f in x if not torch.equal(torch.as_tensor(x[f]),
                                            torch.as_tensor(y[f]))]


def phase_lockstep(n=4096, rounds=50, every=5):
    import torch

    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    p = bench_params(n)
    topo = erdos_renyi(n, avg_degree=8.0, seed=3)
    slots = burst(p.m, 0.01)
    cpu = CompressedSim(p, topo, bench_time(), device="cpu")
    gen = torch.Generator().manual_seed(1)
    draws = [cpu.draw(gen, r) for r in range(1, rounds + 1)]
    runs, counts = {}, {}
    for label, device, fused in (("cuda_fused", "cuda", True),
                                 ("cuda_unfused", "cuda", False),
                                 ("cpu", "cpu", True)):
        sim = CompressedSim(p, topo, bench_time(), device=device,
                            fused_gather=fused)
        state = sim.mint(sim.init_state(), slots, 10)
        reset_launches()
        final, curve = sim.run_behind(state, rounds, every, draws=draws)
        if device == "cuda":
            torch.cuda.synchronize()
        counts[label] = launches()
        runs[label] = (final, curve.cpu())
    diffs = {label: states_equal(runs["cpu"][0], runs[label][0])
             for label in ("cuda_fused", "cuda_unfused")}
    curves_equal = all(torch.equal(runs["cpu"][1], runs[l][1])
                       for l in ("cuda_fused", "cuda_unfused"))
    ok = (not any(diffs.values()) and curves_equal
          and counts["cuda_fused"] == expected(fused_publish_gather=rounds)
          and counts["cuda_unfused"] == expected(publish_board=rounds)
          and bool(torch.isfinite(runs["cpu"][1]).all()))
    emit({"phase": "lockstep", "n": n, "rounds": rounds, "every": every,
          "behind": runs["cpu"][1].tolist(), "field_diffs": diffs,
          "curves_equal": curves_equal, "launches": counts, "ok": ok})
    if not ok:
        raise SystemExit("lockstep phase failed")
    lockstep_modes(p, topo, slots, every=every)


def lockstep_modes(p, topo, slots, every=5, sparse_rounds=150, rounds=50):
    """The execution modes on the card and on the CPU from one set of
    injected draws: the forced-sparse round (``sparse="1"``, the
    default cap of 256 rows, which the first ~125 rounds overflow) for
    ``sparse_rounds``; the pipelined round; per-node tick periods in {1,
    2, 4} on a graph staggered with period 3.  Every state field, the
    behind curve and the sparse stats must be equal, and each mode's
    kernel must launch as its rounds say: the publish kernel once a
    sparse round (the fused one once an overflow round), once a
    pipelined tick plus the prime; the fused one once a gated round."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.ops.topology import with_stagger

    t = bench_time()
    base = CompressedSim(p, topo, t, device="cpu")
    gen = torch.Generator().manual_seed(2)
    draws = [base.draw(gen, r) for r in range(1, sparse_rounds + 2)]
    rng = np.random.default_rng(3)
    cadence = dict(tick_period=rng.choice([1, 2, 4], p.n),
                   tick_phase=rng.integers(0, 4, p.n))
    staggered = with_stagger(topo, 3, seed=4)
    modes = {"sparse": (topo, dict(sparse="1")),
             "pipelined": (topo, dict(pipeline="1")),
             "cadence_stagger": (staggered, cadence)}
    out, ok = {}, True
    for label, (graph, kw) in modes.items():
        res = {}
        for device in ("cuda", "cpu"):
            sim = CompressedSim(p, graph, t, device=device, **kw)
            state = sim.mint(sim.init_state(), slots, 10)
            reset_launches()
            if label == "sparse":
                final, curve = sim.run_behind(state, sparse_rounds, every,
                                              draws=draws)
                extra = sim.last_sparse_stats.tolist()
            elif label == "pipelined":
                final, curve, inflight = sim.run_pipelined(
                    state, rounds, every, draws=draws[:rounds + 1])
                extra = [x.cpu() for x in inflight.publish]
            else:
                final, curve = sim.run_behind(state, rounds, every,
                                              draws=draws)
                extra = None
            if device == "cuda":
                torch.cuda.synchronize()
            res[device] = (final, curve.cpu(), extra, launches())
        (gf, gc, gx, counts), (cf, cc, cx, _) = res["cuda"], res["cpu"]
        diffs = states_equal(cf, gf)
        if label == "sparse":
            extras_equal = gx == cx
            want = expected(publish_board=cx[0],
                            fused_publish_gather=cx[1])
            premise = cx[0] > 0 and cx[1] > 0
        elif label == "pipelined":
            extras_equal = all(torch.equal(a, b) for a, b in zip(gx, cx))
            want, premise = expected(publish_board=rounds + 1), True
        else:
            extras_equal = True
            want, premise = expected(fused_publish_gather=rounds), True
        mode_ok = (not diffs and torch.equal(gc, cc) and extras_equal
                   and counts == want and premise)
        ok = ok and mode_ok
        out[label] = {"curve": cc.tolist(), "field_diffs": diffs,
                      "extras_equal": extras_equal, "launches": counts,
                      "stats": cx if label == "sparse" else None,
                      "ok": mode_ok}
        del res
    emit({"phase": "lockstep_modes", "n": p.n, "every": every,
          "sparse_rounds": sparse_rounds, "rounds": rounds, **out,
          "ok": ok})
    if not ok:
        raise SystemExit("lockstep modes failed")


# -- phase 5: the north star -----------------------------------------------------

def run_to_eps(sim, state, generator, *, eps, max_rounds, every, thr_total,
               thr_unsettled, keep=(), advance=None):
    """``run_behind`` in chunks of ``every`` rounds until the behind
    count crosses the unsettled-set threshold (or ``max_rounds``).  The
    states after the rounds in ``keep`` (multiples of ``every``) are
    returned too, in ``kept``.  ``advance(state, rounds)``, where given,
    runs a chunk instead and returns ``(state, behind count)``."""
    import torch

    if advance is None:
        def advance(st, k):
            st, behind = sim.run_behind(st, k, k, generator=generator)
            return st, float(behind[-1])
    curve, hit_total, hit_unsettled, rounds = [], None, None, 0
    first, kept = None, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while rounds < max_rounds:
        state, b = advance(state, every)
        rounds += every
        first = state if first is None else first
        if rounds in keep:
            kept[rounds] = state
        curve.append(b)
        if hit_total is None and b <= thr_total:
            hit_total = rounds
        if b <= thr_unsettled:
            hit_unsettled = rounds
            break
    torch.cuda.synchronize()
    return state, first, curve, hit_total, hit_unsettled, rounds, \
        time.perf_counter() - t0, kept


# Coarse kernel families of a profiled round: the first key found in
# the kernel's lower-cased name (PyTorch's kernels carry their
# operation's name).
KERNEL_FAMILIES = (("board_row_gather_kernel", "K3 board_row_gather"),
                   ("publish_board_kernel", "K2 publish_board"),
                   ("fused_publish_select_kernel", "K1 fused_publish_gather"),
                   ("fused_publish_gather_kernel", "K1 fused_publish_gather"),
                   ("scatter_max_apply_kernel", "K4a scatter_max_apply"),
                   ("rmw_max_kernel", "K4b rmw_max"),
                   ("topk", "top-k"), ("radix", "top-k"),
                   ("index", "indexing (gathers, scatters)"),
                   ("gather", "indexing (gathers, scatters)"),
                   ("scatter", "indexing (gathers, scatters)"),
                   ("catarray", "cat"), ("sort", "sort"),
                   ("reduce", "reductions"), ("scan", "scans"),
                   ("elementwise", "elementwise"), ("memcpy", "copies"),
                   ("memset", "copies"), ("copy", "copies"))


def profile_rounds(sim, state, rounds=5, drive=None):
    """Device activity of ``rounds`` rounds from ``state`` under
    ``torch.profiler`` (after one unprofiled pass over the same draws):
    device-busy time a round (the union of the kernels' intervals), the
    host wall of the profiled window, and device time by kernel
    family.  The profiler slows the host side, so the idle share it
    gives is an upper bound.  ``drive(state, draws)`` runs the rounds
    (default ``run_fast``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if drive is None:
        def drive(st, draws):
            return sim.run_fast(st, len(draws), draws=draws)
    gen = sim.default_generator(7)
    draws = [sim.draw(gen, state.round_idx + 1 + i) for i in range(rounds)]
    drive(state, draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive(state, draws)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, families = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        name = e.name.lower()
        family = next((label for key, label in KERNEL_FAMILIES
                       if key in name), "other")
        families[family] = families.get(family, 0.0) + (end - start)
    if not spans:
        return {"device_time": "not measured: the profiler recorded no "
                               "device activity"}
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    per_round = 1e3 * rounds
    return {"rounds": rounds, "kernels": len(spans),
            "wall_ms_per_round": wall_us / per_round,
            "device_busy_ms_per_round": busy / per_round,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_per_round_by_family": {
                k: v / per_round for k, v in sorted(
                    families.items(), key=lambda kv: -kv[1])}}


def phase_breakdown(sim, state, generator, iters=5):
    """Device time of each phase of one round on a mid-flight state
    (CUDA events around each phase alone), and the per-round share at
    the configured cadences."""
    import torch

    from sidecar_tpu_torch.ops import gossip as gossip_ops
    from sidecar_tpu_torch.ops import kernels as kernel_ops

    p, kn = sim.p, sim._knobs
    r = state.round_idx + 1
    now = r * sim.t.round_ticks
    draws = sim.draw(generator, sim._knobs.push_pull_rounds)
    src = gossip_ops.sample_peers(draws.peer_slot, p.n, nbrs=sim._nbrs,
                                  node_alive=state.node_alive)
    kw = dict(stale_ticks=kn.stale_ticks, budget=p.budget, limit=kn.limit,
              fanout=p.fanout, cache_lines=p.cache_lines)
    sent, pv, ps = kernel_ops.fused_publish_gather(
        state.cache_val, state.cache_slot, state.cache_sent, src, now, **kw)
    ok = state.node_alive[src.long()] & state.node_alive[:, None]
    phases = {
        "sample_peers": lambda: gossip_ops.sample_peers(
            draws.peer_slot, p.n, nbrs=sim._nbrs,
            node_alive=state.node_alive),
        "publish_gather_kernel": lambda: kernel_ops.fused_publish_gather(
            state.cache_val, state.cache_slot, state.cache_sent, src, now,
            **kw),
        "merge": lambda: sim._merge_pulled(state, sent, pv, ps, ok, now,
                                           stale_filtered=True),
        "announce": lambda: sim._announce(state, r, now),
        "push_pull": lambda: sim._push_pull_stride(state, draws.stride,
                                                   now),
        "sweep": lambda: sim._floor_advance_and_sweep(state, now),
        "behind_census": lambda: sim.behind(state),
    }
    every = {"push_pull": kn.push_pull_rounds, "sweep": kn.sweep_rounds,
             "behind_census": 25}
    ms = {name: cuda_time_ms(fn, iters) for name, fn in phases.items()}
    per_round = {name: t / every.get(name, 1) for name, t in ms.items()}
    return {"ms_per_call": ms, "ms_per_round": per_round,
            "sum_ms_per_round": sum(per_round.values()),
            "census_path": sim.census_path(state)}


NORTH_STAR_RUN = dict(max_rounds=600, every=25, eps=1e-4)
# Rounds of each north-star run whose cache the path's publish kernel is
# timed on, besides the run's end.
REAL_CACHE_ROUNDS = (100,)


def north_star_thresholds(p, slots, eps):
    """The ε crossings on both denominators: the total belief space and
    the burst's own unsettled set."""
    return dict(thr_total=eps * float(p.n) * float(p.m),
                thr_unsettled=eps * float(len(slots)) * (p.n - 1))


def phase_north_star(topo, graph_s, max_rounds, every, eps):
    """Both single-device paths; returns the launch counts of each and
    the unfused run ``(final, curve, rounds to ε, rounds run)`` that
    the sharded phase is held against."""
    import math

    import torch

    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.ops import gossip as gossip_ops

    n = topo.n
    p = bench_params(n)
    slots = burst(p.m, 0.001)
    thr = north_star_thresholds(p, slots, eps)
    results = {}
    for fused in (True, False):
        sim = CompressedSim(p, topo, bench_time(), fused_gather=fused)
        state = sim.mint(sim.init_state(), slots, 10)
        # Warm-up on a throw-away generator (the port never updates a
        # state in place, so ``state`` is untouched).
        reset_launches()
        sim.run_fast(state, 2, generator=sim.default_generator(99))
        torch.cuda.synchronize()
        warm = launches()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        final, first, curve, hit_total, hit_unsettled, rounds, wall, kept = \
            run_to_eps(sim, state, sim.default_generator(0), eps=eps,
                       max_rounds=max_rounds, every=every,
                       keep=REAL_CACHE_ROUNDS, **thr)
        counts = launches()
        breakdown, failures = None, []
        # The path's kernel on the run's own caches, as the round calls
        # it (the fused one with the next round's ER(8) peers and now);
        # uncounted (the counts are read).
        bkw = dict(budget=min(p.budget, p.cache_lines),
                   limit=sim._knobs.limit, fanout=p.fanout,
                   cache_lines=p.cache_lines)
        caches = {f"round {r}": kept[r] for r in sorted(kept)}
        caches[f"end (round {rounds})"] = final
        real_caches = {}
        for cache_label, st in caches.items():
            cache = (st.cache_val, st.cache_slot, st.cache_sent)
            if fused:
                r = int(st.round_idx) + 1
                src = gossip_ops.sample_peers(
                    sim.draw(sim.default_generator(6), r).peer_slot, p.n,
                    nbrs=sim._nbrs, node_alive=st.node_alive)
                real_caches[cache_label] = fused_gather_point(
                    f"{cache_label} cache", cache, src,
                    r * sim.t.round_ticks,
                    dict(bkw, stale_ticks=sim._knobs.stale_ticks), failures)
            else:
                real_caches[cache_label] = board_point(
                    f"{cache_label} cache", cache, bkw, failures)
        del caches, cache
        if fused:
            breakdown = phase_breakdown(sim, first,
                                        sim.default_generator(5))
        kept.clear()
        profile = profile_rounds(sim, first)
        label = "fused" if fused else "unfused"
        results[label] = (final, curve, counts, (hit_total, hit_unsettled),
                          rounds, rounds / wall)
        kernel = "fused_publish_gather" if fused else "publish_board"
        ok = (counts == expected(**{kernel: rounds})
              and all(math.isfinite(b) for b in curve)
              and hit_unsettled is not None and not failures)
        emit({"phase": "north_star", "path": label, "n": p.n, "m": p.m,
              "cache_lines": p.cache_lines, "burst": len(slots),
              "graph_build_s": graph_s, "rounds_run": rounds,
              "rounds_to_eps": hit_total,
              "rounds_to_eps_unsettled": hit_unsettled,
              "eps": eps, "wall_s": wall, "rounds_per_s": rounds / wall,
              "behind_curve": curve, "evictions": int(final.evictions),
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "warmup_launches": warm, "launches": counts,
              "breakdown_after_first_sample": breakdown,
              "profile_after_first_sample": profile,
              ("fused_publish_gather_on_run_caches" if fused else
               "publish_board_on_run_caches"): real_caches,
              "failures": failures, "ok": ok})
        if not ok:
            raise SystemExit(f"north-star phase failed ({label})")
    diffs = states_equal(results["fused"][0], results["unfused"][0])
    same = not diffs and results["fused"][1] == results["unfused"][1]
    emit({"phase": "north_star_paths_agree", "field_diffs": diffs,
          "ok": same})
    if not same:
        raise SystemExit("fused and unfused north-star runs differ")
    final, curve, _counts, hits, rounds, _ = results["unfused"]
    fused = results["fused"]
    return [results["fused"][2], results["unfused"][2]], \
        (final, curve, hits, rounds), \
        (fused[0], fused[1], fused[3], fused[4], fused[5])


def ms_per_round(fn, rounds: int) -> float:
    """Host wall of ``fn()`` (``rounds`` rounds), synchronised on both
    sides, per round."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / rounds


def sparse_round_costs(sim, early, late, rounds: int = 25) -> dict:
    """What the sparse round costs and saves, each form in turns (a, b,
    b, a) over the same ``rounds`` draws: on ``early`` (a state whose
    frontiers overflow) the dense round against the sparse path with
    its caps at -1 — every round overflows, so it adds the frontier
    masks and the one host read of their sizes to the dense round —
    and the masks' device time alone (the difference is the host
    read's); on ``late`` (the run's
    tail) the dense round against the compacted one."""
    import torch

    from sidecar_tpu_torch.ops import gossip as gossip_ops
    from sidecar_tpu_torch.ops.kernels import eligible_lines

    out = {}
    for label, st in (("overflowing", early), ("tail", late)):
        gen = sim.default_generator(5)
        draws = [sim.draw(gen, st.round_idx + 1 + i) for i in range(rounds)]
        caps = sim._sparse_caps

        def dense():
            sim.run_fast(st, rounds, draws=draws, sparse=False)

        def sparse():
            if label == "overflowing":
                sim._sparse_caps = (-1, -1, -1)
            try:
                sim.run_fast(st, rounds, draws=draws, sparse=True)
            finally:
                sim._sparse_caps = caps
            return sim.last_sparse_stats.tolist()

        times = {"dense": [], "sparse": []}
        for name in ("dense", "sparse", "sparse", "dense"):
            times[name].append(ms_per_round(
                dense if name == "dense" else sparse, rounds))
        out[label] = {"round": st.round_idx,
                      "dense_ms_per_round": times["dense"],
                      "sparse_path_ms_per_round": times["sparse"],
                      "sparse_path_stats": sparse()}
    # The masks' device time beyond what the dense round computes too
    # (the announce's offers): senders, receivers, announcers and their
    # sizes, without the host read.
    r = early.round_idx + 1
    src = gossip_ops.sample_peers(
        sim.draw(sim.default_generator(6), r).peer_slot, sim.p.n,
        nbrs=sim._nbrs, node_alive=early.node_alive).to(torch.int64)
    offers = sim._announce_offers(early.own, early.floor, early.node_alive,
                                  r, r * sim.t.round_ticks)[2]

    def masks():
        sender = eligible_lines(early.cache_slot, early.cache_sent,
                                sim._knobs.limit).any(dim=1)
        recv = early.node_alive & sender[src].any(dim=1)
        return torch.stack([sender.sum(), recv.sum(),
                            (offers > 0).any(dim=1).sum()])

    out["overflowing"]["frontier_masks_ms"] = cuda_time_ms(masks)
    return out


NORTH_STAR_MODES = ("sparse_forced", "sparse_auto", "pipelined")


def north_star_modes(topo, reference, max_rounds, every, eps):
    """The north star's execution modes, each from the same generator
    seed as the dense runs: ``sparse_forced`` (``sparse="1"``: every
    round takes the sparse path, the overflow fallback where a frontier
    exceeds its cap), ``sparse_auto`` (``SparseArbiter.for_census("auto",
    n)`` decides each chunk from the behind count) and ``pipelined``
    (chunks chained by the ``inflight`` carry).  Both sparse runs must
    equal the dense fused run ``reference`` (curve, crossings, every
    final field) and launch the publish kernel once a compacted round
    and the fused kernel once any other; the pipelined run launches the
    publish kernel once a tick plus the prime.  Returns each run's
    launch counts."""
    import math

    import torch

    from sidecar_tpu_torch import metrics
    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.ops.kernels import eligible_lines
    from sidecar_tpu_torch.ops.sparse import SparseArbiter

    ref_final, ref_curve, ref_hits, ref_rounds, ref_rps = reference
    p = bench_params(topo.n)
    slots = burst(p.m, 0.001)
    thr = north_star_thresholds(p, slots, eps)
    all_counts = []
    for label in NORTH_STAR_MODES:
        kw = {"sparse_forced": dict(sparse="1"), "sparse_auto": {},
              "pipelined": dict(pipeline="1")}[label]
        sim = CompressedSim(p, topo, bench_time(), **kw)
        state = sim.mint(sim.init_state(), slots, 10)
        sim.run_fast(state, 2, generator=sim.default_generator(99))
        torch.cuda.synchronize()
        gen = sim.default_generator(0)
        arbiter = None if label == "pipelined" else SparseArbiter.for_census(
            "1" if label == "sparse_forced" else "auto", p.n)
        carry = {"inflight": None}
        sizes = []

        def advance(st, k):
            if label == "sparse_forced":
                # Which frontier keeps the round dense: the senders and
                # the announcers of the chunk's first round (the
                # receivers depend on its peers).
                r = st.round_idx + 1
                offers = sim._announce_offers(st.own, st.floor,
                                              st.node_alive, r,
                                              r * sim.t.round_ticks)[2]
                sizes.append([r, int(eligible_lines(
                    st.cache_slot, st.cache_sent,
                    sim._knobs.limit).any(dim=1).sum()),
                    int((offers > 0).any(dim=1).sum())])
            if arbiter is None:
                st, carry["inflight"] = sim.run_fast_pipelined(
                    st, k, inflight=carry["inflight"], generator=gen)
                return st, float(sim.behind(st))
            dispatch = arbiter.dispatch_kwargs()
            st, behind = sim.run_behind(st, k, k, generator=gen, **dispatch)
            arbiter.record_chunk(k, sim.last_sparse_stats
                                 if dispatch["sparse"] else None)
            b = float(behind[-1])
            arbiter.update_census(b)
            return st, b

        torch.cuda.reset_peak_memory_stats()
        metrics.reset()
        reset_launches()
        final, first, curve, hit_total, hit_unsettled, rounds, wall, _ = \
            run_to_eps(sim, state, gen, eps=eps, max_rounds=max_rounds,
                       every=every, advance=advance, **thr)
        counts = launches()
        all_counts.append(counts)
        reg = metrics.snapshot()
        record = {"phase": "north_star_mode", "mode": label, "n": p.n,
                  "rounds_run": rounds, "rounds_to_eps": hit_total,
                  "rounds_to_eps_unsettled": hit_unsettled, "wall_s": wall,
                  "rounds_per_s": rounds / wall,
                  "dense_fused_rounds_per_s": ref_rps,
                  "behind_curve": curve,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "launches": counts}
        if arbiter is None:
            ratio = None if hit_unsettled is None \
                else hit_unsettled / ref_hits[1]
            # The one-round-stale round converges more slowly, or not at
            # all, on this workload (PERF.md §7): its crossings are
            # reported, not required.
            ok = (counts == expected(publish_board=rounds + 1)
                  and all(math.isfinite(b) for b in curve))
            record.update(rounds_to_eps_ratio_vs_lockstep=ratio,
                          rounds_to_eps_total_ratio_vs_lockstep=(
                              None if hit_total is None
                              else hit_total / ref_hits[0]),
                          inflight_round=carry["inflight"].round_idx)
        else:
            snap = arbiter.snapshot()
            diffs = states_equal(ref_final, final)
            # The process registry counted what the arbiter did.
            registry = {name: reg["counters"].get(f"sparse.{name}", 0)
                        for name in ("rounds", "overflow", "switches")}
            registry["frontier_size"] = reg["gauges"].get(
                "sparse.frontier_size")
            registry_ok = (
                registry["rounds"] == snap["sparse_rounds"]
                and registry["overflow"] == snap["overflow_rounds"]
                and registry["switches"] == snap["switches"]
                and (registry["frontier_size"] or 0.0)
                <= snap["frontier_hwm"])
            ok = (registry_ok and not diffs and curve == ref_curve
                  and rounds == ref_rounds
                  and (hit_total, hit_unsettled) == ref_hits
                  and snap["sparse_rounds"] + snap["dense_rounds"] == rounds
                  and counts == expected(
                      publish_board=snap["sparse_rounds"],
                      fused_publish_gather=rounds - snap["sparse_rounds"]))
            record.update(arbiter=snap, registry=registry,
                          field_diffs=diffs,
                          curve_equal=curve == ref_curve,
                          sparse_caps=list(sim._sparse_caps))
            if label == "sparse_forced":
                record["senders_announcers_by_chunk"] = sizes
                record["round_costs"] = sparse_round_costs(sim, first,
                                                           final)
                record["tail_profile"] = profile_rounds(sim, final)
        record["ok"] = ok
        emit(record)
        if not ok:
            raise SystemExit(f"north-star mode {label} failed")
        del sim, state, final, first
    return all_counts


# -- phase 6: the sharded north star ------------------------------------------

SHARDED_RUNS = [(mode, d) for mode in ("all_gather", "all_to_all", "ring",
                                       "zoned") for d in (1, 4)]


def phase_sharded(topo, reference, max_rounds, every, eps):
    """The north-star run through the node-sharded twin in every mode at
    d ∈ {1, 4}, held against the single-device unfused run; returns the
    launch counts of each run."""
    import math

    import torch

    from sidecar_tpu_torch.parallel import ShardedCompressedSim

    ref_final, ref_curve, ref_hits, ref_rounds = reference
    p = bench_params(topo.n)
    slots = burst(p.m, 0.001)
    thr = north_star_thresholds(p, slots, eps)
    all_counts = []
    for mode, d in SHARDED_RUNS:
        t0 = time.perf_counter()
        sim = ShardedCompressedSim(p, topo, bench_time(), d=d,
                                   board_exchange=mode)
        build_s = time.perf_counter() - t0
        state = sim.mint(sim.init_state(), slots, 10)
        sim.run_fast(state, 2, generator=sim.default_generator(99))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        final, first, curve, hit_total, hit_unsettled, rounds, wall, _ = \
            run_to_eps(sim, state, sim.default_generator(0), eps=eps,
                       max_rounds=max_rounds, every=every, **thr)
        counts = launches()
        all_counts.append(counts)
        profile = profile_rounds(sim, first)
        diffs = states_equal(ref_final, final)
        dropped = sim.sync_exchange_metrics(final)
        ok = (not diffs and curve == ref_curve and rounds == ref_rounds
              and (hit_total, hit_unsettled) == ref_hits and dropped == 0
              and counts == expected(publish_board=d * rounds,
                                     board_row_gather=d * rounds)
              and all(math.isfinite(b) for b in curve))
        emit({"phase": "sharded", "board_exchange": mode, "d": d,
              "n": p.n, "m": p.m, "rounds_run": rounds,
              "rounds_to_eps": hit_total,
              "rounds_to_eps_unsettled": hit_unsettled, "wall_s": wall,
              "rounds_per_s": rounds / wall, "sim_build_s": build_s,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "exchange_bytes_per_round": sim.exchange_bytes_per_round,
              "dropped": dropped, "launches": counts,
              "field_diffs": diffs, "curve_equal": curve == ref_curve,
              "profile_after_first_sample": profile, "ok": ok})
        if not ok:
            raise SystemExit(f"sharded phase failed ({mode}, d={d})")
        del sim, state, final, first
    return all_counts + sharded_modes(topo, reference, max_rounds, every,
                                      eps)


SHARDED_SPARSE_MODES = ("ring", "all_to_all")


def compacted_kernel_times(sim, state, failures) -> dict:
    """The compacted round's two kernels at shard 1 of ``state`` (a
    state of the twin's forced-sparse run; rows from r0 = N/d on),
    as that round calls them: the publish kernel on the shard's
    compacted senders with global row ids ``idx + r0``, and the board
    row gather kernel for its compacted receivers' own-shard pulls
    (``base = r0``); each against its plain version (equal outputs, CUDA
    events).  Uncounted."""
    import torch

    from sidecar_tpu_torch.ops import gossip as gossip_ops
    from sidecar_tpu_torch.ops import kernels as k
    from sidecar_tpu_torch.ops.sparse import compact_rows

    p, kn = sim.p, sim._knobs
    nl = p.n // sim.d
    r0 = nl
    rows = slice(r0, r0 + nl)
    cs_cap, cr_cap, _ = sim._sparse_caps_shard
    r = state.round_idx + 1
    src = gossip_ops.sample_peers(
        sim.draw(sim.default_generator(6), r).peer_slot, p.n,
        nbrs=sim._nbrs, node_alive=state.node_alive)
    sender = k.eligible_lines(state.cache_slot, state.cache_sent,
                              kn.limit).any(dim=1)
    recv = state.node_alive & sender[src.long()].any(dim=1)
    idx, row, valid, pos = compact_rows(sender[rows], cs_cap)
    rs = (r0 + row).long()
    cv = torch.where(valid[:, None], state.cache_val[rs], 0)
    cs = torch.where(valid[:, None], state.cache_slot[rs], -1)
    se = state.cache_sent[rs]
    bkw = dict(budget=min(p.budget, p.cache_lines), limit=kn.limit,
               fanout=p.fanout, cache_lines=p.cache_lines,
               row_ids=idx + r0)
    got = k.publish_board_cuda(cv, cs, se, **bkw)
    want = k.publish_board_torch(cv, cs, se, **bkw)
    err = max_abs_diff(got, want)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        failures.append("compacted publish_board")
    snd = sender[rows, None]
    bval = torch.where(snd, got[0][pos.long()], 0)
    bslot = torch.where(snd, got[1][pos.long()], -1)
    _, row_r, _, _ = compact_rows(recv[rows], cr_cap)
    dst = src[rows][row_r.long()].contiguous()
    g = k.board_row_gather_cuda(bval, bslot, dst, r0)
    w = k.board_row_gather_torch(bval, bslot, dst, r0)
    if not all(torch.equal(a, b) for a, b in zip(g, w)):
        failures.append("compacted board_row_gather")
    return {
        "round": state.round_idx, "shard": 1, "row_offset": r0,
        "senders": int(sender[rows].sum()),
        "receivers": int(recv[rows].sum()), "caps": [cs_cap, cr_cap],
        "publish_board_row_ids": {
            "rows": cs_cap, "max_abs_err": err,
            "ms": cuda_time_ms(lambda: k.publish_board_cuda(cv, cs, se,
                                                            **bkw)),
            "plain_ms": cuda_time_ms(lambda: k.publish_board_torch(
                cv, cs, se, **bkw))},
        "board_row_gather": {
            "rows": cr_cap, "board_rows": nl,
            "max_abs_err": max_abs_diff(g, w),
            "ms": cuda_time_ms(lambda: k.board_row_gather_cuda(
                bval, bslot, dst, r0)),
            "plain_ms": cuda_time_ms(lambda: k.board_row_gather_torch(
                bval, bslot, dst, r0))}}


def sharded_modes(topo, reference, max_rounds, every, eps):
    """The twin's execution modes at d = 4: forced sparse in ``ring``
    and ``all_to_all`` (the caps as in ``north_star_mode``, split over
    the shards), each equal to the single-device unfused run, with the
    compacted round's kernels timed on its tail; and the pipelined twin
    against the single-device pipelined run for 100 rounds.  Returns
    the launch counts of each run."""
    import torch

    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.parallel import ShardedCompressedSim

    ref_final, ref_curve, ref_hits, ref_rounds = reference
    p = bench_params(topo.n)
    slots = burst(p.m, 0.001)
    thr = north_star_thresholds(p, slots, eps)
    all_counts = []
    for mode in SHARDED_SPARSE_MODES:
        sim = ShardedCompressedSim(p, topo, bench_time(), d=4,
                                   board_exchange=mode, sparse="1")
        state = sim.mint(sim.init_state(), slots, 10)
        sim.run_fast(state, 2, generator=sim.default_generator(99),
                     sparse=True)
        torch.cuda.synchronize()
        gen = sim.default_generator(0)
        acc, compacted = [0, 0, 0], {}

        def advance(st, k):
            start = st
            st, behind = sim.run_behind(st, k, k, generator=gen,
                                        sparse=True)
            s = sim.last_sparse_stats.tolist()
            acc[:] = [acc[0] + s[0], acc[1] + s[1], max(acc[2], s[2])]
            if s[0] and not compacted:
                # The start of the first chunk with a compacted round.
                compacted["start"] = start
            return st, float(behind[-1])

        reset_launches()
        final, _first, curve, hit_total, hit_unsettled, rounds, wall, _ = \
            run_to_eps(sim, state, gen, eps=eps, max_rounds=max_rounds,
                       every=every, advance=advance, **thr)
        counts = launches()
        all_counts.append(counts)
        failures = []
        kernels = {"first_compacted_chunk_start": compacted_kernel_times(
                       sim, compacted["start"], failures),
                   "end": compacted_kernel_times(sim, final, failures)}
        diffs = states_equal(ref_final, final)
        ok = (not diffs and curve == ref_curve and rounds == ref_rounds
              and (hit_total, hit_unsettled) == ref_hits
              and acc[0] + acc[1] == rounds and not failures
              and int(final.dropped) == 0
              and counts == expected(publish_board=4 * rounds,
                                     board_row_gather=4 * rounds))
        emit({"phase": "sharded_mode", "mode": "sparse_forced",
              "board_exchange": mode, "d": 4, "rounds_run": rounds,
              "rounds_to_eps_unsettled": hit_unsettled, "wall_s": wall,
              "rounds_per_s": rounds / wall, "sparse_stats": acc,
              "sparse_caps_shard": list(sim._sparse_caps_shard),
              "launches": counts, "field_diffs": diffs,
              "curve_equal": curve == ref_curve,
              "compacted_kernels": kernels, "failures": failures,
              "ok": ok})
        if not ok:
            raise SystemExit(f"sharded sparse run failed ({mode})")
        del sim, state, final, compacted

    # The pipelined twin (the single-device program on the global
    # state) against the single-device pipelined run.
    rounds = 100
    out = {}
    for label, sim in (
            ("twin", ShardedCompressedSim(p, topo, bench_time(), d=4,
                                          board_exchange="ring",
                                          pipeline="1")),
            ("single", CompressedSim(p, topo, bench_time(),
                                     pipeline="1"))):
        state = sim.mint(sim.init_state(), slots, 10)
        reset_launches()
        t0 = time.perf_counter()
        final, curve, inflight = sim.run_pipelined(
            state, rounds, every, generator=sim.default_generator(0))
        torch.cuda.synchronize()
        out[label] = (final, curve.cpu(), launches(),
                      time.perf_counter() - t0)
        all_counts.append(out[label][2])
        del sim, state
    diffs = states_equal(out["single"][0], out["twin"][0])
    ok = (not diffs and torch.equal(out["single"][1], out["twin"][1])
          and all(out[l][2] == expected(publish_board=rounds + 1)
                  for l in out))
    emit({"phase": "sharded_mode", "mode": "pipelined", "d": 4,
          "board_exchange": "ring", "rounds": rounds,
          "convergence_curve": out["twin"][1].tolist(),
          "wall_s": {l: out[l][3] for l in out},
          "launches": {l: out[l][2] for l in out}, "field_diffs": diffs,
          "ok": ok})
    if not ok:
        raise SystemExit("sharded pipelined run failed")
    return all_counts


# -- phase 7: the scatter experiment -----------------------------------------

def phase_scatter(n=4096, spn=10, iters=20):
    """``benchmarks/pallas_scatter.py``'s experiment on the card: its
    inputs (``default_rng(0)``, the same draws in the same order), its
    shape, and its four points — an elementwise pass over ``known`` (the
    bandwidth floor), the in-place max kernel (the ceiling of any
    in-place merge), the library scatter-max and the scatter-max
    kernel, each an in-place update of the same buffer, 20 launches
    after 3 warm-ups.  Returns the launch counts of that run; after it
    the two scatters, and the in-place max kernel with
    ``torch.maximum(…, out=known)``, are timed again in turns and
    device-only, uncounted."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.ops import kernels as kernel_ops

    m = n * spn
    u = n * 3 * 15 + m                 # deliveries + announce batch
    rng = np.random.default_rng(0)
    rows = rng.integers(0, n, size=u, dtype=np.int32)
    cols = rng.integers(0, m, size=u, dtype=np.int32)
    vals = rng.integers(1, 1 << 22, size=u, dtype=np.int32)
    other = rng.integers(1, 1 << 20, size=(n, m), dtype=np.int32)
    k0 = rng.integers(1, 1 << 20, size=(n, m), dtype=np.int32)
    rows, cols, vals, other, known = to_cuda((rows, cols, vals, other, k0))
    del k0
    flat = rows.to(torch.int64) * m + cols.to(torch.int64)

    reset_launches()
    want = known.clone()
    want.view(-1).scatter_reduce_(0, flat, vals, "amax")
    got, _ = kernel_ops.scatter_max_apply(known.clone(), rows, cols, vals)
    correct = bool(torch.equal(got, want))
    del got, want
    # The experiment's four points, each once, as the reference times
    # them: the counted run.
    points = {
        "elementwise_pass_ms": cuda_time_ms(lambda: known.add_(1), iters),
        "rmw_ceiling_ms": cuda_time_ms(
            lambda: kernel_ops.rmw_max(known, other), iters),
        "library_scatter_ms": cuda_time_ms(
            lambda: known.view(-1).scatter_reduce_(0, flat, vals, "amax"),
            iters),
        "scatter_kernel_ms": cuda_time_ms(
            lambda: kernel_ops.scatter_max_apply(known, rows, cols, vals),
            iters),
    }
    torch.cuda.synchronize()
    counts = launches()
    # Measurements beyond the experiment, after its counts are read: the
    # two scatters in turns (medians), and with CUDA events around each
    # call alone, warm and after an L2 flush, in both orders.  (On an
    # H100 the profiler's sum for the same call in this phase ranged from
    # 0 to 0.013 ms between runs; the events do not vary so.)
    library = lambda: known.view(-1).scatter_reduce_(0, flat, vals, "amax")
    kernel = lambda: kernel_ops.scatter_max_apply(known, rows, cols, vals)
    turns = paired_ms({"library_scatter_ms": library,
                       "scatter_kernel_ms": kernel}, iters=iters)
    flush = l2_flush()
    device = {"device_only": device_times_both_orders(kernel, library, flush,
                                                      iters)}
    # The in-place max kernel and torch.maximum(…, out=known) alike.
    rmw = lambda: kernel_ops.rmw_max(known, other)
    rmw_library = lambda: torch.maximum(known, other, out=known)
    rmw_turns = paired_ms({"rmw_kernel_ms": rmw,
                           "library_max_ms": rmw_library}, iters=iters)
    rmw_device = device_times_both_orders(rmw, rmw_library, flush, iters)
    torch.cuda.synchronize()
    rmw_at_or_below = {
        "in_turns": rmw_turns["rmw_kernel_ms"]
        <= rmw_turns["library_max_ms"],
        **{f"{order} {when}": t["kernel"][when] <= t["library"][when]
           for order, t in rmw_device.items()
           for when in ("warm_ms", "l2_cold_ms")}}
    ratio = turns["library_scatter_ms"] / turns["scatter_kernel_ms"]
    # One parity launch, then 3 warm-ups and ``iters`` timed calls.
    ok = correct and counts == expected(
        scatter_max_apply=1 + iters + 3, rmw_max=iters + 3)
    emit({"phase": "scatter", "shape": [n, m], "updates": u,
          "buffer_mb": n * m * 4 / 1e6, "scatter_kernel_correct": correct,
          **points, "in_turns": turns, **device,
          "rmw_max_in_turns": rmw_turns, "rmw_max_device_only": rmw_device,
          "rmw_max_at_or_below_library": rmw_at_or_below,
          "library_over_kernel": ratio,
          "verdict": ("the kernel beats the library scatter"
                      if ratio > 1.25 else
                      "no meaningful win over the library scatter"),
          "launches": counts, "ok": ok})
    if not ok:
        raise SystemExit("scatter phase failed")
    return counts


# -- phases 8 and 9: the exact model -----------------------------------------

def exact_busy_time():
    """Push-pull every 10 rounds, the sweep every 10, records expiring
    into SUSPECT after 3 s and tombstoning 1 s later, owners refreshing
    every 10 rounds: every phase of the round changes state in 30."""
    from sidecar_tpu_torch.models.timecfg import TimeConfig

    return TimeConfig(push_pull_interval_s=2.0, suspicion_window_s=1.0,
                      alive_lifespan_s=3.0, refresh_interval_s=2.0)


def phase_exact_lockstep(n=1024, rounds=30):
    """The exact model on the card and on the CPU from one set of draws:
    ER(8, seed 3), 10 services a node (M = 10 n, the two-stage select),
    loss 0.1; every state field equal, the convergence curve within
    1e-6, and the scatter-max kernel launched once a round."""
    import torch

    from sidecar_tpu_torch.models.exact import ExactSim, SimParams
    from sidecar_tpu_torch.ops.status import SUSPECT, TOMBSTONE
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    p = SimParams(n=n, services_per_node=10, fanout=3, budget=15,
                  drop_prob=0.1)
    topo = erdos_renyi(n, avg_degree=8.0, seed=3)
    cpu = ExactSim(p, topo, exact_busy_time(), device="cpu")
    gpu = ExactSim(p, topo, exact_busy_time())
    gen = torch.Generator().manual_seed(1)
    draws = [cpu.draw(gen, r) for r in range(1, rounds + 1)]
    reset_launches()
    card, card_conv = gpu.run(gpu.init_state(), rounds, draws=draws)
    torch.cuda.synchronize()
    counts = launches()
    t0 = time.perf_counter()
    host, host_conv = cpu.run(cpu.init_state(), rounds, draws=draws)
    cpu_s = time.perf_counter() - t0
    diffs = states_equal(host, card)
    conv_err = float((host_conv - card_conv.cpu()).abs().max())
    status = host.known & 7
    ok = (not diffs and conv_err <= 1e-6
          and counts == expected(scatter_max_apply=rounds)
          and bool(torch.isfinite(host_conv).all()))
    emit({"phase": "exact_lockstep", "n": n, "m": p.m, "rounds": rounds,
          "conv": host_conv.tolist(), "conv_max_abs_err": conv_err,
          "field_diffs": diffs, "launches": counts,
          "suspect_cells": int((status == SUSPECT).sum()),
          "tombstone_cells": int((status == TOMBSTONE).sum()),
          "cpu_s": cpu_s, "ok": ok})
    if not ok:
        raise SystemExit("exact lockstep phase failed")


def exact_breakdown(sim, state, generator, iters=5):
    """Time of each phase of one exact round alone, on a copy of
    ``state``: CUDA events around the calls (host gaps included) and the
    profiler's device time (without them); the per-round share at the
    configured cadences; beside the scatter-max kernel, the library
    scatter-max on the same in-range triples."""
    import torch

    from sidecar_tpu_torch.models.exact import clone_state
    from sidecar_tpu_torch.ops import gossip as g

    p, kn = sim.p, sim._knobs
    st = clone_state(state)
    r = st.round_idx + 1
    now = r * sim.t.round_ticks
    d = sim.draw(generator, kn.push_pull_rounds)
    dst = g.sample_peers(d.peer_slot, p.n, nbrs=sim._nbrs,
                         node_alive=st.node_alive)
    svc, msg = g.select_messages(st.known, st.sent, p.budget, kn.limit)
    gates = dict(now_tick=now, stale_ticks=kn.stale_ticks,
                 node_alive=st.node_alive)
    d_rows, d_cols, d_vals, d_adv = g.prepare_deliveries(
        st.known, dst, svc, msg, **gates)
    a_rows, a_cols, a_vals, a_due = sim._announce_updates(
        st.known, st.node_alive, r, now)
    rows, cols = torch.cat([d_rows, a_rows]), torch.cat([d_cols, a_cols])
    vals, adv = torch.cat([d_vals, a_vals]), torch.cat([d_adv, a_due])
    ok = (rows < p.n) & (cols < p.m)
    flat_in = (rows.to(torch.int64) * p.m + cols.to(torch.int64))[ok]
    vals_in = vals[ok]
    phases = {
        "select": lambda: g.select_messages(st.known, st.sent, p.budget,
                                            kn.limit),
        "record_transmissions": lambda: g.record_transmissions(
            st.sent, svc, msg, p.fanout),
        "deliveries": lambda: g.prepare_deliveries(st.known, dst, svc, msg,
                                                   **gates),
        "announce": lambda: sim._announce_updates(st.known, st.node_alive,
                                                  r, now),
        "apply_kernel": lambda: g.apply_updates(st.known, st.sent, rows,
                                                cols, vals, adv),
        "push_pull": lambda: sim._push_pull(st.known, st.sent,
                                            st.node_alive, d.pp_slot, now),
        "sweep": lambda: sim._sweep(st.known, st.sent, now),
    }
    every = {"push_pull": kn.push_pull_rounds, "sweep": kn.sweep_rounds}
    ms = {name: cuda_time_ms(fn, iters) for name, fn in phases.items()}
    dev = {name: device_time_ms(fn, iters) for name, fn in phases.items()}
    per_round = {name: t / every.get(name, 1) for name, t in ms.items()}
    dev_round = {name: t / every.get(name, 1) for name, t in dev.items()
                 if t is not None}
    library = cuda_time_ms(lambda: st.known.view(-1).scatter_reduce_(
        0, flat_in, vals_in, "amax"), iters)
    return {"ms_per_call": ms, "ms_per_round": per_round,
            "sum_ms_per_round": sum(per_round.values()),
            "device_ms_per_call": dev, "device_ms_per_round": dev_round,
            "sum_device_ms_per_round": sum(dev_round.values()),
            "device_not_measured": [k for k, t in dev.items() if t is None],
            "updates": int(rows.numel()), "in_range": int(ok.sum()),
            "advancing": int(adv.sum()),
            "library_scatter_ms_same_triples": library}


def phase_exact(n=4096, warm=200, timed=200):
    """``bench.py``'s ``value`` workload (``_bench_dense``) at full size:
    ``run_fast`` for ``warm`` rounds, then ``timed`` rounds chained from
    the warm state (the drivers update it in place), draws from
    ``default_generator(0)``.  Returns the launch counts of the run."""
    import math

    import torch

    from sidecar_tpu_torch.models.exact import ExactSim, SimParams
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    p = SimParams(n=n, services_per_node=10, fanout=3, budget=15)
    t0 = time.perf_counter()
    topo = erdos_renyi(n, avg_degree=8.0, seed=3)
    graph_s = time.perf_counter() - t0
    sim = ExactSim(p, topo)
    state = sim.init_state()
    gen = sim.default_generator(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = sim.run_fast(state, warm, generator=gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = sim.run_fast(state, timed, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    conv = float(sim.convergence(state))
    breakdown = exact_breakdown(sim, state, sim.default_generator(5))
    profile = profile_rounds(sim, state)
    ok = (counts == expected(scatter_max_apply=warm + timed)
          and math.isfinite(conv) and 0.0 < conv <= 1.0)
    emit({"phase": "exact", "n": n, "m": p.m, "graph_build_s": graph_s,
          "warm_rounds": warm, "warm_s": warm_s, "rounds": timed,
          "wall_s": wall, "rounds_per_s": timed / wall,
          "max_memory_allocated": peak, "convergence": conv,
          "launches": counts, "breakdown": breakdown, "profile": profile,
          "ok": ok})
    if not ok:
        raise SystemExit("exact phase failed")
    return counts


def pipeline_bench_time():
    """``benchmarks/pipeline.py``'s protocol (its ``CFG``): refresh out
    of the way, push-pull every 4 s."""
    from sidecar_tpu_torch.models.timecfg import TimeConfig

    return TimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=4.0)


def timed_chunks(advance, state, rounds: int, reps: int):
    """``benchmarks/pipeline.py``'s measurement: one warm chunk of
    ``rounds``, then the best of ``reps`` chunks, each chained from the
    last; returns ``(state, ms a round, every chunk's ms a round)``."""
    state = advance(state, rounds)
    times = []
    for _ in range(reps):
        box = {}

        def chunk():
            box["state"] = advance(state, rounds)

        times.append(ms_per_round(chunk, rounds))
        state = box["state"]
    return state, min(times), times


def rounds_to_conv(sim, eps: float, horizon: int, chunk: int = 16,
                   pipelined: bool = False):
    """``benchmarks/pipeline.py``'s ``_rounds_to_eps``: the first round
    whose convergence reaches ``1 - eps`` from a cold start (draws from
    ``default_generator(11)``), chunk by chunk, the pipelined walk
    handing its carry on; returns ``(round or None, rounds run)``."""
    state = sim.init_state()
    gen = sim.default_generator(11)
    inflight, done = None, 0
    while done < horizon:
        step = min(chunk, horizon - done)
        if pipelined:
            state, conv, inflight = sim.run_pipelined(
                state, step, inflight=inflight, generator=gen,
                start_round=done)
        else:
            state, conv = sim.run(state, step, generator=gen,
                                  start_round=done)
        for i, c in enumerate(conv.tolist()):
            if c >= 1.0 - eps:
                return done + i + 1, done + step
        done += step
    return None, done


def phase_exact_modes(n=4096, rounds=60, reps=3, eps=1e-3, horizon=800):
    """``benchmarks/pipeline.py``'s exact rows at ``bench.py``'s
    ``value`` size (n = 4,096 × 10 services, ER(8, seed 3), its
    protocol): ms a round for the lockstep, pipelined and forced-sparse
    rounds (one warm chunk of ``rounds``, then the best of ``reps``,
    draws from ``default_generator(0)``), the forced-sparse run equal to
    the lockstep one field for field; the convergence row (rounds to
    ``1 - eps`` from a cold start, lockstep against pipelined); the
    cadence row (period 1 against per-node periods {1, 2, 4} cycling
    node by node, phases node % 4: ms a round and rounds to ``1 -
    eps``).  The scatter kernel must launch once a round of every run.
    Returns the launch counts."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.models.exact import ExactSim, SimParams
    from sidecar_tpu_torch.ops import gossip as gossip_ops
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    p = SimParams(n=n, services_per_node=10, fanout=3, budget=15)
    topo = erdos_renyi(n, avg_degree=8.0, seed=3)
    t = pipeline_bench_time()
    mixed = dict(tick_period=np.choose(np.arange(n) % 3, [1, 2, 4]),
                 tick_phase=np.arange(n) % 4)
    sims = {"lockstep": ExactSim(p, topo, t),
            "pipelined": ExactSim(p, topo, t, pipeline="1"),
            "sparse_forced": ExactSim(p, topo, t, sparse="1"),
            "cadence_mixed": ExactSim(p, topo, t, **mixed)}
    reset_launches()
    total, ms, chunks, finals, stats = 0, {}, {}, {}, None
    for label, sim in sims.items():
        gen = sim.default_generator(0)
        carry = {"inflight": None, "stats": [0, 0, 0]}

        def advance(st, k, sim=sim, gen=gen, carry=carry, label=label):
            if label == "pipelined":
                st, carry["inflight"] = sim.run_fast_pipelined(
                    st, k, inflight=carry["inflight"], generator=gen)
                return st
            st = sim.run_fast(st, k, generator=gen)
            if label == "sparse_forced":
                s = sim.last_sparse_stats.tolist()
                acc = carry["stats"]
                carry["stats"] = [acc[0] + s[0], acc[1] + s[1],
                                  max(acc[2], s[2])]
            return st

        finals[label], ms[label], chunks[label] = timed_chunks(
            advance, sim.init_state(), rounds, reps)
        total += rounds * (reps + 1)
        if label == "sparse_forced":
            stats = carry["stats"]
    diffs = states_equal(finals["lockstep"], finals["sparse_forced"])
    # What the sparse path adds to a round that overflows: the sender
    # mask over [N, M] and one host read.
    st = finals["lockstep"]
    mask_ms = cuda_time_ms(lambda: gossip_ops.eligible_records(
        st.known, st.sent, sims["lockstep"]._knobs.limit).any(dim=1))
    del finals, st
    conv = {}
    for label in ("lockstep", "pipelined", "cadence_mixed"):
        conv[label], ran = rounds_to_conv(sims[label], eps, horizon,
                                          pipelined=label == "pipelined")
        total += ran
    torch.cuda.synchronize()
    counts = launches()

    def ratio(a, b):
        return None if a is None or b is None else a / b

    ok = (not diffs and counts == expected(scatter_max_apply=total)
          and stats[0] + stats[1] == rounds * (reps + 1)
          and conv["lockstep"] is not None)
    emit({"phase": "exact_modes", "n": n, "m": p.m, "rounds": rounds,
          "reps": reps, "exact": {
              "lockstep_ms_per_round": ms["lockstep"],
              "pipelined_ms_per_round": ms["pipelined"],
              "sparse_forced_ms_per_round": ms["sparse_forced"],
              "chunk_ms_per_round": chunks,
              "pipelined_speedup": ratio(ms["lockstep"], ms["pipelined"]),
              "sparse_forced_stats": stats,
              "sparse_forced_field_diffs": diffs,
              "sender_mask_ms": mask_ms},
          "convergence": {
              "eps": eps, "horizon": horizon,
              "lockstep_rounds_to_eps": conv["lockstep"],
              "pipelined_rounds_to_eps": conv["pipelined"],
              "rounds_to_eps_ratio": ratio(conv["pipelined"],
                                           conv["lockstep"])},
          "cadence": {
              "mixed_periods": [1, 2, 4],
              "uniform_ms_per_round": ms["lockstep"],
              "mixed_ms_per_round": ms["cadence_mixed"],
              "uniform_rounds_to_eps": conv["lockstep"],
              "mixed_rounds_to_eps": conv["cadence_mixed"],
              "rounds_to_eps_ratio": ratio(conv["cadence_mixed"],
                                           conv["lockstep"])},
          "rounds_run": total, "launches": counts, "ok": ok})
    if not ok:
        raise SystemExit("exact modes phase failed")
    return counts


# -- phase 11: the telemetry planes --------------------------------------------

TELEMETRY_PLANES = ("trace", "digest", "deltas", "provenance")
TELEMETRY_EXACT_ROUNDS = 20
# The compressed digest and deltas' card-against-CPU rounds (20 until
# the script's time limit asked for a cut; about 1 s a round on the CPU).
TELEMETRY_CPU_ROUNDS = 10
# The exact planes card against CPU: 512 × 10 (M = 5,120, still the
# two-stage select) is about a ninth of 1,024 × 10's CPU time, whose
# [N, M] passes outgrow the host's caches.
TELEMETRY_CPU_EXACT_N = 512
TELEMETRY_BUCKETS = 64


def stream_host(stream) -> dict:
    """A stream's fields on the host (tensors as numpy arrays)."""
    return {k: (v.cpu().numpy() if hasattr(v, "cpu") else v)
            for k, v in vars(stream).items()}


def streams_diff(a: dict, b: dict) -> list:
    """``plane.field`` names where two sets of host streams differ."""
    import numpy as np

    out = []
    for plane in a:
        for f, v in a[plane].items():
            w = b[plane][f]
            same = (np.array_equal(v, w) and v.dtype == w.dtype) \
                if isinstance(v, np.ndarray) else v == w
            if not same:
                out.append(f"{plane}.{f}")
    return out


class AllPlanes:
    """Several planes of ``models/planes.py`` over one run, so a check
    takes every stream from one pass over the rounds."""

    def __init__(self, sim, state, rounds, names, delta_cap, tracked):
        from sidecar_tpu_torch.models import planes

        make = {
            "trace": lambda: planes.TracePlane(sim, rounds),
            "digest": lambda: planes.DigestPlane(
                sim, rounds, sim._resolve_digest_idents(None),
                TELEMETRY_BUCKETS),
            "deltas": lambda: planes.DeltaPlane(sim, state, delta_cap),
            "provenance": lambda: planes.ProvPlane(
                sim, planes.start_prov(sim, state, tracked, rounds, None),
                tracked)}
        self.planes = {name: make[name]() for name in names}

    def before(self, state, draws):
        return {k: p.before(state, draws) for k, p in self.planes.items()}

    def after(self, pre, nxt, stats):
        for k, p in self.planes.items():
            p.after(pre[k], nxt, stats)

    def streams(self) -> dict:
        return {k: stream_host(p.result) for k, p in self.planes.items()}


def all_streams(sim, state, rounds, draws, sparse, names, delta_cap,
                tracked):
    """The planes ``names`` over one run of the sim's own loop from
    ``draws``; returns ``(final, host streams, sparse stats)``."""
    from sidecar_tpu_torch.models.exact import ExactSim

    obs = AllPlanes(sim, state, rounds, names, delta_cap, tracked)
    if isinstance(sim, ExactSim):
        final, _ = sim._run(state, rounds, False, None, draws, sparse,
                            plane=obs)
    else:
        final, _ = sim._run(state, rounds, 1, None, None, draws, sparse,
                            plane=obs)
    stats = None if sim.last_sparse_stats is None \
        else sim.last_sparse_stats.tolist()
    return final, obs.streams(), stats


def card_against_cpu(label, make, start, rounds, names, delta_cap,
                     tracked, seed=1):
    """The planes ``names`` on the card and on the CPU from one set of
    draws, dense and ``sparse=True``: every field of the final state and
    of every stream must be equal.  Returns the record and the card
    runs' launch counts."""
    import torch

    cpu, gpu = make("cpu"), make("cuda")
    gen = torch.Generator().manual_seed(seed)
    draws = [cpu.draw(gen, r) for r in range(1, rounds + 1)]
    record, counts = {"rounds": rounds, "planes": list(names)}, []
    for sparse in (False, True):
        t0 = time.perf_counter()
        a, sa, stats_a = all_streams(cpu, start(cpu), rounds, draws, sparse,
                                     names, delta_cap, tracked)
        cpu_s = time.perf_counter() - t0
        reset_launches()
        b, sb, stats_b = all_streams(gpu, start(gpu), rounds, draws, sparse,
                                     names, delta_cap, tracked)
        torch.cuda.synchronize()
        counts.append(launches())
        diffs = states_equal(a, b) + streams_diff(sa, sb)
        if stats_a != stats_b:
            diffs.append("sparse_stats")
        record["sparse" if sparse else "dense"] = {
            "diffs": diffs, "sparse_stats": stats_b, "cpu_s": cpu_s,
            "launches": counts[-1]}
    record["ok"] = not (record["dense"]["diffs"]
                        or record["sparse"]["diffs"])
    return {label: record}, counts


def sync_points(fn, mode="warn"):
    """Where ``fn()`` synchronises with the card, under
    ``torch.cuda.set_sync_debug_mode(mode)``: with ``"warn"``, ``{file:
    line: count}`` of the innermost frame of this repository on the
    stack at each warning (this script's own included); with
    ``"error"``, None where it ran through, else the first line of the
    error."""
    import collections
    import pathlib
    import traceback
    import warnings

    import torch

    root = pathlib.Path(__file__).resolve().parent
    hits = collections.Counter()
    inside = [False]

    def record(message, category, filename, lineno, *args, **kw):
        # The first switch of the mode reports itself; count only fn's.
        if not inside[0] or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(str(root))]
        at = ours[-1] if ours else None
        hits[f"{pathlib.Path(at.filename).relative_to(root)}:{at.lineno}"
             if at else f"{pathlib.Path(filename).name}:{lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode(mode)
        inside[0] = True
        try:
            fn()
        except RuntimeError as exc:
            return str(exc).splitlines()[0]
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    return None if mode == "error" else dict(hits)


def exact_value_planes(n, rounds=TELEMETRY_EXACT_ROUNDS):
    """Each plane on ``bench.py``'s ``value`` workload (n × 10 services,
    ER(8, seed 3), fanout 3, budget 15), ``rounds`` rounds from a cold
    start and ``default_generator(0)``, against the untraced ``run`` from
    the same seed: final state and curve equal bit for bit; ms a round
    in turns (untraced, traced, traced, untraced) and peak memory.  The
    delta cap is the median of the trace's ``admitted`` column, so busy
    rounds overflow and quiet ones do not, and each batch's count must
    equal that column.  Returns the record and the launch counts."""
    import numpy as np
    import torch

    from sidecar_tpu_torch import convert
    from sidecar_tpu_torch.models.exact import ExactSim, SimParams
    from sidecar_tpu_torch.ops import provenance as prov_ops
    from sidecar_tpu_torch.ops import trace as trace_ops
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    p = SimParams(n=n, services_per_node=10, fanout=3, budget=15)
    sim = ExactSim(p, erdos_renyi(n, avg_degree=8.0, seed=3))
    tracked = prov_ops.default_tracked(p.m, 8)
    cap = {}

    def run(plane, k=rounds):
        return drive(plane, k, sim.init_state(), sim.default_generator(0))

    def drive(plane, k, st, g):
        if plane is None:
            return sim.run(st, k, generator=g)
        if plane == "trace":
            return sim.run_with_trace(st, k, generator=g)
        if plane == "digest":
            return sim.run_with_digest(st, k, generator=g,
                                       buckets=TELEMETRY_BUCKETS)
        if plane == "deltas":
            return sim.run_with_deltas(st, k, cap["deltas"], generator=g)
        return sim.run_with_provenance(st, k, tracked, generator=g)

    def peak_of(plane):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = run(plane)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(), launches()

    # The untraced run's result is held on the host, and each run's is
    # dropped before the next, so every peak has the same resident set.
    (u_final, u_conv), u_peak, u_counts = peak_of(None)
    u_host, u_conv = convert.state_to_numpy(u_final), u_conv.cpu()
    del u_final
    counts, record = [u_counts], {"n": n, "m": p.m, "rounds": rounds,
                                  "untraced_max_memory_allocated": u_peak}
    ok = u_counts == expected(scatter_max_apply=rounds)
    admitted = None
    for plane in TELEMETRY_PLANES:
        (final, stream, conv), peak, c = peak_of(plane)
        counts.append(c)
        diffs = [f for f, v in convert.state_to_numpy(final).items()
                 if not np.array_equal(v, u_host[f])]
        same_conv = torch.equal(u_conv, conv.cpu())
        del final, conv
        rec = {"final_field_diffs": diffs, "conv_equal": same_conv,
               "max_memory_allocated": peak, "launches": c}
        plane_ok = not diffs and same_conv and \
            c == expected(scatter_max_apply=rounds)
        if plane == "trace":
            rows = stream.rec.cpu()
            admitted = rows[:, trace_ops.TRACE_ADMITTED].tolist()
            cap["deltas"] = sorted(admitted)[len(admitted) // 2]
            rec["summary"] = trace_ops.summarize(stream)
            plane_ok = plane_ok and stream.count == rounds
        elif plane == "digest":
            rows = stream.rec.cpu()
            rec["records_first_last"] = [rows[0].tolist(), rows[-1].tolist()]
            plane_ok = plane_ok and int(rows[0, 1]) == n
        elif plane == "deltas":
            counts_d = stream.count.tolist()
            over = stream.overflow.tolist()
            busy = next(i for i, o in enumerate(over) if o) \
                if any(over) else None
            quiet = next(i for i, o in enumerate(over) if not o) \
                if not all(over) else None
            rec.update(cap=cap["deltas"], counts=counts_d,
                       busy_round=None if busy is None else
                       {"round": busy + 1, "count": counts_d[busy],
                        "overflow": True},
                       quiet_round=None if quiet is None else
                       {"round": quiet + 1, "count": counts_d[quiet],
                        "overflow": False,
                        "filled": int((stream.node[quiet] >= 0).sum())})
            plane_ok = (plane_ok and counts_d == admitted
                        and busy is not None and quiet is not None)
        else:
            rec["lag"] = prov_ops.pooled_lag(stream.first_seen.cpu().numpy())
            plane_ok = plane_ok and rec["lag"]["samples"] > 0
        del stream
        times = {"untraced": [], "traced": []}
        reset_launches()
        for which in ("untraced", "traced", "traced", "untraced"):
            plane_arg = None if which == "untraced" else plane
            times[which].append(ms_per_round(lambda: run(plane_arg),
                                             rounds))
        counts.append(launches())
        rec["ms_per_round"] = times
        rec["ok"] = plane_ok
        record[plane] = rec
        ok = ok and plane_ok
    # What synchronises in two rounds (the state and generator made
    # first); where the untraced round has no such point, the traced
    # round must also run under "error".
    reset_launches()
    sync = {}
    for plane in (None,) + TELEMETRY_PLANES:
        st, g = sim.init_state(), sim.default_generator(0)
        sync[plane or "untraced"] = sync_points(
            lambda: drive(plane, 2, st, g))
    if not sync["untraced"]:
        st, g = sim.init_state(), sim.default_generator(0)
        sync["trace_under_error"] = sync_points(
            lambda: drive("trace", 2, st, g), "error")
    counts.append(launches())
    record["sync_points"] = sync
    # Device activity of three rounds from a cold start, untraced and
    # traced (both sample the curve; the input is copied first).
    reset_launches()
    record["profile"] = {
        "untraced": profile_rounds(sim, sim.init_state(), 3, drive=lambda
                                   st, d: sim.run(st, len(d), draws=d,
                                                  donate=False)),
        "trace": profile_rounds(sim, sim.init_state(), 3, drive=lambda
                                st, d: sim.run_with_trace(
                                    st, len(d), draws=d, donate=False))}
    counts.append(launches())
    record["ok"] = ok
    return record, counts


def north_star_planes(topo, fused):
    """The trace and provenance planes over the north star's burst for
    the fused run's rounds, from its generator seed: each final state
    equal to the fused run's, the trace's ``behind`` column at every
    25th round equal to its curve, and the twin at d = 4 (``ring``)
    recording the same trace.  Returns the record and the counts."""
    import torch

    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.ops import provenance as prov_ops
    from sidecar_tpu_torch.ops import trace as trace_ops
    from sidecar_tpu_torch.parallel import ShardedCompressedSim

    ref_final, ref_curve, _hits, rounds, ref_rps = fused
    every = NORTH_STAR_RUN["every"]
    p = bench_params(topo.n)
    slots = burst(p.m, 0.001)
    # 64 of the burst's records, spread over it (the host summary walks
    # every (record, node) pair in Python: 64 · 10⁵ pairs, not 10⁸).
    tracked = tuple(int(slots[i]) for i in
                    prov_ops.default_tracked(len(slots), 64))
    record, counts = {"rounds": rounds,
                      "fused_untraced_rounds_per_s": ref_rps}, []
    ok = True
    traces = {}
    for label, make in (
            ("trace", lambda: CompressedSim(p, topo, bench_time())),
            ("provenance", lambda: CompressedSim(p, topo, bench_time())),
            ("trace_sharded_ring_d4", lambda: ShardedCompressedSim(
                p, topo, bench_time(), d=4, board_exchange="ring"))):
        sim = make()
        state = sim.mint(sim.init_state(), slots, 10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        if label == "provenance":
            final, stream = sim.run_with_provenance(
                state, rounds, tracked, generator=sim.default_generator(0))
        else:
            final, stream = sim.run_with_trace(
                state, rounds, generator=sim.default_generator(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = launches()
        counts.append(c)
        diffs = states_equal(ref_final, final)
        rec = {"wall_s": wall, "rounds_per_s": rounds / wall,
               "ms_per_round": 1e3 * wall / rounds,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "final_field_diffs": diffs, "launches": c}
        rec_ok = not diffs
        if label == "provenance":
            summ = prov_ops.summarize(stream, tracked, p.services_per_node)
            recs = summ["records"]
            rec.update(tracked=len(tracked), lag=summ["lag"],
                       rounds_observed=summ["rounds_observed"],
                       reached_min=min(r["reached"] for r in recs),
                       reached_max=max(r["reached"] for r in recs),
                       unattributed_total=sum(r["unattributed"]
                                              for r in recs))
            rec_ok = rec_ok and c == expected(fused_publish_gather=rounds)
        else:
            rows = stream.rec.cpu()
            traces[label] = rows
            behind = rows[:, trace_ops.TRACE_BEHIND].tolist()
            sampled = behind[every - 1::every]
            want = [int(b) for b in ref_curve]
            rec.update(summary=trace_ops.summarize(stream),
                       behind_every_25=sampled,
                       behind_equals_curve=sampled == want)
            rec_ok = rec_ok and sampled == want
            if label == "trace":
                rec_ok = rec_ok and c == expected(
                    fused_publish_gather=rounds)
            else:
                same = torch.equal(rows, traces["trace"])
                rec["trace_equals_single_device"] = same
                rec["dropped"] = sim.sync_exchange_metrics(final)
                rec_ok = rec_ok and same and c == expected(
                    publish_board=4 * rounds, board_row_gather=4 * rounds)
        if label == "trace":
            # Device activity of five rounds from the burst, untraced
            # and traced.
            reset_launches()
            rec["profile"] = {
                "untraced": profile_rounds(sim, state),
                "trace": profile_rounds(sim, state, drive=lambda st, d:
                                        sim.run_with_trace(st, len(d),
                                                           draws=d))}
            counts.append(launches())
        rec["ok"] = rec_ok
        record[label] = rec
        ok = ok and rec_ok
        del sim, state, final, stream
    record["ok"] = ok
    return record, counts


def compressed_lockstep_planes(n=4096, rounds=50):
    """The digest and delta planes at the lockstep size on the card
    (n = 4,096, the 1 % burst), dense and ``sparse=True`` from one set
    of draws: the final state equal to the untraced run's and the
    sparse streams equal to the dense ones."""
    import torch

    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    p = bench_params(n)
    topo = erdos_renyi(n, avg_degree=8.0, seed=3)
    sim = CompressedSim(p, topo, bench_time())
    slots = burst(p.m, 0.01)
    gen = torch.Generator().manual_seed(1)
    draws = [sim.draw(gen, r) for r in range(1, rounds + 1)]
    state = sim.mint(sim.init_state(), slots, 10)
    plain = sim.run_fast(state, rounds, draws=draws)
    record, counts, streams = {"n": n, "rounds": rounds}, [], {}
    for sparse in (False, True):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        final, got, stats = all_streams(sim, state, rounds, draws, sparse,
                                        ("digest", "deltas"), 1 << 16, ())
        torch.cuda.synchronize()
        counts.append(launches())
        streams[sparse] = got
        record["sparse" if sparse else "dense"] = {
            "ms_per_round": 1e3 * (time.perf_counter() - t0) / rounds,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "final_field_diffs": states_equal(plain, final),
            "sparse_stats": stats, "launches": counts[-1],
            "digest_last_record": got["digest"]["rec"][-1].tolist(),
            "delta_overflow_rounds": int(got["deltas"]["overflow"].sum())}
    record["sparse_streams_diff_dense"] = streams_diff(streams[False],
                                                       streams[True])
    record["ok"] = (not record["dense"]["final_field_diffs"]
                    and not record["sparse"]["final_field_diffs"]
                    and not record["sparse_streams_diff_dense"])
    return record, counts


def phase_telemetry(topo, fused, exact_n=4096):
    """The telemetry planes (``models/planes.py``) on both models: the
    exact ``value`` workload, the compressed north star (trace and
    provenance, and the twin's trace), the compressed digest and deltas
    at the lockstep size, and card against CPU: the exact planes at half
    the exact lockstep's size (n = 512 × 10), the compressed trace and
    provenance at the lockstep's (n = 4,096), its digest and deltas at
    n = 1,024, where the CPU's [N, M] belief view takes well under a
    second a round.
    Returns the launch counts of the card runs."""
    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.models.exact import ExactSim, SimParams
    from sidecar_tpu_torch.ops import provenance as prov_ops
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    counts = []
    t0 = time.perf_counter()
    exact, c = exact_value_planes(exact_n)
    counts += c
    emit({"phase": "telemetry", "part": "exact_value",
          "seconds": time.perf_counter() - t0, **exact})
    ok = exact["ok"]
    if topo is not None:
        t0 = time.perf_counter()
        ns, c = north_star_planes(topo, fused)
        counts += c
        emit({"phase": "telemetry", "part": "north_star",
              "seconds": time.perf_counter() - t0, **ns})
        ok = ok and ns["ok"]
    t0 = time.perf_counter()
    small, c = compressed_lockstep_planes()
    counts += c
    emit({"phase": "telemetry", "part": "compressed_lockstep",
          "seconds": time.perf_counter() - t0, **small})
    ok = ok and small["ok"]
    t0 = time.perf_counter()

    xn = min(TELEMETRY_CPU_EXACT_N, exact_n)
    xp = SimParams(n=xn, services_per_node=10, fanout=3, budget=15,
                   drop_prob=0.1)
    xtopo = erdos_renyi(xn, avg_degree=8.0, seed=3)
    checks = {}
    rec, c = card_against_cpu(
        f"exact_n{xn}",
        lambda dev: ExactSim(xp, xtopo, exact_busy_time(), device=dev),
        lambda sim: sim.init_state(), 20, TELEMETRY_PLANES, 1 << 16,
        prov_ops.default_tracked(xp.m, 8))
    checks.update(rec)
    counts += c
    for n, rounds, names in ((4096, 30, ("trace", "provenance")),
                             (1024, TELEMETRY_CPU_ROUNDS,
                              ("digest", "deltas"))):
        p = bench_params(n)
        ctopo = erdos_renyi(n, avg_degree=8.0, seed=3)
        slots = burst(p.m, 0.01)
        rec, c = card_against_cpu(
            f"compressed_n{n}",
            lambda dev, p=p, ctopo=ctopo: CompressedSim(
                p, ctopo, bench_time(), device=dev),
            lambda sim, slots=slots: sim.mint(sim.init_state(), slots, 10),
            rounds, names, 1 << 16, tuple(int(s) for s in slots[:8]))
        checks.update(rec)
        counts += c
    cok = all(r["ok"] for r in checks.values())
    emit({"phase": "telemetry", "part": "card_against_cpu",
          "seconds": time.perf_counter() - t0, **checks, "ok": cok})
    if not (ok and cok):
        raise SystemExit("telemetry phase failed")
    return counts


# -- phase 12: the node-sharded exact twin -------------------------------------

SHARDED_EXACT_RUNS = [(mode, d) for mode in ("all_gather", "ring", "zoned")
                      for d in (1, 4)]


def exact_fields_differ(a, b) -> list:
    """Names of the fields where two exact-model states differ, compared
    on ``a``'s device (no host copy of ``known``)."""
    import torch

    return [f for f in ("known", "sent", "node_alive")
            if not torch.equal(getattr(a, f),
                               getattr(b, f).to(getattr(a, f).device))] + \
        ([] if a.round_idx == b.round_idx else ["round_idx"])


def curve_list(conv) -> list:
    return [float(c) for c in conv.cpu()]


def phase_sharded_exact(n=4096, warm=200, timed=200, cpu_n=1024,
                        cpu_rounds=30):
    """The node-sharded exact twin (``ShardedSim``) on ``bench.py``'s
    ``value`` workload at full size (n = 4,096 × 10 services, fanout 3,
    budget 15, the default ``TimeConfig``, ER(8, seed 3)), the shards
    sharing the one card: in each board-exchange mode at d ∈ {1, 4},
    ``run`` for ``warm`` rounds then ``run_fast`` for ``timed`` rounds
    from ``default_generator(0)`` — rounds/s, a 5-round profile, peak
    memory, the exchange bytes, the scatter kernel once a shard a round
    — each cell's final state and warm convergence curve equal to the
    d = 1 ``all_gather`` run's.  Then, each equal to its reference: the
    forced-sparse round at d = 4 ``ring`` and the digest-gated d = 4
    ``zoned`` round over the warm rounds (the gate's skip predicate on
    the host at the end, and the hops it skipped); ``run_pipelined`` at
    d = 4 against the single-device ``ExactSim``'s for 100 rounds; with
    push-pull past the horizon, every mode at d = 4 against ``ExactSim``
    for 50 rounds from the same draws; and the card against the CPU at
    n = ``cpu_n`` × 10 with loss 0.1 and push-pull every 10 rounds for
    ``cpu_rounds`` rounds.  Returns the launch counts of every run."""
    import math

    import torch

    from sidecar_tpu_torch.models.exact import (
        ExactSim,
        SimParams,
        clone_state,
    )
    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.ops.topology import erdos_renyi
    from sidecar_tpu_torch.parallel import ShardedSim

    p = SimParams(n=n, services_per_node=10, fanout=3, budget=15)
    topo = erdos_renyi(n, avg_degree=8.0, seed=3)
    all_counts, ref = [], None
    for mode, d in SHARDED_EXACT_RUNS:
        sim = ShardedSim(p, topo, d=d, board_exchange=mode)
        state = sim.init_state()
        gen = sim.default_generator(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state, conv = sim.run(state, warm, generator=gen)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_state = clone_state(state) if ref is None else None
        t0 = time.perf_counter()
        state = sim.run_fast(state, timed, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        all_counts.append(counts)
        peak = torch.cuda.max_memory_allocated()
        curve = curve_list(conv)
        final_conv = float(sim.convergence(state))
        if ref is None:
            ref = {"final": clone_state(state), "curve": curve,
                   "warm": warm_state, "conv": final_conv}
        diffs = exact_fields_differ(ref["final"], state)
        profile = profile_rounds(sim, state)
        ok = (not diffs and curve == ref["curve"]
              and counts == expected(scatter_max_apply=d * (warm + timed))
              and math.isfinite(final_conv) and 0.0 < final_conv <= 1.0)
        emit({"phase": "sharded_exact", "board_exchange": mode, "d": d,
              "n": n, "m": p.m, "warm_rounds": warm, "warm_s": warm_s,
              "rounds": timed, "wall_s": wall, "rounds_per_s": timed / wall,
              "max_memory_allocated": peak,
              "exchange_bytes_per_round": sim.exchange_bytes_per_round,
              "convergence": final_conv, "launches": counts,
              "field_diffs": diffs, "curve_equal": curve == ref["curve"],
              "profile": profile, "ok": ok})
        if not ok:
            raise SystemExit(f"sharded exact phase failed ({mode}, d={d})")
        del sim, state
    checks = {}

    def check(label, ok, counts, **info):
        all_counts.append(counts)
        checks[label] = dict(info, launches=counts, ok=bool(ok))

    # Forced sparse at d = 4 ring, and the digest-gated zoned exchange,
    # each over the warm rounds against the reference's warm state.
    for label, kw in (("sparse_forced_ring", dict(board_exchange="ring",
                                                  sparse="1")),
                      ("digest_gate_zoned", dict(board_exchange="zoned",
                                                 digest_gate=True))):
        sim = ShardedSim(p, topo, d=4, **kw)
        skipped, offered = [], []
        if label.startswith("digest"):
            gate_skips = sim._gate_skips

            def spy(shards, live, gate_skips=gate_skips):
                out = gate_skips(shards, live)
                skipped.append(len(out))
                offered.append(len(live))
                return out

            sim._gate_skips = spy
        reset_launches()
        t0 = time.perf_counter()
        st, conv = sim.run(sim.init_state(), warm,
                           generator=sim.default_generator(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        diffs = exact_fields_differ(ref["warm"], st)
        info = dict(field_diffs=diffs, rounds=warm,
                    ms_per_round=wall * 1e3 / warm,
                    curve_equal=curve_list(conv) == ref["curve"])
        if label.startswith("sparse"):
            info["sparse_stats"] = sim.last_sparse_stats.tolist()
        else:
            info.update(hops_skipped=sum(skipped),
                        hops_offered=sum(offered),
                        gate_predicates_at_end=sim.gate_predicates(
                            st).tolist())
        check(label, not diffs and info["curve_equal"]
              and counts == expected(scatter_max_apply=4 * warm),
              counts, **info)
        del sim, st

    # The pipelined round by delegation against ExactSim's, 100 rounds.
    reset_launches()
    twin = ShardedSim(p, topo, d=4, board_exchange="ring")
    a, ca, _ = twin.run_pipelined(twin.init_state(), 100,
                                  generator=twin.default_generator(0))
    single = ExactSim(p, topo)
    b, cb, _ = single.run_pipelined(single.init_state(), 100,
                                    generator=single.default_generator(0))
    torch.cuda.synchronize()
    counts = launches()
    diffs = exact_fields_differ(a, b)
    check("pipelined", not diffs and torch.equal(ca, cb)
          and counts == expected(scatter_max_apply=200), counts,
          field_diffs=diffs, rounds=100, convergence=float(ca[-1]))
    del twin, single, a, b

    # Push-pull past the horizon: every mode at d = 4 equals ExactSim.
    t_no_pp = TimeConfig(push_pull_interval_s=1e6)
    single = ExactSim(p, topo, t_no_pp)
    gen = single.default_generator(3)
    draws = [single.draw(gen, r) for r in range(1, 51)]
    reset_launches()
    want, want_conv = single.run(single.init_state(), 50, draws=draws)
    ok, diffs = True, {}
    for mode in ("all_gather", "ring", "zoned"):
        twin = ShardedSim(p, topo, t_no_pp, d=4, board_exchange=mode)
        got, got_conv = twin.run(twin.init_state(), 50, draws=draws)
        diffs[mode] = exact_fields_differ(want, got)
        ok = ok and not diffs[mode] and torch.equal(want_conv, got_conv)
        del twin, got
    torch.cuda.synchronize()
    counts = launches()
    check("exact_sim_no_push_pull", ok and counts == expected(
        scatter_max_apply=50 + 3 * 4 * 50), counts, field_diffs=diffs,
        rounds=50)
    del single, want, draws

    # The card against the CPU at n = cpu_n.
    pc = SimParams(n=cpu_n, services_per_node=10, fanout=3, budget=15,
                   drop_prob=0.1)
    tc = TimeConfig(push_pull_interval_s=2.0)
    topo_c = erdos_renyi(cpu_n, avg_degree=8.0, seed=3)
    cpu = ShardedSim(pc, topo_c, tc, d=4, board_exchange="ring",
                     device="cpu")
    gen = torch.Generator().manual_seed(1)
    draws = [cpu.draw(gen, r) for r in range(1, cpu_rounds + 1)]
    t0 = time.perf_counter()
    host, host_conv = cpu.run(cpu.init_state(), cpu_rounds, draws=draws)
    cpu_s = time.perf_counter() - t0
    reset_launches()
    ok, diffs, errs = True, {}, {}
    for mode in ("all_gather", "ring", "zoned"):
        card = ShardedSim(pc, topo_c, tc, d=4, board_exchange=mode)
        got, got_conv = card.run(card.init_state(), cpu_rounds,
                                 draws=draws)
        diffs[mode] = exact_fields_differ(got, host)
        errs[mode] = float((host_conv - got_conv.cpu()).abs().max())
        ok = ok and not diffs[mode] and errs[mode] <= 1e-6
        del card, got
    torch.cuda.synchronize()
    counts = launches()
    check("card_against_cpu", ok and counts == expected(
        scatter_max_apply=3 * 4 * cpu_rounds), counts, n=cpu_n,
        rounds=cpu_rounds, field_diffs=diffs, conv_max_abs_err=errs,
        cpu_s=cpu_s, push_pull_rounds=cpu._knobs.push_pull_rounds)
    ok = all(c["ok"] for c in checks.values())
    emit({"phase": "sharded_exact", "part": "equalities", **checks,
          "ok": ok})
    if not ok:
        raise SystemExit("sharded exact equalities failed")
    return all_counts


# -- phase 13: chaos and the partition hooks -----------------------------------

CHAOS_ROUNDS = 200
CHAOS_CONV_AT = (20, 80, 120, 200)
CONFIG5_SIDE = 1000                # mesh2d(1000, 1000): config 5's 1M nodes
CONFIG5_RUN = dict(split_rounds=150, heal_rounds=450, every=5, eps=1e-5)
EQUAL_ROUNDS = 50


def chaos_value_plan(n):
    """The config6-shaped plan scaled to ``n`` nodes, sides A (the lower
    half) and B: A→B loss 0.2 all run, a full split over rounds 20–80,
    B→A delay of 3 rounds at 0.1 with duplicates at 0.05, a pause of 64
    A nodes over rounds 30–60, a crash of 64 B nodes over rounds 40–70,
    a clock 30 s ahead with drift on 16 nodes over rounds 0–150, and a
    tombstone bomb from 8 A nodes against B over rounds 90–150 at rate
    0.2.  Returns ``(FaultPlan, AdversaryPlan)``."""
    from sidecar_tpu_torch.chaos import (
        AdversaryPlan,
        Attack,
        ClockFault,
        EdgeFault,
        FaultPlan,
        NodeFault,
    )

    a, b = tuple(range(n // 2)), tuple(range(n // 2, n))
    plan = FaultPlan(
        seed=6,
        edges=(EdgeFault(src=a, dst=b, drop_prob=0.2),
               EdgeFault(src=b, dst=a, delay_rounds=3, delay_prob=0.1,
                         duplicate_prob=0.05)),
        nodes=(NodeFault(nodes=a[64:128], start_round=30, end_round=60),
               NodeFault(nodes=b[64:128], start_round=40, end_round=70,
                         kind="crash")),
        clocks=(ClockFault(nodes=a[200:216], start_round=0, end_round=150,
                           offset_ticks=30_000,
                           drift_ticks_per_round=12.5),),
    ).with_edges(*FaultPlan.partition(a, b, 20, 80))
    adversary = AdversaryPlan(seed=6, attacks=(
        Attack("tombstone_bomb", nodes=a[-8:], victims=b, start_round=90,
               end_round=150, rate=0.2),))
    return plan, adversary


def chaos_time():
    """The default ``TimeConfig`` with the defences on: the future bound
    (0.5 s), the per-origin budget (2 suspicious records a packet, below
    the bomb's 3 forged columns) and the quarantine (16 violations)."""
    from sidecar_tpu_torch.models.timecfg import TimeConfig

    return TimeConfig(future_fudge_s=0.5, origin_budget=2,
                      origin_quarantine=16)


def chaos_fields_differ(a, b) -> list:
    """Names of the fields where two chaos states differ: the exact
    fields, the rings and the counters, compared on ``a``'s device."""
    import torch

    out = exact_fields_differ(a.sim, b.sim)
    for i, (ra, rb) in enumerate(zip(a.rings, b.rings)):
        out += [f"ring{i}.{k}" for k, x, y in zip(("rows", "cols", "vals"),
                                                  ra, rb)
                if not torch.equal(x, y.to(x.device))]
    return out + [f for f in ("injected_drops", "injected_delays",
                              "injected_dups", "rejected_future",
                              "forged_records", "rejected_budget",
                              "origin_violations")
                  if not torch.equal(getattr(a, f),
                                     getattr(b, f).to(getattr(a, f).device))]


def chaos_sim(n, plan, adversary, device=None, **kw):
    """The ``value`` workload's graph and params (ER(8, seed 3), 10
    services a node, fanout 3, budget 15) under ``plan``, with the side
    churn hook over rounds 30–60."""
    from sidecar_tpu_torch.chaos import ChaosExactSim
    from sidecar_tpu_torch.models.exact import SimParams
    from sidecar_tpu_torch.ops.topology import erdos_renyi
    from sidecar_tpu_torch.sim.scenarios import side_churn

    device = DEVICE if device is None else device
    p = SimParams(n=n, services_per_node=10, fanout=3, budget=15)
    t = kw.pop("timecfg", chaos_time())
    hook = side_churn(p, 0.02 / 10, seed=6, device=device)
    return ChaosExactSim(p, kw.pop("topo", None) or erdos_renyi(
        n, avg_degree=8.0, seed=3), t, plan, device=device, perturb=hook,
        adversary=adversary, **kw)


def chaos_scatter_point(sim, state) -> dict:
    """The scatter-max kernel on the chaos path's own input: one round
    from ``state`` (a clone) hands its triples — the immediate batch,
    each delay ring's matured batch with its sentinel rows ``N``, and the
    announce — to ``apply_updates``, which is watched to copy them and
    the pre-scatter ``known``/``sent``.  On copies of those, the kernel
    is held against its plain version and both are timed (repeated
    calls on the merged state).  Returns the counts of the round and the
    fields; ``equal`` is False where any cell differs."""
    import torch

    from sidecar_tpu_torch.ops import gossip as gossip_ops
    from sidecar_tpu_torch.ops.kernels import scatter_max as sm

    taken = []
    apply = gossip_ops.apply_updates

    def watch(known, sent, rows, cols, vals, adv):
        taken.append((known.clone(), sent.clone(), rows, cols, vals, adv))
        return apply(known, sent, rows, cols, vals, adv)

    reset_launches()
    gossip_ops.apply_updates = watch
    try:
        sim._run(sim._clone_state(state), 1, False,
                 sim.default_generator(8), None, False)
    finally:
        gossip_ops.apply_updates = apply
    torch.cuda.synchronize()
    counts = launches()
    known, sent, rows, cols, vals, adv = taken[0]
    n = known.shape[0]
    batch = sim.p.n * sim.p.fanout * min(sim.p.budget, sim.p.m)
    ring = rows[batch:batch * (1 + len(sim._prog.ring_specs))]
    want_k, want_s = known.clone(), sent.clone()
    sm.scatter_max_apply_torch(want_k, rows, cols, vals, want_s, adv)
    got_k, got_s = known, sent
    sm.scatter_max_apply_cuda(got_k, rows, cols, vals, got_s, adv)
    torch.cuda.synchronize()
    err = max_abs_diff([got_k, got_s], [want_k, want_s])
    equal = torch.equal(got_k, want_k) and torch.equal(got_s, want_s)
    turns = paired_ms({
        "ms": lambda: sm.scatter_max_apply_cuda(got_k, rows, cols, vals,
                                                got_s, adv),
        "plain_ms": lambda: sm.scatter_max_apply_torch(want_k, rows, cols,
                                                       vals, want_s, adv)})
    return counts, dict(
        updates=int(rows.numel()), sentinel_rows=int((rows == n).sum()),
        matured_ring_rows=int((ring < n).sum()),
        advanced=int(adv.sum()), max_abs_err=err, equal=equal, **turns)


def chaos_value(n=4096, rounds=CHAOS_ROUNDS, cpu_n=1024, cpu_rounds=30):
    """Part (a): the chaos round at the ``value`` size under the
    config6-shaped plan, and its equalities.  Returns ``(launch counts
    of each run, the line's fields)``."""
    import torch

    from sidecar_tpu_torch.chaos import FaultPlan
    from sidecar_tpu_torch.models.exact import ExactSim

    plan, adversary = chaos_value_plan(n)
    sim = chaos_sim(n, plan, adversary)
    all_counts, checks = [], {}

    def check(label, ok, counts, **info):
        all_counts.append(counts)
        checks[label] = dict(info, launches=counts, ok=bool(ok))

    # The straight run: 200 rounds with the convergence every round.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    straight, conv = sim.run(sim.init_state(), rounds,
                             generator=sim.default_generator(0))
    torch.cuda.synchronize()
    wall_conv = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    curve = curve_list(conv)
    injections = sim.injection_counts(straight)
    check("straight", counts == expected(scatter_max_apply=rounds)
          and all(0.0 <= c <= 1.0 for c in curve), counts, rounds=rounds)
    # 100 + 100 chunked rounds, no convergence samples: timed, and equal
    # to the straight run, rings and counters included.
    gen = sim.default_generator(0)
    reset_launches()
    t0 = time.perf_counter()
    half = sim.run_fast(sim.init_state(), rounds // 2, generator=gen)
    chunked = sim.run_fast(half, rounds - rounds // 2, generator=gen,
                           start_round=rounds // 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    diffs = chaos_fields_differ(straight, chunked)
    check("chunked_equals_straight", not diffs and counts == expected(
        scatter_max_apply=rounds), counts, field_diffs=diffs)
    del half, chunked
    # The profile and the host reads, from the end of the run.
    state = sim._clone_state(straight)
    profile = profile_rounds(sim, state)
    syncs = sync_points(lambda: sim._run(
        sim._clone_state(straight), 10, False, sim.default_generator(5),
        None, False))
    run_syncs = sync_points(lambda: sim.run_fast(
        sim._clone_state(straight), 10, generator=sim.default_generator(5)))
    del state
    # K4a on one round's own triples, sentinel rows included.
    counts, scatter = chaos_scatter_point(sim, straight)
    check("scatter_max_apply_on_chaos_triples", scatter["equal"]
          and scatter["sentinel_rows"] > 0
          and scatter["matured_ring_rows"] > 0
          and counts == expected(scatter_max_apply=1), counts, **scatter)

    # Two driver seeds consume the same fault draws.
    seen = {}
    round_fault = sim._round_fault
    reset_launches()
    for seed in (1, 2):
        got = seen.setdefault(seed, [])

        def spy(i, r, got=got):
            fd = round_fault(i, r)
            got.append(fd)
            return fd

        sim._round_fault = spy
        sim._run(sim.init_state(), 5, False, sim.default_generator(seed),
                 None, False)
    sim._round_fault = round_fault
    torch.cuda.synchronize()
    counts = launches()
    same = all(
        all((u is None and v is None) or torch.equal(u, v)
            for u, v in zip((x.drop_u,) + x.delay_u + x.dup_u,
                            (y.drop_u,) + y.delay_u + y.dup_u))
        for x, y in zip(seen[1], seen[2]))
    check("fault_draws_ignore_driver_seed", same and len(seen[1]) == 5
          and counts == expected(scatter_max_apply=10), counts, rounds=5)
    del straight

    # An empty plan equals ExactSim for the same draws.
    empty = chaos_sim(n, FaultPlan(seed=0), None)
    empty.perturb = None
    plain = ExactSim(empty.p, empty.topo, empty.t)
    gen = plain.default_generator(3)
    draws = [plain.draw(gen, r) for r in range(1, EQUAL_ROUNDS + 1)]
    reset_launches()
    a = empty.run_fast(empty.init_state(), EQUAL_ROUNDS, draws=draws)
    b = plain.run_fast(plain.init_state(), EQUAL_ROUNDS, draws=draws)
    torch.cuda.synchronize()
    counts = launches()
    diffs = exact_fields_differ(a.sim, b)
    check("empty_plan_equals_exact_sim", not diffs and counts == expected(
        scatter_max_apply=2 * EQUAL_ROUNDS), counts, field_diffs=diffs,
        rounds=EQUAL_ROUNDS)
    del empty, plain, a, b, draws

    # The card equals the CPU at n = cpu_n under the same plan.
    plan_c, adversary_c = chaos_value_plan(cpu_n)
    cpu = chaos_sim(cpu_n, plan_c, adversary_c, device="cpu")
    card = chaos_sim(cpu_n, plan_c, adversary_c, topo=cpu.topo)
    gen = torch.Generator().manual_seed(1)
    draws = [cpu.draw(gen, r) for r in range(1, cpu_rounds + 1)]
    faults = [cpu.fault_draw(r) for r in range(1, cpu_rounds + 1)]
    t0 = time.perf_counter()
    host, host_conv = cpu.run(cpu.init_state(), cpu_rounds, draws=draws,
                              fault_draws=faults)
    cpu_s = time.perf_counter() - t0
    reset_launches()
    got, got_conv = card.run(card.init_state(), cpu_rounds, draws=draws,
                             fault_draws=faults)
    torch.cuda.synchronize()
    counts = launches()
    diffs = chaos_fields_differ(host, got)
    err = float((host_conv - got_conv.cpu()).abs().max())
    check("card_against_cpu", not diffs and err <= 1e-6
          and counts == expected(scatter_max_apply=cpu_rounds), counts,
          n=cpu_n, rounds=cpu_rounds, field_diffs=diffs,
          conv_max_abs_err=err, cpu_s=cpu_s,
          injections=cpu.injection_counts(host))
    del cpu, card, host, got

    line = {"part": "value", "n": n, "m": sim.p.m, "rounds": rounds,
            "rounds_per_s": rounds / wall, "rounds_per_s_with_conv":
            rounds / wall_conv, "max_memory_allocated": peak,
            "injection_counts": injections,
            "convergence_at": {r: curve[r - 1] for r in CHAOS_CONV_AT
                               if r <= rounds},
            "host_syncs_per_round": sum((syncs or {}).values()) / 10,
            "host_syncs_round": syncs,
            "host_syncs_run_fast_10_rounds": run_syncs,
            "profile": profile, "checks": checks}
    ok = all(c["ok"] for c in checks.values()) and not syncs
    return all_counts, line, ok


def chaos_config6(rounds=CHAOS_ROUNDS, eps=1e-3):
    """Part (b): config6 at its own size, built by the port's
    ``sim/scenarios.py`` (``config6_sim``): n = 256, 4 services a node,
    the complete graph, push-pull every 2 s, A→B loss 0.2 and a full
    split over rounds 20–80, side-A churn over rounds 30–60; the card
    equal to the CPU from one set of draws, and the round at which ε is
    reached."""
    import torch

    from sidecar_tpu_torch.sim.scenarios import config6_sim

    n = 256
    cpu, card = config6_sim(n, 6, device="cpu"), config6_sim(n, 6,
                                                            device=DEVICE)
    p = cpu.p
    gen = torch.Generator().manual_seed(6)
    draws = [cpu.draw(gen, r) for r in range(1, rounds + 1)]
    faults = [cpu.fault_draw(r) for r in range(1, rounds + 1)]
    host, host_conv = cpu.run(cpu.init_state(), rounds, draws=draws,
                              fault_draws=faults)
    reset_launches()
    t0 = time.perf_counter()
    got, got_conv = card.run(card.init_state(), rounds, draws=draws,
                             fault_draws=faults)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    diffs = chaos_fields_differ(host, got)
    err = float((host_conv - got_conv.cpu()).abs().max())
    curve = curve_list(got_conv)
    hits = [i + 1 for i, c in enumerate(curve) if c >= 1.0 - eps]
    ok = (not diffs and err <= 1e-6
          and counts == expected(scatter_max_apply=rounds))
    return counts, {"part": "config6", "n": n, "m": p.m, "rounds": rounds,
                    "rounds_per_s": rounds / wall,
                    "eps": eps, "eps_round": hits[0] if hits else None,
                    "convergence_at": {r: curve[r - 1]
                                       for r in CHAOS_CONV_AT},
                    "field_diffs": diffs, "conv_max_abs_err": err,
                    "injection_counts": card.injection_counts(got),
                    "launches": counts}, ok


def config5_split_heal(side=CONFIG5_SIDE, split_rounds=150, heal_rounds=450,
                       every=5, eps=1e-5):
    """Part (c): config5 at the declared size, its params, graph, cut,
    sides, clock and burst from the port's ``sim/scenarios.py``
    (``config5_split_heal``): ``mesh2d(side, side)``, a burst of 1e-4 of
    the slots minted on side 0 at tick 10, ``split_rounds`` with the cut
    and the sides, then ``heal_rounds`` without the cut, fused, the
    convergence every ``every`` rounds; and K1 at this shape in turns
    with the unfused pair."""
    import torch

    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.sim import scenarios

    t0 = time.perf_counter()
    topo, halves, cut = scenarios.split_mesh(side)
    n = topo.n
    graph_s = time.perf_counter() - t0
    p, t = scenarios.config5_params(n), scenarios.CONFIG5_TIME
    split_sim = CompressedSim(p, topo, t, cut_mask=cut, node_side=halves)
    heal_sim = CompressedSim(p, topo, t)
    slots = scenarios.churn_slots(p, 1e-4, 5, halves == 0)
    gen = split_sim.default_generator(5)
    state = split_sim.mint(split_sim.init_state(), slots, 10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, conv_split = split_sim.run(state, split_rounds, every,
                                      generator=gen)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    split_counts = launches()
    split_profile = profile_rounds(split_sim, state)
    split_peak_bytes = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # K1 at this shape: the split's cache and a round's requests.
    failures = []
    src = split_sim._sample(state, split_sim.draw(
        split_sim.default_generator(21), state.round_idx + 1),
        state.round_idx + 1)
    gkw = dict(stale_ticks=t.stale_ticks, budget=min(p.budget, 64),
               limit=p.resolved_retransmit_limit(), fanout=p.fanout,
               cache_lines=p.cache_lines)
    k1 = fused_gather_point("config5 split", (state.cache_val,
                                              state.cache_slot,
                                              state.cache_sent), src,
                            state.round_idx * t.round_ticks, gkw, failures)
    del src
    k1_peak_bytes = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, conv_heal = heal_sim.run(state, heal_rounds, every,
                                    generator=gen)
    torch.cuda.synchronize()
    heal_s = time.perf_counter() - t0
    heal_counts = launches()
    heal_profile = profile_rounds(heal_sim, state)
    heal_peak_bytes = torch.cuda.max_memory_allocated()
    split_curve, heal_curve = curve_list(conv_split), curve_list(conv_heal)
    curve = split_curve + heal_curve
    hits = [(i + 1) * every for i, c in enumerate(curve) if c >= 1.0 - eps]
    split_peak = max(split_curve)
    ok = (split_peak < 1.0 and not failures
          and split_counts == expected(fused_publish_gather=split_rounds)
          and heal_counts == expected(fused_publish_gather=heal_rounds)
          and all(0.0 <= c <= 1.0 for c in curve))
    line = {"part": "config5", "n": n, "m": p.m, "cache_lines": 64,
            "burst": int(slots.size), "graph_s": graph_s,
            "split_rounds": split_rounds, "heal_rounds": heal_rounds,
            "split_peak_convergence": split_peak,
            "split_rounds_per_s": split_rounds / split_s,
            "heal_rounds_per_s": heal_rounds / heal_s,
            "eps": eps, "eps_round": hits[0] if hits else None,
            "convergence_every_5": curve,
            "split_profile": split_profile, "heal_profile": heal_profile,
            "fused_publish_gather_at_1m_x_64": k1,
            "max_memory_allocated": max(split_peak_bytes, heal_peak_bytes),
            "max_memory_allocated_split": split_peak_bytes,
            "max_memory_allocated_heal": heal_peak_bytes,
            "max_memory_allocated_k1_timing": k1_peak_bytes,
            "failures": failures,
            "launches": {"split": split_counts, "heal": heal_counts}}
    return [split_counts, heal_counts], line, ok


def config5_equalities(rounds=EQUAL_ROUNDS):
    """config5's round with the cut and the sides, each for ``rounds``
    rounds from one set of draws: on ``mesh2d(64, 64)`` fused equals
    unfused equals the CPU, and the compressed twin at d = 4 (``ring``,
    ``all_to_all``) equals the single device; ``ShardedSim`` at d = 4
    (``all_gather``, ``ring``, ``zoned``) equals d = 1 at n = 1,024 × 10
    on ``mesh2d(32, 32)``, push-pull every 10 rounds."""
    import torch

    from sidecar_tpu_torch.models.compressed import CompressedSim
    from sidecar_tpu_torch.models.exact import SimParams
    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.parallel import ShardedCompressedSim, ShardedSim
    from sidecar_tpu_torch.sim import scenarios

    all_counts, checks = [], {}

    def check(label, ok, counts, **info):
        all_counts.append(counts)
        checks[label] = dict(info, launches=counts, ok=bool(ok))

    topo, halves, cut = scenarios.split_mesh(64)
    kw = dict(cut_mask=cut, node_side=halves)
    p, t = scenarios.config5_params(topo.n), scenarios.CONFIG5_TIME
    slots = scenarios.churn_slots(p, 1e-2, 5, halves == 0)
    cpu = CompressedSim(p, topo, t, device="cpu", **kw)
    gen = torch.Generator().manual_seed(5)
    draws = [cpu.draw(gen, r) for r in range(1, rounds + 1)]
    host, host_b = cpu.run(cpu.mint(cpu.init_state(), slots, 10), rounds,
                           draws=draws)
    runs = {}
    for label, fused in (("fused", True), ("unfused", False)):
        sim = CompressedSim(p, topo, t, fused_gather=fused, **kw)
        reset_launches()
        runs[label] = sim.run(sim.mint(sim.init_state(), slots, 10),
                              rounds, draws=draws)
        torch.cuda.synchronize()
        counts = launches()
        diffs = states_equal(runs[label][0], host)
        err = float((host_b - runs[label][1].cpu()).abs().max())
        kernel = "fused_publish_gather" if fused else "publish_board"
        check(f"mesh64_{label}_equals_cpu", not diffs and err <= 1e-6
              and counts == expected(**{kernel: rounds}), counts,
              field_diffs=diffs, conv_max_abs_err=err)
    for mode in ("ring", "all_to_all"):
        twin = ShardedCompressedSim(p, topo, t, d=4, board_exchange=mode,
                                    **kw)
        reset_launches()
        got, got_b = twin.run(twin.mint(twin.init_state(), slots, 10),
                              rounds, draws=draws)
        torch.cuda.synchronize()
        counts = launches()
        diffs = states_equal(got, runs["fused"][0])
        dropped = twin.sync_exchange_metrics(got)
        check(f"twin_d4_{mode}_equals_single", not diffs and dropped == 0
              and torch.equal(got_b, runs["fused"][1])
              and counts == expected(publish_board=4 * rounds,
                                     board_row_gather=4 * rounds), counts,
              field_diffs=diffs, dropped=dropped)
        del twin, got
    del runs, host, cpu

    topo, halves, cut = scenarios.split_mesh(32)
    kw = dict(cut_mask=cut, node_side=halves)
    px = SimParams(n=topo.n, services_per_node=10, fanout=3, budget=15)
    tx = TimeConfig(push_pull_interval_s=2.0)
    ref = ShardedSim(px, topo, tx, d=1, **kw)
    gen = ref.default_generator(5)
    draws = [ref.draw(gen, r) for r in range(1, rounds + 1)]
    reset_launches()
    want, want_conv = ref.run(ref.init_state(), rounds, draws=draws)
    torch.cuda.synchronize()
    counts = launches()
    check("sharded_exact_d1", counts == expected(scatter_max_apply=rounds),
          counts)
    for mode in ("all_gather", "ring", "zoned"):
        twin = ShardedSim(px, topo, tx, d=4, board_exchange=mode, **kw)
        reset_launches()
        got, got_conv = twin.run(twin.init_state(), rounds, draws=draws)
        torch.cuda.synchronize()
        counts = launches()
        diffs = exact_fields_differ(want, got)
        check(f"sharded_exact_d4_{mode}_equals_d1", not diffs
              and torch.equal(want_conv, got_conv)
              and counts == expected(scatter_max_apply=4 * rounds), counts,
              field_diffs=diffs)
        del twin, got
    return all_counts, {"part": "config5_equalities", "rounds": rounds,
                        "checks": checks}, \
        all(c["ok"] for c in checks.values())


def phase_chaos(n=4096, cpu_n=1024):
    """The chaos phase: (a) the chaos round at the ``value`` size, (b)
    config6 at its own size, (c) config5's split and heal at the
    declared size with its equalities.  Returns the launch counts of
    every counted run, and the worst difference of each kernel held
    against its plain version on the chaos path's own input."""
    all_counts = []
    for part in (lambda: chaos_value(n, CHAOS_ROUNDS, cpu_n),
                 lambda: chaos_config6(CHAOS_ROUNDS),
                 lambda: config5_split_heal(CONFIG5_SIDE, **CONFIG5_RUN),
                 lambda: config5_equalities(EQUAL_ROUNDS)):
        counts, line, ok = part()
        all_counts += counts if isinstance(counts, list) else [counts]
        emit({"phase": "chaos", **line, "ok": ok})
        if not ok:
            raise SystemExit(f"chaos phase failed ({line['part']})")
        if line["part"] == "value":
            scatter_err = line["checks"][
                "scatter_max_apply_on_chaos_triples"]["max_abs_err"]
        if line["part"] == "config5":
            config5 = {"curve": line["convergence_every_5"],
                       "eps_round": line["eps_round"], "n": line["n"]}
    return all_counts, {"scatter_max_apply": scatter_err}, config5


# -- phase 14: the scenario fleet ------------------------------------------------

FLEET_ROUNDS = 100
FLEET_CPU_ROUNDS = 20
FLEET_COMPRESSED_SCENARIOS = 8


def sweep_grid_axes() -> dict:
    """``benchmarks/sweep.py``'s 64-point grid (``sweep_axes``): push-pull
    1/2/4/8 s × suspicion 0/2 s × loss 0/0.05/0.1/0.2 × limit 0/8."""
    return {"push_pull_interval_s": [1.0, 2.0, 4.0, 8.0],
            "suspicion_window_s": [0.0, 2.0],
            "drop_prob": [0.0, 0.05, 0.1, 0.2],
            "retransmit_limit": [0, 8]}


class _FleetProfiled:
    """What :func:`profile_rounds` asks of a sim, for a fleet, whose
    rounds draw from its own generators."""

    def default_generator(self, seed):
        return None

    def draw(self, generator, round_idx):
        return round_idx


def fleet_profile(fleet, state, rounds=5, **kw):
    """:func:`profile_rounds` of ``rounds`` fleet rounds from a copy of
    ``state``; ``kw`` goes to ``FleetSim.run`` (the timed run's
    convergence cadence)."""
    import types

    from sidecar_tpu_torch.fleet.engine import clone_batched

    def drive(st, draws):
        fleet.run(clone_batched(st.state), len(draws), **kw)

    return profile_rounds(_FleetProfiled(),
                          types.SimpleNamespace(round_idx=0, state=state),
                          rounds, drive=drive)


def fleet_breakdown(fleet, state, iters=3) -> dict:
    """ms of each part of one fleet round from ``state``, each alone
    (CUDA events, the median of ``iters``): the pre-round census, the
    S scenarios' draws (host), the batched round (on a copy of the
    state) and the convergence sample."""
    import torch

    from sidecar_tpu_torch.fleet.engine import clone_batched, state_rounds

    b = fleet.batch
    idx = list(range(b.size))
    r = state_rounds(state)[0] + 1

    def timed(fn):
        out = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(stop))
        return sorted(out)[len(out) // 2]

    t0 = time.perf_counter()
    draws = [fleet.draw(i, r) for i in idx]
    faults = [fleet.fault_draw(i, r) if fleet.family == "chaos" else None
              for i in idx]
    torch.cuda.synchronize()
    draws_ms = (time.perf_counter() - t0) * 1e3
    rounds = []
    for _ in range(iters):
        sub = clone_batched(state)
        rounds.append(timed(lambda: fleet._step(sub, idx, draws,
                                                faults)))
        del sub
    return {"census_ms": timed(lambda: fleet._census(state, idx)),
            "draws_host_ms": draws_ms,
            "round_ms": sorted(rounds)[len(rounds) // 2],
            "convergence_ms": timed(lambda: fleet.convergence(state))}


def fleet_scatter_point(fleet, state) -> tuple:
    """K4a on one fleet round's own batched triples: the round from a
    copy of ``state`` hands ``apply_updates`` its deliveries and announce
    over the ``[S·N, M]`` view, dropped rows at ``S·N``; on copies of
    the pre-scatter ``known``/``sent`` the kernel is held against its
    plain version and both are timed in turns.  Returns ``(launch
    counts of the round, fields)``."""
    import torch

    from sidecar_tpu_torch.fleet.engine import clone_batched
    from sidecar_tpu_torch.ops import gossip as gossip_ops
    from sidecar_tpu_torch.ops.kernels import scatter_max as sm

    taken = []
    apply = gossip_ops.apply_updates

    def watch(known, sent, rows, cols, vals, adv):
        taken.append((known.clone(), sent.clone(), rows, cols, vals, adv))
        return apply(known, sent, rows, cols, vals, adv)

    reset_launches()
    gossip_ops.apply_updates = watch
    try:
        fleet.run(clone_batched(state), 1, curve=False)
    finally:
        gossip_ops.apply_updates = apply
    torch.cuda.synchronize()
    counts = launches()
    known, sent, rows, cols, vals, adv = taken[0]
    s_n = known.shape[0]
    want_k, want_s = known.clone(), sent.clone()
    sm.scatter_max_apply_torch(want_k, rows, cols, vals, want_s, adv)
    got_k, got_s = known, sent
    sm.scatter_max_apply_cuda(got_k, rows, cols, vals, got_s, adv)
    torch.cuda.synchronize()
    err = max_abs_diff([got_k, got_s], [want_k, want_s])
    equal = torch.equal(got_k, want_k) and torch.equal(got_s, want_s)
    turns = paired_ms({
        "ms": lambda: sm.scatter_max_apply_cuda(got_k, rows, cols, vals,
                                                got_s, adv),
        "plain_ms": lambda: sm.scatter_max_apply_torch(want_k, rows, cols,
                                                       vals, want_s, adv)})
    return counts, dict(
        view_rows=s_n, updates=int(rows.numel()),
        sentinel_rows=int((rows == s_n).sum()),
        rows_beyond_view=int((rows > s_n).sum()),
        advanced=int(adv.sum()), max_abs_err=err, equal=equal, **turns)


def timed_fleet_run(fleet, rounds, **kw):
    """One fleet run from a fresh state on fresh generators, with the
    peak memory and the launches; returns ``(run, counts, peak)``."""
    import torch

    fleet.generators = fleet.batch.generators()
    state = fleet.init_states()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    run = fleet.run(state, rounds, **kw)
    torch.cuda.synchronize()
    return run, launches(), torch.cuda.max_memory_allocated()


def fleet_exact_grid(n=1024, rounds=FLEET_ROUNDS):
    """The 64-point grid as one batch (``benchmarks/sweep.py``'s: the
    complete graph, ``TimeConfig(refresh_interval_s=10_000)``, seed 0 at
    every point) at n × 10 services, fanout 3, budget 15: the batched
    run, the same points as 64 unbatched ``ExactSim`` runs from the same
    generators (each row equal, the sequential wall beside the
    batch's), a 5-round profile, K4a on a fleet round's own triples, and
    the run with early exit.  Returns ``(launch counts, line, ok, K4a's
    error)``."""
    import torch

    from sidecar_tpu_torch.fleet import FleetSim, ScenarioBatch, expand_grid
    from sidecar_tpu_torch.fleet.engine import scenario_state
    from sidecar_tpu_torch.models.exact import ExactSim, SimParams
    from sidecar_tpu_torch.models.timecfg import TimeConfig

    specs = expand_grid(sweep_grid_axes(), base={"seed": 0})
    p = SimParams(n=n, services_per_node=10, fanout=3, budget=15)
    batch = ScenarioBatch.build(specs, p,
                                TimeConfig(refresh_interval_s=10_000.0))
    s_n = batch.size
    all_counts, checks = [], {}

    def check(label, ok, counts, **info):
        all_counts.append(counts)
        checks[label] = dict(info, launches=counts, ok=bool(ok))

    fleet = FleetSim(batch)
    timed_fleet_run(fleet, 5, curve=False)      # warm-up
    run, counts, peak = timed_fleet_run(fleet, rounds, eps=0.01)
    check("batched", counts == expected(scatter_max_apply=rounds)
          and bool(torch.isfinite(torch.as_tensor(run.convergence)).all()),
          counts, rounds=rounds)
    # Every live scenario shares the round index, so an early-exit run
    # scatters once for each round it runs at all.
    stop, stop_counts, _ = timed_fleet_run(fleet, rounds, eps=0.01,
                                           stop=True)
    saved = int(s_n * rounds - stop.rounds.sum())
    live_diffs = {specs[i].name: exact_fields_differ(
        scenario_state(stop.final_states, i),
        scenario_state(run.final_states, i))
        for i in range(s_n) if stop.rounds[i] == rounds}
    live_diffs = {k: v for k, v in live_diffs.items() if v}
    # The unbatched runs stop at each frozen row's freeze round, are
    # compared there, and go on to the horizon.
    gens = batch.generators()
    diffs, frozen_diffs, conv_err, seq_s = {}, {}, 0.0, 0.0
    reset_launches()
    for i in range(s_n):
        period, phase = batch.scenario_cadence(i)
        sim = ExactSim(batch.scenario_params(i), fleet.topo,
                       batch.scenario_timecfg(i), tick_period=period,
                       tick_phase=phase)
        final = sim.init_state()
        convs = []
        for seg in sorted({int(stop.rounds[i]), rounds}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, conv = sim.run(final, seg - final.round_idx,
                                  generator=gens[i])
            torch.cuda.synchronize()
            seq_s += time.perf_counter() - t0
            convs.append(conv)
            if seg < rounds:
                d = exact_fields_differ(
                    scenario_state(stop.final_states, i), final)
                if d:
                    frozen_diffs[specs[i].name] = d
        conv = torch.cat(convs)
        d = exact_fields_differ(scenario_state(run.final_states, i), final)
        if d:
            diffs[specs[i].name] = d
        conv_err = max(conv_err, float(
            (conv.cpu() - torch.as_tensor(run.convergence[:, i])).abs()
            .max()))
        del sim, final
    counts = launches()
    check("rows_equal_unbatched_runs", not diffs and conv_err <= 1e-6
          and counts == expected(scatter_max_apply=s_n * rounds), counts,
          field_diffs=diffs, conv_max_abs_err=conv_err)
    frozen = int((stop.rounds < rounds).sum())
    check("early_exit", stop.eps_round == run.eps_round
          and 0 < frozen < s_n and not live_diffs and not frozen_diffs
          and stop_counts == expected(
              scatter_max_apply=int(stop.rounds.max())), stop_counts,
          rounds_saved=saved, host_reads=stop.host_reads, frozen=frozen,
          crossed=sum(e is not None for e in stop.eps_round),
          live_rows_differ=live_diffs, frozen_rows_differ=frozen_diffs,
          wall_s=stop.wall_seconds, last_round_run=int(stop.rounds.max()))
    del stop
    profile = fleet_profile(fleet, run.final_states)
    breakdown = fleet_breakdown(fleet, run.final_states)
    counts, scatter = fleet_scatter_point(fleet, run.final_states)
    check("scatter_max_apply_on_fleet_triples", scatter["equal"]
          and scatter["sentinel_rows"] > 0
          and not scatter["rows_beyond_view"]
          and counts == expected(scatter_max_apply=1), counts, **scatter)
    wall, full_eps = run.wall_seconds, run.eps_round
    del run
    line = {"part": "exact_grid", "scenarios": s_n, "n": n, "m": p.m,
            "rounds": rounds,
            "state_bytes": s_n * n * p.m * 5,
            "batched_wall_s": wall, "rounds_per_s": rounds / wall,
            "scenarios_per_s": s_n / wall,
            "sequential_wall_s": seq_s, "ratio_vs_sequential": seq_s / wall,
            "max_memory_allocated": peak, "eps_round": full_eps,
            "breakdown": breakdown, "profile": profile, "checks": checks}
    return all_counts, line, all(c["ok"] for c in checks.values()), \
        scatter["max_abs_err"]


def fleet_chaos_batch(n, device=None):
    """The chaos fleet's batch and graph: four scenarios under the
    ``chaos`` phase's plan at n × 10 services, the defences on, fault
    seeds 7–10 (one lossy, one churny); ER(8, seed 3)."""
    from sidecar_tpu_torch.fleet import ScenarioBatch, ScenarioSpec
    from sidecar_tpu_torch.models.exact import SimParams
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    plan, _ = chaos_value_plan(n)
    specs = [ScenarioSpec(name="fs7", seed=1, fault_seed=7),
             ScenarioSpec(name="fs8", seed=2, fault_seed=8),
             ScenarioSpec(name="fs9-lossy", seed=3, fault_seed=9,
                          drop_prob=0.05),
             ScenarioSpec(name="fs10-churny", seed=4, fault_seed=10,
                          churn_prob=0.002)]
    p = SimParams(n=n, services_per_node=10, fanout=3, budget=15)
    batch = ScenarioBatch.build(specs, p, chaos_time(), plan=plan,
                                device=DEVICE if device is None else device)
    return batch, erdos_renyi(n, avg_degree=8.0, seed=3)


def fleet_chaos(n=4096, rounds=FLEET_ROUNDS):
    """Four scenarios under the config6-shaped plan of the ``chaos``
    phase (its FaultPlan; the fleet has no adversary) at the ``value``
    size, the defences on, fault seeds 7–10 (one lossy, one churny):
    the batched run, and each row equal to its unbatched
    ``ChaosExactSim`` run, rings and counters included."""
    import torch

    from sidecar_tpu_torch.chaos import ChaosExactSim
    from sidecar_tpu_torch.fleet import (
        FleetSim,
        churn_seed,
        restart_churn_perturb,
    )
    from sidecar_tpu_torch.fleet.engine import scenario_state

    batch, topo = fleet_chaos_batch(n)
    specs, p = batch.specs, batch.params
    fleet = FleetSim(batch, topo)
    all_counts, checks = [], {}
    run, counts, peak = timed_fleet_run(fleet, rounds)
    all_counts.append(counts)
    checks["batched"] = dict(ok=counts == expected(
        scatter_max_apply=rounds), launches=counts)
    gens = batch.generators()
    diffs, seq_s, injections = {}, 0.0, []
    reset_launches()
    for i, spec in enumerate(specs):
        pi = batch.scenario_params(i)
        hook = None if not spec.churn_prob else restart_churn_perturb(
            pi, prob=spec.churn_prob, seed=churn_seed(spec.seed))
        sim = ChaosExactSim(pi, topo, batch.scenario_timecfg(i),
                            batch.scenario_plan(i), perturb=hook)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, conv = sim.run(sim.init_state(), rounds, generator=gens[i])
        torch.cuda.synchronize()
        seq_s += time.perf_counter() - t0
        d = chaos_fields_differ(scenario_state(run.final_states, i), final)
        err = float((conv.cpu() - torch.as_tensor(run.convergence[:, i]))
                    .abs().max())
        if d or err > 1e-6:
            diffs[spec.name] = dict(fields=d, conv_max_abs_err=err)
        injections.append(sim.injection_counts(final))
        del sim, final
    counts = launches()
    all_counts.append(counts)
    checks["rows_equal_unbatched_runs"] = dict(
        ok=not diffs and counts == expected(
            scatter_max_apply=len(specs) * rounds),
        launches=counts, diffs=diffs)
    profile = fleet_profile(fleet, run.final_states)
    breakdown = fleet_breakdown(fleet, run.final_states)
    wall = run.wall_seconds
    line = {"part": "chaos", "scenarios": len(specs), "n": n, "m": p.m,
            "rounds": rounds, "batched_wall_s": wall,
            "rounds_per_s": rounds / wall,
            "scenarios_per_s": len(specs) / wall,
            "sequential_wall_s": seq_s, "ratio_vs_sequential": seq_s / wall,
            "max_memory_allocated": peak, "injection_counts": injections,
            "convergence_at_end": [float(c) for c in run.convergence[-1]],
            "breakdown": breakdown, "profile": profile, "checks": checks}
    return all_counts, line, all(c["ok"] for c in checks.values())


def fleet_compressed(topo, rounds=FLEET_ROUNDS,
                     scenarios=FLEET_COMPRESSED_SCENARIOS, every=10):
    """``scenarios`` north-star scenarios as one batch (ER(8, seed 3),
    n = 100,000, M = 1,000,000, K = 256), each with its own seed and a
    0.1 % mint burst, limits 0/8 and push-pull 1/2 s: the fleet run (K1
    once per scenario a round), every row equal to its unbatched
    ``CompressedSim`` run from the same generator (their summed wall is
    the sequential baseline), and K1 on one scenario's slice of the
    stacked cache.  Returns ``(counts, line, ok, K1's error)``."""
    import torch

    from sidecar_tpu_torch.fleet import FleetSim, ScenarioBatch, ScenarioSpec
    from sidecar_tpu_torch.fleet.engine import scenario_state
    from sidecar_tpu_torch.models.compressed import CompressedSim

    p = bench_params(topo.n)
    specs = [ScenarioSpec(name=f"s{i}", seed=i + 1, mint_frac=0.001,
                          retransmit_limit=8 * (i % 2),
                          push_pull_interval_s=1.0 + (i // 2) % 2)
             for i in range(scenarios)]
    batch = ScenarioBatch.build(specs, p, bench_time(), family="compressed")
    fleet = FleetSim(batch, topo)
    all_counts, checks, failures = [], {}, []
    run, counts, peak = timed_fleet_run(fleet, rounds, conv_every=every)
    all_counts.append(counts)
    checks["batched"] = dict(ok=counts == expected(
        fused_publish_gather=scenarios * rounds), launches=counts,
        host_reads=run.host_reads)
    gens = batch.generators()
    diffs, seq_s = {}, 0.0
    reset_launches()
    for i in range(scenarios):
        sim = CompressedSim(batch.scenario_params(i), topo,
                            batch.scenario_timecfg(i))
        st = sim.mint(sim.init_state(), batch.mint_slots(i),
                      specs[i].mint_tick)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, conv = sim.run(st, rounds, every, generator=gens[i])
        torch.cuda.synchronize()
        seq_s += time.perf_counter() - t0
        d = states_equal(scenario_state(run.final_states, i), final)
        err = float((conv.cpu() - torch.as_tensor(run.convergence[:, i]))
                    .abs().max())
        if d or err > 1e-6:
            diffs[specs[i].name] = dict(fields=d, conv_max_abs_err=err)
        del sim, st, final
    counts = launches()
    all_counts.append(counts)
    checks["rows_equal_unbatched_runs"] = dict(
        ok=not diffs and counts == expected(
            fused_publish_gather=scenarios * rounds), launches=counts,
        rows=scenarios, diffs=diffs)
    # K1 on scenario 0's slice of the stacked cache, with its own draw.
    st0 = run.final_states
    h = batch.knobs.host[0]
    r = st0.round_idx[0] + 1
    sim0 = fleet.scenario_sims[0]
    src = sim0._sample(scenario_state(st0, 0), fleet.draw(0, r),
                       r).contiguous()
    cache = (st0.cache_val[0], st0.cache_slot[0], st0.cache_sent[0])
    gkw = dict(stale_ticks=h.stale_ticks, budget=min(p.budget, p.cache_lines),
               limit=h.limit, fanout=p.fanout, cache_lines=p.cache_lines)
    k1 = fused_gather_point("fleet scenario 0", cache, src,
                            r * batch.timecfg.round_ticks, gkw, failures)
    checks["fused_publish_gather_on_scenario_slice"] = dict(
        ok=not failures, failures=failures, **k1)
    profile = fleet_profile(fleet, st0, conv_every=5)
    breakdown = fleet_breakdown(fleet, st0)
    wall = run.wall_seconds
    line = {"part": "compressed", "scenarios": scenarios, "n": p.n,
            "m": p.m, "k": p.cache_lines, "rounds": rounds,
            "batched_wall_s": wall, "rounds_per_s": rounds / wall,
            "scenarios_per_s": scenarios / wall,
            "sequential_wall_s": seq_s, "ratio_vs_sequential": seq_s / wall,
            "max_memory_allocated": peak,
            "convergence_at_end": [float(c) for c in run.convergence[-1]],
            "breakdown": breakdown, "profile": profile, "checks": checks}
    return all_counts, line, all(c["ok"] for c in checks.values()), \
        k1["max_abs_err"]


def fleet_small_batch(family, device, n):
    """A three-scenario batch of ``family`` (exact, chaos or compressed)
    at ``n`` nodes on ``device``."""
    import dataclasses

    from sidecar_tpu_torch.chaos import EdgeFault, FaultPlan, NodeFault
    from sidecar_tpu_torch.fleet import ScenarioBatch, ScenarioSpec
    from sidecar_tpu_torch.models.compressed import CompressedParams
    from sidecar_tpu_torch.models.exact import SimParams
    from sidecar_tpu_torch.models.timecfg import TimeConfig

    base = TimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
    quick = dict(push_pull_interval_s=1.0, suspicion_window_s=1.0,
                 alive_lifespan_s=2.0, sweep_interval_s=0.4)
    plan = None
    if family == "compressed":
        p = CompressedParams(n=n, services_per_node=4, cache_lines=32)
        specs = [ScenarioSpec(name="b", seed=2, mint_frac=0.02,
                              drop_prob=0.1, retransmit_limit=8),
                 ScenarioSpec(name="a", seed=1, mint_frac=0.02),
                 ScenarioSpec(name="c", seed=3, mint_frac=0.05, **quick)]
    else:
        p = SimParams(n=n, services_per_node=4, fanout=3, budget=8)
        specs = [ScenarioSpec(name="a", seed=1),
                 ScenarioSpec(name="c", seed=3, future_fudge_s=0.5,
                              origin_budget=1, **quick),
                 ScenarioSpec(name="b", seed=2, drop_prob=0.1,
                              churn_prob=0.02, retransmit_limit=8)]
        if family == "chaos":
            a, b = tuple(range(n // 2)), tuple(range(n // 2, n))
            plan = FaultPlan(
                seed=5,
                edges=(EdgeFault(src=a, dst=b, drop_prob=0.2),
                       EdgeFault(src=b, dst=a, delay_rounds=2,
                                 delay_prob=0.2, duplicate_prob=0.1)),
                nodes=(NodeFault(nodes=(3, 4), start_round=4, end_round=9,
                                 kind="crash"),))
            specs = [dataclasses.replace(s, fault_seed=5 + i)
                     for i, s in enumerate(specs)]
    batch = ScenarioBatch.build(
        specs, p, base, family="compressed" if family == "compressed"
        else "exact", plan=plan, device=device)
    return batch


def fleet_card_against_cpu(n=256, rounds=FLEET_CPU_ROUNDS):
    """A small batch of each family on the card and on the CPU from one
    set of inputs drawn on the CPU (round draws, churn masks, fault
    draws), with and without early exit: every field, the stats and the
    curves equal; K4a once a round, or K1 once per scenario a round.
    ``eps`` freezes the middle scenario mid-run while the others run on
    (its rows are then not a run of consecutive positions), so the early
    exit's subset rounds are held to the CPU too."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.fleet import FleetSim, restart_churn_perturb

    out, all_counts = {}, []
    for family in ("exact", "chaos", "compressed"):
        cpu_b = fleet_small_batch(family, "cpu", n)
        gpu_b = fleet_small_batch(family, DEVICE, n)
        probe = FleetSim(cpu_b)
        draws = [[probe.draw(i, r) for r in range(1, rounds + 1)]
                 for i in range(cpu_b.size)]
        faults = None if cpu_b.plan is None else [
            [probe.fault_draw(i, r) for r in range(1, rounds + 1)]
            for i in range(cpu_b.size)]
        gen = torch.Generator().manual_seed(4)
        p = cpu_b.params
        masks = [{r: torch.rand(p.m, generator=gen) < s.churn_prob
                  for r in range(1, rounds + 1)} if s.churn_prob else None
                 for s in cpu_b.specs]
        hook = None if family == "compressed" else \
            restart_churn_perturb(p, masks=masks)
        eps = 0.003 if family == "compressed" else 0.45
        for stop in (False, True):
            cpu = FleetSim(cpu_b, perturb=hook)
            gpu = FleetSim(gpu_b, perturb=hook)
            t0 = time.perf_counter()
            a = cpu.run(cpu.init_states(), rounds, eps=eps, stop=stop,
                        draws=draws, fault_draws=faults)
            cpu_s = time.perf_counter() - t0
            reset_launches()
            b = gpu.run(gpu.init_states(), rounds, eps=eps, stop=stop,
                        draws=draws, fault_draws=faults)
            torch.cuda.synchronize()
            counts = launches()
            all_counts.append(counts)
            diffs = fleet_leaves_differ(a.final_states, b.final_states)
            err = float(abs(a.convergence - b.convergence).max())
            # The live scenarios share the round index: one K4a launch
            # for each round run at all.
            want = (expected(fused_publish_gather=int(a.rounds.sum()))
                    if family == "compressed" else
                    expected(scatter_max_apply=int(a.rounds.max())))
            mixed = not stop or (min(a.rounds) < rounds == max(a.rounds))
            out[f"{family}{'_stop' if stop else ''}"] = dict(
                ok=not diffs and err <= 1e-6 and counts == want and mixed
                and list(a.rounds) == list(b.rounds)
                and a.eps_round == b.eps_round
                and np.array_equal(a.exchange_bytes, b.exchange_bytes)
                and np.array_equal(a.frontier_max, b.frontier_max),
                field_diffs=diffs, conv_max_abs_err=err,
                rounds=[int(x) for x in a.rounds], launches=counts,
                cpu_s=cpu_s)
    return all_counts, out


def fleet_leaves_differ(a, b) -> list:
    """Names of the fields (rings and counters included) where two
    batched fleet states differ, compared on the CPU."""
    import torch

    from sidecar_tpu_torch import convert

    def flat(x, prefix=""):
        out = {}
        for k, v in x.items():
            if isinstance(v, dict):
                out.update(flat(v, k + "."))
            elif isinstance(v, list):
                for i, ring in enumerate(v):
                    for j, t in enumerate(ring):
                        out[f"ring{i}.{j}"] = t
            else:
                out[prefix + k] = v
        return out

    x = flat(convert.fleet_state_to_numpy(a))
    y = flat(convert.fleet_state_to_numpy(b))
    return [k for k in x if not torch.equal(torch.as_tensor(x[k]),
                                            torch.as_tensor(y[k]))]


def phase_fleet(topo, n=1024, chaos_n=4096):
    """The fleet phase: the exact grid, the chaos and compressed fleets,
    and card against CPU, each its own line.  Returns the launch counts
    of every counted run and each kernel's worst difference on the
    fleet's own inputs."""
    all_counts, errs = [], {}
    t0 = time.perf_counter()
    counts, line, ok, errs["scatter_max_apply"] = fleet_exact_grid(n)
    all_counts += counts
    emit({"phase": "fleet", **line, "ok": ok})
    if not ok:
        raise SystemExit("fleet phase failed (exact_grid)")
    counts, line, ok = fleet_chaos(chaos_n)
    all_counts += counts
    emit({"phase": "fleet", **line, "ok": ok})
    if not ok:
        raise SystemExit("fleet phase failed (chaos)")
    counts, line, ok, errs["fused_publish_gather"] = fleet_compressed(topo)
    all_counts += counts
    emit({"phase": "fleet", **line, "ok": ok})
    if not ok:
        raise SystemExit("fleet phase failed (compressed)")
    counts, checks = fleet_card_against_cpu()
    all_counts += counts
    ok = all(c["ok"] for c in checks.values())
    emit({"phase": "fleet", "part": "card_against_cpu", "checks": checks,
          "phase_s": time.perf_counter() - t0, "ok": ok})
    if not ok:
        raise SystemExit("fleet phase failed (card_against_cpu)")
    return all_counts, errs


# -- phase 15: the autopilot ------------------------------------------------------

AUTOPILOT_RULES = ("converge <= 30 rounds", "agreement >= 0.99")


def autopilot_time():
    """The live cluster's status-quo clock (``benchmarks/autopilot.py``):
    the default 20 s push-pull, refresh pinned out."""
    from sidecar_tpu_torch.models.timecfg import TimeConfig

    return TimeConfig(refresh_interval_s=10_000.0)


def warm_state(sim):
    """A chaos sim's state once its cluster has run a while: every node
    holds every record at its boot stamp, each record already sent its
    retransmit limit times, so nothing is left to gossip (the exact
    model's form of the compressed model's converged boot)."""
    from sidecar_tpu_torch.ops.status import ALIVE, pack

    state = sim.init_state()
    state.sim.known.fill_(pack(1, ALIVE))
    state.sim.sent.fill_(sim.p.resolved_retransmit_limit())
    return state


def traced_estimate(sim, rounds, seed, draws=None, fault_draws=None,
                    warm=False):
    """The live cluster observed: ``rounds`` traced rounds of ``sim``
    from a cold start, or from :func:`warm_state` with ``warm`` (from
    ``default_generator(seed)``, or the given draws), then
    ``fit_from_trace``.  Returns ``(estimate, trace_s, fit_s)``."""
    import torch

    from sidecar_tpu_torch.autopilot import fit_from_trace
    from sidecar_tpu_torch.ops.trace import trace_to_dicts

    gen = None if draws is not None else sim.default_generator(seed)
    start = warm_state(sim) if warm else sim.init_state()
    t0 = time.perf_counter()
    final, tr, _ = sim.run_with_trace(start, rounds, cap=rounds,
                                      generator=gen, draws=draws,
                                      fault_draws=fault_draws)
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = fit_from_trace(trace_to_dicts(tr), params=sim.p,
                         injections=sim.injection_counts(final),
                         timecfg=sim.t)
    return est, trace_s, time.perf_counter() - t0


def rows_differ(a: list, b: list) -> list:
    """Where two reports' candidate rows differ: every field exact but
    ``final_convergence`` (float32 sums, within 1e-6)."""
    out = []
    for i, (x, y) in enumerate(zip(a, b)):
        for k in x["row"]:
            u, v = x["row"][k], y["row"].get(k)
            same = abs(u - v) <= 1e-6 if k == "final_convergence" \
                else u == v
            if not same:
                out.append(f"{i}.{k}")
        if (x["candidate"], x["score"], x["slo"]) != \
                (y["candidate"], y["score"], y["slo"]):
            out.append(f"{i}.score")
    return out + (["length"] if len(a) != len(b) else [])


def autopilot_card_against_cpu(n=64, trace_rounds=40, rounds=30):
    """The closed loop at ``n`` on the card and on the CPU from one set
    of inputs: the trace from the CPU sim's draws and fault draws (the
    side churn's masks are the hook's own CPU draws), then ``recommend``
    with every dispatch fed one set of inputs drawn on the CPU
    (``fleet.cpu_inputs``).  The estimate, every candidate's row and
    score, and the winner must be equal."""
    import torch

    from sidecar_tpu_torch.autopilot import AutopilotController, search
    from sidecar_tpu_torch.fleet import cpu_inputs
    from sidecar_tpu_torch.sim.scenarios import config6_sim

    t = autopilot_time()
    cpu, card = config6_sim(n, 6, timecfg=t, device="cpu"), \
        config6_sim(n, 6, timecfg=t, device=DEVICE)
    gen = torch.Generator().manual_seed(6)
    draws = [cpu.draw(gen, r) for r in range(1, trace_rounds + 1)]
    faults = [cpu.fault_draw(r) for r in range(1, trace_rounds + 1)]
    reports, rows = [], []
    run_batch = search.FleetEvaluator._run_batch
    evaluate = search.FleetEvaluator.evaluate

    def one_set_run_batch(self, batch):
        return run_batch(self, batch, cpu_inputs(batch, self.rounds))

    def evaluate_kept(self, candidates, tag):
        out = evaluate(self, candidates, tag)
        rows[-1].extend(r.to_json() for r in out)
        return out

    search.FleetEvaluator._run_batch = one_set_run_batch
    search.FleetEvaluator.evaluate = evaluate_kept
    try:
        for sim, device in ((cpu, "cpu"), (card, DEVICE)):
            est, _, _ = traced_estimate(sim, trace_rounds, 6, draws, faults)
            rows.append([])
            reset_launches()
            reports.append(AutopilotController(timecfg=t).recommend(
                rules=list(AUTOPILOT_RULES), estimate=est, n=n,
                rounds=rounds, seed=6, generations=1, population=4,
                device=device))
            torch.cuda.synchronize()
            counts = launches()     # the card's pass is the last
    finally:
        search.FleetEvaluator._run_batch = run_batch
        search.FleetEvaluator.evaluate = evaluate
    host, got = reports
    diffs = rows_differ(*rows)
    same = {k: host[k] == got[k] for k in (
        "estimate", "axes", "fault_plan", "evaluations", "dispatches",
        "grid_points", "candidates")}
    same["recommended"] = host["recommended"]["candidate"] == \
        got["recommended"]["candidate"]
    # One K4a a round of each dispatch, and the replay's rounds.
    want = expected(scatter_max_apply=rounds * (got["dispatches"] + 1))
    ok = not diffs and all(same.values()) and counts == want
    return counts, {"n": n, "trace_rounds": trace_rounds, "rounds": rounds,
                    "rows": len(rows[1]), "row_diffs": diffs, "equal": same,
                    "estimate": got["estimate"],
                    "recommended": got["recommended"]["candidate"],
                    "launches": counts, "ok": ok}


# The fitted paused share the phase accepts: the live cluster pauses no
# node, so a larger share is a misfit (a backlog read as paused nodes).
MAX_FITTED_PAUSE = 0.01


def phase_autopilot(n=4096, trace_rounds=240, rounds=60, seed=6,
                    generations=2, population=6):
    """``benchmarks/autopilot.py``'s closed loop through the port at
    ``n`` nodes × 4 services: the config6-shaped live cluster of
    ``sim/scenarios.py`` (20 % A→B loss, a split over rounds 20–80,
    side-A churn over rounds 30–60) on the status-quo clock, traced for
    ``trace_rounds`` rounds from a warm start and fitted.  The bench's
    120 rounds from a cold start leave this size's cluster unconverged,
    and 120 from a warm start leave the heal's backlog; the pause fit
    reads either as paused nodes, so both fits are printed beside the
    one used, whose paused share must stay within
    :data:`MAX_FITTED_PAUSE`.  Then ``recommend`` with the default axes
    and rules (``rounds``, ``seed``, ``generations`` of
    ``population``), timing each dispatch, the scoring and the host
    digest apart, and the replay; the winner's replay must be identical,
    and K4a must launch once a round of every trace, of every dispatch
    and of the replay.  Then the card against the CPU at n = 64."""
    import torch

    from sidecar_tpu_torch.autopilot import AutopilotController, search
    from sidecar_tpu_torch.autopilot import controller
    from sidecar_tpu_torch.fleet import engine
    from sidecar_tpu_torch.sim.scenarios import config6_sim

    t_phase = time.perf_counter()
    cfg = autopilot_time()
    sim = config6_sim(n, seed, timecfg=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    traces = ((False, 120), (True, 120), (True, trace_rounds))
    fits = {}     # the last is the one ``recommend`` takes
    for warm, length in traces:
        est, trace_s, fit_s = traced_estimate(sim, length, seed, warm=warm)
        fits[f"{'warm' if warm else 'cold'}_{length}"] = {
            **est.to_json(), "trace_s": trace_s}
    trace_counts = launches()
    del sim

    dispatch_s, table_s, digest_s, replay_s, dispatched = [], [], [], [], []
    run_batch = search.FleetEvaluator._run_batch
    table = engine.FleetRun.table
    digest = engine.FleetRun.digest_agreement
    replay = controller.replay_check

    def timed(fn, into):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return wrapper

    def run_batch_kept(self, batch):
        out = timed(run_batch, dispatch_s)(self, batch)
        dispatched.append((batch, out[1].scenarios_per_sec))
        return out

    search.FleetEvaluator._run_batch = run_batch_kept
    engine.FleetRun.table = timed(table, table_s)
    engine.FleetRun.digest_agreement = timed(digest, digest_s)
    controller.replay_check = timed(replay, replay_s)
    reset_launches()
    try:
        report = AutopilotController(timecfg=cfg).recommend(
            rules=list(AUTOPILOT_RULES), estimate=est, n=n,
            services_per_node=4, fanout=3, budget=15, rounds=rounds,
            seed=seed, generations=generations, population=population)
    finally:
        search.FleetEvaluator._run_batch = run_batch
        engine.FleetRun.table = table
        engine.FleetRun.digest_agreement = digest
        controller.replay_check = replay
    torch.cuda.synchronize()
    counts = launches()
    peak = torch.cuda.max_memory_allocated()

    # A 5-round profile of one dispatch: the first batch, afresh.
    from sidecar_tpu_torch.fleet import FleetSim

    fleet = FleetSim(dispatched[0][0])
    profile = fleet_profile(fleet, fleet.init_states(), stop=False)
    del fleet

    card_counts, card_cpu = autopilot_card_against_cpu()
    base_r, rec = report["baseline"], report["recommended"]
    all_counts = [trace_counts, counts, card_counts]
    line = {
        "n": n, "services_per_node": 4, "trace_rounds": trace_rounds,
        "rounds": rounds, "seed": seed, "rules": report["rules"],
        "estimate": report["estimate"], "fault_plan": report["fault_plan"],
        "fits": fits,
        "baseline": {"candidate": base_r["candidate"],
                     "score": base_r["score"],
                     "pass": base_r["slo"]["pass"]},
        "recommended": {"candidate": rec["candidate"], "score": rec["score"],
                        "pass": rec["slo"]["pass"], "row": rec["row"]},
        "closed_loop": bool(rec["slo"]["pass"])
        and base_r["slo"]["pass"] is False,
        "evaluations": report["evaluations"],
        "dispatches": report["dispatches"],
        "grid_points": report["grid_points"],
        "eval_ratio": report["evaluations"] / report["grid_points"],
        "replay": report["replay"],
        "trace_s": trace_s, "fit_s": fit_s,
        "dispatch_s": dispatch_s,
        "dispatch_scenarios": [b.size for b, _ in dispatched],
        "scenarios_per_s": [r for _, r in dispatched],
        "scoring_s_without_digest": sum(table_s) - sum(digest_s),
        "host_digest_s": sum(digest_s), "host_digest_rows": len(digest_s),
        "replay_s": sum(replay_s),
        "recommend_wall_s": report["wall_seconds"],
        "max_memory_allocated": peak, "dispatch_profile": profile,
        "launches": {"trace": trace_counts, "recommend": counts},
        "card_against_cpu": card_cpu,
        "phase_s": time.perf_counter() - t_phase}
    # K4a once a round of every trace, of every dispatch and of the
    # replay.
    ok = (report["replay"]["identical"] and card_cpu["ok"]
          and est.paused_frac <= MAX_FITTED_PAUSE
          and trace_counts == expected(
              scatter_max_apply=sum(length for _, length in traces))
          and counts == expected(scatter_max_apply=rounds * (
              report["dispatches"] + 1)))
    emit({"phase": "autopilot", **line, "ok": ok})
    if not ok:
        raise SystemExit("autopilot phase failed")
    return all_counts


# -- phase 16: the scenario configs --------------------------------------------------

CHECKPOINT_AT = 600


def phase_scenarios(scale=1.0):
    """``sim/scenarios.py``'s configs through the port's module on the
    card at ``scale`` (1.0: the declared sizes), all but config5 (the
    ``chaos`` phase runs it): each summary with its rounds/s, peak
    memory and launches — K1 once a round of config4, K4a once a round
    of the others — and config4's BA graph build time alone; then
    config3 checkpointed at round 600 with its generator, loaded, and
    run to its end, equal to the straight run."""
    import tempfile

    import torch

    from sidecar_tpu_torch.ops.topology import barabasi_albert
    from sidecar_tpu_torch.sim import checkpoint, scenarios

    all_counts = []
    t_phase = time.perf_counter()
    for name in scenarios.ALL_SCENARIOS:
        if name == "config5":
            continue
        extra = {}
        if name == "config4":
            t0 = time.perf_counter()
            barabasi_albert(max(128, int(65_536 * scale)), m=3, seed=4)
            extra["graph_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        result = scenarios.run_one(name, scale)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        all_counts.append(counts)
        kernel = "fused_publish_gather" if name == "config4" \
            else "scatter_max_apply"
        want = expected(**{kernel: result.rounds_run})
        curve = result.convergence
        ok = counts == want and len(curve) and bool(
            ((curve >= 0) & (curve <= 1)).all())
        emit({"phase": "scenarios", "config": name, **result.summary(),
              "rounds_per_s": result.rounds_per_sec, "call_s": wall,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": counts, **extra, "ok": bool(ok)})
        if not ok:
            raise SystemExit(f"scenarios phase failed ({name})")
        del result

    # config3 through a checkpoint: 600 rounds, save with the generator,
    # load into a fresh sim, the rest; equal to the straight run.
    rounds = 1200
    sim = scenarios.config3_sim(rounds, scale)
    reset_launches()
    straight = sim.run_fast(sim.init_state(), rounds,
                            generator=sim.default_generator(3))
    gen = sim.default_generator(3)
    half = sim.run_fast(sim.init_state(), CHECKPOINT_AT, generator=gen)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/config3.npz"
        t0 = time.perf_counter()
        checkpoint.save_state(path, half, sim.p, generator=gen)
        save_s = time.perf_counter() - t0
        del half
        gen2 = torch.Generator(device=DEVICE)
        t0 = time.perf_counter()
        loaded, params = checkpoint.load_state(path, generator=gen2)
        load_s = time.perf_counter() - t0
    resumed = scenarios.config3_sim(rounds, scale).run_fast(
        loaded, rounds - CHECKPOINT_AT, generator=gen2)
    torch.cuda.synchronize()
    counts = launches()
    all_counts.append(counts)
    diffs = exact_fields_differ(straight, resumed)
    ok = not diffs and params == sim.p and counts == expected(
        scatter_max_apply=2 * rounds)
    emit({"phase": "scenarios", "config": "config3_checkpoint",
          "checkpoint_at": CHECKPOINT_AT, "rounds": rounds,
          "field_diffs": diffs, "save_s": save_s, "load_s": load_s,
          "launches": counts, "phase_s": time.perf_counter() - t_phase,
          "ok": ok})
    if not ok:
        raise SystemExit("scenarios phase failed (config3_checkpoint)")
    return all_counts


def row_gather_variants(k: int = 256) -> dict:
    """Rows a pass → the ``(source, macro definitions)`` build of the
    row-gather kernel with that window."""
    return {w: ("publish_gather",
                (f"-DSIDECAR_ROW_GATHER_WINDOW_BYTES={w * 2 * k * 4}",))
            for w in ROW_GATHER_WINDOWS}


def phase_row_gather_windows(n: int, k: int = 256, f: int = 3,
                              iters: int = 20):
    """The row-gather kernel built with each window of
    ``ROW_GATHER_WINDOWS`` (one ``nvcc`` each, started with the build
    phase's), held against its plain version and timed at the sharded
    north star's shapes on a random board and uniform peers: d=1 (the
    whole board), d=4 (shard 2's own block at base 2·nl) and
    all_gather's d=4 (the whole board, shard 2's requests); beside the
    unmasked ``index_select`` pair.  Then the fused publish gather,
    whose gather pass walks the same windows, at the north star's shape
    with the same requests.  Launches the entry points directly: no
    wrapper's count moves."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.ops.kernels import build
    from sidecar_tpu_torch.ops.kernels import publish_gather as pg

    variants = row_gather_variants(k)
    t0 = time.perf_counter()
    build.build((), list(variants.values()))
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    bval = torch.randint(0, 1 << 20, (n, k), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    bslot = torch.randint(-1, 1 << 20, (n, k), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    src = torch.randint(0, n, (n, f), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    nl = n // 4
    blk = slice(2 * nl, 3 * nl)
    shapes = {"d=1": (bval, bslot, src, 0),
              "d=4": (bval[blk], bslot[blk], src[blk], 2 * nl),
              "all_gather d=4": (bval, bslot, src[blk], 0)}
    failures = []
    times = {}
    for label, (bv, bs, sr, base) in shapes.items():
        want = pg.board_row_gather_torch(bv, bs, sr, base)
        flat = torch.clamp(sr.to(torch.int64) - base, 0,
                           bv.shape[0] - 1).reshape(-1)
        row = {"index_select_pair_ms": cuda_time_ms(lambda: (
            torch.index_select(bv, 0, flat),
            torch.index_select(bs, 0, flat)), iters)}
        pv = bv.new_empty((sr.shape[0], f, k))
        ps = torch.empty_like(pv)
        for w, variant in variants.items():
            entry = build.load(*variant).sidecar_board_row_gather

            def call():
                build.launch("board_row_gather_kernel launch", entry,
                             bv.get_device(), bv.data_ptr(), bs.data_ptr(),
                             sr.data_ptr(), bv.shape[0], sr.numel(), k,
                             base, pv.data_ptr(), ps.data_ptr())

            pv.fill_(7)
            ps.fill_(7)
            call()
            torch.cuda.synchronize()
            if not (torch.equal(pv, want[0]) and torch.equal(ps, want[1])):
                failures.append(f"window {w} {label}")
            row[f"window_{w}_ms"] = cuda_time_ms(call, iters)
        times[label] = row
        del want, pv, ps
    # K1's gather pass walks the same windows: the fused entry point on a
    # random cache with the same requests, beside the shipped window.
    rng = np.random.default_rng(22)
    cv, cs, se = to_cuda(random_cache(rng, n, k))
    gkw = dict(stale_ticks=10_860_000, budget=15, limit=20, fanout=f,
               cache_lines=k)
    now = 1 << 22
    want = pg.fused_publish_gather_torch(cv, cs, se, src, now, **gkw)
    mask = cv.new_empty((n, k // 32))
    sent, pv, ps = (torch.empty_like(t) for t in want)
    row = {}
    for w, variant in variants.items():
        entry = build.load(*variant).sidecar_fused_publish_gather

        def call():
            build.launch("fused publish gather launch", entry,
                         cv.get_device(), cv.data_ptr(), cs.data_ptr(),
                         se.data_ptr(), src.data_ptr(), n, f, k, 15, 20, f,
                         now, gkw["stale_ticks"], mask.data_ptr(),
                         sent.data_ptr(), pv.data_ptr(), ps.data_ptr())

        pv.fill_(7)
        call()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((sent, pv, ps), want)):
            failures.append(f"window {w} fused publish gather")
        row[f"window_{w}_ms"] = cuda_time_ms(call, iters)
    times["fused publish gather"] = row
    del want, sent, pv, ps, cv, cs, se
    emit({"phase": "row_gather_windows", "n": n, "k": k, "f": f,
          "build_seconds": build_s, "rows_per_window": ROW_GATHER_WINDOWS,
          "times": times, "failures": failures, "ok": not failures})
    if failures:
        raise SystemExit(f"row-gather window sweep failed: {failures}")


# -- phase 17: the simulator bridge --------------------------------------------------

BRIDGE_HOSTS, BRIDGE_SPN = 1024, 4
BRIDGE_SEED = 5


def synthetic_catalog(hosts, spn, seed) -> bytes:
    """The wire document (``ServicesState.encode()``, what ``GET
    /api/state.json`` serves) of a catalog of ``hosts`` × ``spn``
    services made with numpy from ``seed``: stamps over 10 s, 85 %
    Alive and 5 % each Draining, Unhealthy and Tombstone."""
    import numpy as np

    from sidecar_tpu_torch import service as svc
    from sidecar_tpu_torch.catalog import Server, ServicesState

    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000 * svc.NS_PER_SECOND
    stamps = t0 + rng.integers(0, 10 * svc.NS_PER_SECOND, (hosts, spn))
    statuses = rng.choice([svc.ALIVE, svc.DRAINING, svc.UNHEALTHY,
                           svc.TOMBSTONE], (hosts, spn),
                          p=[0.85, 0.05, 0.05, 0.05])
    state = ServicesState(hostname="host-0000", cluster_name="smoke")
    for h in range(hosts):
        name = f"host-{h:04d}"
        server = state.servers[name] = Server(name)
        for s in range(spn):
            sid = f"{name}-svc{s}"
            server.services[sid] = svc.Service(
                id=sid, name=f"app{s}", image="app:1", hostname=name,
                updated=int(stamps[h, s]), status=int(statuses[h, s]))
    return state.encode()


def post_json(port, route, payload):
    """POST ``payload`` to the bridge on 127.0.0.1; returns ``(status,
    body bytes)``."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


class BridgeTimer:
    """Wall time of the bridge's host steps, per request: the library
    call, each chunk's dispatch and read-back, the projection, and the
    server's JSON encode of the answer (the module's one ``json.dumps``,
    in the handler's reply)."""

    STEPS = {"simulate": "simulate", "sweep": "sweep",
             "autopilot_recommend": "recommend", "_dispatch": "dispatch",
             "_consume": "consume", "_project": "projection"}

    def __init__(self):
        from sidecar_tpu_torch.bridge import SimBridge

        self.cls, self.saved, self.acc = SimBridge, {}, {}
        for attr, label in self.STEPS.items():
            raw = SimBridge.__dict__[attr]
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw
            self.saved[attr] = raw
            wrapped = self._timed(fn, label)
            setattr(SimBridge, attr, staticmethod(wrapped)
                    if isinstance(raw, staticmethod) else wrapped)
        import types

        from sidecar_tpu_torch.bridge import sim_bridge

        self.module = sim_bridge
        sim_bridge.json = types.SimpleNamespace(
            dumps=self._timed(json.dumps, "encode"), loads=json.loads,
            JSONDecodeError=json.JSONDecodeError)

    def _timed(self, fn, label):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.acc[label] = self.acc.get(label, 0.0) + \
                    time.perf_counter() - t0
        return wrapper

    def take(self) -> dict:
        out, self.acc = self.acc, {}
        return out

    def restore(self):
        for attr, raw in self.saved.items():
            setattr(self.cls, attr, raw)
        self.module.json = json


def bridge_request(port, route, payload, timer, status=200):
    """One timed POST: the request's wall split into the library call's
    steps, the server's JSON encode and the remainder (the request's
    parse, HTTP both ways and the client's read); the response bytes,
    peak device memory and K4a's launches."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    timer.take()
    t0 = time.perf_counter()
    code, body = post_json(port, route, payload)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launches()
    steps = timer.take()
    doc = json.loads(body)
    lib = steps.get("simulate", steps.get("sweep", steps.get("recommend",
                                                              0.0)))
    line = {"route": route, "status": code, "wall_s": wall, **{
        f"{k}_s": v for k, v in steps.items()},
        "http_s": wall - lib - steps.get("encode", 0.0),
        "response_bytes": len(body),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "k4a_launches": counts["scatter_max_apply"]}
    if code != status:
        raise SystemExit(f"bridge: {route} answered {code}, expected "
                         f"{status}: {body[:300]!r}")
    return doc, counts, line


def simulate_summary(doc, line, rounds):
    """The printed figures of one ``/simulate`` answer."""
    conv = doc["convergence"]
    run_s = line.get("dispatch_s", 0.0) + line.get("consume_s", 0.0)
    return {**line, "rounds": rounds, "eps_round": doc["eps_round"],
            "final_convergence": conv[-1] if conv else None,
            "rounds_per_s": rounds / run_s if run_s > 0 else None,
            "finite": all(0.0 <= c <= 1.0 for c in conv)
            and len(conv) == rounds,
            "sparse": doc["sparse"]}


def bridge_card_against_cpu(hosts=64, spn=4, rounds=60):
    """Requests 1–5 at ``hosts`` × ``spn``, the card's bridge against the
    CPU's, equal reports: each ``/simulate`` fed one set of draws drawn
    on the CPU, each fleet dispatch one set of inputs drawn on the CPU
    (``fleet.cpu_inputs``)."""
    import torch

    from sidecar_tpu_torch.autopilot import search
    from sidecar_tpu_torch.bridge import SimBridge
    from sidecar_tpu_torch.catalog import decode
    from sidecar_tpu_torch.fleet import cpu_inputs
    from sidecar_tpu_torch.models.timecfg import TimeConfig

    state = decode(synthetic_catalog(hosts, spn, BRIDGE_SEED))
    pair = [SimBridge(state, TimeConfig(), device=d, shards=4)
            for d in ("cpu", DEVICE)]
    cold = sorted(state.servers)[::16]
    sims = {
        "long": dict(rounds=2 * rounds, cold_nodes=cold),
        "deltas_damping": dict(rounds=rounds, deltas_cap=256,
                               protocol={"damping_threshold": 2.0}),
        "digest": dict(rounds=rounds, digest=rounds, cold_nodes=cold),
        "provenance": dict(rounds=rounds, provenance={"count": 8},
                           cold_nodes=cold),
        "trace_sparse": dict(rounds=rounds, trace=rounds, sparse=True,
                             cold_nodes=cold),
        "sharded": dict(rounds=rounds, sharded=True, cold_nodes=cold),
    }
    for b in pair:
        b.CHUNK_ROUNDS = rounds
    run_sweep = SimBridge._run_sweep_batch
    run_batch = search.FleetEvaluator._run_batch
    SimBridge._run_sweep_batch = staticmethod(
        lambda batch, run_kw, inputs=None: run_sweep(
            batch, run_kw, cpu_inputs(batch, run_kw["num_rounds"])))
    search.FleetEvaluator._run_batch = \
        lambda self, batch: run_batch(self, batch,
                                      cpu_inputs(batch, self.rounds))
    equal = {}
    reset_launches()
    try:
        for name, kw in sims.items():
            _, _, _, sim = pair[0].snapshot(sharded=kw.get("sharded",
                                                           False))
            gen = torch.Generator().manual_seed(11)
            draws = [sim.draw(gen, r) for r in range(1, kw["rounds"] + 1)]
            a, b = (br.simulate(draws=draws, **kw).to_json()
                    for br in pair)
            equal[name] = a == b
        axes = {"push_pull_interval_s": [1.0, 2.0, 4.0, 8.0],
                "drop_prob": [0.0, 0.1]}
        a, b = (br.sweep(axes, rounds=rounds, slo=["converge <= 30 rounds"])
                for br in pair)
        skip = ("wall_seconds", "scenarios_per_sec")
        equal["sweep"] = all(a[k] == b[k] for k in a if k not in skip)
        req = {"rules": ["converge <= 30 rounds"],
               "estimate": {"loss_rate": 0.1}, "rounds": rounds,
               "seed": 2, "generations": 1, "population": 4}
        a, b = (br.autopilot_recommend(dict(req)) for br in pair)
        equal["autopilot"] = all(a[k] == b[k] for k in a
                                 if k not in ("wall_seconds", "replay"))
        equal["replay_identical"] = bool(b["replay"]["identical"])
    finally:
        SimBridge._run_sweep_batch = run_sweep
        search.FleetEvaluator._run_batch = run_batch
    torch.cuda.synchronize()
    return launches(), {"hosts": hosts, "services_per_node": spn,
                        "equal": equal, "ok": all(equal.values())}


def phase_bridge(hosts=BRIDGE_HOSTS, spn=BRIDGE_SPN, rounds=300,
                 short=60, cpu_hosts=64):
    """The port's bridge (``sidecar_tpu_torch/bridge``) served over HTTP
    on the card, at ``hosts`` × ``spn`` services: the catalog made with
    numpy, encoded as ``/api/state.json`` serves it and loaded with
    ``catalog.decode``, then ``serve_bridge(..., port=0)`` on
    127.0.0.1 answers a 10-round warm-up, then (1) a ``rounds``-round
    ``/simulate`` (two chunks) with 2 % cold nodes, (2) ``short``-round
    requests with ``deltas_cap`` and a damping ``protocol``, with
    ``digest``, with ``provenance``, with ``trace`` and ``sparse``, (3)
    ``sharded: true``
    on a bridge of 4 shards, equal to the same request unsharded, (4)
    an 8-point ``/sweep`` at the catalog's n (push-pull 1/2/4/8 s × loss
    0/0.1, 100 rounds, one SLO rule), (5) ``/autopilot/recommend`` with
    a given estimate (``short`` rounds, one generation of 4), and (6) a
    malformed request, which must get a 400.  Each request's wall and
    its split, response bytes, peak memory and K4a launches (once a
    round of every simulated round, a shard's round on the sharded
    bridge).  Then 1–5 at ``cpu_hosts`` × ``spn``, card against CPU."""
    import torch

    from sidecar_tpu_torch.bridge import SimBridge, serve_bridge
    from sidecar_tpu_torch.catalog import decode
    from sidecar_tpu_torch.models.timecfg import TimeConfig

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    catalog_doc = synthetic_catalog(hosts, spn, BRIDGE_SEED)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = decode(catalog_doc)
    decode_s = time.perf_counter() - t0
    bridge = SimBridge(state, TimeConfig())
    sharded_bridge = SimBridge(state, TimeConfig(), shards=4)
    cold = sorted(state.servers)[::hosts // 20][:20]
    timer = BridgeTimer()
    servers = [serve_bridge(b, port=0) for b in (bridge, sharded_bridge)]
    port, sharded_port = (s.server_address[1] for s in servers)
    lines, all_counts, failures = [], [], []

    def simulate(name, payload, on=port, want_launches=None):
        doc, counts, line = bridge_request(on, "/simulate", payload, timer)
        n_rounds = payload["rounds"]
        line = simulate_summary(doc, line, n_rounds)
        lines.append({"request": name, **line})
        all_counts.append(counts)
        want = n_rounds if want_launches is None else want_launches
        if counts != expected(scatter_max_apply=want) or \
                not line["finite"]:
            failures.append(name)
        return doc

    try:
        # The process's first request pays for the card's warm-up (the
        # kernels' first loads, the caching allocator): its own line.
        simulate("warmup", {"rounds": 10, "seed": 9})
        long = simulate("simulate_cold", {"rounds": rounds,
                                          "cold_nodes": cold, "seed": 1})
        for name, extra in (
                ("deltas_damping", {"deltas_cap": 4096, "protocol": {
                    "damping_threshold": 2.0, "suspicion_window_s": 1.0}}),
                ("digest", {"digest": short}),
                ("provenance", {"provenance": {"count": 8}}),
                ("trace_sparse", {"trace": short, "sparse": True})):
            doc = simulate(name, {"rounds": short, "cold_nodes": cold,
                                  "seed": 2, **extra})
            block = {"deltas_damping": "robustness", "digest": "digest",
                     "provenance": "provenance", "trace_sparse": "trace"
                     }[name]
            if not doc.get(block):
                failures.append(f"{name}.{block}")
        plain = simulate("unsharded", {"rounds": short, "cold_nodes": cold,
                                       "seed": 3})
        sharded = simulate("sharded", {"rounds": short, "cold_nodes": cold,
                                       "seed": 3, "sharded": True},
                           on=sharded_port, want_launches=4 * short)
        sharded_equal = all(plain[k] == sharded[k] for k in plain
                            if k not in ("board_exchange", "devices"))
        if not sharded_equal or sharded["devices"] != 4:
            failures.append("sharded_equal")

        sweep_req = {"axes": {"push_pull_interval_s": [1.0, 2.0, 4.0, 8.0],
                              "drop_prob": [0.0, 0.1]},
                     "rounds": 100, "slo": ["converge <= 30 rounds"]}
        sweep, counts, line = bridge_request(port, "/sweep", sweep_req,
                                             timer)
        all_counts.append(counts)
        lines.append({"request": "sweep", **line,
                      "points": sweep["points"], "n": sweep["n"],
                      "rounds_to_eps": [r["rounds_to_eps"]
                                        for r in sweep["table"]],
                      "slo_pass": [r["slo"]["pass"] for r in sweep["table"]],
                      "pareto_front": sweep["pareto_front"],
                      "pareto_excluded": sweep["pareto_excluded"],
                      "scenarios_per_sec": sweep["scenarios_per_sec"]})
        if sweep["points"] != 8 or sweep["n"] != hosts or \
                counts["scatter_max_apply"] < 1:
            failures.append("sweep")

        ap_req = {"rules": ["converge <= 30 rounds"],
                  "estimate": {"loss_rate": 0.1}, "rounds": short,
                  "seed": 2, "generations": 1, "population": 4}
        rec, counts, line = bridge_request(port, "/autopilot/recommend",
                                           ap_req, timer)
        all_counts.append(counts)
        lines.append({"request": "autopilot", **line,
                      "evaluations": rec["evaluations"],
                      "dispatches": rec["dispatches"],
                      "recommended": rec["recommended"]["candidate"],
                      "pass": rec["recommended"]["slo"]["pass"],
                      "replay_identical": rec["replay"]["identical"]})
        if not rec["replay"]["identical"] or rec["n"] != hosts:
            failures.append("autopilot")

        bad, _, line = bridge_request(port, "/simulate",
                                      {"rounds": 5, "trace": 3,
                                       "provenance": {"count": 2}}, timer,
                                      status=400)
        lines.append({"request": "malformed", "status": line["status"],
                      "message": bad.get("message")})
        if "mutually exclusive" not in bad.get("message", ""):
            failures.append("malformed")
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        timer.restore()
    del bridge, sharded_bridge
    card_counts, card_cpu = bridge_card_against_cpu(cpu_hosts, spn, short)
    all_counts.append(card_counts)
    if not card_cpu["ok"]:
        failures.append("card_against_cpu")
    ok = not failures
    emit({"phase": "bridge", "hosts": hosts, "services_per_node": spn,
          "cells": hosts * hosts * spn, "catalog_bytes": len(catalog_doc),
          "catalog_make_s": make_s, "catalog_decode_s": decode_s,
          "projected_entries": sum(len(v) for v in long["projected"]
                                   .values()),
          "requests": lines, "card_against_cpu": card_cpu,
          "failures": failures, "phase_s": time.perf_counter() - t_phase,
          "ok": ok})
    if not ok:
        raise SystemExit("bridge phase failed")
    return all_counts


# -- phase 18: the sequential oracle -------------------------------------------------

ORACLE_TIME = dict(refresh_interval_s=3.0, push_pull_interval_s=2.0,
                   sweep_interval_s=1.0)


def oracle_cases(n):
    """(name, sim factory) of the oracle phase: the plain round on the
    complete graph and ER(8); the suspicion window with the future bound
    and the origin budget; a clock-only chaos plan; an adversary with the
    defences on."""
    import dataclasses

    from sidecar_tpu_torch.chaos import (
        AdversaryPlan,
        Attack,
        ChaosExactSim,
        ClockFault,
        FaultPlan,
    )
    from sidecar_tpu_torch.models.exact import ExactSim, SimParams
    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.ops.topology import complete, erdos_renyi

    p = SimParams(n=n, services_per_node=4, fanout=3, budget=15,
                  drop_prob=0.1)
    fast = TimeConfig(**ORACLE_TIME)
    er = erdos_renyi(n, avg_degree=8.0, seed=3)
    suspicion = dataclasses.replace(fast, alive_lifespan_s=2.0,
                                    refresh_interval_s=600.0,
                                    suspicion_window_s=1.0,
                                    future_fudge_s=0.5, origin_budget=2)
    clocks = FaultPlan(seed=11, clocks=(
        ClockFault(nodes=(0, 1, 2), start_round=3, end_round=30,
                   offset_ticks=30_000, drift_ticks_per_round=7.5),
        ClockFault(nodes=(5,), start_round=5, end_round=35,
                   offset_ticks=-9_000, step_ticks=2_000, step_round=12)))
    attack = AdversaryPlan(seed=7, attacks=(
        Attack(kind="tombstone_bomb", nodes=(0,), victims=(3, 4),
               rate=0.8, start_round=2, end_round=40),
        Attack(kind="sybil_flood", nodes=(2,), victims=(5,), rate=0.6,
               magnitude_ticks=300, start_round=3, end_round=40)))
    defended = dataclasses.replace(fast, future_fudge_s=0.5,
                                   origin_budget=1, origin_quarantine=6)
    return [
        ("complete", lambda d: ExactSim(p, complete(n), fast, device=d)),
        ("er8", lambda d: ExactSim(p, er, fast, device=d)),
        ("suspicion_future_budget",
         lambda d: ExactSim(p, er, suspicion, device=d)),
        ("clock_plan", lambda d: ChaosExactSim(
            p, complete(n), dataclasses.replace(fast, future_fudge_s=0.5),
            clocks, device=d)),
        ("adversary", lambda d: ChaosExactSim(
            p, complete(n), defended, FaultPlan(seed=1), device=d,
            adversary=attack)),
    ]


def phase_oracle(n=64, rounds=40):
    """The card's exact model against the port's sequential NumPy oracle
    (``sim/oracle.py``) at ``n`` × 4 services, ``rounds`` rounds on a
    fast clock (push-pull every 10 rounds, the sweep every 5), draws
    drawn on the CPU: ``known`` and ``sent`` equal after every round in
    each case of :func:`oracle_cases`; then the pipelined oracle against
    ``step_pipelined`` and the provenance oracle against
    ``run_with_provenance``.  K4a once a round of every card run."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.models.exact import ExactSim, SimParams
    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.ops import provenance as prov_ops
    from sidecar_tpu_torch.ops.topology import erdos_renyi
    from sidecar_tpu_torch.sim.oracle import (
        OracleSim,
        PipelinedOracleSim,
        ProvenanceOracle,
    )

    t_phase = time.perf_counter()
    results, all_counts = {}, []

    def same(sim_state, orc):
        # The oracle counts ``sent`` in int32 and selects on its int8
        # cast, the model's storage: an attacker's count past 127 wraps
        # alike in both.
        return (np.array_equal(sim_state.known.cpu().numpy(), orc.known)
                and np.array_equal(sim_state.sent.cpu().numpy(),
                                   orc.sent.astype(np.int8)))

    for name, build in oracle_cases(n):
        sim = build(DEVICE)
        state = sim.init_state()
        inner = getattr(state, "sim", state)
        orc = OracleSim(sim, inner)
        gen = torch.Generator().manual_seed(3)
        reset_launches()
        first_diff, wrap, oracle_s = None, None, 0.0
        for r in range(1, rounds + 1):
            d = sim.draw(gen, r)
            state = sim.step(state, draws=d)
            t0 = time.perf_counter()
            orc.step(d)
            oracle_s += time.perf_counter() - t0
            if first_diff is None and not same(getattr(state, "sim", state),
                                               orc):
                first_diff = r
            if wrap is None and int(orc.sent.max()) > 127:
                wrap = r
        torch.cuda.synchronize()
        counts = launches()
        all_counts.append(counts)
        codes = np.unique(orc.known[orc.known > 0] & 7).tolist()
        results[name] = {"equal": first_diff is None,
                         "first_diff_round": first_diff,
                         "sent_over_int8_round": wrap,
                         "convergence": orc.convergence(),
                         "status_codes": codes,
                         "quarantined": list(orc.quarantined_origins()),
                         "oracle_s": oracle_s,
                         "launches_ok": counts == expected(
                             scatter_max_apply=rounds)}

    p = SimParams(n=n, services_per_node=4, fanout=3, budget=15,
                  drop_prob=0.1)
    er = erdos_renyi(n, avg_degree=8.0, seed=3)
    fast = TimeConfig(**ORACLE_TIME)
    sim = ExactSim(p, er, fast, pipeline="1")
    gen = torch.Generator().manual_seed(4)
    draws = [sim.draw(gen, r) for r in range(1, rounds + 2)]
    state = sim.init_state()
    orc = PipelinedOracleSim(sim, state)
    reset_launches()
    state, inflight = sim.prime_pipeline(state, draws=draws[0])
    orc.prime(draws[0])
    first_diff = None
    for r in range(1, rounds + 1):
        state, inflight = sim.step_pipelined(state, inflight,
                                             draws=draws[r])
        orc.step(draws[r])
        if first_diff is None and not same(state, orc):
            first_diff = r
    torch.cuda.synchronize()
    counts = launches()
    all_counts.append(counts)
    results["pipelined"] = {"equal": first_diff is None,
                            "first_diff_round": first_diff,
                            "launches_ok": counts == expected(
                                scatter_max_apply=rounds)}

    sim = ExactSim(p, er, TimeConfig(refresh_interval_s=10_000.0,
                                     push_pull_interval_s=2.0))
    tracked = prov_ops.default_tracked(p.m, 8)
    tr = torch.tensor(tracked, dtype=torch.int32, device=sim.device)
    draws = draws[:rounds]
    start = sim.init_state()
    reset_launches()
    _, pv, _ = sim.run_with_provenance(start, rounds, tracked, draws=draws,
                                       donate=False)
    orc = ProvenanceOracle(sim._prov_belief(start, tr), 0)
    st = start
    for d in draws:
        nxt = sim.step(st, draws=d)
        orc.observe(orc.holders(sim._prov_belief(st, tr)),
                    orc.holders(sim._prov_belief(nxt, tr)),
                    nxt.round_idx, *sim._prov_channels(nxt, d))
        st = nxt
    torch.cuda.synchronize()
    counts = launches()
    all_counts.append(counts)
    results["provenance"] = {
        "equal": bool(
            np.array_equal(pv.first_seen.cpu().numpy(), orc.first_seen)
            and np.array_equal(pv.parent.cpu().numpy(), orc.parent)
            and np.array_equal(pv.hops.cpu().numpy(), orc.hops)
            and np.array_equal(pv.coverage.cpu().numpy()[:rounds],
                               np.asarray(orc.coverage))),
        "attributed": int((orc.parent >= 0).sum()),
        "launches_ok": counts == expected(scatter_max_apply=2 * rounds)}
    ok = all(r["equal"] and r["launches_ok"] for r in results.values()) \
        and results["adversary"]["quarantined"] == [0, 2]
    emit({"phase": "oracle", "n": n, "services_per_node": 4,
          "rounds": rounds, "results": results,
          "phase_s": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise SystemExit("oracle phase failed")
    return all_counts


# -- phase 19: the live catalog ------------------------------------------------------

LIVE_N, LIVE_SPN = 4096, 10
LIVE_ROUNDS = 60
LIVE_SEED = 17
LIVE_BRIDGE_ROUNDS = 60


def live_rebuild(host, beliefs, names):
    """A live catalog of ``host`` built from one node's belief row (a
    host list of packed ints) through the writer: one
    ``add_service_entry`` a known slot, stamped ``packed >> 3`` with the
    status ``packed & 7``.  Returns ``(state, records, seconds)``."""
    from sidecar_tpu_torch import service as svc
    from sidecar_tpu_torch.catalog import ServicesState

    st = ServicesState(hostname=host, cluster_name="live")
    st.set_clock(lambda: 1_000_000)
    t0 = time.perf_counter()
    n = 0
    for j, packed in enumerate(beliefs):
        if packed:
            st.add_service_entry(svc.Service(
                id=names[j][1], name="app", image="app:1",
                hostname=names[j][0], updated=packed >> 3,
                status=packed & 7))
            n += 1
    return st, n, time.perf_counter() - t0


def live_twin(n=LIVE_N, spn=LIVE_SPN, rounds=LIVE_ROUNDS):
    """Part 1: the partitioned chaos run, the two rebuilt catalogs and
    the session that heals them, held against the card's ladder of the
    merged beliefs.  Returns ``(launch counts, the line's fields,
    failures)``."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.chaos import ChaosExactSim, FaultPlan
    from sidecar_tpu_torch.models.exact import SimParams
    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.ops import digest as digest_ops
    from sidecar_tpu_torch.ops.topology import erdos_renyi
    from sidecar_tpu_torch.transport import antientropy as ae

    failures = []
    side_a, side_b = tuple(range(n // 2)), tuple(range(n // 2, n))
    plan = FaultPlan(seed=LIVE_SEED).with_edges(
        *FaultPlan.partition(side_a, side_b, 0, rounds))
    p = SimParams(n=n, services_per_node=spn, fanout=3, budget=15)
    sim = ChaosExactSim(p, erdos_renyi(n, avg_degree=8.0, seed=3),
                        TimeConfig(refresh_interval_s=10_000.0), plan,
                        device=DEVICE)
    names = [(f"host-{j // spn:04d}", f"svc-{j}") for j in range(p.m)]
    idents = digest_ops.catalog_idents(names)
    state = sim.init_state()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    final, dt, _ = sim.run_with_digest(
        state, rounds, cap=rounds, idents=idents,
        generator=sim.default_generator(LIVE_SEED))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launches()
    if counts != expected(scatter_max_apply=rounds):
        failures.append("twin launches")
    rec = dt.rec[:int(dt.count)].cpu().numpy()
    if not (rec[:, digest_ops.DIG_DIFF_TOTAL] > 0).all():
        failures.append("partition kept no divergence")
    k_a = final.known[0].cpu().numpy().tolist()
    k_b = final.known[n - 1].cpu().numpy().tolist()
    live_a, rec_a, build_a = live_rebuild("node-0000", k_a, names)
    live_b, rec_b, build_b = live_rebuild(f"node-{n - 1:04d}", k_b, names)
    diverged = digest_ops.diff_buckets_py(live_a.digest_snapshot[1],
                                          live_b.digest_snapshot[1])
    full_bytes = len(live_a.encode_annotated()) + \
        len(live_b.encode_annotated())
    t0 = time.perf_counter()
    rep = ae.reconcile(live_a, ae.LoopbackChannel(
        ae.AntiEntropyResponder(live_b)))
    session_s = time.perf_counter() - t0
    if rep.mode != "digest" or rep.coherent is not True:
        failures.append(f"session {rep.mode} coherent={rep.coherent}")
    merged = torch.maximum(final.known[0], final.known[n - 1])[None, :]
    base, depth = live_a.ladder_geometry()
    levels = digest_ops.ladder_digests(
        merged, torch.as_tensor(idents.astype(np.int64), device=merged.device),
        base, depth)
    torch.cuda.synchronize()
    level_equal = [live_a.digest_level(k)
                   == live_b.digest_level(k)
                   == digest_ops.digest_value(levels[k][0])
                   for k in range(depth)]
    if not all(level_equal):
        failures.append(f"ladder levels {level_equal}")
    return counts, {
        "n": n, "services_per_node": spn, "rounds": rounds,
        "run_s": run_s, "diff_total_last": int(rec[-1, digest_ops.
                                                  DIG_DIFF_TOTAL]),
        "records": [rec_a, rec_b], "build_s": [build_a, build_b],
        "writer_records_per_s": (rec_a + rec_b) / (build_a + build_b),
        "diverged_buckets": diverged,
        "session": {"mode": rep.mode, "coherent": rep.coherent,
                    "levels_walked": rep.levels_walked,
                    "records_sent": rep.records_sent,
                    "records_received": rep.records_received,
                    "bytes": rep.total_bytes,
                    "digest_bytes": rep.digest_bytes,
                    "record_bytes": rep.record_bytes,
                    "full_body_bytes": full_bytes, "wall_s": session_s,
                    "states": rep.states},
        "ladder_levels_equal": level_equal,
        "k4a_launches": counts["scatter_max_apply"]}, failures


class _PostSink:
    """A local HTTP server that counts the POSTs it is sent, their bytes
    and the highest ``Version`` among them."""

    def __init__(self):
        import http.server
        import threading

        sink = self
        self.lock = threading.Lock()
        self.posts = self.bytes = self.version = 0

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                version = json.loads(body)["Version"]
                with sink.lock:
                    sink.posts += 1
                    sink.bytes += len(body)
                    sink.version = max(sink.version, version)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/live"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def live_bridge(hosts=BRIDGE_HOSTS, spn=BRIDGE_SPN,
                rounds=LIVE_BRIDGE_ROUNDS):
    """Part 2: the bridge phase's catalog built through the writer
    thread, with a hub and a ``UrlListener``, then one ``/simulate`` on
    it and on its decoded wire form.  Returns ``(launch counts, the
    line's fields, failures)``."""
    import threading

    import torch

    from sidecar_tpu_torch import service as svc
    from sidecar_tpu_torch.bridge import SimBridge, serve_bridge
    from sidecar_tpu_torch.catalog import ServicesState, decode
    from sidecar_tpu_torch.catalog.url_listener import UrlListener
    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.runtime import TimedLooper

    failures = []
    source = decode(synthetic_catalog(hosts, spn, BRIDGE_SEED))
    state = ServicesState(hostname=source.hostname,
                          cluster_name=source.cluster_name)
    t_end = 1_700_000_000 * svc.NS_PER_SECOND + 10 * svc.NS_PER_SECOND
    state.set_clock(lambda: t_end)
    hub = state.query_hub()
    sink = _PostSink()
    listener = UrlListener(sink.url, retries=0)
    listener.watch(state)
    servers = []
    try:
        writer = threading.Thread(target=state.process_service_msgs,
                                  args=(TimedLooper(0.0),), name="writer")
        records = [s.copy() for _, _, s in source.each_service()]
        t0 = time.perf_counter()
        writer.start()
        for s in records:
            state.update_service(s)
        state.stop_processing()
        writer.join(timeout=300)
        write_s = time.perf_counter() - t0
        if writer.is_alive():
            raise SystemExit("live: the writer thread did not stop")
        head = hub.current().version
        t0 = time.perf_counter()
        while sink.version < head and time.perf_counter() - t0 < 120:
            time.sleep(0.01)
        drain_s = time.perf_counter() - t0
        if sink.version != head:
            failures.append(f"listener reached v{sink.version} of v{head}")
        have = json.loads(state.encode())["Servers"]
        want = json.loads(source.encode())["Servers"]
        if {h: v["Services"] for h, v in have.items()} != \
                {h: v["Services"] for h, v in want.items()}:
            failures.append("writer records")
        if hub.current().to_json()["Servers"] != have:
            failures.append("hub snapshot")
        bridges = (SimBridge(state, TimeConfig()),
                   SimBridge(decode(state.encode()), TimeConfig()))
        servers = [serve_bridge(b, port=0) for b in bridges]
        torch.cuda.synchronize()
        reset_launches()
        answers, walls = [], []
        for server in servers:
            t0 = time.perf_counter()
            code, body = post_json(server.server_address[1], "/simulate",
                                   {"rounds": rounds, "seed": 4})
            walls.append(time.perf_counter() - t0)
            if code != 200:
                failures.append(f"/simulate answered {code}")
            answers.append(body)
        torch.cuda.synchronize()
        counts = launches()
        if counts != expected(scatter_max_apply=2 * rounds):
            failures.append("bridge launches")
        doc = json.loads(answers[0])
        conv = doc.get("convergence") or []
        if answers[0] != answers[1]:
            failures.append("live and decoded answers differ")
        if len(conv) != rounds or not all(0.0 <= c <= 1.0 for c in conv):
            failures.append("convergence")
    finally:
        listener.stop()
        for server in servers:
            server.shutdown()
            server.server_close()
        sink.close()
    if listener._thread is not None:
        listener._thread.join(timeout=30)
    return counts, {
        "hosts": hosts, "services_per_node": spn,
        "records": len(records), "write_s": write_s,
        "writer_records_per_s": len(records) / write_s,
        "hub_version": head, "listener_posts": sink.posts,
        "listener_bytes": sink.bytes, "listener_drain_s": drain_s,
        "simulate_rounds": rounds, "simulate_wall_s": walls,
        "answer_bytes": len(answers[0]),
        "final_convergence": conv[-1] if conv else None,
        "answers_equal": answers[0] == answers[1],
        "k4a_launches": counts["scatter_max_apply"]}, failures


def phase_live(n=LIVE_N, hosts=BRIDGE_HOSTS):
    """The live catalog on the card: :func:`live_twin` and
    :func:`live_bridge`.  Returns their launch counts."""
    t_phase = time.perf_counter()
    twin_counts, twin, twin_fail = live_twin(n)
    bridge_counts, bridge, bridge_fail = live_bridge(hosts)
    failures = twin_fail + bridge_fail
    emit({"phase": "live", "twin": twin, "bridge": bridge,
          "failures": failures, "phase_s": time.perf_counter() - t_phase,
          "ok": not failures})
    if failures:
        raise SystemExit(f"live phase failed: {failures}")
    return [twin_counts, bridge_counts]


# -- phase 20: the live node's transport ----------------------------------------

GOSSIP_ROUND_S = 0.05             # the cross-check's gossip interval
GOSSIP_NAMES = ("chaos-a", "chaos-b", "chaos-c")
GOSSIP_SPLIT = (10, 50)           # the plan's split rounds [start, end)
GOSSIP_CHURN_ROUND = 20
GOSSIP_SIM_ROUNDS = 100
GOSSIP_SEED = 77
# 16 nodes, not 32: 32 × 10 nodes sharing this one interpreter did not
# reach one catalog set within 50 s (their writers shed inbound records
# under the burst; PERF.md §4).
GOSSIP_NODES, GOSSIP_SPN = 16, 10
GOSSIP_INTERVAL = 0.2             # the reference's protocol constants
GOSSIP_FANOUT, GOSSIP_MESSAGES = 3, 15
GOSSIP_BRIDGE_ROUNDS = 60


def gossip_plan():
    """``tests/test_chaos.py``'s cross-validation plan: a clean split of
    a from (b, c) over rounds [10, 50), with 20 % loss and a 20 %
    one-round delay on the (b, c) → a direction for the whole run."""
    from sidecar_tpu_torch.chaos import EdgeFault, FaultPlan

    side_a, side_b = (0,), (1, 2)
    return FaultPlan(
        seed=GOSSIP_SEED,
        edges=(EdgeFault(src=side_b, dst=side_a, drop_prob=0.2),
               EdgeFault(src=side_b, dst=side_a, delay_rounds=1,
                         delay_prob=0.2)),
    ).with_edges(*FaultPlan.partition(side_a, side_b, *GOSSIP_SPLIT))


def wait_until(predicate, timeout, step=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return False


class LiveNode:
    """One port node on loopback: a catalog, its writer thread and a
    gossip transport (started by :meth:`start`)."""

    def __init__(self, name, cluster, **kw):
        import threading

        from sidecar_tpu_torch.catalog import ServicesState
        from sidecar_tpu_torch.runtime import TimedLooper
        from sidecar_tpu_torch.transport import GossipTransport

        self.state = ServicesState(hostname=name, cluster_name=cluster)
        self.transport = GossipTransport(
            node_name=name, cluster_name=cluster, bind_ip="127.0.0.1",
            bind_port=0, advertise_ip="127.0.0.1", **kw)
        self.looper = TimedLooper(0.0)
        self.writer = threading.Thread(
            target=self.state.process_service_msgs, args=(self.looper,),
            name=f"writer-{name}", daemon=True)
        self.writer.start()
        self.scheduler = None
        self.loopers = []

    def start(self, seeds=None) -> int:
        return self.transport.start(self.state, seeds=seeds)

    def records(self) -> set:
        with self.state._lock:
            return {(h, s.id, s.status, s.updated)
                    for h, _, s in self.state.each_service()}

    def status_of(self, owner, sid):
        server = self.state.servers.get(owner)
        svc = server.services.get(sid) if server else None
        return None if svc is None else svc.status

    def engine_stats(self) -> dict:
        return {name.split(".", 1)[1]: v
                for name, v in self.transport.engine_stats().items()}

    def stop(self):
        for looper in self.loopers:
            looper.quit()
        if self.scheduler is not None:
            self.scheduler.stop()
        self.transport.stop()
        # The sentinel first: a writer quit before it could leave a full
        # queue that the sentinel's put would wait on forever.
        self.state.stop_processing()
        self.looper.quit()
        self.writer.join(timeout=5.0)


def stop_all(nodes):
    """Stop the nodes together: each stop joins its node's threads."""
    import threading

    threads = [threading.Thread(target=node.stop) for node in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def os_threads() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("Threads:"):
                return int(line.split()[1])
    return -1


def gossip_cross_live():
    """Part 2a: the plan on three live port nodes (``test_chaos``'s live
    path).  Returns ``(the line's fields, failures)``."""
    from sidecar_tpu_torch import metrics
    from sidecar_tpu_torch import service as svc
    from sidecar_tpu_torch.chaos import LiveChaosController, LiveInjector
    from sidecar_tpu_torch.runtime import FreeLooper

    failures = []
    plan = gossip_plan()
    names = list(GOSSIP_NAMES)
    before = {k: metrics.counter(f"chaos.live.{k}") for k in (
        "droppedRecords", "delayedRecords", "partitionEdgesCut")}
    injectors = {n: LiveInjector(plan, names, n, GOSSIP_ROUND_S)
                 for n in names}
    nodes = {}
    controller = ctl_thread = None
    sids = {n: f"svc-{n[-1]}" for n in names}
    t_start = time.perf_counter()
    try:
        for n in names:
            nodes[n] = LiveNode(n, "chaos-xv", gossip_interval=GOSSIP_ROUND_S,
                                push_pull_interval=1.0, probe_interval=5.0,
                                suspect_timeout=60.0,
                                fault_injector=injectors[n])
        controller = LiveChaosController(
            plan, {n: nodes[n].transport for n in names}, GOSSIP_ROUND_S)
        recs = {}
        port_a = nodes[names[0]].start()
        for n in names:
            if n != names[0]:
                nodes[n].start()
                nodes[n].transport.join("127.0.0.1", port_a)
            recs[n] = svc.Service(
                id=sids[n], name="web", image="i:1", hostname=n,
                updated=svc.now_ns(), status=svc.ALIVE,
                ports=[svc.Port("tcp", 1000, 80, "127.0.0.1")])
            nodes[n].state.add_service_entry(recs[n].copy())
            nodes[n].state.send_services([recs[n]], FreeLooper(3))
        if not wait_until(lambda: all(
                nodes[n].status_of(o, sids[o]) == svc.ALIVE
                for n in names for o in names), 20.0):
            raise SystemExit("gossip: the three nodes did not converge "
                             "before the plan")
        t0 = time.monotonic()
        for inj in injectors.values():
            inj.start(t0)
        controller.start(t0)
        ctl_thread = controller.run(poll_s=GOSSIP_ROUND_S / 2)
        anchor = injectors[names[0]]
        wait_until(lambda: anchor.round_now() >= GOSSIP_CHURN_ROUND, 5.0,
                   step=0.005)
        for n, status in ((names[1], svc.DRAINING), (names[2], svc.ALIVE)):
            rec = recs[n].copy()
            rec.status, rec.updated = status, svc.now_ns()
            nodes[n].state.add_service_entry(rec.copy())
            nodes[n].state.send_services([rec], FreeLooper(3))
        same_side = wait_until(lambda: nodes[names[2]].status_of(
            names[1], sids[names[1]]) == svc.DRAINING, 5.0)
        wait_until(lambda: anchor.round_now() >= GOSSIP_SPLIT[1] - 5, 5.0,
                   step=0.005)
        mid_a = nodes[names[0]].status_of(names[1], sids[names[1]])
        # The round after the read: the sample is inside the split only
        # if this is.
        mid_round = anchor.round_now()
        if not same_side:
            failures.append("cross live: c did not hear b's drain")
        if mid_round >= GOSSIP_SPLIT[1]:
            failures.append(f"cross live: mid-split sample taken at round "
                            f"{mid_round} >= {GOSSIP_SPLIT[1]}")
        elif mid_a != svc.ALIVE:
            failures.append("cross live: the split leaked the drain")
        truth = {names[0]: svc.ALIVE, names[1]: svc.DRAINING,
                 names[2]: svc.ALIVE}
        t_heal = time.perf_counter()
        healed = wait_until(lambda: all(
            nodes[n].status_of(o, sids[o]) == truth[o]
            for n in names for o in names), 20.0)
        heal_s = time.perf_counter() - t_heal
        if not healed:
            failures.append("cross live: no convergence after the heal")

        def provoked():
            rec = recs[names[2]].copy()
            rec.updated = svc.now_ns()
            nodes[names[2]].state.add_service_entry(rec.copy())
            nodes[names[2]].state.send_services([rec], FreeLooper(2))
            return all(metrics.counter(f"chaos.live.{k}") > before[k]
                       for k in before)

        if not wait_until(provoked, 15.0, step=0.3):
            failures.append("cross live: the injector counters did not "
                            "move")
        statuses = [nodes[names[0]].status_of(o, sids[o]) for o in names]
    finally:
        if controller is not None:
            controller.stop()
        if ctl_thread is not None:
            ctl_thread.join(timeout=5.0)
        stop_all(nodes.values())
    return {"nodes": len(names), "round_s": GOSSIP_ROUND_S,
            "mid_split_round": mid_round,
            "mid_split_a_view_of_b": mid_a, "heal_s": heal_s,
            "statuses": statuses,
            "injected": {k: metrics.counter(f"chaos.live.{k}") - before[k]
                         for k in before},
            "wall_s": time.perf_counter() - t_start}, failures


def gossip_cross_sim():
    """Part 2b: the plan on the card's ``ChaosExactSim`` (n = 3, the
    complete graph, ``test_sim_path``'s clock), 100 rounds with b's drain
    and c's re-mint at round 20.  Returns ``(launch counts, the line's
    fields, failures)``."""
    import torch

    from sidecar_tpu_torch.chaos import ChaosExactSim
    from sidecar_tpu_torch.models.exact import SimParams
    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.ops import topology
    from sidecar_tpu_torch.ops.status import (ALIVE, DRAINING, pack,
                                              unpack_status)

    failures = []
    cfg = TimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
    sim = ChaosExactSim(SimParams(n=3, services_per_node=1, fanout=2,
                                  budget=3),
                        topology.complete(3), cfg, gossip_plan(),
                        device=DEVICE)
    gen = sim.default_generator(1)
    cst = sim.init_state()
    curve, mid = [], None
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for r in range(GOSSIP_SIM_ROUNDS):
        if r + 1 == GOSSIP_CHURN_ROUND:
            tick = (r + 1) * cfg.round_ticks
            for slot, status in ((1, DRAINING), (2, ALIVE)):
                cst.sim.known[slot, slot] = int(pack(tick, status))
                cst.sim.sent[slot, slot] = 0
        cst = sim.step(cst, generator=gen)
        curve.append(float(sim.convergence(cst)))
        if r + 1 == GOSSIP_SPLIT[1] - 5:
            mid = int(unpack_status(cst.sim.known[0, 1]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launches()
    if counts != expected(scatter_max_apply=GOSSIP_SIM_ROUNDS):
        failures.append(f"cross sim launches {counts}")
    known = cst.sim.known.cpu()
    truth = known.max(dim=0).values
    final = [int(s) for s in unpack_status(truth)]
    if mid == DRAINING:
        failures.append("cross sim: a heard the drain through the split")
    if not bool((known == truth[None, :]).all()) or \
            final != [ALIVE, DRAINING, ALIVE]:
        failures.append(f"cross sim: final {final}")
    eps_round = next((i + 1 for i, c in enumerate(curve) if c == 1.0
                      and i + 1 >= GOSSIP_SPLIT[1]), None)
    return counts, {"n": 3, "rounds": GOSSIP_SIM_ROUNDS,
                    "mid_split_a_view_of_b": mid, "statuses": final,
                    "final_convergence": curve[-1],
                    "heal_round_converged": eps_round,
                    "injection_counts": sim.injection_counts(cst),
                    "run_s": run_s,
                    "k4a_launches": counts["scatter_max_apply"]}, failures


def gossip_services(node, spn, t_ns):
    from sidecar_tpu_torch import service as svc

    host = node.state.hostname
    return [svc.Service(id=f"{host}-s{j}", name=f"app{j}", image="app:1",
                        hostname=host, created=t_ns, updated=t_ns + j,
                        status=svc.ALIVE,
                        ports=[svc.Port("tcp", 20_000 + j, 80,
                                        "127.0.0.1")])
            for j in range(spn)]


def gossip_cluster(n=GOSSIP_NODES, spn=GOSSIP_SPN,
                   bridge_rounds=GOSSIP_BRIDGE_ROUNDS):
    """Parts 3-5: ``n`` port nodes in this process on loopback at the
    reference's protocol constants, each with a scheduler driving
    ``broadcast_services_step`` and ``broadcast_tombstones_step`` over a
    static list of ``spn`` local services (empty until the write); the
    write, and the wall until every node holds one catalog set; the HTTP
    API on node 0; then, the cluster stopped, node 0's catalog into the
    bridge on the card.
    Returns ``(launch counts, the line's fields, failures)``."""
    import socket
    import threading
    import urllib.request

    import torch

    from sidecar_tpu_torch import metrics
    from sidecar_tpu_torch import service as svc
    from sidecar_tpu_torch.bridge import SimBridge
    from sidecar_tpu_torch.catalog import decode
    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.runtime import TimedLooper
    from sidecar_tpu_torch.runtime.scheduler import Scheduler
    from sidecar_tpu_torch.web import SidecarApi, serve_http

    failures = []
    threads0, pythreads0 = os_threads(), threading.active_count()
    nodes, server = [], None
    local = {}
    try:
        t0 = time.perf_counter()
        for i in range(n):
            node = LiveNode(f"node-{i:02d}", "gossip",
                            gossip_interval=GOSSIP_INTERVAL,
                            gossip_nodes=GOSSIP_FANOUT,
                            gossip_messages=GOSSIP_MESSAGES)
            local[node.state.hostname] = []
            names = local[node.state.hostname]
            node.scheduler = Scheduler(name=f"sched-{i:02d}")
            for interval, step, label in (
                    (1.0, node.state.broadcast_services_step,
                     "broadcast-services"),
                    (2.0, node.state.broadcast_tombstones_step,
                     "broadcast-tombstones")):
                looper = TimedLooper(interval)
                node.loopers.append(looper)
                node.scheduler.drive(looper, step(lambda names=names:
                                                  list(names)), name=label)
            nodes.append(node)
        seed = f"127.0.0.1:{nodes[0].start()}"
        for node in nodes[1:]:
            node.start(seeds=[seed])
        start_s = time.perf_counter() - t0
        if not wait_until(lambda: all(len(nd.transport.members()) == n
                                      for nd in nodes), 30.0, step=0.1):
            seen = sorted(len(nd.transport.members()) for nd in nodes)
            raise SystemExit(f"gossip: membership did not converge in "
                             f"30 s (members seen: {seen})")
        members_s = time.perf_counter() - t0
        threads = os_threads() - threads0
        pythreads = threading.active_count() - pythreads0
        stats0 = [nd.engine_stats() for nd in nodes]

        # The write: each node's services join its scheduler's list (so
        # the tombstone step keeps them), then enter its catalog.
        t_ns = svc.now_ns()
        for node in nodes:
            recs = gossip_services(node, spn, t_ns)
            local[node.state.hostname].extend(recs)
            for rec in recs:
                node.state.add_service_entry(rec.copy())
        t_write = time.perf_counter()
        want = set().union(*(nd.records() for nd in nodes))
        if len(want) != n * spn:
            failures.append(f"gossip: {len(want)} records written")
        # Each poll also samples the share of (node, record) pairs held,
        # to show how much the gossip carries and what waits for a
        # push-pull.
        shares = []

        def one_set():
            held = [nd.records() & want for nd in nodes]
            shares.append((time.perf_counter() - t_write,
                           sum(map(len, held)) / (n * len(want))))
            return all(len(nd.state.servers) == n and nd.records() == want
                       for nd in nodes)

        # The gossip carries most records and a node's next push-pull
        # the rest, so the wait ends two push-pull periods after 99 % of
        # the pairs are held (three after the write until they are), not
        # at a fixed time that a slower host would miss.
        pp = nodes[0].transport.push_pull_interval
        t99 = None
        while not (converged := one_set()):
            if t99 is None and shares[-1][1] >= 0.99:
                t99 = shares[-1][0]
            if shares[-1][0] > (3 * pp if t99 is None else t99 + 2 * pp):
                break
            time.sleep(0.02)
        converge_s = time.perf_counter() - t_write
        held_share_s = {str(q): next((t for t, share in shares
                                      if share >= q), None)
                        for q in (0.5, 0.9, 0.99)}
        if not converged:
            missing = [n * spn - len(nd.records()) for nd in nodes]
            failures.append(f"gossip: no convergence {converge_s:.1f} s "
                            f"after the write (99 % held at {t99} s), "
                            f"missing {missing}")
        stats1 = [nd.engine_stats() for nd in nodes]

        # A dead seed: the retry discipline's counters.
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()[1]
        retry_ok = nodes[0].transport.join_with_retry("127.0.0.1", dead)

        # The HTTP API on node 0, live.
        cat = nodes[0].records()
        node0_doc = nodes[0].state.encode()
        server = serve_http(SidecarApi(nodes[0].state,
                                       members_fn=nodes[0].transport.members,
                                       cluster_name="gossip"),
                            bind="127.0.0.1", port=0)
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/state.json", timeout=30) as r:
            state_doc = r.read()
        served = decode(state_doc)
        served_set = {(h, s.id, s.status, s.updated)
                      for h, _, s in served.each_service()}
        if served_set != cat:
            failures.append("api: /api/state.json differs from node 0")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/metrics", timeout=30) as r:
            prom = r.read().decode()
        series = [line.split()[0] for line in prom.splitlines()
                  if line and not line.startswith("#")]
        engine_series = [s for s in series if s.startswith("sidecar_engine_")]
        transport_series = [s for s in series
                            if s.startswith("sidecar_transport_")]
        if not engine_series or not transport_series:
            failures.append(f"api: /api/metrics series {engine_series} "
                            f"{transport_series}")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        t_stop = time.perf_counter()
        stop_all(nodes)
        stop_s = time.perf_counter() - t_stop

    # Node 0's catalog into the bridge on the card, once the cluster is
    # stopped (its threads would share the host with the dispatches).
    bridge = SimBridge(decode(node0_doc), TimeConfig())
    st, params, mapping, _ = bridge.snapshot()
    proj0 = bridge._project(st.known.cpu().numpy(), mapping, params)
    statuses = {sid: svc.status_string(stat) for _, sid, stat, _ in cat}
    if any(proj0[h] != statuses for h in mapping.hostnames):
        failures.append("bridge: the round-0 projection is not node "
                        "0's catalog")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rep = bridge.simulate(bridge_rounds, seed=4,
                          cold_nodes=list(mapping.hostnames),
                          eps=1e-5)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    counts = launches()
    if counts != expected(scatter_max_apply=bridge_rounds):
        failures.append(f"bridge launches {counts}")
    if len(rep.convergence) != bridge_rounds:
        failures.append("bridge: convergence curve")

    def per_node(key):
        vals = [b[key] - a[key] for a, b in zip(stats0, stats1)]
        return {"mean": sum(vals) / len(vals), "max": max(vals)}

    totals = {k: sum(s[k] for s in stats1) / len(stats1)
              for k in stats1[0]}
    return counts, {
        "nodes": n, "services_per_node": spn,
        "gossip_interval_s": GOSSIP_INTERVAL, "gossip_nodes": GOSSIP_FANOUT,
        "gossip_messages": GOSSIP_MESSAGES, "start_s": start_s,
        "membership_s": members_s, "converged": converged,
        "write_to_converged_s": converge_s,
        "write_to_converged_rounds": converge_s / GOSSIP_INTERVAL,
        "held_share_s": held_share_s, "push_pull_interval_s": pp,
        "engine_write_to_converged_per_node": {
            k: per_node(k) for k in ("udpOut", "udpBytesOut", "udpIn",
                                     "udpBytesIn", "pushPullOut",
                                     "pushPullIn")},
        "engine_total_mean_per_node": totals,
        "os_threads_per_node": threads / n,
        "python_threads_per_node": pythreads / n,
        "dead_seed_join": retry_ok,
        "transport_counters": {k: v for k, v in metrics.snapshot()[
            "counters"].items() if k.startswith("transport.")},
        "bridge": {"rounds": bridge_rounds, "cold_nodes": n,
                   "eps": 1e-5, "predicted_eps_round": rep.eps_round,
                   "predicted_eps_s": None if rep.eps_round is None
                   else rep.eps_round * GOSSIP_INTERVAL,
                   "live_rounds": converge_s / GOSSIP_INTERVAL,
                   "final_convergence": rep.convergence[-1],
                   "simulate_s": sim_s,
                   "k4a_launches": counts["scatter_max_apply"]},
        "api": {"state_bytes": len(state_doc),
                "engine_series": len(engine_series),
                "transport_series": len(transport_series)},
        "stop_s": stop_s}, failures


def phase_gossip(n=GOSSIP_NODES):
    """The live node's transport: the engine's build, the cross-check of
    one plan on live port nodes and on the card's ``ChaosExactSim``, a
    live cluster of ``n`` nodes, the bridge on its catalog and the HTTP
    API.  Returns the launch counts of the card's runs."""
    from sidecar_tpu_torch.transport import gossip

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib = gossip.build_native()
    build_s = time.perf_counter() - t0
    gossip.load_native()
    live, live_fail = gossip_cross_live()
    sim_counts, sim, sim_fail = gossip_cross_sim()
    cluster_counts, cluster, cluster_fail = gossip_cluster(n)
    failures = live_fail + sim_fail + cluster_fail
    if live["statuses"] != sim["statuses"]:
        failures.append(f"cross: live {live['statuses']} sim "
                        f"{sim['statuses']}")
    gxx = subprocess.run([gossip.compiler(), "--version"],
                         capture_output=True, text=True, check=True)
    emit({"phase": "gossip", "engine": {"compiler":
                                        gxx.stdout.splitlines()[0],
                                        "library": lib.name,
                                        "build_s": build_s},
          "cross_live": live, "cross_sim": sim, "cluster": cluster,
          "failures": failures, "phase_s": time.perf_counter() - t_phase,
          "ok": not failures})
    if failures:
        raise SystemExit(f"gossip phase failed: {failures}")
    return [sim_counts, cluster_counts]


# -- phase 21: the shard groups over torch.distributed -------------------------

DIST_EXACT_ROUNDS = {"nccl": 50, "gloo": 50}
DIST_COMPRESSED_ROUNDS = {"nccl": 25, "gloo": 25}
DIST_CONV_EVERY = 25
DIST_GRID_ROUNDS = 50             # of the fleet phase's 100
DIST_GLOO_N = 16_384
# The twins' other paths over the group: the telemetry planes, the
# pipelined round and configs 4 and 5.
DIST_PATH_ROUNDS = 50
DIST_EXACT_PLANES = ("trace", "digest", "provenance")
DIST_TRACKED = 4
# The compressed deltas diff an [N, M] belief view: 10^11 cells at the
# north star, so they run at the lockstep size.
DIST_DELTA_N = 4096
DIST_DELTA_CAP = 1 << 16
DIST_CONFIG4_SCALE = 0.25           # 16,384 × 10
DIST_CONFIG4_ROUNDS = 100           # of its 400: ε falls at round 75
DIST_CONFIG5_SCALE = 1.0            # the declared 1M × 64
# The split's 150 rounds and the first 150 of the heal's 450, held
# against that prefix of the single-device run (ε falls at round 590,
# which the chaos phase reaches).
DIST_CONFIG5_HEAL_ROUNDS = 150
DIST_PATHS = ("exact_planes", "compressed_trace", "compressed_deltas",
              "exact_pipelined", "compressed_pipelined", "config4",
              "config5")
# The fleet's node axis: each scenario's nodes over the gloo group's two
# ranks, the layout (sd, nd) = (1, 2) — the grid job's batch, and the
# `fleet` phase's 4-scenario chaos batch at the `value` size.  The grid
# shares the scenario-axis grid job's reference; only the chaos job is
# profiled.
DIST_NODE_JOBS = ("grid_nodes", "chaos_nodes")
DIST_CHAOS_NODES_ROUNDS = 50


def dist_jobs(north_star_n):
    """The groups of the ``dist`` phase, ``[(backend, world, jobs)]``,
    each job ``(kind, mode, d, n, rounds)``."""
    nccl = [("exact", mode, 4, 4096, DIST_EXACT_ROUNDS["nccl"])
            for mode in ("all_gather", "ring", "zoned")] + \
        [("compressed", mode, 4, north_star_n, DIST_COMPRESSED_ROUNDS["nccl"])
         for mode in ("all_gather", "all_to_all", "ring", "zoned")] + \
        [("exact_planes", "ring", 4, 4096, DIST_PATH_ROUNDS),
         ("compressed_trace", "ring", 4, north_star_n, DIST_PATH_ROUNDS),
         ("compressed_deltas", "ring", 4, DIST_DELTA_N, DIST_PATH_ROUNDS),
         ("exact_pipelined", "ring", 4, 4096, DIST_PATH_ROUNDS),
         ("compressed_pipelined", "ring", 4, north_star_n,
          DIST_PATH_ROUNDS),
         ("config5", None, 4,
          int(1000 * DIST_CONFIG5_SCALE ** 0.5) ** 2,
          CONFIG5_RUN["split_rounds"] + DIST_CONFIG5_HEAL_ROUNDS)]
    gloo = [("exact", mode, 4, 4096, DIST_EXACT_ROUNDS["gloo"])
            for mode in ("all_gather", "ring")] + \
        [("compressed", mode, 4, DIST_GLOO_N, DIST_COMPRESSED_ROUNDS["gloo"])
         for mode in ("all_gather", "all_to_all")] + \
        [("grid", None, 2, 1024, DIST_GRID_ROUNDS),
         ("grid_nodes", None, 2, 1024, DIST_GRID_ROUNDS),
         ("chaos_nodes", None, 2, 4096, DIST_CHAOS_NODES_ROUNDS),
         ("exact_planes", "ring", 4, 4096, DIST_PATH_ROUNDS),
         ("compressed_trace", "all_gather", 4, DIST_GLOO_N,
          DIST_PATH_ROUNDS),
         ("compressed_deltas", "all_gather", 4, DIST_DELTA_N,
          DIST_PATH_ROUNDS),
         ("exact_pipelined", "ring", 4, 4096, DIST_PATH_ROUNDS),
         ("compressed_pipelined", "all_gather", 4, DIST_GLOO_N,
          DIST_PATH_ROUNDS),
         ("config4", None, 4, int(65_536 * DIST_CONFIG4_SCALE),
          DIST_CONFIG4_ROUNDS)]
    return [("nccl", 1, nccl), ("gloo", 2, gloo)]


def field_digests(arrays: dict) -> dict:
    """SHA-256 of each field's bytes (dtype and shape included)."""
    import hashlib

    import numpy as np

    out = {}
    for name, value in arrays.items():
        a = np.ascontiguousarray(value)
        h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
        out[name] = h.hexdigest()
    return out


def dist_topology(n, graphs):
    """ER(8, seed 3) at ``n``, built once: ``graphs`` maps n to the
    graphs built so far (the north star's is passed in)."""
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    if n not in graphs:
        graphs[n] = erdos_renyi(n, avg_degree=8.0, seed=3)
    return graphs[n]


def dist_sim(kind, mode, d, n, topo, group, device=None, timecfg=None):
    """The job's twin: the exact model at the ``value`` shape, or the
    compressed model at ``bench_params``; ``group`` None is the
    one-process ``LocalShardGroup``."""
    from sidecar_tpu_torch.models.exact import SimParams
    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.parallel import ShardedCompressedSim, ShardedSim

    device = DEVICE if device is None else device
    if kind == "exact":
        return ShardedSim(SimParams(n=n, services_per_node=10, fanout=3,
                                    budget=15), topo,
                          timecfg or TimeConfig(), d=d,
                          board_exchange=mode, group=group, device=device)
    return ShardedCompressedSim(bench_params(n), topo, bench_time(), d=d,
                                board_exchange=mode, group=group,
                                device=device)


def dist_drive(sim, kind, rounds):
    """Run the job from its start state: the exact model's cold start, or
    the compressed boot plus the bench's 0.1 % burst; returns ``(final,
    curve)`` (the curve every round, or every 25 rounds on the compressed
    model)."""
    gen = sim.default_generator(0)
    if kind == "exact":
        return sim.run(sim.init_state(), rounds, generator=gen)
    state = sim.mint(sim.init_state(), burst(sim.p.m, 0.001), 10)
    return sim.run(state, rounds, DIST_CONV_EVERY, generator=gen)


def dist_grid(device, n, rounds, group=None, node_devices=1):
    """The 64-point grid at n × 10 services (``fleet_exact_grid``'s
    batch), its scenarios (and with ``node_devices`` > 1 each one's
    nodes) over ``group``'s ranks; returns the fleet, the run and its
    table."""
    from sidecar_tpu_torch.fleet import FleetSim, ScenarioBatch, expand_grid
    from sidecar_tpu_torch.models.exact import SimParams
    from sidecar_tpu_torch.models.timecfg import TimeConfig

    t = TimeConfig(refresh_interval_s=10_000.0)
    batch = ScenarioBatch.build(
        expand_grid(sweep_grid_axes(), base={"seed": 0}),
        SimParams(n=n, services_per_node=10, fanout=3, budget=15), t,
        device=device)
    fleet = FleetSim(batch, group=group, node_devices=node_devices)
    run = fleet.run(fleet.init_states(), rounds, eps=0.01)
    return fleet, run, run.table(t.round_ticks, t.ticks_per_second)


def dist_chaos_fleet(device, n, rounds, group=None, node_devices=1):
    """The ``fleet`` phase's chaos batch (``fleet_chaos_batch``) with its
    nodes over ``group``'s ranks; returns the fleet and the run."""
    from sidecar_tpu_torch.fleet import FleetSim

    batch, topo = fleet_chaos_batch(n, device)
    fleet = FleetSim(batch, topo, group=group, node_devices=node_devices)
    return fleet, fleet.run(fleet.init_states(), rounds)


def fleet_run_stats(run) -> dict:
    """A fleet run's per-scenario rows on the host: rounds, ε rounds,
    offer bytes, frontier high-water marks and the curve."""
    return {"rounds": run.rounds.tolist(), "eps_round": run.eps_round,
            "exchange_bytes": run.exchange_bytes.tolist(),
            "frontier_max": run.frontier_max.tolist(),
            "curve": run.convergence.tolist()}


def fleet_state_digests(state) -> tuple:
    """A fleet state's numpy form split for comparison: the SHA-256 of
    every leaf but the chaos counters, and the counters themselves (a
    node block's are its senders' counts: the ranks' sum is compared)."""
    from sidecar_tpu_torch import convert

    flat = convert.fleet_leaves(state)
    counters = {k: flat.pop(k).tolist() for k in convert.FLEET_COUNTERS
                if k in flat}
    return field_digests(flat), counters


def dist_timed(fn):
    """``(fn(), seconds)``, the card synchronized around it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dist_path(kind, mode, d, n, rounds, group, device, graphs):
    """One of the twins' other paths through ``group`` (None: the
    one-process ``LocalShardGroup``) on ``device``: the exact twin's
    trace, digest and provenance in one run beside the untraced run; the
    compressed twin's trace (or deltas) beside ``run_fast``; either
    twin's pipelined run; config4 or config5 through ``group=``.
    Returns ``(record, sim, final state)``, a config's with no sim and
    no state: the record holds the timed run's wall (and the untraced
    one's), its curve, every stream's fields on the host, the carry and
    whether the traced run ended where the untraced one did."""
    import torch

    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.ops import provenance as prov_ops
    from sidecar_tpu_torch.ops import trace as trace_ops
    from sidecar_tpu_torch.parallel import LocalShardGroup
    from sidecar_tpu_torch.sim import scenarios

    rec = {}
    if kind in ("config4", "config5"):
        g = LocalShardGroup(d) if group is None else group
        if kind == "config4":
            res, rec["wall_s"] = dist_timed(
                lambda: scenarios.config4_ba_antientropy(
                    rounds=rounds, scale=DIST_CONFIG4_SCALE, device=device,
                    group=g))
        else:
            res, rec["wall_s"] = dist_timed(
                lambda: scenarios.config5_split_heal(
                    scale=DIST_CONFIG5_SCALE,
                    split_rounds=CONFIG5_RUN["split_rounds"],
                    heal_rounds=rounds - CONFIG5_RUN["split_rounds"],
                    device=device, group=g))
        rec.update(n=res.n, curve=[float(c) for c in res.convergence],
                   eps_round=res.eps_round)
        return rec, None, None
    topo = dist_topology(n, graphs)
    timecfg = None
    if kind == "exact_pipelined":
        # Push-pull every 25 rounds: the uniform partner's rows travel.
        timecfg = TimeConfig(push_pull_interval_s=5.0)
    sim = dist_sim("exact" if kind.startswith("exact") else "compressed",
                   mode, d, n, topo, group, device, timecfg)
    gen = sim.default_generator(0)
    if kind == "exact_planes":
        draws = [sim.draw(gen, r) for r in range(1, rounds + 1)]
        (plain, plain_conv), rec["untraced_wall_s"] = dist_timed(
            lambda: sim.run(sim.init_state(), rounds, draws=draws))
        state = sim.init_state()
        obs = AllPlanes(sim, state, rounds, DIST_EXACT_PLANES, 0,
                        prov_ops.default_tracked(sim.p.m, DIST_TRACKED))
        (final, conv), rec["wall_s"] = dist_timed(
            lambda: sim._run(state, rounds, True, None, draws, False,
                             plane=obs))
        rec.update(streams=obs.streams(), curve=curve_list(conv),
                   traced_equals_untraced=(not states_equal(plain, final)
                                           and bool(torch.equal(
                                               plain_conv, conv))))
        del plain
    elif kind in ("compressed_trace", "compressed_deltas"):
        draws = [sim.draw(gen, r) for r in range(1, rounds + 1)]
        state = sim.mint(sim.init_state(), burst(sim.p.m, 0.001), 10)
        plain, rec["untraced_wall_s"] = dist_timed(
            lambda: sim.run_fast(state, rounds, draws=draws))
        if kind == "compressed_trace":
            plane = "trace"
            (final, stream), rec["wall_s"] = dist_timed(
                lambda: sim.run_with_trace(state, rounds, draws=draws))
            rec["curve"] = stream.rec[:, trace_ops.TRACE_BEHIND].tolist()
        else:
            plane = "deltas"
            (final, stream), rec["wall_s"] = dist_timed(
                lambda: sim.run_with_deltas(state, rounds, DIST_DELTA_CAP,
                                            draws=draws))
            rec["curve"] = stream.count.tolist()
        rec.update(streams={plane: stream_host(stream)},
                   traced_equals_untraced=not states_equal(plain, final))
        del plain
    else:
        if kind == "exact_pipelined":
            (final, conv, inflight), rec["wall_s"] = dist_timed(
                lambda: sim.run_pipelined(sim.init_state(), rounds,
                                          generator=gen))
        else:
            state = sim.mint(sim.init_state(), burst(sim.p.m, 0.001), 10)
            (final, conv, inflight), rec["wall_s"] = dist_timed(
                lambda: sim.run_pipelined(state, rounds, DIST_CONV_EVERY,
                                          generator=gen))
        rec.update(curve=curve_list(conv),
                   carry=[t.cpu().numpy() for t in inflight.publish])
    return rec, sim, final


def dist_path_expected(kind, d, world, rounds):
    """A rank's launches of a path job: K4a a local shard a round on the
    exact twin's lockstep and rank-local pipelined rounds (the traced and
    untraced runs of the planes job both), once a round on one rank's
    delegated pipelined round; K2 and K3 a local shard a round on the
    compressed twin's lockstep rounds; on its pipelined round K2 once a
    tick and at the prime (a rank's rows, or every row on one rank) and
    K3 a local shard a tick over ranks (one rank folds with a plain
    gather)."""
    dl = d // world
    if kind == "exact_planes":
        return expected(scatter_max_apply=2 * dl * rounds)
    if kind in ("compressed_trace", "compressed_deltas"):
        return expected(publish_board=2 * dl * rounds,
                        board_row_gather=2 * dl * rounds)
    if kind == "exact_pipelined":
        return expected(scatter_max_apply=(dl if world > 1 else 1) * rounds)
    if kind == "compressed_pipelined":
        return expected(publish_board=rounds + 1,
                        board_row_gather=dl * rounds if world > 1 else 0)
    return expected(publish_board=dl * rounds, board_row_gather=dl * rounds)


def dist_rank(ctx, jobs, topo_data):
    """A rank of the ``dist`` phase: each job through a group over the
    ranks; returns per job the rank's digests, curve or table (and a path
    job's streams and carry), wall, launches, peak memory and exchange
    accounting, and a 5-round profile of the first exact and the first
    compressed job and of the node-axis chaos job."""
    import torch

    from sidecar_tpu_torch import convert

    big = convert.topology_from_numpy(*topo_data)
    graphs = {big.n: big}
    out, profiled = [], set()
    for kind, mode, d, n, rounds in jobs:
        t_setup = time.perf_counter()
        g = ctx.group(d)
        if kind in ("exact", "compressed"):
            sim = dist_sim(kind, mode, d, n, dist_topology(n, graphs), g,
                           ctx.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(ctx.device)
        reset_launches()
        t0 = time.perf_counter()
        setup_s = t0 - t_setup
        path = fleet = run = None
        if kind == "grid":
            _, run, table = dist_grid(ctx.device, n, rounds, g)
        elif kind == "grid_nodes":
            fleet, run, table = dist_grid(ctx.device, n, rounds, g, d)
        elif kind == "chaos_nodes":
            fleet, run = dist_chaos_fleet(ctx.device, n, rounds, g, d)
        elif kind in DIST_PATHS:
            path, sim, final = dist_path(kind, mode, d, n, rounds, g,
                                         ctx.device, graphs)
        else:
            final, curve = dist_drive(sim, kind, rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 if path is None else path["wall_s"]
        rec = {"rank": ctx.rank, "wall_s": wall, "setup_s": setup_s,
               "launches": launches(),
               "max_memory_allocated":
                   torch.cuda.max_memory_allocated(ctx.device),
               "exchange": dict(g.stats)}
        t_check = time.perf_counter()
        if fleet is not None:
            rec["node_exchange"] = dict(fleet.nodes.group.stats)
        if kind in ("grid", "grid_nodes"):
            rec.update(table=table, fleet_wall_s=run.wall_seconds)
        elif kind == "chaos_nodes":
            from sidecar_tpu_torch import convert as cv

            rec["digests"], rec["counters"] = fleet_state_digests(
                cv.fleet_state_to_numpy(run.final_states))
            rec.update(fleet_run_stats(run), fleet_wall_s=run.wall_seconds,
                       digest_s=time.perf_counter() - t_check)
            t_check = time.perf_counter()
            rec["profile"] = fleet_profile(fleet, run.final_states)
            rec["profile_s"] = time.perf_counter() - t_check
        else:
            if path is None:
                rec.update(
                    digests=field_digests(convert.state_to_numpy(final)),
                    curve=curve_list(curve))
            else:
                rec.update(dist_path_digests(path))
                if kind not in ("config4", "config5"):
                    rec["digests"] = field_digests(
                        convert.state_to_numpy(final))
            rec["digest_s"] = time.perf_counter() - t_check
            if kind in ("exact", "compressed") and kind not in profiled:
                profiled.add(kind)
                t_check = time.perf_counter()
                rec["profile"] = profile_rounds(sim, final)
                rec["profile_s"] = time.perf_counter() - t_check
            del sim, final
        out.append(rec)
        fleet = run = None
        torch.cuda.empty_cache()
    return out


def dist_path_digests(path) -> dict:
    """What a path job's record is held to: its walls, curve, ε round,
    the traced run against the untraced one, and the SHA-256 of every
    stream field and of the carry."""
    out = {k: path[k] for k in ("untraced_wall_s", "curve", "eps_round",
                                "n", "traced_equals_untraced")
           if k in path}
    if "streams" in path:
        out["stream_digests"] = {
            plane: field_digests({k: v for k, v in fields.items()})
            for plane, fields in path["streams"].items()}
    if "carry" in path:
        out["carry_digests"] = field_digests(
            {str(i): a for i, a in enumerate(path["carry"])})
    return out


def dist_reference(kind, mode, d, n, rounds, world, graphs, config5=None,
                   worlds=()):
    """The job through ``LocalShardGroup`` in this process: the digests of
    each rank's part of the final state (``convert.shard_state``), the
    curve (or the grid's table; a path job's streams and each rank's
    part of its carry), the wall and the launches.  A path job's digests
    are kept for each world size of ``worlds`` (by world), so one run
    serves both groups.  config5's reference is the single-device run of
    the ``chaos`` phase when it ran."""
    import torch

    from sidecar_tpu_torch import convert
    from sidecar_tpu_torch.sim import scenarios

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    if kind in ("grid", "grid_nodes"):
        _, run, table = dist_grid(DEVICE, n, rounds)
        torch.cuda.synchronize()
        return {"table": table, "wall_s": time.perf_counter() - t0,
                "fleet_wall_s": run.wall_seconds, "launches": launches()}
    if kind == "chaos_nodes":
        _, run = dist_chaos_fleet(DEVICE, n, rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        arrays = convert.fleet_state_to_numpy(run.final_states)
        parts = [fleet_state_digests(convert.shard_state(
            arrays, r, world, node_devices=d)) for r in range(world)]
        _, counters = fleet_state_digests(arrays)
        ref = {**fleet_run_stats(run), "wall_s": wall,
               "fleet_wall_s": run.wall_seconds, "launches": counts,
               "digests": [dg for dg, _ in parts], "counters": counters}
        del run, arrays
        torch.cuda.empty_cache()
        return ref
    if kind == "config5":
        # The single-device config5 (the chaos phase's, or run here); its
        # ε round as the config computes it, from the float32 curve.
        import numpy as np

        if config5 is None:
            res = scenarios.config5_split_heal(
                scale=DIST_CONFIG5_SCALE,
                split_rounds=CONFIG5_RUN["split_rounds"],
                heal_rounds=rounds - CONFIG5_RUN["split_rounds"],
                device=DEVICE)
            config5 = {"curve": [float(c) for c in res.convergence],
                       "n": res.n}
        # A sample every CONFIG5_RUN["every"] rounds; the job's rounds
        # are a prefix of the chaos phase's.
        curve = config5["curve"][:rounds // CONFIG5_RUN["every"]]
        eps_round = scenarios._eps_round(
            np.asarray(curve, np.float32), CONFIG5_RUN["eps"],
            CONFIG5_RUN["every"])
        return {**config5, "curve": curve, "eps_round": eps_round,
                "wall_s": time.perf_counter() - t0,
                "launches": launches(), "single_device": True}
    if kind in DIST_PATHS:
        path, sim, final = dist_path(kind, mode, d, n, rounds, None,
                                        DEVICE, graphs)
        counts = launches()
        ref = {**dist_path_digests(path), "wall_s": path["wall_s"],
               "launches": counts}
        if kind not in ("config4", "config5"):
            arrays = convert.state_to_numpy(final)
            ref["digests"] = {w: [field_digests(convert.shard_state(
                arrays, r, w, d)) for r in range(w)] for w in worlds}
        if "carry" in path:
            ref["carry_digests"] = {w: [field_digests(
                {str(i): a for i, a in enumerate(convert.shard_inflight(
                    path["carry"], r, w))}) for r in range(w)]
                for w in worlds}
        del sim, final
        torch.cuda.empty_cache()
        return ref
    sim = dist_sim(kind, mode, d, n, dist_topology(n, graphs), None)
    final, curve = dist_drive(sim, kind, rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    arrays = convert.state_to_numpy(final)
    del sim, final
    torch.cuda.empty_cache()
    return {"digests": [field_digests(convert.shard_state(arrays, r, world,
                                                         d))
                        for r in range(world)],
            "curve": curve_list(curve), "wall_s": wall, "launches": counts}


def dist_expected(kind, d, world, rounds):
    """A rank's launches of a job: K4a once a local shard a round (exact),
    K2 and K3 once a local shard a round (compressed), K4a once a round
    for the rank's batch (grid); a path job's as
    :func:`dist_path_expected` says."""
    dl = d // world
    if kind in DIST_PATHS:
        return dist_path_expected(kind, d, world, rounds)
    if kind == "exact":
        return expected(scatter_max_apply=dl * rounds)
    if kind == "compressed":
        return expected(publish_board=dl * rounds,
                        board_row_gather=dl * rounds)
    # The grid and the node-axis jobs: once a round on the rank's rows of
    # its scenarios.
    return expected(scatter_max_apply=rounds)


def dist_equal(kind, recs, ref) -> bool:
    """Whether every rank's record equals the reference's: the grid's
    table (either axis); the node-axis chaos fleet's state digests rank
    by rank, its counters summed over the ranks, its per-scenario rows
    and curve; a config's curve and ε round; else the state digests rank
    by rank and the curve, and a path job's streams (whole on every
    rank) and carry (rank by rank), its traced run ending where its
    untraced one did."""
    if kind in ("grid", "grid_nodes"):
        return all(r["table"] == ref["table"] for r in recs)
    if kind == "chaos_nodes":
        import numpy as np

        summed = {k: np.sum([r["counters"][k] for r in recs], axis=0).tolist()
                  for k in ref["counters"]}
        return summed == ref["counters"] and all(
            r["digests"] == ref["digests"][r["rank"]]
            and all(r[k] == ref[k] for k in (
                "rounds", "eps_round", "exchange_bytes", "frontier_max",
                "curve")) for r in recs)
    if kind in ("config4", "config5"):
        return all(r["curve"] == ref["curve"]
                   and r["eps_round"] == ref["eps_round"]
                   and r["n"] == ref["n"] for r in recs)
    ok = all(r["digests"] == ref["digests"][r["rank"]]
             and r["curve"] == ref["curve"] for r in recs)
    if "stream_digests" in ref:
        ok = ok and all(r["stream_digests"] == ref["stream_digests"]
                        and r["traced_equals_untraced"] for r in recs)
        ok = ok and ref["traced_equals_untraced"]
    if "carry_digests" in ref:
        ok = ok and all(r["carry_digests"] == ref["carry_digests"][r["rank"]]
                        for r in recs)
    return ok


def dist_node_summary(recs, ref, rounds) -> dict:
    """A node-axis job's figures, a rank a round where so named: the
    fleet's rounds/s beside the one-process run's, the bytes each rank
    sent to the other and staged through the host (its node group's
    row collectives and the world's gathers), the idle share (profiled
    jobs only), peak memory and K4a launches."""
    fleet_wall = max(r["fleet_wall_s"] for r in recs)
    out = {"layout": {"scenario_blocks": 1, "node_blocks": len(recs)},
           "fleet_rounds_per_s": rounds / fleet_wall,
           "one_process_fleet_rounds_per_s": rounds / ref["fleet_wall_s"],
           "ranks_detail": []}
    for r in recs:
        sent = r["exchange"]["bytes_sent"] + r["node_exchange"]["bytes_sent"]
        staged = r["exchange"]["staging_bytes"] + \
            r["node_exchange"]["staging_bytes"]
        prof = r.get("profile", {})
        out["ranks_detail"].append({
            "rank": r["rank"], "bytes_sent_per_round": sent / rounds,
            "staging_bytes_per_round": staged / rounds,
            "node_group_collectives": r["node_exchange"]["collectives"],
            "device_idle_share": prof.get(
                "device_idle_share", "not measured: one node-axis job is "
                "profiled"),
            "max_memory_allocated": r["max_memory_allocated"],
            "scatter_max_apply_launches":
                r["launches"]["scatter_max_apply"]})
    return out


def phase_dist(smi, topo=None, north_star_n=100_000, config5=None):
    """The twins and the fleet's scenario and node axes over a
    ``torch.distributed`` group (``parallel/dist.py``,
    ``parallel/launch.py``) on this one card:
    NCCL with one rank holding d = 4 shards (real NCCL collectives on the
    card's tensors), then gloo with two ranks of two shards each sharing
    the card (every exchanged tensor copied through the host), each job
    held against the same run through ``LocalShardGroup`` in this
    process — the final state's digests rank by rank and the curve,
    every row of the grid's table, every stream field of a traced run and
    each rank's part of a pipelined carry — and config5 against the
    single-device run of the ``chaos`` phase (``config5``, or run here).
    On gloo the fleet's node axis runs too: the grid and the chaos batch
    with each scenario's nodes split over the two ranks, held against
    the one-process fleet (the grid's table shared with the scenario-axis
    job).  Returns the launch counts of every run, the ranks' summed."""
    import math

    from sidecar_tpu_torch.parallel import spawn_group

    graphs = {} if topo is None else {topo.n: topo}
    topo = dist_topology(north_star_n, graphs)
    topo_data = (topo.n, topo.nbrs, topo.deg, topo.name)
    all_counts, failed, cache = [], [], {}
    t_phase = time.perf_counter()
    groups = dist_jobs(north_star_n)
    worlds = sorted({world for _, world, _ in groups})
    for backend, world, jobs in groups:
        refs = []
        for kind, mode, d, n, rounds in jobs:
            # The exact twin's trajectory is the same in every mode (the
            # port's generator), so one reference serves them all; a
            # path job's serves every world size.
            key = ("grid" if kind == "grid_nodes" else kind, n, rounds,
                   None if kind in DIST_PATHS else world,
                   None if kind == "exact" else mode)
            if key not in cache:
                cache[key] = dist_reference(kind, mode, d, n, rounds, world,
                                            graphs, config5, worlds)
                all_counts.append(cache[key]["launches"])
            ref = dict(cache[key])
            for k in ("digests", "carry_digests"):
                if kind in DIST_PATHS and k in ref:
                    ref[k] = ref[k][world]
            refs.append(ref)
        t0 = time.perf_counter()
        ranks = spawn_group(dist_rank, world, backend, (jobs, topo_data),
                            device=DEVICE, timeout_s=900.0)
        spawn_wall = time.perf_counter() - t0
        for j, (kind, mode, d, n, rounds) in enumerate(jobs):
            recs = [r[j] for r in ranks]
            ref = refs[j]
            counts = {k: sum(r["launches"][k] for r in recs)
                      for k in recs[0]["launches"]}
            all_counts.append(counts)
            want = dist_expected(kind, d, world, rounds)
            equal = dist_equal(kind, recs, ref)
            if kind in ("grid", "grid_nodes"):
                finite = all(math.isfinite(row["final_convergence"])
                             for row in recs[0]["table"])
            elif kind == "chaos_nodes":
                finite = all(math.isfinite(c) for row in ref["curve"]
                             for c in row)
            else:
                finite = all(math.isfinite(c) for c in ref["curve"])
            ok = (equal and finite
                  and all(r["launches"] == want for r in recs))
            wall = max(r["wall_s"] for r in recs)
            line = {"phase": "dist", "backend": backend, "world": world,
                    "job": kind, "board_exchange": mode, "d": d, "n": n,
                    "rounds": rounds, "card": smi,
                    "wall_s": wall, "rounds_per_s": rounds / wall,
                    "local_group_wall_s": ref["wall_s"],
                    "local_group_rounds_per_s": rounds / ref["wall_s"],
                    "equal_to_local_group": equal, "launches": counts,
                    "ranks": [{k: r[k] for k in (
                        "rank", "wall_s", "untraced_wall_s", "fleet_wall_s",
                        "setup_s", "digest_s", "profile_s",
                        "launches", "max_memory_allocated", "exchange",
                        "node_exchange", "profile") if k in r}
                        for r in recs],
                    "ok": ok}
            if kind in DIST_NODE_JOBS:
                line.update(dist_node_summary(recs, ref, rounds))
            if "untraced_wall_s" in recs[0]:
                traced = max(r["wall_s"] for r in recs)
                plain = max(r["untraced_wall_s"] for r in recs)
                line.update(ms_per_round_traced=1e3 * traced / rounds,
                            ms_per_round_untraced=1e3 * plain / rounds,
                            local_group_ms_per_round_traced=1e3
                            * ref["wall_s"] / rounds,
                            local_group_ms_per_round_untraced=1e3
                            * ref["untraced_wall_s"] / rounds)
            if kind == "config5" and ref.get("single_device"):
                line["reference"] = "single device (the chaos phase)"
                line.pop("local_group_wall_s")
                line.pop("local_group_rounds_per_s")
            if kind in ("config4", "config5"):
                line["eps_round"] = ref["eps_round"]
            if kind in ("grid", "grid_nodes"):
                # The walls above include each side's table (its host
                # digest of every final belief); the runs alone:
                line["scenarios"] = len(ref["table"])
                line["fleet_wall_s"] = max(r["fleet_wall_s"] for r in recs)
                line["local_group_fleet_wall_s"] = ref["fleet_wall_s"]
                line["scenarios_per_s"] = len(ref["table"]) / \
                    line["fleet_wall_s"]
            else:
                line["curve"] = ref["curve"]
            emit(line)
            if not ok:
                failed.append((backend, kind, mode))
        emit({"phase": "dist", "backend": backend, "world": world,
              "spawn_wall_s": spawn_wall, "card": smi,
              "phase_s": time.perf_counter() - t_phase})
    if failed:
        raise SystemExit(f"dist phase failed: {failed}")
    return all_counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--n", type=int, default=100_000,
                    help="north-star node count (default 100,000)")
    ap.add_argument("--exact-n", type=int, default=4096,
                    help="exact-model and scatter node count (default "
                         "4,096; the exact lockstep takes min(1,024, "
                         "this))")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    t_main, walls = time.perf_counter(), {}

    @contextlib.contextmanager
    def timed(name):
        # Each phase's wall, printed before the kernels line.
        t0 = time.perf_counter()
        try:
            yield
        finally:
            walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a "
              "GPU", file=sys.stderr)
        return 2
    from sidecar_tpu_torch.ops.kernels import build

    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if "build" in phases or "kernels" in phases:
        t0 = time.perf_counter()
        # The window sweep's builds start with the rest.
        variants = (row_gather_variants().values()
                    if "row_gather_windows" in phases else ())
        libs = build.build(variants=variants)
        walls["build"] = time.perf_counter() - t0
        emit({"phase": "build", "libraries": {k: v.name
                                              for k, v in libs.items()},
              "seconds": walls["build"],
              **{kernel: ptxas_report(build.build_log("publish_gather"),
                                      kernel)
                 for kernel in ("publish_board_kernel",
                                "fused_publish_select_kernel",
                                "fused_publish_gather_kernel")},
              "ptxas": {k: [l.strip() for l in build.build_log(k).splitlines()
                            if "ptxas" in l or "spill" in l] for k in libs}})
    topo = fused = config5 = None
    if phases & {"north_star", "sharded", "telemetry", "fleet"}:
        from sidecar_tpu_torch.ops.topology import erdos_renyi

        # One graph for the kernels' ER(8) peers and both run phases:
        # building it bit for bit with the reference takes over a minute
        # on the host at n=100,000.
        t0 = time.perf_counter()
        topo = erdos_renyi(args.n, avg_degree=8.0, seed=3)
        graph_s = walls["graph"] = time.perf_counter() - t0
    records = {}
    if "kernels" in phases:
        with timed("kernels"):
            records = phase_kernels(args.n, 256, 3, args.exact_n,
                                    args.exact_n * 10, topo)
    if "row_gather_windows" in phases:
        with timed("row_gather_windows"):
            phase_row_gather_windows(args.n)
    if "lockstep" in phases:
        with timed("lockstep"):
            phase_lockstep()
    # The main paths' runs, each with its counts set to 0 just before it
    # and read just after.
    runs = []
    if phases & {"north_star", "sharded", "telemetry"}:
        with timed("north_star"):
            counts, reference, fused = phase_north_star(topo, graph_s,
                                                        **NORTH_STAR_RUN)
            runs += counts
            runs += north_star_modes(topo, fused, **NORTH_STAR_RUN)
        if "sharded" in phases:
            with timed("sharded"):
                runs += phase_sharded(topo, reference, **NORTH_STAR_RUN)
        del reference
    if "scatter" in phases:
        with timed("scatter"):
            runs.append(phase_scatter(args.exact_n))
    if "exact_lockstep" in phases:
        with timed("exact_lockstep"):
            phase_exact_lockstep(min(1024, args.exact_n))
    if "exact" in phases:
        with timed("exact"):
            runs.append(phase_exact(args.exact_n))
    if "exact_modes" in phases:
        with timed("exact_modes"):
            runs.append(phase_exact_modes(args.exact_n))
    if "telemetry" in phases:
        with timed("telemetry"):
            runs += phase_telemetry(topo, fused, args.exact_n)
    del fused
    if "sharded_exact" in phases:
        with timed("sharded_exact"):
            runs += phase_sharded_exact(args.exact_n,
                                        cpu_n=min(1024, args.exact_n))
    if "chaos" in phases:
        with timed("chaos"):
            counts, errs, config5 = phase_chaos(
                args.exact_n, cpu_n=min(1024, args.exact_n))
        runs += counts
        # The kernels' worst differences include the chaos path's own.
        for name, err in errs.items():
            if name in records:
                records[name]["max_abs_err"] = max(
                    records[name]["max_abs_err"], err)
    if "fleet" in phases:
        with timed("fleet"):
            counts, errs = phase_fleet(topo, min(1024, args.exact_n),
                                       args.exact_n)
        runs += counts
        # ... and the fleet path's own.
        for name, err in errs.items():
            if name in records:
                records[name]["max_abs_err"] = max(
                    records[name]["max_abs_err"], err)
    for name, phase in (("autopilot", phase_autopilot),
                        ("scenarios", phase_scenarios),
                        ("bridge", phase_bridge), ("oracle", phase_oracle),
                        ("live", phase_live), ("gossip", phase_gossip)):
        if name in phases:
            with timed(name):
                runs += phase()
    if "dist" in phases:
        # Last: it reuses the north star's graph.
        with timed("dist"):
            runs += phase_dist(smi, topo, args.n, config5)
    del topo
    emit({"phase": "walls", "seconds": walls,
          "total_s": time.perf_counter() - t_main})
    if records:
        emit({"kernels": [
            {"name": f"{name}_kernel", "route": "cuda",
             "source": CSRC + KERNELS[name][0],
             "replaces": KERNELS[name][1],
             "launches": sum(c[name] for c in runs),
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": "bytes", "library_ms": rec["library_ms"]}
            for name, rec in records.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
