#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the compressed model's dense lockstep round — the bench's
north-star workload — through the port's entry points, on one device
and over node shards, and checks it:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — ``nvcc`` builds the kernels from
   ``sidecar_tpu_torch/ops/kernels/csrc`` and reports registers, shared
   memory and spills (``-Xptxas -v``);
3. kernels  — each CUDA kernel against its plain PyTorch version on the
   same CUDA tensors, ``torch.equal`` on every output (integer outputs,
   no tolerance), over adversarial shapes and the north-star shapes;
   then each timed with CUDA events beside its bound;
4. lockstep — n=4096, K=256, ER(8, seed 3), 50 rounds from one set of
   injected draws three ways: on the card with the fused kernel, on the
   card with the publish-only kernel, and on the CPU with the plain
   versions; every state field and the behind curve must be equal;
5. north star — ER(8, seed 3) at n=100,000 and M=1,000,000, K=256, the
   bench's 0.1 % burst, ``run_behind(every=25)`` until the behind count
   crosses ε=1e-4 of the unsettled set (at most 600 rounds), once with
   each kernel; the two runs must agree and each kernel's launch count
   must equal the rounds run;
6. sharded  — the same run through the node-sharded twin in every
   board-exchange mode at d ∈ {1, 4} shards, from the same generator
   seed: each must reach ε in the same rounds with the same behind
   curve and final state as the single-device unfused run, drop no
   pull, and launch the publish and board-row-gather kernels d times a
   round.

Each phase prints one JSON line; then the ``kernels`` line, the card's
``nvidia-smi`` name and power limit, and, last, the device line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line, as does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PHASES = ("device", "build", "kernels", "lockstep", "north_star",
          "sharded")
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
KERNEL_SOURCE = "sidecar_tpu_torch/ops/kernels/csrc/publish_gather.cu"


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
    return cases


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
    return cases


def row_gather_cases():
    """(label, bval, bslot, src, base) for board_row_gather: ragged
    request counts, blocks at an offset with src overshooting them on
    both sides, every row out of block, K from 8 to 1024, F = 1."""
    import numpy as np

    cases = []
    for n, k, f, rows, base, hi in (
            (13, 16, 3, 13, 0, 18), (20, 32, 2, 5, 10, 20),
            (33, 8, 4, 11, 22, 38), (7, 128, 2, 7, 0, 12),
            (9, 1024, 1, 4, 3, 12), (31, 64, 3, 7, 50, 70),
            (1000, 256, 3, 1000, 0, 1000), (777, 256, 1, 250, 500, 1000)):
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
    return cases


def to_cuda(arrays):
    import torch

    return [torch.as_tensor(a).cuda() for a in arrays]


def max_abs_diff(got, want) -> int:
    import torch

    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


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


def phase_kernels(ns_n: int, ns_k: int, ns_f: int):
    """Every kernel against its plain version; returns the partial
    ``kernels`` records (times and errors)."""
    import numpy as np
    import torch

    from sidecar_tpu_torch.ops.kernels import publish_gather as pg

    worst = {"publish_board": 0, "fused_publish_gather": 0,
             "board_row_gather": 0}
    failures = []
    for label, cache, kw in board_cases():
        cv, cs, se = to_cuda(cache)
        k = cv.shape[1]
        got = pg.publish_board_cuda(cv, cs, se, cache_lines=k, **kw)
        want = pg.publish_board_torch(cv, cs, se, cache_lines=k, **kw)
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        worst["publish_board"] = max(worst["publish_board"], err)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            failures.append(f"publish_board {label}")
    for label, cache, src, now, kw in gather_cases():
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
    got = pg.publish_board_cuda(cv, cs, se, **bkw)
    want = pg.publish_board_torch(cv, cs, se, **bkw)
    worst["publish_board"] = max(worst["publish_board"],
                                 max_abs_diff(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        failures.append("publish_board north-star shape")
    got = pg.fused_publish_gather_cuda(cv, cs, se, src, now, **gkw)
    want = pg.fused_publish_gather_torch(cv, cs, se, src, now, **gkw)
    worst["fused_publish_gather"] = max(worst["fused_publish_gather"],
                                        max_abs_diff(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        failures.append("fused_publish_gather north-star shape")
    del got, want
    torch.cuda.synchronize()

    for label, bval, bslot, src_c, base in row_gather_cases():
        bv, bs, sr = to_cuda((bval, bslot, src_c))
        got = pg.board_row_gather_cuda(bv, bs, sr, base)
        want = pg.board_row_gather_torch(bv, bs, sr, base)
        torch.cuda.synchronize()
        worst["board_row_gather"] = max(worst["board_row_gather"],
                                        max_abs_diff(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            failures.append(f"board_row_gather {label}")

    line = ns_n * ns_k
    board_bytes = line * (4 + 4 + 1) * 2
    fused_bytes = line * (4 + 4 + 1) + src.numel() * 4 + line * 1 + \
        2 * line * ns_f * 4
    times = {
        "publish_board": (
            cuda_time_ms(lambda: pg.publish_board_cuda(cv, cs, se, **bkw)),
            cuda_time_ms(lambda: pg.publish_board_torch(cv, cs, se, **bkw)),
            board_bytes),
        "fused_publish_gather": (
            cuda_time_ms(lambda: pg.fused_publish_gather_cuda(
                cv, cs, se, src, now, **gkw)),
            cuda_time_ms(lambda: pg.fused_publish_gather_torch(
                cv, cs, se, src, now, **gkw)),
            fused_bytes),
    }
    records = {}
    for name, (ms, plain_ms, nbytes) in times.items():
        records[name] = dict(max_abs_err=worst[name], ms=ms,
                             plain_ms=plain_ms,
                             bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                             bytes=nbytes, library_ms=None)

    # The board row gather at the sharded north star's two shapes, on a
    # published board: d=1 (all_gather: the whole board at base 0) and
    # d=4 (shard 2's own block at base 2·nl, its rows' sampled peers).
    bval, bslot, _ = pg.publish_board_cuda(cv, cs, se, **bkw)
    del cv, cs, se
    nl = ns_n // 4
    blk = slice(2 * nl, 3 * nl)
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
    records["board_row_gather"] = dict(rg["d=1"],
                                       max_abs_err=worst["board_row_gather"])
    emit({"phase": "kernels", "cases": len(board_cases())
          + len(gather_cases()) + len(row_gather_cases()) + 4,
          "failures": failures,
          "shape": {"n": ns_n, "k": ns_k, "f": ns_f},
          "kernels": records, "board_row_gather_shapes": rg})
    if failures:
        raise SystemExit(f"kernel parity failed: {failures}")
    return records


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


def reset_launches():
    from sidecar_tpu_torch.ops.kernels import publish_gather as pg

    pg.publish_board_cuda.launches = 0
    pg.fused_publish_gather_cuda.launches = 0
    pg.board_row_gather_cuda.launches = 0


def launches():
    from sidecar_tpu_torch.ops.kernels import publish_gather as pg

    return {"publish_board": pg.publish_board_cuda.launches,
            "fused_publish_gather": pg.fused_publish_gather_cuda.launches,
            "board_row_gather": pg.board_row_gather_cuda.launches}


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
          and counts["cuda_fused"] == {"publish_board": 0,
                                       "fused_publish_gather": rounds,
                                       "board_row_gather": 0}
          and counts["cuda_unfused"] == {"publish_board": rounds,
                                         "fused_publish_gather": 0,
                                         "board_row_gather": 0}
          and bool(torch.isfinite(runs["cpu"][1]).all()))
    emit({"phase": "lockstep", "n": n, "rounds": rounds, "every": every,
          "behind": runs["cpu"][1].tolist(), "field_diffs": diffs,
          "curves_equal": curves_equal, "launches": counts, "ok": ok})
    if not ok:
        raise SystemExit("lockstep phase failed")


# -- phase 5: the north star -----------------------------------------------------

def run_to_eps(sim, state, generator, *, eps, max_rounds, every, thr_total,
               thr_unsettled):
    """``run_behind`` in chunks of ``every`` rounds until the behind
    count crosses the unsettled-set threshold (or ``max_rounds``)."""
    import torch

    curve, hit_total, hit_unsettled, rounds = [], None, None, 0
    first = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while rounds < max_rounds:
        state, behind = sim.run_behind(state, every, every,
                                       generator=generator)
        rounds += every
        first = state if first is None else first
        b = float(behind[-1])
        curve.append(b)
        if hit_total is None and b <= thr_total:
            hit_total = rounds
        if b <= thr_unsettled:
            hit_unsettled = rounds
            break
    torch.cuda.synchronize()
    return state, first, curve, hit_total, hit_unsettled, rounds, \
        time.perf_counter() - t0


# Coarse kernel families of a profiled round: the first key found in
# the kernel's lower-cased name (PyTorch's kernels carry their
# operation's name).
KERNEL_FAMILIES = (("board_row_gather_kernel", "K3 board_row_gather"),
                   ("publish_board_kernel", "K2 publish_board"),
                   ("fused_publish_gather_kernel", "K1 fused_publish_gather"),
                   ("index", "indexing (gathers, scatters)"),
                   ("gather", "indexing (gathers, scatters)"),
                   ("scatter", "indexing (gathers, scatters)"),
                   ("catarray", "cat"), ("sort", "sort"),
                   ("reduce", "reductions"), ("scan", "scans"),
                   ("elementwise", "elementwise"), ("memcpy", "copies"),
                   ("memset", "copies"), ("copy", "copies"))


def profile_rounds(sim, state, rounds=5):
    """Device activity of ``rounds`` rounds from ``state`` under
    ``torch.profiler`` (after one unprofiled pass over the same draws):
    device-busy time a round (the union of the kernels' intervals), the
    host wall of the profiled window, and device time by kernel
    family.  The profiler slows the host side, so the idle share it
    gives is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = sim.default_generator(7)
    draws = [sim.draw(gen, state.round_idx + 1 + i) for i in range(rounds)]
    sim.run_fast(state, rounds, draws=draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_fast(state, rounds, draws=draws)
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
        final, first, curve, hit_total, hit_unsettled, rounds, wall = \
            run_to_eps(sim, state, sim.default_generator(0), eps=eps,
                       max_rounds=max_rounds, every=every, **thr)
        counts = launches()
        breakdown = None
        if fused:
            breakdown = phase_breakdown(sim, first,
                                        sim.default_generator(5))
        profile = profile_rounds(sim, first)
        label = "fused" if fused else "unfused"
        results[label] = (final, curve, counts, (hit_total, hit_unsettled),
                          rounds)
        kernel = "fused_publish_gather" if fused else "publish_board"
        other = "publish_board" if fused else "fused_publish_gather"
        ok = (counts[kernel] == rounds and counts[other] == 0
              and counts["board_row_gather"] == 0
              and all(math.isfinite(b) for b in curve)
              and hit_unsettled is not None)
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
              "profile_after_first_sample": profile, "ok": ok})
        if not ok:
            raise SystemExit(f"north-star phase failed ({label})")
    diffs = states_equal(results["fused"][0], results["unfused"][0])
    same = not diffs and results["fused"][1] == results["unfused"][1]
    emit({"phase": "north_star_paths_agree", "field_diffs": diffs,
          "ok": same})
    if not same:
        raise SystemExit("fused and unfused north-star runs differ")
    final, curve, _counts, hits, rounds = results["unfused"]
    return [results["fused"][2], results["unfused"][2]], \
        (final, curve, hits, rounds)


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
        final, first, curve, hit_total, hit_unsettled, rounds, wall = \
            run_to_eps(sim, state, sim.default_generator(0), eps=eps,
                       max_rounds=max_rounds, every=every, **thr)
        counts = launches()
        all_counts.append(counts)
        profile = profile_rounds(sim, first)
        diffs = states_equal(ref_final, final)
        dropped = sim.sync_exchange_metrics(final)
        ok = (not diffs and curve == ref_curve and rounds == ref_rounds
              and (hit_total, hit_unsettled) == ref_hits and dropped == 0
              and counts == {"publish_board": d * rounds,
                             "fused_publish_gather": 0,
                             "board_row_gather": d * rounds}
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
    return all_counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--n", type=int, default=100_000,
                    help="north-star node count (default 100,000)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

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
        lib = build.build()
        emit({"phase": "build", "library": lib.name,
              "seconds": time.perf_counter() - t0,
              "ptxas": [l.strip() for l in build.build_log().splitlines()
                        if "ptxas" in l or "spill" in l]})
    records = {}
    if "kernels" in phases:
        records = phase_kernels(args.n, 256, 3)
    if "lockstep" in phases:
        phase_lockstep()
    # The main path's runs, each with its counts set to 0 just before it
    # and read just after.
    runs = []
    if "north_star" in phases or "sharded" in phases:
        from sidecar_tpu_torch.ops.topology import erdos_renyi

        # One graph for both phases: the bit-identical builder takes
        # over a minute on the host at n=100,000.
        t0 = time.perf_counter()
        topo = erdos_renyi(args.n, avg_degree=8.0, seed=3)
        graph_s = time.perf_counter() - t0
        counts, reference = phase_north_star(topo, graph_s,
                                             **NORTH_STAR_RUN)
        runs += counts
        if "sharded" in phases:
            runs += phase_sharded(topo, reference, **NORTH_STAR_RUN)
    if records:
        replaces = {
            "fused_publish_gather":
                "sidecar_tpu/ops/kernels/publish_gather.py:371",
            "publish_board": "sidecar_tpu/ops/kernels/publish_gather.py:193",
            "board_row_gather":
                "sidecar_tpu/ops/kernels/publish_gather.py:265",
        }
        emit({"kernels": [
            {"name": f"{name}_kernel", "route": "cuda",
             "source": KERNEL_SOURCE, "replaces": replaces[name],
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
