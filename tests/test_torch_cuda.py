"""Tests of the port that need the card: each CUDA kernel against its
plain PyTorch version on the same CUDA tensors, and short runs of the
compressed model, its sharded twin, the exact model, the scenario
fleet of each family, the autopilot's recommendation, the scenario
configs and the simulator bridge's routes on the card against the same
runs on the CPU, and the card's exact model against the NumPy oracle.
Marked ``cuda``; each decides inside a fixture whether a card is present
and skips with the reason where none is.  ``python3 chip_smoke.py`` covers the same ground at the
north-star shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidecar_tpu_torch import convert
from sidecar_tpu_torch.models.compressed import (
    CompressedParams,
    CompressedSim,
)
from sidecar_tpu_torch.models.exact import ExactSim, SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import topology
from sidecar_tpu_torch.ops.kernels import publish_gather as pg
from sidecar_tpu_torch.ops.kernels import scatter_max as sm
from sidecar_tpu_torch.parallel import ShardedCompressedSim

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def cache(rng, n, k, tie_value=None):
    ts = np.full((n, k), tie_value) if tie_value is not None else \
        rng.integers(1, 1 << 20, (n, k))
    cs = np.where(rng.random((n, k)) < 0.7,
                  rng.integers(0, 8 * n, (n, k)), -1)
    cv = np.where(cs >= 0, ts << 3, 0)
    se = rng.integers(0, 8, (n, k))
    return (torch.tensor(cv, dtype=torch.int32).cuda(),
            torch.tensor(cs, dtype=torch.int32).cuda(),
            torch.tensor(se, dtype=torch.int8).cuda())


@pytest.mark.parametrize("n,k", [(7, 8), (33, 16), (130, 32), (64, 256),
                                 (9, 1024)])
@pytest.mark.parametrize("ties", [False, True])
def test_publish_board_kernel_equals_plain(card, n, k, ties):
    cv, cs, se = cache(np.random.default_rng(n + k), n, k,
                       tie_value=5 if ties else None)
    kw = dict(budget=5, limit=6, fanout=3, cache_lines=k, row_offset=3)
    got = pg.publish_board_cuda(cv, cs, se, **kw)
    want = pg.publish_board_torch(cv, cs, se, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def corner_cache(rng, case, n, k):
    """(cache triple on the card, kwargs) of one corner of the
    warp-per-row publish kernel; "misaligned" starts all three buffers
    one element past an aligned address (the scalar path)."""
    budget, row_offset = min(15, k), 3
    cv, cs, se = (t.cpu().numpy() for t in cache(rng, n, k))
    if case in ("budget-1", "budget-k"):
        budget = 1 if case == "budget-1" else k
    elif case in ("exactly-b", "b-minus-1"):
        positive = budget - (case == "b-minus-1")
        cv, cs = np.zeros_like(cv), np.full_like(cs, -1)
        for r in range(n):
            cols = rng.choice(k, positive, replace=False)
            cv[r, cols] = rng.integers(1, 40, positive) << 3
            cs[r, cols] = rng.integers(0, 8 * n, positive)
    elif case == "bit30":
        cv = np.where(cs >= 0, cv | (1 << 30), 0)
    elif case == "all-tied":
        cv, cs = np.full_like(cv, 40 << 3), np.arange(n * k).reshape(n, k)
        se = np.zeros_like(se)
    elif case == "high-offset":
        row_offset = (1 << 30) + 12345
        cv, se = np.where(cs >= 0, 5 << 3, 0), np.zeros_like(se)
    arrays = [torch.tensor(cv, dtype=torch.int32),
              torch.tensor(cs, dtype=torch.int32),
              torch.tensor(se, dtype=torch.int8)]
    if case == "misaligned":
        arrays = [torch.cat([t.reshape(-1)[:1], t.reshape(-1)]).cuda()[1:]
                  .view(n, k) for t in arrays]
    else:
        arrays = [t.cuda() for t in arrays]
    return arrays, dict(budget=budget, limit=6, fanout=3, cache_lines=k,
                        row_offset=row_offset)


@pytest.mark.parametrize("k", [1, 2, 4, 32, 256, 1024])
@pytest.mark.parametrize("case", ["budget-1", "budget-k", "exactly-b",
                                  "b-minus-1", "bit30", "all-tied",
                                  "high-offset", "misaligned"])
def test_publish_board_kernel_corners(card, k, case):
    """The warp-per-row kernel's corners: K below, at and above a warp
    (1, 2 or 4 lines a lane take the scalar path; 8 and 32 the
    vectors), budget 1 and budget K, rows with exactly B and B - 1
    positive priorities (the t = 0 shortcut's edge), bit 30 set, every
    line tied, a row_offset above 2^30 (gid · 2654435761 wraps mod
    2^32), and buffers one element past an aligned address."""
    rng = np.random.default_rng(k)
    (cv, cs, se), kw = corner_cache(rng, case, 40, k)
    if case == "misaligned":
        assert cv.data_ptr() % 16 and se.data_ptr() % 2
    before = pg.publish_board_cuda.launches
    got = pg.publish_board_cuda(cv, cs, se, **kw)
    want = pg.publish_board_torch(cv, cs, se, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pg.publish_board_cuda.launches - before == 1


@pytest.mark.parametrize("n,k,f", [(20, 16, 3), (33, 64, 2), (7, 8, 4),
                                   (50, 1024, 3)])
def test_fused_gather_kernel_equals_plain(card, n, k, f):
    rng = np.random.default_rng(n * k)
    cv, cs, se = cache(rng, n, k)
    src = torch.tensor(rng.integers(0, n, (n, f)),
                       dtype=torch.int32).cuda()
    kw = dict(stale_ticks=1 << 18, budget=5, limit=6, fanout=f,
              cache_lines=k)
    got = pg.fused_publish_gather_cuda(cv, cs, se, src, 1 << 19, **kw)
    want = pg.fused_publish_gather_torch(cv, cs, se, src, 1 << 19, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def gather_corner(rng, case, k):
    """(cache triple and src on the card, now, kwargs) of one corner of
    the fused publish gather.  The publish corners come from
    :func:`corner_cache` ("misaligned" also starts src one element past
    an aligned address); N is 43, not a multiple of the 8 rows a select
    block takes, except in "windows", where the rows span two and a
    half of the gather pass's 3 MiB windows (8 K bytes of val and slot a
    row)."""
    n, f, now, stale = 43, 3, 1 << 19, 1 << 18
    if case == "windows":
        n = 5 * ((3 << 20) // (8 * k)) // 2 + 3
    publish = case if case in ("budget-1", "budget-k", "exactly-b",
                               "b-minus-1", "bit30", "all-tied",
                               "misaligned") else "random"
    (cv, cs, se), kw = corner_cache(rng, publish, n, k)
    del kw["row_offset"]
    if case == "f1":
        f = 1
    src = rng.integers(0, n, (n, f))
    if case == "hot-row":
        src[:] = 7
    elif case == "self-sends":
        src[:] = np.arange(n)[:, None]
    elif case == "stale-edge":
        # ts one below the horizon now - stale (stale), at it and one
        # above (kept), and ts = 0 (never stale), any status bits; budget
        # K publishes every eligible line, the stale ones too.
        now, stale, kw["budget"] = 1000, 400, k
        ts = rng.choice([599, 600, 601, 0], (n, k))
        cv = torch.tensor(np.where(cs.cpu().numpy() >= 0,
                                   (ts << 3) | rng.integers(0, 8, (n, k)),
                                   0), dtype=torch.int32).cuda()
    src = torch.tensor(src, dtype=torch.int32)
    if case == "misaligned":
        src = torch.cat([src.reshape(-1)[:1], src.reshape(-1)]).cuda()[1:] \
            .view(n, f)
    else:
        src = src.cuda()
    return (cv, cs, se, src), now, dict(kw, stale_ticks=stale, fanout=f)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 32, 256, 1024])
@pytest.mark.parametrize("case", ["random", "budget-1", "budget-k",
                                  "exactly-b", "b-minus-1", "bit30",
                                  "all-tied", "f1", "hot-row", "self-sends",
                                  "stale-edge", "windows", "misaligned"])
def test_fused_gather_kernel_corners(card, k, case):
    """The two-pass fused publish gather's corners: K from 1 to 1024 (K
    < 4 takes the gather pass's scalar path, K < 32 one mask word a row,
    K = 1024 32 words), budget 1 and budget K, rows with exactly B and
    B - 1 positive priorities, bit 30 set, every line tied, F = 1, a hot
    row that every request names, self-sends, the staleness boundary,
    a ragged N and N over several windows, and all four input buffers
    one element past an aligned address (the scalar paths)."""
    rng = np.random.default_rng(k + 1000)
    (cv, cs, se, src), now, kw = gather_corner(rng, case, k)
    if case == "misaligned":
        assert cv.data_ptr() % 16 and se.data_ptr() % 2 and \
            src.data_ptr() % 16
    before = pg.fused_publish_gather_cuda.launches
    got = pg.fused_publish_gather_cuda(cv, cs, se, src, now, **kw)
    want = pg.fused_publish_gather_torch(cv, cs, se, src, now, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pg.fused_publish_gather_cuda.launches - before == 1
    if case == "stale-edge":
        # Premise: the gate fired (keeping the slot) and spared ts at
        # the horizon.
        assert bool(((got[1] == 0) & (got[2] >= 0)).any())
        assert bool((got[1] >> 3 == 600).any())


@pytest.mark.parametrize("fused", [True, False])
def test_run_on_card_equals_cpu(card, fused):
    p = CompressedParams(n=512, services_per_node=10, cache_lines=256,
                         fold_quorum=0.995, deep_sweep_every=0)
    topo = topology.erdos_renyi(512, 8.0, seed=3)
    t = TimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=4.0)
    cpu = CompressedSim(p, topo, t, device="cpu")
    gpu = CompressedSim(p, topo, t, device="cuda", fused_gather=fused)
    gen = torch.Generator().manual_seed(0)
    draws = [cpu.draw(gen, r) for r in range(1, 31)]
    slots = np.arange(0, p.m, 97)
    a, ca = cpu.run_behind(cpu.mint(cpu.init_state(), slots, 10), 30, 5,
                           draws=draws)
    b, cb = gpu.run_behind(gpu.mint(gpu.init_state(), slots, 10), 30, 5,
                           draws=draws)
    assert torch.equal(ca, cb.cpu())
    for name, value in convert.state_to_numpy(a).items():
        np.testing.assert_array_equal(
            convert.state_to_numpy(b)[name], value, err_msg=name)


@pytest.mark.parametrize("n,k,f,rows,base,hi", [
    (13, 16, 3, 13, 0, 18), (20, 32, 2, 5, 10, 20), (33, 8, 4, 11, 22, 38),
    (9, 1024, 1, 4, 3, 12), (10, 64, 3, 6, 100, 100),
    (70_000, 256, 1, 25_000, 50_000, 100_000), (37, 1, 3, 9, 4, 15),
    (29, 2, 3, 12, 0, 14), (41, 4, 3, 10, 5, 17), (43, 4, 3, 16, 0, 1),
    (23, 6, 1, 8, 2, 12), (101, 1024, 3, 60, 0, 80)])
def test_board_row_gather_kernel_equals_plain(card, n, k, f, rows, base,
                                              hi):
    """Also K = 1, 2 and 6 (the scalar path), K = 4, K = 1024 (a row
    copied in chunks), every request naming row 0 (hi = 1), and request
    counts that are not a multiple of the 8 warps of a block."""
    rng = np.random.default_rng(n + k)
    bval = torch.tensor(rng.integers(0, 1 << 20, (rows, k)),
                        dtype=torch.int32).cuda()
    bslot = torch.tensor(rng.integers(-1, 4 * rows, (rows, k)),
                         dtype=torch.int32).cuda()
    src = torch.tensor(rng.integers(0, hi, (n, f)),
                       dtype=torch.int32).cuda()
    got = pg.board_row_gather_cuda(bval, bslot, src, base)
    want = pg.board_row_gather_torch(bval, bslot, src, base)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_board_row_gather_kernel_misaligned_and_duplicates(card):
    """A board one int32 past a 16-byte boundary (the scalar path at
    K = 256), and a block at an offset named with many duplicates."""
    rng = np.random.default_rng(3)
    rows, k = 40, 256
    bval, bslot = (torch.tensor(rng.integers(-1, 1 << 20, rows * k + 1),
                                dtype=torch.int32).cuda()[1:].view(rows, k)
                   for _ in range(2))
    src = rng.integers(10, 60, (77, 3))
    src[::4] = 33
    src = torch.tensor(src, dtype=torch.int32).cuda()
    got = pg.board_row_gather_cuda(bval, bslot, src, 12)
    want = pg.board_row_gather_torch(bval, bslot, src, 12)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("mode", ["all_gather", "all_to_all", "ring",
                                  "zoned"])
@pytest.mark.parametrize("d", [1, 4])
def test_sharded_run_on_card_equals_cpu(card, mode, d):
    p = CompressedParams(n=512, services_per_node=10, cache_lines=256,
                         fold_quorum=0.995, deep_sweep_every=0)
    topo = topology.erdos_renyi(512, 8.0, seed=3)
    t = TimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=4.0)
    cpu = ShardedCompressedSim(p, topo, t, d=d, board_exchange=mode,
                               device="cpu")
    gpu = ShardedCompressedSim(p, topo, t, d=d, board_exchange=mode)
    gen = torch.Generator().manual_seed(0)
    draws = [cpu.draw(gen, r) for r in range(1, 31)]
    slots = np.arange(0, p.m, 97)
    before = (pg.publish_board_cuda.launches,
              pg.board_row_gather_cuda.launches)
    a, ca = cpu.run_behind(cpu.mint(cpu.init_state(), slots, 10), 30, 5,
                           draws=draws)
    b, cb = gpu.run_behind(gpu.mint(gpu.init_state(), slots, 10), 30, 5,
                           draws=draws)
    assert (pg.publish_board_cuda.launches - before[0],
            pg.board_row_gather_cuda.launches - before[1]) == (30 * d,
                                                               30 * d)
    assert torch.equal(ca, cb.cpu())
    for name, value in convert.state_to_numpy(a).items():
        np.testing.assert_array_equal(
            convert.state_to_numpy(b)[name], value, err_msg=name)


@pytest.mark.parametrize("n,m,u", [(16, 24, 300), (7, 13, 1), (7, 13, 0),
                                   (64, 5120, 20_000)])
def test_scatter_max_apply_kernel_equals_plain(card, n, m, u):
    """Rows up to N and columns up to M (padding, including the (r, M)
    entry a flat index would alias to (r+1, 0)), duplicate cells with
    different values, and the sent reset."""
    rng = np.random.default_rng(n + m + u)
    known = torch.tensor(rng.integers(1, 1 << 20, (n, m)),
                         dtype=torch.int32).cuda()
    sent = torch.tensor(rng.integers(0, 10, (n, m)), dtype=torch.int8).cuda()
    rows = rng.integers(0, n + 1, u)
    cols = rng.integers(0, m + 1, u)
    if u > 8:
        rows[:4], cols[:4] = 2, m
        rows[4:8], cols[4:8] = 1, 5
    rows, cols = (torch.tensor(x, dtype=torch.int32).cuda()
                  for x in (rows, cols))
    vals = torch.tensor(rng.integers(1, 1 << 22, u), dtype=torch.int32).cuda()
    adv = torch.tensor(rng.random(u) < 0.5).cuda()
    want = sm.scatter_max_apply_torch(known.clone(), rows, cols, vals,
                                      sent.clone(), adv)
    before = sm.scatter_max_apply_cuda.launches
    got = sm.scatter_max_apply_cuda(known, rows, cols, vals, sent, adv)
    torch.cuda.synchronize()
    assert got[0] is known and got[1] is sent
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sm.scatter_max_apply_cuda.launches - before == (1 if u else 0)


@pytest.mark.parametrize("regime", ["none", "all"])
@pytest.mark.parametrize("u,offset", [(4000, 0), (4003, 0), (4000, 1)])
def test_scatter_max_apply_kernel_none_or_all_advance(card, regime, u,
                                                      offset):
    """Values that advance no cell they reach (every atomic skipped) or
    every one; whole int4 vectors of triples, a scalar tail of 3, and
    (offset 1) triples that are not 16-byte aligned."""
    rng = np.random.default_rng(u + offset)
    n, m = 32, 320
    lo = 1 << 21 if regime == "none" else 1
    known = torch.tensor(rng.integers(lo, lo + (1 << 20), (n, m)),
                         dtype=torch.int32).cuda()
    sent = torch.tensor(rng.integers(0, 10, (n, m)), dtype=torch.int8).cuda()
    vlo, vhi = (1, 1 << 21) if regime == "none" else (1 << 21, 1 << 22)
    rows, cols, vals = (
        torch.tensor(np.concatenate([np.zeros(offset), x]),
                     dtype=torch.int32).cuda()[offset:]
        for x in (rng.integers(0, n + 1, u), rng.integers(0, m + 1, u),
                  rng.integers(vlo, vhi, u)))
    adv = torch.tensor(rng.random(u) < 0.5).cuda()
    want = sm.scatter_max_apply_torch(known.clone(), rows, cols, vals,
                                      sent.clone(), adv)
    got = sm.scatter_max_apply_cuda(known.clone(), rows, cols, vals,
                                    sent.clone(), adv)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(want[0], known) == (regime == "none")


def test_wrappers_keep_their_messages(card):
    """The wrappers raise their own messages, one check per tensor."""
    known = torch.zeros((4, 8), dtype=torch.int32, device="cuda")
    sent = torch.zeros((4, 8), dtype=torch.int8, device="cuda")
    idx = torch.zeros(5, dtype=torch.int32, device="cuda")
    adv = torch.zeros(5, dtype=torch.bool, device="cuda")
    cases = [
        ((known, idx.long(), idx, idx), "rows must be a 1-D torch.int32"),
        ((known, idx, torch.zeros((5, 2), dtype=torch.int32,
                                  device="cuda")[:, 0], idx),
         "cols must be contiguous"),
        ((known, idx, idx, idx[:4]), "vals has 4 entries, rows 5"),
        ((known, idx, idx, idx, sent[:2], adv), r"sent \(2, 8\) must match"),
        ((known, idx, idx, idx, sent, adv[:3]), "advanced has 3 entries"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            sm.scatter_max_apply_cuda(*args)
    src = torch.zeros((3, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bval must be a 2-D int32"):
        pg.board_row_gather_cuda(known.long(), known, src)
    with pytest.raises(ValueError, match=r"bslot \(4, 4\) must match"):
        pg.board_row_gather_cuda(known, known[:, :4].contiguous(), src)
    with pytest.raises(ValueError, match="cache_lines must be a power"):
        pg.publish_board_cuda(known[:, :6].contiguous(),
                              known[:, :6].contiguous(), sent[:, :6]
                              .contiguous(), budget=2, limit=3, fanout=1,
                              cache_lines=6)


# int32 elements in one tile of the in-place max kernel, 4 a vector × 512
# threads × 8 vectors a thread, and in a sixteenth and a quarter of one
# (counts that end inside a tile).
RMW_TILES = (4 * 512 * 8, 4 * 128 * 2, 4 * 256 * 4)


@pytest.mark.parametrize("count", [1, 3, 4, 5]
                         + [3 * t + d for t in RMW_TILES for d in (-1, 1)])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmw_max_kernel_counts(card, count, offset):
    """Counts with no whole vector, one, one and a tail, and one element
    either side of three tiles, of three sixteenths and of three quarters
    of a tile; aligned and (offset 1) misaligned buffers."""
    rng = np.random.default_rng(count + offset)
    known, other = (torch.tensor(rng.integers(-9, 1 << 20, count + offset),
                                 dtype=torch.int32).cuda()[offset:]
                    for _ in range(2))
    want = torch.maximum(known, other)
    before = sm.rmw_max_cuda.launches
    got = sm.rmw_max_cuda(known, other)
    torch.cuda.synchronize()
    assert got is known and torch.equal(got, want)
    assert sm.rmw_max_cuda.launches - before == 1


@pytest.mark.parametrize("shape,offset", [((8, 40), 0), ((7, 13), 0),
                                          ((1, 3), 0), ((33, 100), 1)])
def test_rmw_max_kernel_equals_plain(card, shape, offset):
    """Whole int4 vectors, a tail of 1-3 elements, and (offset 1) a
    buffer that is not 16-byte aligned."""
    rng = np.random.default_rng(shape[0])
    n = shape[0] * shape[1]
    known = torch.tensor(rng.integers(1, 1 << 20, n + offset),
                         dtype=torch.int32).cuda()[offset:].view(shape)
    other = torch.tensor(rng.integers(1, 1 << 20, n + offset),
                         dtype=torch.int32).cuda()[offset:].view(shape)
    want = torch.maximum(known, other)
    got = sm.rmw_max_cuda(known, other)
    torch.cuda.synchronize()
    assert got is known and torch.equal(got, want)


def test_exact_run_on_card_equals_cpu(card):
    """20 rounds of the exact model at M = 5,120 (the two-stage select),
    with loss, push-pull and the sweep firing, on the card and on the
    CPU from one set of draws; K4a launches once a round."""
    p = SimParams(n=64, services_per_node=80, drop_prob=0.1)
    topo = topology.erdos_renyi(64, 8.0, seed=3)
    t = TimeConfig(push_pull_interval_s=1.0, suspicion_window_s=1.0,
                   alive_lifespan_s=3.0, refresh_interval_s=2.0)
    cpu = ExactSim(p, topo, t, device="cpu")
    gpu = ExactSim(p, topo, t)
    gen = torch.Generator().manual_seed(0)
    draws = [cpu.draw(gen, r) for r in range(1, 21)]
    a, ca = cpu.run(cpu.init_state(), 20, draws=draws)
    before = sm.scatter_max_apply_cuda.launches
    b, cb = gpu.run(gpu.init_state(), 20, draws=draws)
    torch.cuda.synchronize()
    assert sm.scatter_max_apply_cuda.launches - before == 20
    np.testing.assert_allclose(cb.cpu().numpy(), ca.numpy(), rtol=0,
                               atol=1e-6)
    for name, value in convert.state_to_numpy(a).items():
        np.testing.assert_array_equal(
            convert.state_to_numpy(b)[name], value, err_msg=name)


# -- the execution modes ---------------------------------------------------------


@pytest.mark.parametrize("label", ["pads", "one-row", "arange", "shard",
                                   "misaligned"])
def test_publish_board_row_ids_equals_plain(card, label):
    """The publish kernel with explicit global row ids (the sparse
    round's compacted publish) against its plain version: ascending ids
    padded with n, one row, ids ``arange(N)`` (equal to the
    ``row_offset=0`` launch), ids of a far block, and misaligned ids."""
    rng = np.random.default_rng(len(label) + 40)
    n, k = 300, 256
    c = {"pads": 48, "one-row": 1, "arange": n, "shard": 64,
         "misaligned": 33}[label]
    cv, cs, se = cache(rng, c, k, tie_value=7)
    if label == "arange":
        ids = torch.arange(n, dtype=torch.int32, device="cuda")
    elif label == "shard":
        ids = torch.arange(c, dtype=torch.int32, device="cuda") + (1 << 30)
    else:
        real = np.sort(rng.choice(n, max(1, c - 5), replace=False))
        host = np.full(c + 1, n, np.int32)
        host[1:1 + len(real)] = real
        ids = torch.as_tensor(host, device="cuda")
        ids = ids[1:] if label == "misaligned" else ids[:c]
    kw = dict(budget=15, limit=6, fanout=3, cache_lines=k)
    before = pg.publish_board_cuda.launches
    got = pg.publish_board_cuda(cv, cs, se, row_ids=ids, **kw)
    want = pg.publish_board_torch(cv, cs, se, row_ids=ids, **kw)
    torch.cuda.synchronize()
    assert pg.publish_board_cuda.launches - before == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if label == "arange":
        plain = pg.publish_board_cuda(cv, cs, se, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    with pytest.raises(ValueError, match="row_ids must be int32"):
        pg.publish_board_cuda(cv, cs, se, row_ids=ids.long(), **kw)


def mode_pair(model, **kw):
    """The same model on the CPU and on the card, n = 256."""
    t = TimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
    topo = topology.erdos_renyi(256, 8.0, seed=3)
    if model == "compressed":
        p = CompressedParams(n=256, services_per_node=10, cache_lines=256,
                             fold_quorum=0.995, deep_sweep_every=0,
                             drop_prob=0.1, sparse_cap=32)
        cls = CompressedSim
    else:
        # Two services a node and one offer a record (limit 3, fanout
        # 3): the senders thin out within the run.
        p = SimParams(n=256, services_per_node=2, drop_prob=0.1,
                      retransmit_limit=3, sparse_cap=32)
        cls = ExactSim
    return cls(p, topo, t, device="cpu", **kw), cls(p, topo, t, **kw)


def start(sim):
    if isinstance(sim, CompressedSim):
        return sim.mint(sim.init_state(), np.arange(0, sim.p.m, 41), 10)
    return sim.init_state(0.5, seed=1)


def assert_same(a, b):
    for name, value in convert.state_to_numpy(a).items():
        np.testing.assert_array_equal(
            convert.state_to_numpy(b)[name], value, err_msg=name)


@pytest.mark.parametrize("model", ["compressed", "exact"])
def test_sparse_run_on_card_equals_cpu(card, model):
    """A forced-sparse run with a cap that some rounds overflow: equal
    states and stats; on the compressed model the publish kernel
    launches once a sparse round and the fused kernel once an overflow
    round, on the exact model the scatter kernel once a round."""
    cpu, gpu = mode_pair(model)
    gen = torch.Generator().manual_seed(2)
    draws = [cpu.draw(gen, r) for r in range(1, 41)]
    a = cpu.run_fast(start(cpu), 40, draws=draws, sparse=True)
    kernels = (pg.publish_board_cuda, pg.fused_publish_gather_cuda,
               sm.scatter_max_apply_cuda)
    before = [k.launches for k in kernels]
    b = gpu.run_fast(start(gpu), 40, draws=draws, sparse=True)
    torch.cuda.synchronize()
    got = [k.launches - x for k, x in zip(kernels, before)]
    assert_same(a, b)
    stats = gpu.last_sparse_stats.tolist()
    assert stats == cpu.last_sparse_stats.tolist()
    assert stats[0] > 0 and stats[1] > 0
    if model == "compressed":
        assert got == [stats[0], stats[1], 0]
    else:
        assert got == [0, 0, 40]


@pytest.mark.parametrize("model", ["compressed", "exact"])
def test_pipelined_run_on_card_equals_cpu(card, model):
    """A pipelined run (primed, 30 ticks): the compressed model's
    publish kernel launches once a tick and once for the prime, the
    exact model's scatter kernel once a tick."""
    cpu, gpu = mode_pair(model)
    gen = torch.Generator().manual_seed(3)
    draws = [cpu.draw(gen, r) for r in range(1, 32)]
    a, _ = cpu.run_fast_pipelined(start(cpu), 30, draws=draws)
    kernel = pg.publish_board_cuda if model == "compressed" \
        else sm.scatter_max_apply_cuda
    before = kernel.launches
    b, inf = gpu.run_fast_pipelined(start(gpu), 30, draws=draws)
    torch.cuda.synchronize()
    assert kernel.launches - before == (31 if model == "compressed" else 30)
    assert_same(a, b)
    assert inf.round_idx == 31


@pytest.mark.parametrize("model", ["compressed", "exact"])
def test_cadence_run_on_card_equals_cpu(card, model):
    """Per-node periods in {1, 2, 4} and a stagger of period 2."""
    rng = np.random.default_rng(4)
    kw = dict(tick_period=rng.choice([1, 2, 4], 256),
              tick_phase=rng.integers(0, 4, 256))
    cpu, gpu = mode_pair(model, **kw)
    gen = torch.Generator().manual_seed(4)
    draws = [cpu.draw(gen, r) for r in range(1, 31)]
    a = cpu.run_fast(start(cpu), 30, draws=draws)
    b = gpu.run_fast(start(gpu), 30, draws=draws)
    assert_same(a, b)
    topo = topology.with_stagger(topology.erdos_renyi(256, 8.0, seed=3), 2,
                                 seed=1)
    cpu2 = type(cpu)(cpu.p, topo, cpu.t, device="cpu")
    gpu2 = type(gpu)(gpu.p, topo, gpu.t)
    assert_same(cpu2.run_fast(start(cpu2), 30, draws=draws),
                gpu2.run_fast(start(gpu2), 30, draws=draws))


def plane_run(sim, plane, draws, rounds, sparse):
    """One telemetry plane's run; returns ``(final, stream)``."""
    st = start(sim)
    kw = dict(draws=draws, sparse=sparse)
    if plane == "trace":
        out = sim.run_with_trace(st, rounds, **kw)
    elif plane == "digest":
        out = sim.run_with_digest(st, rounds, buckets=32, **kw)
    elif plane == "deltas":
        out = sim.run_with_deltas(st, rounds, 512, **kw)
    else:
        out = sim.run_with_provenance(st, rounds, (0, 41, 287, 510), **kw)
    return out[0], out[1]


def stream_fields(stream) -> dict:
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in vars(stream).items()}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("plane", ["trace", "digest", "deltas",
                                   "provenance"])
@pytest.mark.parametrize("model", ["compressed", "exact"])
def test_plane_on_card_equals_cpu(card, model, plane, sparse):
    """Each telemetry plane, 40 rounds at n = 256 from one set of
    draws (sparse: some rounds overflow, some run compacted): every
    field of the stream and of the final state equal."""
    cpu, gpu = mode_pair(model)
    gen = torch.Generator().manual_seed(2)
    draws = [cpu.draw(gen, r) for r in range(1, 41)]
    a, sa = plane_run(cpu, plane, draws, 40, sparse)
    b, sb = plane_run(gpu, plane, draws, 40, sparse)
    assert_same(a, b)
    if sparse:
        stats = gpu.last_sparse_stats.tolist()
        assert stats == cpu.last_sparse_stats.tolist()
        assert stats[0] > 0 and stats[1] > 0
    fa, fb = stream_fields(sa), stream_fields(sb)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), (plane, k)
        else:
            assert fa[k] == fb[k], (plane, k)


# -- the node-sharded exact twin, and the compressed twin's sparse round -------


@pytest.mark.parametrize("mode", ["all_gather", "ring", "zoned"])
def test_sharded_exact_run_on_card_equals_cpu(card, mode):
    """20 rounds of the exact twin at d = 4 (M = 5,120, the two-stage
    select), with loss, the stride push-pull and the sweep firing, on
    the card and on the CPU from one set of draws; the scatter kernel
    launches once a shard a round."""
    from sidecar_tpu_torch.parallel import ShardedSim

    p = SimParams(n=64, services_per_node=80, drop_prob=0.1)
    topo = topology.erdos_renyi(64, 8.0, seed=3)
    t = TimeConfig(push_pull_interval_s=1.0, suspicion_window_s=1.0,
                   alive_lifespan_s=3.0, refresh_interval_s=2.0)
    cpu = ShardedSim(p, topo, t, d=4, board_exchange=mode, device="cpu")
    gpu = ShardedSim(p, topo, t, d=4, board_exchange=mode)
    gen = torch.Generator().manual_seed(0)
    draws = [cpu.draw(gen, r) for r in range(1, 21)]
    a, ca = cpu.run(cpu.init_state(), 20, draws=draws)
    before = sm.scatter_max_apply_cuda.launches
    b, cb = gpu.run(gpu.init_state(), 20, draws=draws)
    torch.cuda.synchronize()
    assert sm.scatter_max_apply_cuda.launches - before == 4 * 20
    np.testing.assert_allclose(cb.cpu().numpy(), ca.numpy(), rtol=0,
                               atol=1e-6)
    assert_same(a, b)


@pytest.mark.parametrize("r0,nl", [(0, 16), (16, 16), (48, 16), (8, 40)])
def test_scatter_max_apply_kernel_on_a_row_slice(card, r0, nl):
    """K4a on a shard's contiguous row slice ``known[r0:r0+nl]`` of a
    larger buffer, local row ``nl`` the dropped pad: equal to the plain
    version, and the rows outside the slice untouched."""
    n, m, u = 64, 200, 3000
    rng = np.random.default_rng(r0 + nl)
    known = torch.tensor(rng.integers(1, 1 << 20, (n, m)),
                         dtype=torch.int32).cuda()
    sent = torch.tensor(rng.integers(0, 10, (n, m)), dtype=torch.int8).cuda()
    rows, cols = (torch.tensor(rng.integers(0, hi + 1, u),
                               dtype=torch.int32).cuda()
                  for hi in (nl, m))
    vals = torch.tensor(rng.integers(1, 1 << 22, u), dtype=torch.int32).cuda()
    adv = torch.tensor(rng.random(u) < 0.5).cuda()
    want_k, want_s = known.clone(), sent.clone()
    sm.scatter_max_apply_torch(want_k[r0:r0 + nl], rows, cols, vals,
                               want_s[r0:r0 + nl], adv)
    before = sm.scatter_max_apply_cuda.launches
    sm.scatter_max_apply_cuda(known[r0:r0 + nl], rows, cols, vals,
                              sent[r0:r0 + nl], adv)
    torch.cuda.synchronize()
    assert sm.scatter_max_apply_cuda.launches - before == 1
    assert torch.equal(known, want_k) and torch.equal(sent, want_s)


@pytest.mark.parametrize("mode", ["ring", "all_to_all"])
def test_sharded_sparse_run_on_card_equals_cpu(card, mode):
    """The compressed twin's forced-sparse run at d = 4: equal states
    and stats; the publish kernel (compacted, with global row ids, or
    the block's on an overflow round) and the board row gather kernel
    each launch once a shard a round."""
    p = CompressedParams(n=256, services_per_node=10, cache_lines=256,
                         fold_quorum=0.995, deep_sweep_every=0,
                         drop_prob=0.1, sparse_cap=32)
    topo = topology.erdos_renyi(256, 8.0, seed=3)
    t = TimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
    cpu, gpu = (ShardedCompressedSim(p, topo, t, d=4, board_exchange=mode,
                                     device=dev) for dev in ("cpu", "cuda"))
    gen = torch.Generator().manual_seed(2)
    draws = [cpu.draw(gen, r) for r in range(1, 41)]
    a = cpu.run_fast(start(cpu), 40, draws=draws, sparse=True)
    kernels = (pg.publish_board_cuda, pg.fused_publish_gather_cuda,
               pg.board_row_gather_cuda)
    before = [k.launches for k in kernels]
    b = gpu.run_fast(start(gpu), 40, draws=draws, sparse=True)
    torch.cuda.synchronize()
    got = [k.launches - x for k, x in zip(kernels, before)]
    assert_same(a, b)
    stats = gpu.last_sparse_stats.tolist()
    assert stats == cpu.last_sparse_stats.tolist()
    assert stats[0] > 0 and stats[1] > 0
    assert got == [4 * 40, 0, 4 * 40]


# -- chaos and the partition hooks ----------------------------------------------


def test_scatter_max_apply_kernel_drops_ring_sentinel_rows(card):
    """The chaos round's scatter: the delay rings' empty entries carry
    row N (the sentinel), mixed among live rows, with values 0 and
    advanced set; the kernel drops them as the plain version does."""
    n, m, u = 48, 200, 9000
    rng = np.random.default_rng(8)
    known = torch.tensor(rng.integers(1, 1 << 20, (n, m)),
                         dtype=torch.int32).cuda()
    sent = torch.tensor(rng.integers(0, 10, (n, m)), dtype=torch.int8).cuda()
    rows = rng.integers(0, n, u)
    rows[rng.random(u) < 0.4] = n
    cols = rng.integers(0, m, u)
    vals = rng.integers(1, 1 << 22, u)
    vals[rows == n] = rng.choice([0, 1 << 23], int((rows == n).sum()))
    rows, cols, vals = (torch.tensor(x, dtype=torch.int32).cuda()
                        for x in (rows, cols, vals))
    adv = torch.tensor(rng.random(u) < 0.5).cuda()
    want = sm.scatter_max_apply_torch(known.clone(), rows, cols, vals,
                                      sent.clone(), adv)
    got = sm.scatter_max_apply_cuda(known, rows, cols, vals, sent, adv)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [1000, 70_000])
def test_fused_gather_kernel_at_k64_equals_plain(card, n):
    """K1 at config 5's width, K = 64, F = 3: at n = 70,000 the rows
    span several of the gather pass's row windows."""
    rng = np.random.default_rng(n)
    cv, cs, se = cache(rng, n, 64)
    src = torch.tensor(rng.integers(0, n, (n, 3)), dtype=torch.int32).cuda()
    kw = dict(stale_ticks=1 << 18, budget=15, limit=24, fanout=3,
              cache_lines=64)
    got = pg.fused_publish_gather_cuda(cv, cs, se, src, 1 << 19, **kw)
    want = pg.fused_publish_gather_torch(cv, cs, se, src, 1 << 19, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_chaos_run_on_card_equals_cpu(card):
    """30 chaos rounds at n = 64 × 10 under drops, a partition, a delay
    ring with duplicates, a crash, clock skew and a tombstone bomb, the
    defences on, from one set of draws and fault draws: every field,
    the rings and the counters equal; K4a once a round."""
    from sidecar_tpu_torch.chaos import (
        AdversaryPlan,
        Attack,
        ChaosExactSim,
        ClockFault,
        EdgeFault,
        FaultPlan,
        NodeFault,
    )

    n = 64
    a, b = tuple(range(32)), tuple(range(32, 64))
    plan = FaultPlan(
        seed=3,
        edges=(EdgeFault(src=a, dst=b, drop_prob=0.2),
               EdgeFault(src=b, dst=a, delay_rounds=3, delay_prob=0.2,
                         duplicate_prob=0.1)),
        nodes=(NodeFault(nodes=(1, 2), start_round=5, end_round=12,
                         kind="crash"),),
        clocks=(ClockFault(nodes=(4, 5), end_round=40, offset_ticks=2000,
                           drift_ticks_per_round=12.5),),
    ).with_edges(*FaultPlan.partition(a, b, 10, 20))
    adv = AdversaryPlan(seed=1, attacks=(
        Attack("tombstone_bomb", nodes=(7,), victims=b, start_round=8,
               end_round=25, rate=0.5),))
    p = SimParams(n=n, services_per_node=10, drop_prob=0.1)
    t = TimeConfig(push_pull_interval_s=1.0, future_fudge_s=0.5,
                   origin_budget=2, origin_quarantine=3)
    topo = topology.erdos_renyi(n, 8.0, seed=3)
    cpu = ChaosExactSim(p, topo, t, plan, device="cpu", adversary=adv)
    gpu = ChaosExactSim(p, topo, t, plan, adversary=adv)
    gen = torch.Generator().manual_seed(0)
    draws = [cpu.draw(gen, r) for r in range(1, 31)]
    faults = [cpu.fault_draw(r) for r in range(1, 31)]
    x = cpu.run_fast(cpu.init_state(), 30, draws=draws, fault_draws=faults)
    before = sm.scatter_max_apply_cuda.launches
    y = gpu.run_fast(gpu.init_state(), 30, draws=draws, fault_draws=faults)
    torch.cuda.synchronize()
    assert sm.scatter_max_apply_cuda.launches - before == 30
    for name, value in convert.state_to_numpy(x.sim).items():
        np.testing.assert_array_equal(
            convert.state_to_numpy(y.sim)[name], value, err_msg=name)
    for ra, rb in zip(x.rings, y.rings):
        assert all(torch.equal(u, v.cpu()) for u, v in zip(ra, rb))
    assert cpu.injection_counts(x) == gpu.injection_counts(y)
    assert torch.equal(x.origin_violations, y.origin_violations.cpu())


@pytest.mark.parametrize("fused", [True, False])
def test_cut_and_sides_run_on_card_equals_cpu(card, fused):
    """30 rounds of the compressed model on an 8 × 8 mesh split into
    column halves, the cut on the sample and the sides on the stride
    push-pull, on the card and on the CPU from one set of draws."""
    topo = topology.mesh2d(8, 8)
    side = (np.arange(64) % 8 >= 4).astype(np.int32)
    cut = topology.partition_mask(topo, side)
    p = CompressedParams(n=64, services_per_node=4, cache_lines=64,
                         fold_quorum=0.5)
    t = TimeConfig(push_pull_interval_s=1.0)
    kw = dict(fused_gather=fused, cut_mask=cut, node_side=side)
    cpu = CompressedSim(p, topo, t, device="cpu", **kw)
    gpu = CompressedSim(p, topo, t, **kw)
    gen = torch.Generator().manual_seed(1)
    draws = [cpu.draw(gen, r) for r in range(1, 31)]
    slots = np.arange(0, 128, 3)
    a, ca = cpu.run(cpu.mint(cpu.init_state(), slots, 10), 30, draws=draws)
    b, cb = gpu.run(gpu.mint(gpu.init_state(), slots, 10), 30, draws=draws)
    torch.cuda.synchronize()
    assert torch.equal(ca, cb.cpu())
    for name, value in convert.state_to_numpy(a).items():
        np.testing.assert_array_equal(
            convert.state_to_numpy(b)[name], value, err_msg=name)


# -- the scenario fleet ---------------------------------------------------------


def fleet_pair(family):
    """A small batch of ``family`` (exact, chaos or compressed) on the
    CPU and on the card, with one set of inputs drawn on the CPU: each
    scenario's round draws, its churn masks and its fault draws."""
    from sidecar_tpu_torch.chaos import EdgeFault, FaultPlan, NodeFault
    from sidecar_tpu_torch.fleet import (
        FleetSim,
        ScenarioBatch,
        ScenarioSpec,
        restart_churn_perturb,
    )

    rounds, n = 20, 64
    base = TimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
    plan = None
    if family == "compressed":
        p = CompressedParams(n=n, services_per_node=4, cache_lines=32)
        specs = [ScenarioSpec(name="a", seed=1, mint_frac=0.05),
                 ScenarioSpec(name="b", seed=2, mint_frac=0.05,
                              drop_prob=0.1, retransmit_limit=8),
                 ScenarioSpec(name="c", seed=3, mint_frac=0.1,
                              push_pull_interval_s=1.0,
                              suspicion_window_s=1.0, alive_lifespan_s=2.0,
                              sweep_interval_s=0.4)]
    else:
        p = SimParams(n=n, services_per_node=4, fanout=3, budget=8)
        specs = [ScenarioSpec(name="a", seed=1),
                 ScenarioSpec(name="c", seed=3, push_pull_interval_s=1.0,
                              suspicion_window_s=1.0, alive_lifespan_s=2.0,
                              sweep_interval_s=0.4, future_fudge_s=0.5,
                              origin_budget=1),
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
    fams = "compressed" if family == "compressed" else "exact"
    cpu_b = ScenarioBatch.build(specs, p, base, family=fams, plan=plan,
                                device="cpu")
    gpu_b = ScenarioBatch.build(specs, p, base, family=fams, plan=plan)
    cpu_probe = FleetSim(cpu_b)
    draws = [[cpu_probe.draw(i, r) for r in range(1, rounds + 1)]
             for i in range(len(specs))]
    faults = None
    if plan is not None:
        faults = [[cpu_probe.fault_draw(i, r) for r in range(1, rounds + 1)]
                  for i in range(len(specs))]
    gen = torch.Generator().manual_seed(4)
    masks = [{r: torch.rand(p.m, generator=gen) < s.churn_prob
              for r in range(1, rounds + 1)} if s.churn_prob else None
             for s in specs]
    hook = restart_churn_perturb(p, masks=masks) if fams == "exact" \
        else None
    return (FleetSim(cpu_b, perturb=hook), FleetSim(gpu_b, perturb=hook),
            dict(draws=draws, fault_draws=faults), rounds)


def fleet_leaves(state):
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "sim":
            out.update({f"sim.{k}": x for k, x in fleet_leaves(v).items()})
        elif f.name == "rings":
            for i, ring in enumerate(v):
                for j, t in enumerate(ring):
                    out[f"ring{i}.{j}"] = t.cpu().numpy()
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.cpu().numpy()
        else:
            out[f.name] = np.asarray(v)
    return out


@pytest.mark.parametrize("family", ["exact", "chaos", "compressed"])
@pytest.mark.parametrize("stop", [False, True])
def test_fleet_run_on_card_equals_cpu(card, family, stop):
    """A small fleet of each family on the card equals the same fleet on
    the CPU from one set of inputs: every field, the stats and the
    curves.  K4a launches once a round for the whole exact or chaos
    batch; K1 once per scenario a round on the compressed one.  With
    early exit ``eps`` freezes one scenario mid-run while the others run
    on, the middle one first on the exact and chaos families."""
    cpu, gpu, inputs, rounds = fleet_pair(family)
    eps = 0.003 if family == "compressed" else 0.2
    a = cpu.run(cpu.init_states(), rounds, stop=stop, eps=eps, **inputs)
    before = (sm.scatter_max_apply_cuda.launches,
              pg.fused_publish_gather_cuda.launches)
    b = gpu.run(gpu.init_states(), rounds, stop=stop, eps=eps, **inputs)
    torch.cuda.synchronize()
    got = (sm.scatter_max_apply_cuda.launches - before[0],
           pg.fused_publish_gather_cuda.launches - before[1])
    want, have = fleet_leaves(a.final_states), fleet_leaves(b.final_states)
    for name, value in want.items():
        np.testing.assert_array_equal(have[name], value, err_msg=name)
    np.testing.assert_array_equal(a.rounds, b.rounds)
    assert a.eps_round == b.eps_round
    np.testing.assert_array_equal(a.exchange_bytes, b.exchange_bytes)
    np.testing.assert_array_equal(a.frontier_max, b.frontier_max)
    np.testing.assert_allclose(a.convergence, b.convergence, atol=1e-6)
    if stop:
        assert min(a.rounds) < rounds == max(a.rounds)
    if family == "compressed":
        assert got == (0, int(a.rounds.sum()))
    else:
        # The live scenarios share the round index: one launch for each
        # round run at all.
        assert got == (int(max(a.rounds)), 0)


def test_scatter_max_apply_kernel_on_fleet_triples(card):
    """K4a on one fleet round's own batched triples over ``[S·N, M]``,
    its dropped rows remapped to ``S·N``: caught at ``apply_updates``
    with the pre-scatter ``known``/``sent``, the kernel equals its plain
    version."""
    from sidecar_tpu_torch.ops import gossip as gossip_ops

    _, gpu, inputs, _ = fleet_pair("chaos")
    taken = []
    apply = gossip_ops.apply_updates

    def watch(known, sent, rows, cols, vals, adv):
        taken.append((known.clone(), sent.clone(), rows, cols, vals, adv))
        return apply(known, sent, rows, cols, vals, adv)

    gossip_ops.apply_updates = watch
    try:
        gpu.run(gpu.init_states(), 6,
                draws=[d[:6] for d in inputs["draws"]],
                fault_draws=[f[:6] for f in inputs["fault_draws"]])
    finally:
        gossip_ops.apply_updates = apply
    known, sent, rows, cols, vals, adv = taken[-1]
    s_n = known.shape[0]
    assert s_n == 3 * gpu.batch.params.n
    assert int((rows == s_n).sum()) > 0 and int(rows.max()) == s_n
    want = sm.scatter_max_apply_torch(known.clone(), rows, cols, vals,
                                      sent.clone(), adv)
    got = sm.scatter_max_apply_cuda(known, rows, cols, vals, sent, adv)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_recommend_on_card_equals_cpu(card, monkeypatch):
    """A small ``recommend`` (n = 16, a fitted loss, churn and pause, so
    the chaos family) on the card equals the CPU's when every dispatch
    is fed one set of inputs drawn on the CPU (``fleet.cpu_inputs``):
    every candidate's row and score, the estimate and the winner.  Then
    the card's own pass, from its own generators, replays the winner
    identically."""
    from sidecar_tpu_torch.autopilot import AutopilotController, search
    from sidecar_tpu_torch.fleet import cpu_inputs

    kw = dict(rules=["converge <= 10 rounds", "agreement >= 0.99"],
              estimate={"loss_rate": 0.2, "churn_rate": 0.01,
                        "paused_frac": 0.125},
              n=16, rounds=20, seed=3, seed_grid=2, generations=1,
              population=3)
    rows = []
    evaluate = search.FleetEvaluator.evaluate
    run_batch = search.FleetEvaluator._run_batch

    def one_set_run_batch(self, batch):
        return run_batch(self, batch, cpu_inputs(batch, self.rounds))

    def kept(self, candidates, tag):
        out = evaluate(self, candidates, tag)
        rows[-1].extend(r.to_json() for r in out)
        return out

    with monkeypatch.context() as m:
        m.setattr(search.FleetEvaluator, "_run_batch", one_set_run_batch)
        m.setattr(search.FleetEvaluator, "evaluate", kept)
        reports = []
        for device in ("cpu", "cuda"):
            rows.append([])
            reports.append(AutopilotController(
                timecfg=TimeConfig()).recommend(device=device, **kw))
    host, got = reports
    assert host["fault_plan"] is not None
    for key in host:
        if key not in ("replay", "wall_seconds", "recommended",
                       "baseline"):
            assert got[key] == host[key], key
    assert len(rows[0]) == len(rows[1]) == host["candidates"]
    for a, b in zip(*rows):
        row_a, row_b = dict(a.pop("row")), dict(b.pop("row"))
        assert a == b
        assert abs(row_a.pop("final_convergence")
                   - row_b.pop("final_convergence")) <= 1e-6
        assert row_a == row_b
    own = AutopilotController(timecfg=TimeConfig()).recommend(**kw)
    assert own["replay"]["identical"] is True


def captured_scenario(name, device, monkeypatch, **kw):
    """Scenario ``name`` of the port's module built on ``device``: the
    sim and state its ``_run`` would get."""
    from sidecar_tpu_torch.sim import scenarios

    seen = []

    def fake_run(sim, state, *a, **k):
        seen.append((sim, state))

    with monkeypatch.context() as m:
        m.setattr(scenarios, "_run", fake_run)
        scenarios.ALL_SCENARIOS[name](device=device, **kw)
    return seen[0]


@pytest.mark.parametrize("name,kw,rounds", [
    ("config6", dict(scale=0.125), 40),
    ("config4", dict(scale=128 / 65_536), 20)])
def test_scenario_on_card_equals_cpu(card, monkeypatch, name, kw, rounds):
    """config6 (n = 32) and config4 (128 nodes, K = 256) built by the
    module on the card equal the CPU's from one set of draws (and fault
    draws; config6's side churn draws its masks on the CPU)."""
    cpu, cpu_st = captured_scenario(name, "cpu", monkeypatch, **kw)
    gpu, gpu_st = captured_scenario(name, "cuda", monkeypatch, **kw)
    gen = torch.Generator().manual_seed(6)
    draws = [cpu.draw(gen, r) for r in range(1, rounds + 1)]
    extra = {}
    if name == "config6":
        extra["fault_draws"] = [cpu.fault_draw(r)
                                for r in range(1, rounds + 1)]
    a, ca = cpu.run(cpu_st, rounds, draws=draws, **extra)
    b, cb = gpu.run(gpu_st, rounds, draws=draws, **extra)
    torch.cuda.synchronize()
    if name == "config6":
        a, b = a.sim, b.sim
    for f, v in convert.state_to_numpy(a).items():
        np.testing.assert_array_equal(convert.state_to_numpy(b)[f], v,
                                      err_msg=f)
    np.testing.assert_allclose(ca.numpy(), cb.cpu().numpy(), atol=1e-6)


# -- the bridge and the oracle ------------------------------------------------

BRIDGE_CFG = dict(refresh_interval_s=1000.0, push_pull_interval_s=2.0)


def card_and_cpu_bridges(**kw):
    """The CPU and card bridges on ``chip_smoke.py``'s catalog of 64
    hosts × 4, loaded from its wire document through ``decode``."""
    import chip_smoke
    from sidecar_tpu_torch.bridge import SimBridge
    from sidecar_tpu_torch.catalog import decode

    state = decode(chip_smoke.synthetic_catalog(64, 4, seed=5))
    return [SimBridge(state, TimeConfig(**BRIDGE_CFG), device=d, **kw)
            for d in ("cpu", "cuda")]


@pytest.mark.parametrize("kw", [
    dict(cold_nodes=["host-0003"]),
    dict(deltas_cap=64, cold_nodes=["host-0003"],
         protocol={"damping_threshold": 1.0}),
    dict(digest=20, digest_buckets=32, cold_nodes=["host-0003"]),
    dict(provenance={"count": 8}, cold_nodes=["host-0003"]),
    dict(trace=20, sparse=True, cold_nodes=["host-0003"]),
    dict(sharded=True, cold_nodes=["host-0003"]),
], ids=["cold", "deltas_damping", "digest", "provenance", "trace_sparse",
        "sharded"])
def test_bridge_simulate_on_card_equals_cpu(card, kw):
    """Each ``/simulate`` option at 64 hosts × 4, chunked (25-round
    chunks), card against CPU from one set of draws drawn on the CPU."""
    cpu, gpu = card_and_cpu_bridges(shards=4)
    rounds = 60
    cpu.CHUNK_ROUNDS = gpu.CHUNK_ROUNDS = 25
    _, _, _, sim = cpu.snapshot(sharded=kw.get("sharded", False))
    gen = torch.Generator().manual_seed(9)
    draws = [sim.draw(gen, r) for r in range(1, rounds + 1)]
    a = cpu.simulate(rounds, draws=draws, **kw).to_json()
    b = gpu.simulate(rounds, draws=draws, **kw).to_json()
    assert a == b


def test_bridge_sweep_and_recommend_on_card_equal_cpu(card, monkeypatch):
    """An 8-point ``/sweep`` and ``/autopilot/recommend`` with a given
    estimate, card against CPU, every dispatch fed one set of inputs
    drawn on the CPU (``fleet.cpu_inputs``)."""
    from sidecar_tpu_torch.autopilot import search
    from sidecar_tpu_torch.bridge import SimBridge
    from sidecar_tpu_torch.fleet import cpu_inputs

    run_sweep = SimBridge._run_sweep_batch
    run_batch = search.FleetEvaluator._run_batch
    monkeypatch.setattr(SimBridge, "_run_sweep_batch", staticmethod(
        lambda batch, run_kw, inputs=None: run_sweep(
            batch, run_kw, cpu_inputs(batch, run_kw["num_rounds"]))))
    monkeypatch.setattr(search.FleetEvaluator, "_run_batch",
                        lambda self, batch: run_batch(
                            self, batch, cpu_inputs(batch, self.rounds)))
    cpu, gpu = card_and_cpu_bridges()
    axes = {"push_pull_interval_s": [1.0, 2.0, 4.0, 8.0],
            "drop_prob": [0.0, 0.1]}
    sweeps = [b.sweep(axes, rounds=40, slo=["converge <= 20 rounds"])
              for b in (cpu, gpu)]
    for k in sweeps[0]:
        if k not in ("wall_seconds", "scenarios_per_sec"):
            assert sweeps[0][k] == sweeps[1][k], k
    req = {"rules": ["converge <= 30 rounds"],
           "estimate": {"loss_rate": 0.1}, "rounds": 30, "seed": 2,
           "generations": 1, "population": 4}
    reps = [b.autopilot_recommend(dict(req)) for b in (cpu, gpu)]
    for k in reps[0]:
        if k not in ("wall_seconds", "replay"):
            assert reps[0][k] == reps[1][k], k


def test_exact_on_card_equals_oracle(card):
    """The card's ``ExactSim`` against the NumPy oracle for 40 rounds
    on ER(8) with loss, push-pull every 10 rounds and the sweep every
    5: ``known`` and ``sent`` every round."""
    from sidecar_tpu_torch.sim.oracle import OracleSim

    p = SimParams(n=64, services_per_node=4, fanout=3, budget=10,
                  drop_prob=0.1)
    sim = ExactSim(p, topology.erdos_renyi(64, 8.0, seed=3),
                   TimeConfig(refresh_interval_s=3.0,
                              push_pull_interval_s=2.0,
                              sweep_interval_s=1.0), device="cuda")
    state = sim.init_state()
    orc = OracleSim(sim, state)
    gen = torch.Generator().manual_seed(4)
    for r in range(1, 41):
        d = sim.draw(gen, r)
        state = sim.step(state, draws=d)
        orc.step(d)
        np.testing.assert_array_equal(state.known.cpu().numpy(), orc.known,
                                      err_msg=f"round {r}")
        np.testing.assert_array_equal(
            state.sent.cpu().numpy().astype(np.int32), orc.sent,
            err_msg=f"round {r}")


def test_nccl_group_of_one_rank_equals_local_group(card, monkeypatch):
    """A NCCL group of one rank holding d = 4 shards (real NCCL
    collectives on CUDA tensors) against ``LocalShardGroup`` at d = 4 on
    the card: the exact and compressed twins, ``all_gather`` and
    ``ring``, equal state and curve.  The rank imports the worker as a
    top-level module from this directory (the spawned process inherits
    the path)."""
    import importlib
    import pathlib

    from sidecar_tpu_torch.parallel import spawn_group

    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parent))
    worker = importlib.import_module("torch_dist_worker")
    (got,) = spawn_group(worker.group_against_local, 1, "nccl",
                         timeout_s=600.0)
    assert got and all(not r["fields_differ"] and r["curve_equal"]
                       for r in got.values()), got


def test_nccl_group_paths_equal_local_group(card, monkeypatch):
    """The planes and the pipelined round of the twins over a NCCL group
    of one rank holding d = 4 shards, against ``LocalShardGroup`` at d = 4 on the card: the
    exact twin's trace (state, record buffer and curve) and the
    compressed twin's pipelined ticks (state, curve and carry)."""
    import importlib
    import pathlib

    from sidecar_tpu_torch.parallel import spawn_group

    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parent))
    worker = importlib.import_module("torch_dist_worker")
    (got,) = spawn_group(worker.paths_against_local, 1, "nccl",
                         timeout_s=600.0)
    assert got and all(not r["fields_differ"] and r["equal"]
                       for r in got.values()), got


@pytest.mark.parametrize("family", ["exact", "chaos"])
def test_fleet_node_axis_on_card_equals_one_process(card, monkeypatch,
                                                    family):
    """The fleet's node axis on the card: two gloo ranks sharing it (NCCL
    refuses two ranks on one device), each holding half the nodes of
    every scenario at n = 256, against the one-process fleet on the card
    from the same CPU-drawn inputs: every table row, the curve,
    ``first_seen`` and the joined final state; K4a launches once a round
    on each rank's rows, as in one process."""
    import importlib
    import pathlib
    import types

    from sidecar_tpu_torch.chaos import (
        ClockFault,
        EdgeFault,
        FaultPlan,
        NodeFault,
    )
    from sidecar_tpu_torch.fleet import ScenarioBatch, ScenarioSpec
    from sidecar_tpu_torch.fleet.batch import churn_seed
    from sidecar_tpu_torch.fleet.engine import cpu_inputs
    from sidecar_tpu_torch.parallel import LocalShardGroup, spawn_group
    from sidecar_tpu_torch.sim.scenarios import churn_masks

    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parent))
    worker = importlib.import_module("torch_dist_worker")
    n, rounds = 256, 20
    params = dict(n=n, services_per_node=4, fanout=3, budget=8)
    time = dict(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
    specs = [dict(name="a", seed=1),
             dict(name="b", seed=2, drop_prob=0.1, churn_prob=0.02,
                  retransmit_limit=8),
             dict(name="c", seed=3, push_pull_interval_s=1.0,
                  future_fudge_s=0.5, origin_budget=1,
                  refresh_interval_s=1.0)]
    plan = None
    if family == "chaos":
        a, b = tuple(range(n // 2)), tuple(range(n // 2, n))
        plan = FaultPlan(
            seed=5,
            edges=(EdgeFault(src=a, dst=b, drop_prob=0.2),
                   EdgeFault(src=b, dst=a, delay_rounds=2, delay_prob=0.2,
                             duplicate_prob=0.1)),
            nodes=(NodeFault(nodes=(3, 200), start_round=4, end_round=9,
                             kind="crash"),),
            clocks=(ClockFault(nodes=b, start_round=2,
                               offset_ticks=300),)).dumps()
        specs = [dict(s, fault_seed=5 + i, origin_quarantine=2)
                 for i, s in enumerate(specs)]
    cpu_b = ScenarioBatch.build(
        [ScenarioSpec(**s) for s in specs], SimParams(**params),
        TimeConfig(**time), plan=None if plan is None else
        FaultPlan.loads(plan), device="cpu")
    draws, faults, _ = cpu_inputs(cpu_b, rounds)
    data = dict(
        specs=specs, params=params, time=time, plan=plan, rounds=rounds,
        draws=[worker.draws_to_data(d) for d in draws],
        faults=None if faults is None else
        [worker.faults_to_data(f) for f in faults],
        masks=[{r: v.numpy() for r, v in churn_masks(
            cpu_b.params.m, s.churn_prob, (1, rounds + 1),
            churn_seed(s.seed)).items()} if s.churn_prob > 0 else None
            for s in cpu_b.specs],
        stop=False, eps=0.05, tracked=(1, 500))
    ranks = spawn_group(worker.run_cases, 2, "gloo",
                        ([("nodes", "fleet_nodes", dict(data, nd=2))],),
                        device="cuda", timeout_s=600.0)
    one = types.SimpleNamespace(rank=0, world=1, device=card,
                                group=LocalShardGroup)
    want = worker.run_fleet_nodes(one, nd=1, **data)
    parts = [r["nodes"] for r in ranks]
    for p in parts:
        assert p["table"] == want["table"]
        for k in ("convergence", "rounds", "first_seen", "exchange_bytes"):
            np.testing.assert_array_equal(p[k], want[k], err_msg=k)
        # One K4a a round on each rank's rows, as in one process.
        assert p["k4a"] == want["k4a"] == rounds
        assert p["node_exchange"]["staging_bytes"] > 0
    got = convert.fleet_leaves(
        convert.join_state([p["state"] for p in parts], 2))
    for name, value in convert.fleet_leaves(want["state"]).items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.mark.parametrize("n,m", [(5, 40), (300, 2000), (1024, 10240)])
def test_fleet_row_digests_on_card_equal_numpy(card, n, m):
    """The fleet's end-state digests on the card (``fleet.engine.
    row_digests``: ``ops/digest.node_digests`` a block of rows at a
    time) equal the reference's NumPy digests of the alive rows."""
    from sidecar_tpu_torch.fleet import engine
    from sidecar_tpu_torch.ops import digest as digest_ops

    rng = np.random.default_rng(n + m)
    packed = np.where(rng.random((n, m)) < 0.8,
                      rng.integers(1, 1 << 28, (n, m)), 0).astype(np.int32)
    alive = rng.random(n) < 0.9
    want = digest_ops.node_digests_np(packed[alive],
                                      digest_ops.default_idents(m))
    got = engine.row_digests(torch.as_tensor(packed, device=card),
                             torch.as_tensor(alive, device=card))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,depth", [(40, 5), (4096, 5), (3000, 3)])
def test_live_ladder_equals_card_ladder(card, m, depth):
    """A catalog built through the live writer keeps, at every ladder
    level, the digest that ``ops/digest.ladder_digests`` computes on
    the card over the same beliefs (the live phase's check, small)."""
    from sidecar_tpu_torch import service as svc
    from sidecar_tpu_torch.catalog import ServicesState
    from sidecar_tpu_torch.ops import digest as digest_ops

    rng = np.random.default_rng(m)
    packed = np.where(rng.random(m) < 0.7,
                      rng.integers(1, 1 << 20, m) << 3 |
                      rng.choice([0, 1, 2, 4], m), 0).astype(np.int32)
    names = [(f"h{j // 10}", f"s{j}") for j in range(m)]
    idents = digest_ops.catalog_idents(names)
    st = ServicesState(hostname="card", ladder_depth=depth)
    st.set_clock(lambda: 1_000_000)
    for j, v in enumerate(packed.tolist()):
        if v:
            st.add_service_entry(svc.Service(
                id=names[j][1], name="app", image="i", hostname=names[j][0],
                updated=v >> 3, status=v & 7))
    packed_dev = torch.as_tensor(packed[None, :], device=card)
    levels = digest_ops.ladder_digests(
        packed_dev, torch.as_tensor(idents.astype(np.int64), device=card),
        st.ladder_geometry()[0], depth)
    assert levels[0].device == packed_dev.device
    for k in range(depth):
        assert st.digest_level(k) == digest_ops.digest_value(levels[k][0]), k


def test_cross_validation_plan_on_card_equals_cpu(card):
    """The live cross-check's sim half (``tests/test_chaos.py``'s plan:
    a split of node a from b and c over rounds [10, 50), 20 % loss and a
    20 % one-round delay on (b, c) → a) at n = 3 on the complete graph,
    100 rounds with b's drain and c's re-mint at round 20, on the card
    and on the CPU from one set of draws: equal every round, K4a once a
    round, a's view of b stale through the split, and [ALIVE, DRAINING,
    ALIVE] everywhere at the end."""
    from sidecar_tpu_torch.chaos import ChaosExactSim, EdgeFault, FaultPlan
    from sidecar_tpu_torch.ops.status import (ALIVE, DRAINING, pack,
                                              unpack_status)

    plan = FaultPlan(seed=77, edges=(
        EdgeFault(src=(1, 2), dst=(0,), drop_prob=0.2),
        EdgeFault(src=(1, 2), dst=(0,), delay_rounds=1, delay_prob=0.2),
    )).with_edges(*FaultPlan.partition((0,), (1, 2), 10, 50))
    p = SimParams(n=3, services_per_node=1, fanout=2, budget=3)
    t = TimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
    cpu = ChaosExactSim(p, topology.complete(3), t, plan, device="cpu")
    gpu = ChaosExactSim(p, topology.complete(3), t, plan)
    gen = torch.Generator().manual_seed(1)
    draws = [cpu.draw(gen, r) for r in range(1, 101)]
    faults = [cpu.fault_draw(r) for r in range(1, 101)]
    x, y = cpu.init_state(), gpu.init_state()
    before = sm.scatter_max_apply_cuda.launches
    for r in range(100):
        if r + 1 == 20:
            for st in (x, y):
                for slot, status in ((1, DRAINING), (2, ALIVE)):
                    st.sim.known[slot, slot] = int(pack(20 * t.round_ticks,
                                                        status))
                    st.sim.sent[slot, slot] = 0
        x = cpu.step(x, draws=draws[r], fault_draws=faults[r])
        y = gpu.step(y, draws=draws[r], fault_draws=faults[r])
        assert torch.equal(x.sim.known, y.sim.known.cpu()), r
        assert torch.equal(x.sim.sent, y.sim.sent.cpu()), r
        if r + 1 == 45:
            assert int(unpack_status(y.sim.known[0, 1])) != DRAINING
    torch.cuda.synchronize()
    assert sm.scatter_max_apply_cuda.launches - before == 100
    truth = y.sim.known.cpu().max(dim=0).values
    assert bool((y.sim.known.cpu() == truth[None, :]).all())
    assert [int(s) for s in unpack_status(truth)] == [ALIVE, DRAINING, ALIVE]
    assert cpu.injection_counts(x) == gpu.injection_counts(y)
