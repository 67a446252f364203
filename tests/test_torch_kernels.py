"""The kernels' plain PyTorch versions against the JAX reference's
``publish_board_xla``/``_pallas``, ``fused_publish_gather_xla``/
``_pallas`` and ``board_row_gather_xla``/``_pallas`` (Pallas in
interpret mode on the CPU), at the adversarial shapes of
``tests/test_kernels.py``: ragged row counts, K from 8 to 1024,
tie-heavy rows, rows with nothing eligible, tombstone-only rows, an
empty cache, a row offset, a budget wider than the cache, a firing
staleness gate, board blocks at an offset and rows outside the block.
Exact comparisons.

Also the dispatch rule: a CPU tensor takes the plain version, and the
CUDA wrappers refuse anything that is not a CUDA tensor.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu.ops.kernels.publish_gather import (
    board_row_gather_pallas,
    board_row_gather_xla,
    fused_publish_gather_pallas,
    fused_publish_gather_xla,
    publish_board_pallas,
    publish_board_xla,
)
from sidecar_tpu.ops.status import ALIVE, TOMBSTONE
from sidecar_tpu_torch.ops import kernels as tk
from sidecar_tpu_torch.ops.kernels import publish_gather as tpg


def random_cache(rng, n, k, *, occupancy=0.7, tie_value=None,
                 sent_ceiling=8, status=ALIVE):
    """The cache-triple generator of tests/test_kernels.py, in numpy."""
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


def jitted(fn, **static):
    """``fn`` with its keyword arguments fixed, under one ``jax.jit`` —
    a single compile per shape instead of one per primitive."""
    return jax.jit(functools.partial(fn, **static))


def board_case(name):
    """(cache triple, kwargs) of one named adversarial board case."""
    if name.startswith("random"):
        n, k = (int(x) for x in name.split("-")[1:])
        rng = np.random.default_rng(n * 1000 + k)
        return random_cache(rng, n, k), dict(budget=5, limit=6, fanout=3)
    if name == "tie-heavy":
        rng = np.random.default_rng(0)
        return random_cache(rng, 50, 32, occupancy=1.0, tie_value=17,
                            sent_ceiling=2), dict(budget=6, limit=6,
                                                  fanout=3)
    if name == "tie-heavy-1024":
        rng = np.random.default_rng(11)
        return random_cache(rng, 20, 1024, occupancy=0.9, tie_value=5,
                            sent_ceiling=2), dict(budget=15, limit=6,
                                                  fanout=3)
    if name == "all-ineligible":
        rng = np.random.default_rng(1)
        cv, cs, se = random_cache(rng, 19, 16)
        return (cv, cs, np.full_like(se, 100)), dict(budget=4, limit=6,
                                                     fanout=2)
    if name == "tombstone-only":
        rng = np.random.default_rng(2)
        return random_cache(rng, 21, 32, status=TOMBSTONE), \
            dict(budget=5, limit=8, fanout=3)
    if name == "empty":
        return (np.zeros((12, 16), np.int32),
                np.full((12, 16), -1, np.int32),
                np.zeros((12, 16), np.int8)), dict(budget=5, limit=6,
                                                   fanout=3)
    if name == "row-offset":
        rng = np.random.default_rng(3)
        return random_cache(rng, 24, 32, tie_value=9, occupancy=1.0,
                            sent_ceiling=2), dict(budget=4, limit=6,
                                                  fanout=2, row_offset=13)
    if name == "budget-over-k":
        rng = np.random.default_rng(4)
        return random_cache(rng, 9, 8), dict(budget=64, limit=6, fanout=2)
    # The corners of the card's warp-per-row kernel: K below a warp,
    # budget 1 and budget K, rows with exactly B and B - 1 positive
    # priorities, bit 30 set, every line tied at a row_offset above 2^30.
    if name.startswith("k") and "-budget" in name:
        k, budget = (int(x) for x in name[1:].split("-budget"))
        rng = np.random.default_rng(40 + k)
        return random_cache(rng, 37, k, occupancy=0.9), \
            dict(budget=budget, limit=6, fanout=3, row_offset=5)
    if name in ("exactly-b", "b-minus-1"):
        positive = 15 if name == "exactly-b" else 14
        rng = np.random.default_rng(positive)
        cv = np.zeros((24, 256), np.int32)
        cs = np.full((24, 256), -1, np.int32)
        for r in range(24):
            cols = rng.choice(256, positive, replace=False)
            cv[r, cols] = (rng.integers(1, 40, positive) << 3) | ALIVE
            cs[r, cols] = rng.integers(0, 512, positive)
        return (cv, cs, np.zeros((24, 256), np.int8)), \
            dict(budget=15, limit=6, fanout=3)
    if name == "bit30":
        rng = np.random.default_rng(52)
        cv, cs, se = random_cache(rng, 17, 256)
        return (np.where(cs >= 0, cv | (1 << 30), 0).astype(np.int32), cs,
                se), dict(budget=15, limit=6, fanout=3)
    if name == "all-tied-high-offset":
        rng = np.random.default_rng(53)
        return random_cache(rng, 17, 256, occupancy=1.0, tie_value=40,
                            sent_ceiling=1), \
            dict(budget=15, limit=6, fanout=3, row_offset=(1 << 30) + 12345)
    raise KeyError(name)


BOARD_CASES = ["random-7-8", "random-20-64", "random-33-16",
               "random-64-256", "random-130-32",
               "tie-heavy", "tie-heavy-1024", "all-ineligible",
               "tombstone-only", "empty", "row-offset", "budget-over-k",
               "k1-budget1", "k2-budget2", "k4-budget1", "exactly-b",
               "b-minus-1", "bit30", "all-tied-high-offset"]


def assert_all_equal(got, want, names):
    for name, g, w in zip(names, got, want):
        g = g.numpy()
        w = np.asarray(w)
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)


class TestPublishBoardPlain:
    @pytest.mark.parametrize("case", BOARD_CASES)
    def test_matches_xla(self, case):
        (cv, cs, se), kw = board_case(case)
        k = cv.shape[1]
        want = jitted(publish_board_xla, cache_lines=k, **kw)(
            jnp.asarray(cv), jnp.asarray(cs), jnp.asarray(se))
        got = tpg.publish_board_torch(torch.tensor(cv), torch.tensor(cs),
                                      torch.tensor(se), cache_lines=k, **kw)
        assert_all_equal(got, want, ("bval", "bslot", "sent"))

    @pytest.mark.parametrize("case", ["tie-heavy", "row-offset",
                                      "budget-over-k"])
    def test_matches_pallas_interpret(self, case):
        (cv, cs, se), kw = board_case(case)
        k = cv.shape[1]
        want = publish_board_pallas(jnp.asarray(cv), jnp.asarray(cs),
                                    jnp.asarray(se), cache_lines=k,
                                    interpret=True, **kw)
        got = tk.publish_board(torch.tensor(cv), torch.tensor(cs),
                               torch.tensor(se), cache_lines=k, **kw)
        assert_all_equal(got, want, ("bval", "bslot", "sent"))


GATHER_CASES = [(20, 16, 3), (33, 64, 2), (7, 8, 4), (5, 256, 3)]


def gather_inputs(n, k, f):
    rng = np.random.default_rng(n + k + f)
    cache = random_cache(rng, n, k)
    src = rng.integers(0, n, (n, f)).astype(np.int32)
    kw = dict(stale_ticks=1 << 18, budget=5, limit=6, fanout=f,
              cache_lines=k)
    return cache, src, 1 << 19, kw


def stale_inputs():
    """Records straddling the staleness horizon (ts in [1, 50) stale)."""
    rng = np.random.default_rng(7)
    n, k, f = 16, 16, 3
    ts = rng.integers(1, 100, (n, k), dtype=np.int64)
    cache = (((ts << 3) | ALIVE).astype(np.int32),
             rng.integers(0, n * 4, (n, k)).astype(np.int32),
             np.zeros((n, k), np.int8))
    src = rng.integers(0, n, (n, f)).astype(np.int32)
    kw = dict(stale_ticks=40, budget=6, limit=6, fanout=f, cache_lines=k)
    return cache, src, 90, kw


def run_both(ref, cache, src, now, kw):
    cv, cs, se = cache
    if ref is fused_publish_gather_xla:
        ref = jitted(ref, now=now, **kw)
    else:   # the Pallas interpreter runs faster un-jitted
        ref = functools.partial(ref, now=now, interpret=True, **kw)
    want = ref(jnp.asarray(cv), jnp.asarray(cs), jnp.asarray(se),
               jnp.asarray(src))
    got = tk.fused_publish_gather(torch.tensor(cv), torch.tensor(cs),
                                  torch.tensor(se), torch.tensor(src), now,
                                  **kw)
    return got, want


def gather_corner(name):
    """(cache triple, src, now, kwargs) of one corner of the card's
    two-pass fused publish gather, at n <= 64: publish corners of
    ``BOARD_CASES`` (K below a warp with budget 1 and budget K, rows with
    exactly B and B - 1 positive priorities, bit 30 set, every line
    tied), F = 1, a hot row that every request names, self-sends, the
    staleness boundary (ts one below ``now - stale_ticks``, at it, one
    above, and 0) and a ragged N."""
    now, stale, f = 1 << 19, 1 << 18, 3
    if name in ("k1-budget1", "k2-budget2", "k4-budget1", "exactly-b",
                "b-minus-1", "bit30", "all-tied-high-offset"):
        (cv, cs, se), kw = board_case(name)
    elif name == "budget-k":
        rng = np.random.default_rng(60)
        (cv, cs, se), kw = random_cache(rng, 29, 8, occupancy=0.9), \
            dict(budget=8, limit=6, fanout=3)
    else:
        rng = np.random.default_rng(61)
        (cv, cs, se), kw = random_cache(rng, 43, 16), \
            dict(budget=5, limit=6, fanout=3)
    kw.pop("row_offset", None)
    n = cv.shape[0]
    rng = np.random.default_rng(62)
    if name == "f1":
        f = 1
    src = rng.integers(0, n, (n, f)).astype(np.int32)
    if name == "hot-row":
        src[:] = 7
    elif name == "self-sends":
        src[:] = np.arange(n, dtype=np.int32)[:, None]
    elif name == "stale-edge":
        # Budget K publishes every eligible line, the stale ones too.
        now, stale, kw["budget"] = 1000, 400, cv.shape[1]
        ts = rng.choice([599, 600, 601, 0], cv.shape)
        cv = np.where(cs >= 0, (ts << 3) | rng.integers(0, 8, cv.shape),
                      0).astype(np.int32)
    return (cv, cs, se), src, now, dict(kw, stale_ticks=stale,
                                        cache_lines=cv.shape[1])


GATHER_CORNERS = ["k1-budget1", "k2-budget2", "k4-budget1", "budget-k",
                  "exactly-b", "b-minus-1", "bit30", "all-tied-high-offset",
                  "f1", "hot-row", "self-sends", "stale-edge", "ragged"]


class TestFusedGatherPlain:
    @pytest.mark.parametrize("n,k,f", GATHER_CASES)
    def test_matches_xla(self, n, k, f):
        got, want = run_both(fused_publish_gather_xla, *gather_inputs(n, k, f))
        assert_all_equal(got, want, ("sent", "pv", "ps"))

    @pytest.mark.parametrize("n,k,f", GATHER_CASES[1:3])
    def test_matches_pallas_interpret(self, n, k, f):
        got, want = run_both(fused_publish_gather_pallas,
                             *gather_inputs(n, k, f))
        assert_all_equal(got, want, ("sent", "pv", "ps"))

    @pytest.mark.parametrize("case", GATHER_CORNERS)
    def test_corners_match_xla(self, case):
        got, want = run_both(fused_publish_gather_xla, *gather_corner(case))
        assert_all_equal(got, want, ("sent", "pv", "ps"))

    @pytest.mark.parametrize("case", ["k2-budget2", "hot-row", "stale-edge"])
    def test_corners_match_pallas_interpret(self, case):
        got, want = run_both(fused_publish_gather_pallas,
                             *gather_corner(case))
        assert_all_equal(got, want, ("sent", "pv", "ps"))
        if case == "stale-edge":
            # Premise: the gate fired (ps kept its slot where pv zeroed)
            # and spared ts at the horizon.
            assert bool(((got[1] == 0) & (got[2] >= 0)).any())
            assert bool((got[1] >> 3 == 600).any())

    @pytest.mark.parametrize("ref", [fused_publish_gather_xla,
                                     fused_publish_gather_pallas])
    def test_staleness_gate_fires_identically(self, ref):
        got, want = run_both(ref, *stale_inputs())
        assert_all_equal(got, want, ("sent", "pv", "ps"))
        # Premise: the gate fired, and ps kept its slot where pv zeroed.
        pv, ps = got[1], got[2]
        assert bool(((pv == 0) & (ps >= 0)).any())


# (n, k, f, block rows, base, src upper bound): the cases of
# tests/test_kernels.py (src overshooting the block on both sides), then
# F = 1 at K = 1024, a wide base with a ragged block, every row out of
# block, K = 1, 2 and 4 (the CUDA kernel's scalar path and its narrowest
# int4 row), and every request naming row 0 (src upper bound 1).
ROW_GATHER_CASES = [(13, 16, 3, 13, 0, 18), (20, 32, 2, 5, 10, 20),
                    (33, 8, 4, 11, 22, 38), (7, 128, 2, 7, 0, 12),
                    (9, 1024, 1, 4, 3, 12), (31, 64, 3, 7, 50, 70),
                    (10, 64, 3, 6, 100, 100), (37, 1, 3, 9, 4, 15),
                    (29, 2, 3, 12, 0, 14), (41, 4, 3, 10, 5, 17),
                    (43, 4, 3, 16, 0, 1)]


def row_gather_inputs(n, k, f, blk, base, hi):
    rng = np.random.default_rng(n * 100 + k + f)
    bval = rng.integers(0, 1 << 20, (blk, k)).astype(np.int32)
    bslot = rng.integers(-1, blk * 4, (blk, k)).astype(np.int32)
    src = rng.integers(0, hi, (n, f)).astype(np.int32)
    return bval, bslot, src, base


class TestBoardRowGatherPlain:
    @pytest.mark.parametrize("case", ROW_GATHER_CASES)
    def test_matches_xla(self, case):
        bval, bslot, src, base = row_gather_inputs(*case)
        want = jax.jit(board_row_gather_xla)(
            jnp.asarray(bval), jnp.asarray(bslot), jnp.asarray(src), base)
        got = tk.board_row_gather(torch.tensor(bval), torch.tensor(bslot),
                                  torch.tensor(src), base)
        assert_all_equal(got, want, ("pv", "ps"))
        # Premise of the all-out-of-block case: no row lies in the block;
        # of the one-row case: every request names row 0.
        if case[5] <= case[4]:
            assert not got[0].any() and bool((got[1] == -1).all())
        if case[5] == 1:
            assert bool((got[0] == got[0][:1, :1]).all())

    @pytest.mark.pallas
    @pytest.mark.parametrize("case", ROW_GATHER_CASES[1:3])
    def test_matches_pallas_interpret(self, case):
        bval, bslot, src, base = row_gather_inputs(*case)
        want = board_row_gather_pallas(jnp.asarray(bval),
                                       jnp.asarray(bslot),
                                       jnp.asarray(src), base,
                                       interpret=True)
        got = tpg.board_row_gather_torch(torch.tensor(bval),
                                         torch.tensor(bslot),
                                         torch.tensor(src), base)
        assert_all_equal(got, want, ("pv", "ps"))


class TestDispatch:
    def _cache(self):
        (cv, cs, se), _ = board_case("random-20-64")
        return torch.tensor(cv), torch.tensor(cs), torch.tensor(se)

    def test_cpu_tensor_takes_plain_version(self):
        cv, cs, se = self._cache()
        before = (tpg.publish_board_cuda.launches,
                  tpg.fused_publish_gather_cuda.launches)
        kw = dict(budget=5, limit=6, fanout=3, cache_lines=64)
        a = tk.publish_board(cv, cs, se, **kw)
        b = tpg.publish_board_torch(cv, cs, se, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        src = torch.zeros((20, 3), dtype=torch.int32)
        tk.fused_publish_gather(cv, cs, se, src, 10, stale_ticks=5, **kw)
        before += (tpg.board_row_gather_cuda.launches,)
        a = tk.board_row_gather(cv, cs, src, 2)
        b = tpg.board_row_gather_torch(cv, cs, src, 2)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert (tpg.publish_board_cuda.launches,
                tpg.fused_publish_gather_cuda.launches,
                tpg.board_row_gather_cuda.launches) == before

    def test_cuda_wrappers_refuse_cpu_tensors(self):
        cv, cs, se = self._cache()
        kw = dict(budget=5, limit=6, fanout=3, cache_lines=64)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tpg.publish_board_cuda(cv, cs, se, **kw)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tpg.fused_publish_gather_cuda(
                cv, cs, se, torch.zeros((20, 3), dtype=torch.int32), 10,
                stale_ticks=5, **kw)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tpg.board_row_gather_cuda(
                cv, cs, torch.zeros((20, 3), dtype=torch.int32), 0)

    def test_kernel_source_is_present(self):
        from sidecar_tpu_torch.ops.kernels import build

        text = build.source_path("publish_gather").read_text()
        for sym in ("publish_board_kernel", "fused_publish_select_kernel",
                    "fused_publish_gather_kernel", "board_row_gather_kernel"):
            assert sym in text, sym
        for name, entry_points in build.SIGNATURES.items():
            text = build.source_path(name).read_text()
            for fn in entry_points:
                assert f"extern \"C\" int {fn}(" in text, (name, fn)
            assert build.library_path(name).parent == build.BUILD_DIR
        assert "sm_90a" in " ".join(build.FLAGS)
