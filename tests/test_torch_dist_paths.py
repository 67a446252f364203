"""The paths of the sharded twins at more than one rank: a real gloo
group of two CPU processes (``parallel/launch.spawn_group``) against the
one-process :class:`LocalShardGroup` run and the JAX reference twin,
exactly.

One group is spawned for the module and runs every case in turn
(``tests/torch_dist_worker.py``, which imports no JAX); meanwhile this
process runs the same rank bodies through ``LocalShardGroup``
(``worker.LocalContext``) and the reference's programs.  Every case
runs on one zoned graph of 32 nodes, which every exchange mode takes, so
one reference run at each ``d`` serves every mode (every mode at every
``d`` ends each round in the same state); the port's ``all_to_all``
buckets are wide enough that no pull drops.

* the trace, digest and provenance planes of ``ShardedSim`` and the
  trace, digest, deltas and provenance planes of
  ``ShardedCompressedSim``, at d = 2 (a shard a rank) and 4 (two), in
  every exchange mode: the joined state, every stream field and the
  float32 curve equal the reference twin's and the one-process run's;
* the pipelined round of both twins (prime, ``run_pipelined``,
  ``step_pipelined``, ``run_pipelined`` again; and
  ``run_fast_pipelined`` in one go): the joined state, the curve and
  the joined carry equal the reference's, whose pipelined round is the
  single-device program, and the one-process run's;
* the compressed twin with a row-local scenario hook (own records
  restarting, nodes toggling), masks replayed from the reference's
  ``bernoulli(k_perturb)``;
* ``gate_predicates`` on a converged state, a cold one and one whose
  shards agree in pairs, equal to the reference's on every rank;
* config4 and config5 with ``group=``, their curve and ε round equal to
  the single-device run's and the one-process group's;
* the routed row collectives (``fetch_rows``, ``scatter_max_rows``)
  against ``LocalShardGroup``'s on the global tensor;
* ``restart_churn_perturb`` on each rank's rows against the whole state
  and the reference hook (no group needed).
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu.models import compressed as jc
from sidecar_tpu.models import exact as jexact
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import status as jstatus
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.parallel.mesh import make_mesh
from sidecar_tpu.parallel.sharded import ShardedSim as JShardedSim
from sidecar_tpu.parallel.sharded_compressed import (
    ShardedCompressedSim as JShardedCompressedSim,
)
from sidecar_tpu_torch import convert
from sidecar_tpu_torch.ops.status import ALIVE, TOMBSTONE, pack
from sidecar_tpu_torch.parallel import spawn_group
from sidecar_tpu_torch.sim import scenarios
from tests import torch_dist_worker as worker
from tests.torch_parity import (
    PLANE_FIELDS,
    exact_to_numpy,
    jax_draw_seq,
    jax_exact_draw_seq,
    jax_perturb_masks,
    jax_sharded_draws,
    jax_sharded_exact_draws,
    np_of,
    to_numpy_state,
)

WORLD = 2
DS = (2, 4)
KEY = jax.random.PRNGKey(3)
ROUNDS = 20
# Refreshes every 10 rounds, push-pull every 5, the sweep every 2.
TIME = dict(refresh_interval_s=2.0, push_pull_interval_s=1.0,
            sweep_interval_s=0.4)
EXACT_PARAMS = dict(n=32, services_per_node=4, fanout=2, budget=6,
                    drop_prob=0.1)
COMPRESSED_PARAMS = dict(n=32, services_per_node=2, fanout=2, budget=4,
                         cache_lines=16, drop_prob=0.1)
EXACT_MODES = ("all_gather", "ring", "zoned")
COMPRESSED_MODES = ("all_gather", "all_to_all", "ring", "zoned")
EXACT_PLANES = ("trace", "digest", "provenance")
COMPRESSED_PLANES = ("trace", "digest", "deltas", "provenance")
TRACKED = (0, 37, 90, 127)
MINT_TICK = 7
DELTA_CAP = 64
PIPE_SPLIT = 6
# Wide buckets: no all_to_all pull drops, as in the reference's run.
A2A_SLACK = 8


def zoned32():
    return jtopo.zoned(32, 4, local_hops=1, remote_deg=2, gateways=1)


def topo_data(topo):
    return (topo.n, topo.nbrs, topo.deg, topo.name, topo.stagger,
            topo.stagger_period)


def mesh(d):
    return make_mesh(jax.devices()[:d])


def burst(m):
    rng = np.random.default_rng(5)
    return np.sort(rng.choice(m, size=6, replace=False)).astype(np.int32)


def sim_kw(mode):
    kw = dict(board_exchange=mode)
    if mode == "all_to_all":
        kw["a2a_slack"] = A2A_SLACK
    return kw


def common_kw(jsim, d, mode):
    return dict(d=d, params=dataclasses.asdict(jsim.p),
                topo=topo_data(jsim.topo), time=dataclasses.asdict(jsim.t),
                sim_kw=sim_kw(mode))


def exact_state_data(jstate):
    return {k: np.asarray(v) for k, v in exact_to_numpy(jstate).items()}


# -- the references (built in the test process) -------------------------------

@functools.lru_cache(maxsize=None)
def jax_exact(d):
    return JShardedSim(jexact.SimParams(**EXACT_PARAMS), zoned32(),
                       JTimeConfig(**TIME), mesh=mesh(d),
                       board_exchange="ring")


@functools.lru_cache(maxsize=None)
def jax_compressed(d, perturb=None):
    return JShardedCompressedSim(jc.CompressedParams(**COMPRESSED_PARAMS),
                                 zoned32(), JTimeConfig(**TIME),
                                 mesh=mesh(d), board_exchange="ring",
                                 perturb=perturb)


def exact_plane_reference(d):
    jsim = jax_exact(d)
    out = {}
    for plane in EXACT_PLANES:
        args = (TRACKED,) if plane == "provenance" else ()
        final, stream, conv = getattr(jsim, f"run_with_{plane}")(
            jsim.init_state(), KEY, ROUNDS, *args)
        out[plane] = (final, stream, np.asarray(conv))
    return out


def compressed_plane_reference(d):
    jsim = jax_compressed(d)
    out = {}
    for plane in COMPRESSED_PLANES:
        js = jsim.mint(jsim.init_state(), jnp.asarray(burst(jsim.p.m)),
                       MINT_TICK)
        args = {"provenance": (tuple(int(s) for s in burst(jsim.p.m)[:4]),),
                "deltas": (DELTA_CAP,)}.get(plane, ())
        out[plane] = getattr(jsim, f"run_with_{plane}")(js, KEY, ROUNDS,
                                                        *args)
    return out


def exact_pipelined_reference():
    jsim = jax_exact(2)
    final, conv, inflight = jsim.run_pipelined(jsim.init_state(), KEY,
                                               ROUNDS, donate=False)
    return final, np.asarray(conv), inflight


def compressed_pipelined_reference():
    jsim = jax_compressed(2)
    js = jsim.mint(jsim.init_state(), jnp.asarray(burst(jsim.p.m)),
                   MINT_TICK)
    final, conv, inflight = jsim.run_pipelined(js, KEY, ROUNDS, 1,
                                               donate=False)
    return final, np.asarray(conv), inflight


CHURN_P, FLIP_P = 0.05, 0.05


def jax_hook(state, key, now):
    """The reference side of ``worker.own_churn_hook``."""
    n, s = state.own.shape
    pick = jax.random.bernoulli(key, CHURN_P, (n * s,)).reshape(n, s)
    own = state.own
    flip = pick & (jstatus.unpack_ts(own) > 0) & state.node_alive[:, None]
    st = jnp.where(jstatus.unpack_status(own) == ALIVE, TOMBSTONE, ALIVE)
    own = jnp.where(flip, jstatus.pack(now, st), own)
    alive = state.node_alive ^ jax.random.bernoulli(key, FLIP_P, (n,))
    return dataclasses.replace(state, own=own, node_alive=alive)


def perturb_reference(d):
    jsim = jax_compressed(d, jax_hook)
    js = jsim.mint(jsim.init_state(), jnp.asarray(burst(jsim.p.m)),
                   MINT_TICK)
    final, behind = jsim.run_behind(js, KEY, ROUNDS, every=1, donate=False)
    return final, np.asarray(behind)


GATE_PARAMS = dict(n=16, services_per_node=2, fanout=4, budget=8)
GATE_TIME = dict(refresh_interval_s=1000.0, push_pull_interval_s=1e6,
                 sweep_interval_s=1.0)


def gate_graph():
    return jtopo.zoned(16, 4, local_hops=2, remote_deg=4, gateways=2)


def gate_states(d):
    """A converged ``known`` (every node holds every record), the cold
    start, and one whose shards hold one of two catalogs in turn."""
    n = GATE_PARAMS["n"]
    m = n * GATE_PARAMS["services_per_node"]
    full = np.full((n, m), pack(1, ALIVE), np.int32)
    cold = np.zeros((n, m), np.int32)
    owner = np.arange(m) // GATE_PARAMS["services_per_node"]
    cold[owner, np.arange(m)] = pack(1, ALIVE)
    other = full.copy()
    other[:, ::3] = pack(2, ALIVE)
    nl = n // d
    pairs = np.where(((np.arange(n) // nl) % 2 == 0)[:, None], full, other)
    return {"converged": full, "cold": cold, "pairs": pairs}


# -- the cases the group runs --------------------------------------------------

SCENARIO_KW = {
    "config4": dict(scale=128 / 65_536, rounds=40),
    "config5": dict(scale=1e-5, split_rounds=20, heal_rounds=20,
                    churn_frac=0.05),
}


def build_cases():
    """``[(case id, kind, kwargs)]``: plain data only."""
    cases = []
    for d in DS:
        je, jcs = jax_exact(d), jax_compressed(d)
        e_draws = worker.draws_to_data(
            jax_sharded_exact_draws(je, KEY, 0, ROUNDS))
        c_draws = worker.draws_to_data(
            jax_sharded_draws(jcs, KEY, 0, ROUNDS))
        mint = (burst(jcs.p.m), MINT_TICK)
        for mode in EXACT_MODES:
            cases.append((f"exact-planes-{mode}-d{d}", "exact_planes", dict(
                common_kw(je, d, mode), draws=e_draws,
                state=exact_state_data(je.init_state()),
                planes=EXACT_PLANES, tracked=TRACKED)))
        for mode in COMPRESSED_MODES:
            cases.append((f"compressed-planes-{mode}-d{d}",
                          "compressed_planes", dict(
                              common_kw(jcs, d, mode), draws=c_draws,
                              planes=COMPRESSED_PLANES,
                              tracked=tuple(int(s) for s in mint[0][:4]),
                              mint=mint, delta_cap=DELTA_CAP)))
        single_e = jexact.ExactSim(je.p, je.topo, je.t)
        p_draws = worker.draws_to_data(
            jax_exact_draw_seq(single_e, KEY, 0, ROUNDS + 1))
        for mode in EXACT_MODES:
            cases.append((f"exact-pipelined-{mode}-d{d}", "exact_pipelined",
                          dict(common_kw(je, d, mode), draws=p_draws,
                               state=exact_state_data(je.init_state()),
                               split=PIPE_SPLIT)))
        cp_draws = worker.draws_to_data(jax_draw_seq(jcs, KEY, 0,
                                                     ROUNDS + 1))
        for mode in COMPRESSED_MODES:
            cases.append((f"compressed-pipelined-{mode}-d{d}",
                          "compressed_pipelined", dict(
                              common_kw(jcs, d, mode), draws=cp_draws,
                              mint=mint, split=PIPE_SPLIT)))
        m, n = jcs.p.m, jcs.p.n
        cases.append((f"compressed-perturb-d{d}", "compressed_perturb", dict(
            common_kw(jcs, d, "ring"), draws=c_draws, mint=mint,
            churn={r: v.numpy() for r, v in jax_perturb_masks(
                KEY, 0, ROUNDS, (m,), CHURN_P).items()},
            flip_alive={r: v.numpy() for r, v in jax_perturb_masks(
                KEY, 0, ROUNDS, (n,), FLIP_P).items()})))
        cases.append((f"gate-d{d}", "gate", dict(
            d=d, params=GATE_PARAMS, topo=topo_data(gate_graph()),
            time=GATE_TIME, states=list(gate_states(d).values()))))
        for name, kw in SCENARIO_KW.items():
            cases.append((f"{name}-d{d}", "scenario",
                          dict(name=name, d=d, kwargs=kw)))
    cases.append(("routed", "routed", dict(world=WORLD)))
    return cases


# -- the module's group --------------------------------------------------------

@pytest.fixture(scope="module")
def results():
    """Spawn the group on every case; meanwhile run the one-process
    group and the references.  ``{case id: (rank results, one-process
    result)}`` and the references."""
    cases = build_cases()
    got, failure = {}, []

    def spawn():
        try:
            got["ranks"] = spawn_group(worker.run_cases, WORLD, "gloo",
                                       (cases,), device="cpu",
                                       timeout_s=240.0)
        except Exception as exc:  # noqa: BLE001 — re-raised below
            failure.append(exc)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        local = worker.run_cases(worker.LocalContext(), cases)
        refs = {"exact": {d: exact_plane_reference(d) for d in DS},
                "compressed": {d: compressed_plane_reference(d) for d in DS},
                "exact_pipelined": exact_pipelined_reference(),
                "compressed_pipelined": compressed_pipelined_reference(),
                "perturb": {d: perturb_reference(d) for d in DS},
                "gate": {d: [JShardedSim(
                    jexact.SimParams(**GATE_PARAMS), gate_graph(),
                    JTimeConfig(**GATE_TIME), mesh=mesh(d),
                    board_exchange="zoned", digest_gate=True)
                    .gate_predicates(jexact.SimState(
                        known=jnp.asarray(k), sent=None, node_alive=None,
                        round_idx=0))
                    for k in gate_states(d).values()] for d in DS},
                "scenario": {name: getattr(scenarios, fn)(
                    device="cpu", **SCENARIO_KW[name])
                    for name, fn in (("config4", "config4_ba_antientropy"),
                                     ("config5", "config5_split_heal"))}}
    finally:
        thread.join(300.0)
    assert not thread.is_alive()
    if failure:
        raise failure[0]
    ranks = got["ranks"]
    return {cid: ([r[cid] for r in ranks], local[cid])
            for cid, _, _ in cases}, refs


def joined(parts, key="state"):
    return convert.join_state([p[key] for p in parts])


def assert_fields_equal(got: dict, want: dict, ctx):
    for f in want:
        np.testing.assert_array_equal(np.asarray(got[f]), want[f],
                                      err_msg=f"{ctx} field {f}")


def assert_stream(parts, local, want, plane, ctx):
    """Every rank's stream, the one-process stream and the reference's,
    field by field."""
    stream = convert.join_stream([p["stream"] for p in parts])
    for f in PLANE_FIELDS[plane]:
        ref = np_of(getattr(want, f))
        np.testing.assert_array_equal(np.asarray(stream[f]), ref,
                                      err_msg=f"{ctx} {plane}.{f}")
        np.testing.assert_array_equal(np.asarray(local["stream"][f]), ref,
                                      err_msg=f"{ctx} {plane}.{f} local")


# -- the routed row collectives ------------------------------------------------

def test_routed_row_collectives_equal_local_group(results):
    """``fetch_rows`` returns the named global rows in request order and
    ``scatter_max_rows`` max-folds every rank's rows into their owners',
    as ``LocalShardGroup`` does on the global tensor (a rank that names
    none of another's rows sends it nothing)."""
    res, _ = results
    parts, _ = res["routed"]
    x, idx, vals = worker.routed_inputs(WORLD)
    local = worker.LocalShardGroup(1)
    for r, p in enumerate(parts):
        np.testing.assert_array_equal(p["fetched"],
                                      local.fetch_rows(x, idx[r]).numpy())
    folded = local.scatter_max_rows(x.clone(), torch.cat(idx),
                                    torch.cat(vals))
    np.testing.assert_array_equal(
        np.concatenate([p["folded"] for p in parts]), folded.numpy())
    assert not np.array_equal(folded.numpy(), x.numpy())


# -- the telemetry planes ------------------------------------------------------

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("mode", EXACT_MODES)
@pytest.mark.parametrize("plane", EXACT_PLANES)
def test_exact_planes_equal_reference_and_local(results, plane, mode, d):
    res, refs = results
    cid = f"exact-planes-{mode}-d{d}"
    parts, local = res[cid]
    jfinal, jstream, jconv = refs["exact"][d][plane]
    want = exact_to_numpy(jfinal)
    assert_fields_equal(joined([p[plane] for p in parts]), want, cid)
    assert_fields_equal(local[plane]["state"], want, f"{cid} local")
    assert_stream([p[plane] for p in parts], local[plane], jstream, plane,
                  cid)
    for p in parts:
        np.testing.assert_array_equal(p[plane]["conv"], jconv, err_msg=cid)
        assert p[plane]["conv"].dtype == np.float32
    np.testing.assert_array_equal(local[plane]["conv"].numpy(), jconv)
    # Premise: the rounds crossed the ranks and the run is not converged.
    assert all(p["exchange"]["bytes_sent"] > 0 for p in parts)
    assert 0.0 < jconv[-1] < 1.0


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("mode", COMPRESSED_MODES)
@pytest.mark.parametrize("plane", COMPRESSED_PLANES)
def test_compressed_planes_equal_reference_and_local(results, plane, mode,
                                                     d):
    res, refs = results
    cid = f"compressed-planes-{mode}-d{d}"
    parts, local = res[cid]
    jfinal, jstream = refs["compressed"][d][plane]
    want = to_numpy_state(jfinal)
    assert_fields_equal(joined([p[plane] for p in parts]), want, cid)
    assert_fields_equal(local[plane]["state"], want, f"{cid} local")
    assert_stream([p[plane] for p in parts], local[plane], jstream, plane,
                  cid)
    assert all(p["dropped"] == 0 for p in parts)
    if plane == "deltas":
        # Premise: cells changed, on both ranks' rows.
        nodes = np.asarray(local["deltas"]["stream"]["node"])
        assert (nodes >= 16).any() and ((nodes >= 0) & (nodes < 16)).any()


# -- the pipelined rounds ------------------------------------------------------

def assert_pipelined(parts, local, ref, ctx, states_to_numpy):
    jfinal, jconv, jinflight = ref
    want = states_to_numpy(jfinal)
    assert_fields_equal(joined(parts), want, ctx)
    assert_fields_equal(joined(parts, "fast"), want, f"{ctx} fast")
    assert_fields_equal(local["state"], want, f"{ctx} local")
    for p in parts:
        np.testing.assert_array_equal(p["conv"], jconv, err_msg=ctx)
    np.testing.assert_array_equal(local["conv"].numpy(), jconv)
    publish = convert.join_inflight([p["publish"] for p in parts])
    for got, loc, want_p in zip(publish, local["publish"], jinflight):
        np.testing.assert_array_equal(got, np.asarray(want_p), err_msg=ctx)
        np.testing.assert_array_equal(loc.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("mode", EXACT_MODES)
def test_exact_pipelined_equals_reference_and_local(results, mode, d):
    res, refs = results
    cid = f"exact-pipelined-{mode}-d{d}"
    parts, local = res[cid]
    assert_pipelined(parts, local, refs["exact_pipelined"], cid,
                     exact_to_numpy)
    # Premise: the uniform push-pull fetched rows from the other rank.
    assert all(p["exchange"]["bytes_sent"] > 0 for p in parts)
    assert 0.0 < refs["exact_pipelined"][1][-1] < 1.0


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("mode", COMPRESSED_MODES)
def test_compressed_pipelined_equals_reference_and_local(results, mode, d):
    res, refs = results
    cid = f"compressed-pipelined-{mode}-d{d}"
    parts, local = res[cid]
    assert_pipelined(parts, local, refs["compressed_pipelined"], cid,
                     to_numpy_state)
    assert all(p["dropped"] == 0 for p in parts)
    assert refs["compressed_pipelined"][1].min() < 1.0


# -- the scenario hook ---------------------------------------------------------

@pytest.mark.parametrize("d", DS)
def test_compressed_perturb_equals_reference_and_local(results, d):
    res, refs = results
    cid = f"compressed-perturb-d{d}"
    parts, local = res[cid]
    jfinal, jbehind = refs["perturb"][d]
    want = to_numpy_state(jfinal)
    assert_fields_equal(joined(parts), want, cid)
    assert_fields_equal(local["state"], want, f"{cid} local")
    for p in parts:
        np.testing.assert_array_equal(p["behind"], jbehind, err_msg=cid)
        np.testing.assert_array_equal(p["convergence"],
                                      local["convergence"].numpy())
    np.testing.assert_array_equal(local["behind"].numpy(), jbehind)
    # Premise: the hook restarted records and took nodes down.
    assert not want["node_alive"].all()
    assert jbehind.max() > 0


def test_a_hook_that_is_not_row_local_is_refused_over_ranks():
    from sidecar_tpu_torch.models.compressed import CompressedParams
    from sidecar_tpu_torch.parallel import ShardedCompressedSim
    from tests.torch_parity import port_topology

    class TwoRanks:
        d, world, rank, dl, local = 2, 2, 0, 1, (0,)

    with pytest.raises(ValueError, match="row_local"):
        ShardedCompressedSim(CompressedParams(**COMPRESSED_PARAMS),
                             port_topology(zoned32()), d=2, device="cpu",
                             group=TwoRanks(), perturb=lambda st, now: st)


# -- the digest gate's host replica -------------------------------------------

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("which", ["converged", "cold", "pairs"])
def test_gate_predicates_equal_reference_on_every_rank(results, which, d):
    res, refs = results
    parts, local = res[f"gate-d{d}"]
    i = list(gate_states(d)).index(which)
    want = refs["gate"][d][i]
    for p in parts:
        np.testing.assert_array_equal(p["predicates"][i], want)
    np.testing.assert_array_equal(local["predicates"][i], want)
    expect = {"converged": np.ones(d - 1, bool),
              "cold": np.zeros(d - 1, bool),
              "pairs": np.arange(1, d) % 2 == 0}[which]
    np.testing.assert_array_equal(want, expect)


# -- configs 4 and 5 over a group ----------------------------------------------

@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", sorted(SCENARIO_KW))
def test_scenario_over_group_equals_single_device(results, name, d):
    res, refs = results
    parts, local = res[f"{name}-d{d}"]
    want = refs["scenario"][name]
    for got in [*parts, local]:
        assert got["n"] == want.n
        np.testing.assert_array_equal(np.asarray(got["convergence"]),
                                      want.convergence, err_msg=name)
        assert got["eps_round"] == want.eps_round
    # Premise: the curve moved.
    assert want.convergence.min() < want.convergence.max()


# -- the restart churn on a rank's rows ----------------------------------------

def test_restart_churn_on_rank_rows_equals_whole_and_reference():
    """``restart_churn_perturb``'s static hook given each rank's rows of
    an exact state restarts what it restarts on the whole state, which
    is the reference hook's restart from the same ``bernoulli`` mask."""
    from sidecar_tpu import fleet as jfleet
    from sidecar_tpu_torch import fleet as tfleet
    from sidecar_tpu_torch.models.exact import SimParams

    n, spn, now = 16, 2, 40
    params = SimParams(n=n, services_per_node=spn, fanout=2, budget=4)
    rng = np.random.default_rng(4)
    known = rng.integers(0, 1 << 12, (n, n * spn)).astype(np.int32)
    alive = rng.random(n) < 0.8
    key = jax.random.PRNGKey(7)
    masks = jax_perturb_masks(key, 0, 1, (n * spn,), 0.3)
    k_perturb = jax.random.split(jax.random.fold_in(key, 0), 4)[0]

    def state(rows=slice(None)):
        return convert.exact_state_from_numpy(
            {"known": known[rows].copy(),
             "sent": np.full(known[rows].shape, 3, np.int8),
             "node_alive": alive[rows].copy(), "round_idx": 0}, "cpu")

    hook = tfleet.restart_churn_perturb(params, prob=0.3, masks=masks)
    whole = convert.state_to_numpy(hook(state(), now))
    half = n // WORLD
    parts = [convert.state_to_numpy(hook(
        state(slice(r * half, (r + 1) * half)), now,
        rows=slice(r * half, (r + 1) * half))) for r in range(WORLD)]
    for f in ("known", "sent"):
        np.testing.assert_array_equal(
            np.concatenate([p[f] for p in parts]), whole[f], err_msg=f)
    jstate = jexact.SimState(known=jnp.asarray(known),
                             sent=jnp.full(known.shape, 3, jnp.int8),
                             node_alive=jnp.asarray(alive),
                             round_idx=jnp.int32(0))
    jhook = jfleet.restart_churn_perturb(jexact.SimParams(
        n=n, services_per_node=spn, fanout=2, budget=4), prob=0.3)
    want = jhook(jstate, k_perturb, now)
    np.testing.assert_array_equal(whole["known"], np.asarray(want.known))
    np.testing.assert_array_equal(whole["sent"], np.asarray(want.sent))
    # Premise: some records restarted.
    assert not np.array_equal(whole["known"], known)
