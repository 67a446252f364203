"""The port's shard groups over ``torch.distributed``: a real gloo group
of two CPU processes (``parallel/launch.spawn_group``) against the
one-process :class:`LocalShardGroup` and the JAX reference, exactly.

One group is spawned for the module and runs every case in turn
(``tests/torch_dist_worker.py``, which imports no JAX); meanwhile this
process runs the reference's programs and the port's one-process twins
from the same inputs.  Each case then compares the ranks' joined
results:

* every group collective (int32 and int8; ``ppermute`` also with a
  destination no pair names) and row collective against
  ``LocalShardGroup``'s — also on each node group of two ranks that a
  4-rank world splits into (``DistShardGroup.split``, a spawn of its
  own);
* ``ShardedSim`` at d = 2 (a shard a rank) and d = 4 (two), in
  ``all_gather``, ``ring``, ``zoned`` and the digest-gated ``zoned``
  exchange, a sparse round whose shards decide differently, and a cut
  with sides: the joined state and the float32 convergence curve equal
  the reference's ``ShardedSim`` at the same d and the port's
  one-process run, bit for bit, with the stride push-pull every 5
  rounds;
* ``ShardedCompressedSim`` at d = 2 and 4 in every exchange mode, from
  the rank-local boot state and a rank-local ``mint`` (one case with a
  node down, on the exact census): the state and the behind curve equal
  the reference twin's, the convergence the one-process run's;
* the fleet: 4 exact scenarios over the 2 ranks, every ``table`` row
  equal to the one-process ``FleetSim``'s and the reference's, with and
  without early exit;
* a rank that raises makes ``spawn_group`` raise, within its timeout.
"""

import dataclasses
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sidecar_tpu import fleet as jfleet
from sidecar_tpu.models import compressed as jc
from sidecar_tpu.models import exact as jexact
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.parallel.mesh import make_mesh
from sidecar_tpu.parallel.sharded import ShardedSim as JShardedSim
from sidecar_tpu.parallel.sharded_compressed import (
    ShardedCompressedSim as JShardedCompressedSim,
)
from sidecar_tpu_torch import convert
from sidecar_tpu_torch import fleet as tfleet
from sidecar_tpu_torch.models.exact import SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops.status import ALIVE, TOMBSTONE
from sidecar_tpu_torch.parallel import (
    LocalShardGroup,
    ShardedCompressedSim,
    spawn_group,
)
from tests import torch_dist_worker as worker
from tests.torch_parity import (
    assert_exact_states_equal,
    assert_port_states_equal,
    assert_states_equal,
    exact_port_state,
    exact_to_numpy,
    jax_exact_draws,
    jax_sharded_draws,
    jax_sharded_exact_draws,
    sharded_exact_port,
    to_numpy_state,
)

WORLD = 2
KEY = jax.random.PRNGKey(3)
ROUNDS = 20
# Refreshes every 10 rounds, the stride push-pull every 5, the sweep
# every 2.
TIME = dict(refresh_interval_s=2.0, push_pull_interval_s=1.0,
            sweep_interval_s=0.4)
EXACT_PARAMS = dict(n=32, services_per_node=4, fanout=2, budget=6,
                    drop_prob=0.1)
COMPRESSED_PARAMS = dict(n=32, services_per_node=2, fanout=2, budget=4,
                         cache_lines=16, drop_prob=0.1)
CHUNK = 10


def topo_data(topo):
    return (topo.n, topo.nbrs, topo.deg, topo.name, topo.stagger,
            topo.stagger_period)


def zoned32():
    return jtopo.zoned(32, 4, local_hops=1, remote_deg=2, gateways=1)


# -- the cases ----------------------------------------------------------------

def exact_case(d, mode, *, params=EXACT_PARAMS, time=TIME, topo=None,
               rounds=ROUNDS, start=None, **kw):
    """A reference ``ShardedSim``, its draws and its start state."""
    if topo is None:
        topo = zoned32() if mode == "zoned" else jtopo.complete(params["n"])
    jsim = JShardedSim(jexact.SimParams(**params), topo, JTimeConfig(**time),
                       mesh=make_mesh(jax.devices()[:d]), board_exchange=mode,
                       **kw)
    st = jsim.init_state() if start is None else start(jsim)
    return dict(jsim=jsim, kw=dict(board_exchange=mode, **kw), d=d,
                start=st, draws=jax_sharded_exact_draws(jsim, KEY, 0, rounds))


def half_down(jsim):
    """The second half of the nodes down and empty: shard 0's senders
    overflow its sparse cap while shard 1 compacts."""
    st = jsim.init_state()
    n = jsim.p.n
    known = np.asarray(st.known).copy()
    known[n // 2:] = 0
    return dataclasses.replace(st, known=jnp.asarray(known),
                               node_alive=jnp.asarray(np.arange(n) < n // 2))


def exact_cases():
    cases = {f"exact-{mode}-d{d}": functools.partial(exact_case, d, mode)
             for d in (2, 4) for mode in ("all_gather", "ring", "zoned")}
    gate_graph = jtopo.zoned(16, 4, local_hops=2, remote_deg=4, gateways=2)
    for d in (2, 4):
        cases[f"exact-gate-d{d}"] = functools.partial(
            exact_case, d, "zoned", topo=gate_graph, digest_gate=True,
            params=dict(n=16, services_per_node=2, fanout=4, budget=8),
            time=dict(refresh_interval_s=1000.0, push_pull_interval_s=1e6,
                      sweep_interval_s=1.0), rounds=14)
    cases["exact-sparse-d2"] = functools.partial(
        exact_case, 2, "ring", start=half_down, sparse="1",
        params=dict(n=64, services_per_node=2, fanout=2, budget=4,
                    drop_prob=0.1, sparse_cap=16, retransmit_limit=2),
        time=dict(TIME, refresh_interval_s=1000.0))
    ring = jtopo.ring(32)
    side = (np.arange(32) >= 16).astype(np.int32)
    cases["exact-cut-sides-d4"] = functools.partial(
        exact_case, 4, "ring", topo=ring,
        cut_mask=jtopo.partition_mask(ring, side), node_side=side)
    return cases


def compressed_case(d, mode, *, dead=()):
    params = dict(COMPRESSED_PARAMS,
                  fanout=3 if mode == "all_to_all" else 2)
    topo = zoned32() if mode == "zoned" else jtopo.complete(32)
    jsim = JShardedCompressedSim(
        jc.CompressedParams(**params), topo, JTimeConfig(**TIME),
        mesh=make_mesh(jax.devices()[:d]), board_exchange=mode)
    rng = np.random.default_rng(5)
    chunks = []
    for c, status in enumerate((ALIVE, TOMBSTONE)):
        slots = np.sort(rng.choice(jsim.p.m, size=6,
                                   replace=False)).astype(np.int32)
        chunks.append((slots, c * CHUNK * 200 + 7, status,
                       jax_sharded_draws(jsim, jax.random.PRNGKey(9),
                                         c * CHUNK, CHUNK)))
    return dict(jsim=jsim, kw=dict(board_exchange=mode), d=d, dead=dead,
                chunks=chunks)


def compressed_cases():
    cases = {f"compressed-{mode}-d{d}":
             functools.partial(compressed_case, d, mode)
             for d in (2, 4) for mode in ("all_gather", "all_to_all", "ring",
                                          "zoned")}
    cases["compressed-dead-d4"] = functools.partial(
        compressed_case, 4, "all_gather", dead=(3, 20))
    return cases


FLEET_SPECS = (dict(name="plain", seed=1),
               dict(name="lossy", seed=2, drop_prob=0.1),
               dict(name="limit8", seed=3, retransmit_limit=8),
               dict(name="pp1", seed=4, push_pull_interval_s=1.0))
FLEET_PARAMS = dict(n=16, services_per_node=2, fanout=3, budget=5)
FLEET_TIME = dict(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
FLEET_EPS = 0.05


def fleet_draws(rounds):
    return [[jax_exact_draws(jax.random.PRNGKey(s["seed"]), r,
                             n=FLEET_PARAMS["n"],
                             fanout=FLEET_PARAMS["fanout"],
                             budget=FLEET_PARAMS["budget"],
                             keep_prob=1.0 - s.get("drop_prob", 0.0))
             for r in range(rounds)] for s in FLEET_SPECS]


def worker_case(cid, case):
    """The case as the worker takes it: plain data only."""
    if cid.startswith("collectives"):
        return cid, "collectives", case
    if cid.startswith("fleet"):
        return cid, "fleet", dict(
            specs=list(FLEET_SPECS), params=FLEET_PARAMS, time=FLEET_TIME,
            rounds=ROUNDS, stop=case["stop"], eps=FLEET_EPS,
            draws=[worker.draws_to_data(d) for d in fleet_draws(ROUNDS)])
    jsim = case["jsim"]
    common = dict(d=case["d"], params=dataclasses.asdict(jsim.p),
                  topo=topo_data(jsim.topo),
                  time=dataclasses.asdict(jsim.t), sim_kw=case["kw"])
    if cid.startswith("exact"):
        return cid, "exact", dict(
            common, draws=worker.draws_to_data(case["draws"]),
            state={k: np.asarray(v)
                   for k, v in exact_to_numpy(case["start"]).items()})
    return cid, "compressed", dict(
        common, dead=case["dead"],
        chunks=[(slots, tick, status, worker.draws_to_data(draws))
                for slots, tick, status, draws in case["chunks"]])


COLLECTIVE_CASES = {f"collectives-{dtype}-d{d}": dict(d=d, dtype=dtype)
                    for d in (2, 4) for dtype in ("int32", "int8")}
FLEET_CASES = {"fleet-full": dict(stop=False), "fleet-stop": dict(stop=True)}


# -- the references, run in this process -------------------------------------

def exact_reference(case):
    jsim, d = case["jsim"], case["d"]
    final, conv = jsim.run(case["start"], KEY, len(case["draws"]),
                           donate=False)
    tsim = sharded_exact_port(jsim, d=d, **case["kw"])
    local, local_conv = tsim.run(exact_port_state(case["start"]),
                                 len(case["draws"]), draws=case["draws"])
    return dict(final=final, conv=np.asarray(conv), local=local,
                local_conv=local_conv.numpy(),
                local_stats=tsim.last_sparse_stats)


def dead_start(jsim, dead):
    """The reference's boot state with the nodes ``dead`` down."""
    arrays = to_numpy_state(jsim.init_state())
    alive = arrays["node_alive"].copy()
    alive[list(dead)] = False
    return jc.CompressedState(**{k: jnp.asarray(v) for k, v in
                                 dict(arrays, node_alive=alive).items()})


def compressed_reference(case):
    jsim = case["jsim"]
    js = dead_start(jsim, case["dead"]) if case["dead"] else \
        jsim.init_state()
    tsim = ShardedCompressedSim(
        convert.params_from_jax_fields(dataclasses.asdict(jsim.p)),
        convert.topology_from_numpy(*topo_data(jsim.topo)[:4]),
        convert.timecfg_from_fields(dataclasses.asdict(jsim.t)),
        d=case["d"], device="cpu", **case["kw"])
    ts = convert.state_from_numpy(
        {k: np.array(v) for k, v in to_numpy_state(js).items()}, "cpu")
    curves, local_curves = [], []
    for slots, tick, status, draws in case["chunks"]:
        js = jsim.mint(js, jnp.asarray(slots), tick, status)
        js, jb = jsim.run_behind(js, jax.random.PRNGKey(9), CHUNK, every=1,
                                 donate=False)
        ts = tsim.mint(ts, slots, tick, status)
        ts, tb = tsim.run_behind(ts, CHUNK, 1, draws=draws)
        curves.append(np.asarray(jb))
        local_curves.append(tb.numpy())
    return dict(final=js, behind=np.concatenate(curves), local=ts,
                local_behind=np.concatenate(local_curves),
                local_conv=tsim.convergence(ts).numpy(),
                local_dropped=tsim.sync_exchange_metrics(ts))


def fleet_reference(case):
    jb = jfleet.ScenarioBatch.build(
        [jfleet.ScenarioSpec(**s) for s in FLEET_SPECS],
        jexact.SimParams(**FLEET_PARAMS), JTimeConfig(**FLEET_TIME))
    jf = jfleet.FleetSim(jb)
    jrun = jf.run(jf.init_states(), ROUNDS, eps=FLEET_EPS,
                  stop=case["stop"])
    tb = tfleet.ScenarioBatch.build(
        [tfleet.ScenarioSpec(**s) for s in FLEET_SPECS],
        SimParams(**FLEET_PARAMS), TimeConfig(**FLEET_TIME), device="cpu")
    tf = tfleet.FleetSim(tb)
    trun = tf.run(tf.init_states(), ROUNDS, eps=FLEET_EPS, stop=case["stop"],
                  draws=fleet_draws(ROUNDS))
    return dict(jax_table=jrun.table(200, 1000),
                local_table=trun.table(200, 1000), local=trun)


# -- the module's group -------------------------------------------------------

@pytest.fixture(scope="module")
def results():
    """Spawn the group on every case, and run the references while it
    works; ``{case id: (rank results, reference)}``."""
    built = {}
    for cid, make in {**exact_cases(), **compressed_cases()}.items():
        built[cid] = make()
    built.update(COLLECTIVE_CASES)
    built.update(FLEET_CASES)
    cases = [worker_case(cid, case) for cid, case in built.items()]
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
    refs = {}
    try:
        for cid, case in built.items():
            if cid.startswith("exact"):
                refs[cid] = exact_reference(case)
            elif cid.startswith("compressed"):
                refs[cid] = compressed_reference(case)
            elif cid.startswith("fleet"):
                refs[cid] = fleet_reference(case)
    finally:
        thread.join(300.0)
    assert not thread.is_alive()
    if failure:
        raise failure[0]
    ranks = got["ranks"]
    return {cid: ([r[cid] for r in ranks], refs.get(cid), built[cid])
            for cid in built}


def joined(parts):
    return convert.join_state([p["state"] for p in parts])


# -- the collectives ----------------------------------------------------------

def assert_collectives_equal_local(parts, d, dtype, world, cid):
    """The ranks' collective outputs (one group of ``world`` ranks, ``d``
    shards) against ``LocalShardGroup``'s."""
    want = worker.group_outputs(LocalShardGroup(d), d, dtype)
    _, _, replicas, rows = worker.collective_inputs(d, dtype)
    dl = d // world
    for name in ("all_gather", "all_to_all", "pmax", "psum",
                 "ppermute_ring", "ppermute_partial"):
        got = [t for p in parts for t in p[name]]
        assert len(got) == d, name
        for s in range(d):
            np.testing.assert_array_equal(got[s], want[name][s],
                                          err_msg=f"{cid} {name} shard {s}")
            assert got[s].dtype == want[name][s].dtype, name
    # ppermute_partial names no pair for shard 0: it receives zeros.
    assert not parts[0]["ppermute_partial"][0].any()
    for p in parts:
        np.testing.assert_array_equal(p["gather_rows"][0], rows.numpy())
    for i, k in enumerate((0, 1, 3, -5)):
        np.testing.assert_array_equal(
            np.concatenate([p["shift_rows"][i] for p in parts]),
            np.roll(rows.numpy(), -k, 0), err_msg=f"{cid} shift {k}")
    firsts = np.stack([replicas[r * dl].numpy() for r in range(world)])
    for p in parts:
        np.testing.assert_array_equal(p["all_reduce_max"][0],
                                      firsts.max(axis=0))
        np.testing.assert_array_equal(
            p["all_reduce_sum"][0],
            firsts.sum(axis=0).astype(firsts.dtype))


@pytest.mark.parametrize("cid", sorted(COLLECTIVE_CASES))
def test_collectives_equal_local_group(results, cid):
    parts, _, case = results[cid]
    assert_collectives_equal_local(parts, case["d"], case["dtype"], WORLD,
                                   cid)


SUBGROUP_WORLD = 4
SUBGROUP_CASES = {f"subgroup-{dtype}": dict(size=2, dtype=dtype)
                  for dtype in ("int32", "int8")}


@pytest.fixture(scope="module")
def subgroup_results():
    """A 4-rank gloo world split into node groups of 2 ranks, running the
    collective case on each: every rank's outputs by case."""
    ranks = spawn_group(worker.run_cases, SUBGROUP_WORLD, "gloo",
                        ([(cid, "subgroup_collectives", case)
                          for cid, case in SUBGROUP_CASES.items()],),
                        device="cpu", timeout_s=120.0)
    return {cid: [r[cid] for r in ranks] for cid in SUBGROUP_CASES}


@pytest.mark.parametrize("cid", sorted(SUBGROUP_CASES))
def test_node_group_collectives_equal_local_group(subgroup_results, cid):
    """Each node group of the split world gives ``LocalShardGroup``'s
    outputs, its collectives confined to its own two ranks."""
    parts = subgroup_results[cid]
    case = SUBGROUP_CASES[cid]
    size = case["size"]
    for blk in range(SUBGROUP_WORLD // size):
        members = parts[blk * size:(blk + 1) * size]
        for p in members:
            np.testing.assert_array_equal(
                p["ranks"][0], np.arange(blk * size, (blk + 1) * size))
        assert_collectives_equal_local(members, size, case["dtype"], size,
                                       f"{cid} block {blk}")


# -- the exact twin -----------------------------------------------------------

@pytest.mark.parametrize("cid", sorted(exact_cases()))
def test_sharded_exact_equals_reference_and_local(results, cid):
    parts, ref, case = results[cid]
    got = convert.exact_state_from_numpy(joined(parts), "cpu")
    assert_exact_states_equal(ref["final"], got, cid)
    assert_port_states_equal(ref["local"], got, f"{cid} vs local")
    for p in parts:
        np.testing.assert_array_equal(p["conv"], ref["conv"], err_msg=cid)
        np.testing.assert_array_equal(p["conv"], ref["local_conv"])
        assert p["conv"].dtype == np.float32
    if "sparse_stats" in parts[0]:
        for p in parts:
            np.testing.assert_array_equal(p["sparse_stats"],
                                          ref["local_stats"].numpy())
        stats = parts[0]["sparse_stats"]
        # Premise: compacted rounds and overflowing rounds both ran.
        assert 0 < stats[0] < ROUNDS, stats
    # Premise: the exchange crossed the ranks, and gloo staged nothing
    # (the tensors are on the CPU).
    for p in parts:
        assert p["exchange"]["bytes_sent"] > 0
        assert p["exchange"]["staging_bytes"] == 0
    if not cid.startswith("exact-gate"):
        assert 0.0 < ref["conv"][-1] < 1.0 or cid.endswith("d2")


# -- the compressed twin ------------------------------------------------------

@pytest.mark.parametrize("cid", sorted(compressed_cases()))
def test_sharded_compressed_equals_reference_twin(results, cid):
    parts, ref, _ = results[cid]
    got = convert.state_from_numpy(joined(parts), "cpu")
    assert_states_equal(ref["final"], got, cid)
    assert_port_states_equal(ref["local"], got, f"{cid} vs local")
    for p in parts:
        np.testing.assert_array_equal(p["behind"], ref["behind"],
                                      err_msg=cid)
        np.testing.assert_array_equal(p["behind"], ref["local_behind"])
        np.testing.assert_array_equal(p["convergence"], ref["local_conv"])
        assert p["dropped"] == ref["local_dropped"]
    # Premise: a burst was in flight.
    assert ref["behind"].max() > 0


# -- the fleet ----------------------------------------------------------------

@pytest.mark.parametrize("cid", sorted(FLEET_CASES))
def test_fleet_table_equals_one_process_and_reference(results, cid):
    parts, ref, case = results[cid]
    for p in parts:
        assert p["table"] == ref["local_table"], cid
        assert p["table"] == ref["jax_table"], cid
        np.testing.assert_array_equal(p["convergence"],
                                      ref["local"].convergence)
        assert p["host_reads"] == ref["local"].host_reads
    if case["stop"]:
        # Premise: the scenarios froze early, at different rounds.
        rounds = ref["local"].rounds
        assert (rounds < ROUNDS).all() and len(set(rounds)) > 1, rounds


# -- failures are not swallowed -----------------------------------------------

def test_a_failing_rank_makes_spawn_group_raise():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_group(worker.fail_on_rank_one, WORLD, "gloo", device="cpu",
                    timeout_s=60.0)
    assert time.perf_counter() - t0 < 60.0


def test_spawn_group_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="backend"):
        spawn_group(worker.fail_on_rank_one, WORLD, "mpi", device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        spawn_group(worker.fail_on_rank_one, WORLD, "nccl", device="cpu")
