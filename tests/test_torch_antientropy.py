"""The port's Merkle digest ladder and anti-entropy sessions
(``sidecar_tpu_torch/ops/digest.py``'s host half and
``sidecar_tpu_torch/transport/antientropy.py``) against the JAX
package's.

* The ladder: ``LadderDigest`` at every level equals the reference's,
  the NumPy ladder and the torch ladder on the CPU; the host helpers
  (bucket, hash, fold, compare, hex) give the reference's values.
* Sessions: ``ReconcileSession`` between two port states gives the same
  report, final catalogs, requests, backoff sleeps and counter deltas
  as between two JAX states — the digest walk, a no-op, the plain-wire
  gate, a geometry mismatch, a channel that fails k times, and a
  disabled session.  Across packages, a port initiator heals a JAX
  responder and the other way round over a channel that passes every
  document through JSON.
* Live against the model: the port's ``ChaosExactSim`` on the CPU
  partitions 8 nodes; two catalogs rebuilt from two sides' beliefs heal
  to the digest of the merged beliefs at every level."""

import json
import random

import numpy as np
import pytest
import torch

from tests.torch_live import (
    NS,
    SIDES,
    T0,
    Clock,
    counters,
    join_senders,
    ladder,
    make_state,
    reset_live,
    service,
)

PORT, JAX = SIDES["port"], SIDES["jax"]


@pytest.fixture
def live(monkeypatch):
    reset_live(monkeypatch)
    yield
    join_senders()


# -- the ladder --------------------------------------------------------------------

def packed_rows(seed, n=4, m=200):
    rng = np.random.default_rng(seed)
    packed = rng.integers(1, 2**24, size=(n, m)).astype(np.int32)
    packed[rng.random((n, m)) < 0.3] = 0
    names = [(f"h{j // 5}", f"s{j}") for j in range(m)]
    return packed, names


@pytest.mark.parametrize("base,depth", [(64, 5), (16, 3), (1, 4), (8, 1)])
def test_ladder_levels_equal_every_twin(base, depth):
    packed, names = packed_rows(base + depth)
    idents = PORT.ops_digest.catalog_idents(names)
    np.testing.assert_array_equal(idents,
                                  JAX.ops_digest.catalog_idents(names))
    np_levels = PORT.ops_digest.ladder_digests_np(packed, idents, base, depth)
    t_levels = PORT.ops_digest.ladder_digests(
        torch.as_tensor(packed), torch.as_tensor(idents.astype(np.int64)),
        base, depth)
    for row in range(packed.shape[0]):
        recs = [(int(idents[j]), int(v)) for j, v in enumerate(packed[row])
                if v != 0]
        lp = PORT.ops_digest.LadderDigest.of(recs, base, depth)
        lj = JAX.ops_digest.LadderDigest.of(recs, base, depth)
        assert lp.count == lj.count == len(recs)
        assert lp.leaf_buckets == lj.leaf_buckets
        for k in range(depth):
            assert lp.level(k) == lj.level(k), k
            assert lp.hex(k) == lj.hex(k)
            assert lp.level(k) == PORT.ops_digest.digest_value(
                np_levels[k][row]), k
            assert lp.level(k) == PORT.ops_digest.digest_value(
                t_levels[k][row]), k
            if k:
                assert PORT.ops_digest.fold_digest_py(lp.level(k)) == \
                    JAX.ops_digest.fold_digest(lj.level(k)) == lp.level(k - 1)
        inc = PORT.ops_digest.IncrementalDigest.of(recs, base)
        assert inc.value() == lp.value() == \
            JAX.ops_digest.IncrementalDigest.of(recs, base).value()
        for ident, key in recs[::3]:
            lp.remove(ident, key)
            lj.remove(ident, key)
        assert [lp.level(k) for k in range(depth)] == \
            [lj.level(k) for k in range(depth)]


def test_host_helpers_equal_reference():
    rng = np.random.default_rng(9)
    pd, jd = PORT.ops_digest, JAX.ops_digest
    for ident in rng.integers(0, 2**32, 64).tolist():
        key = int(rng.integers(0, 2**63))
        for buckets in (1, 2, 64, 1024):
            assert pd.bucket_of(ident, buckets) == jd.bucket_of(ident,
                                                                buckets)
            assert pd.record_hash(ident, key, buckets) == \
                jd.record_hash(ident, key, buckets)
    a = tuple(rng.integers(0, 2**32, 128).tolist())
    b = tuple(v if i % 5 else v ^ 1 for i, v in enumerate(a))
    assert pd.diff_bucket_ids(a, b) == jd.diff_bucket_ids(a, b)
    assert pd.diff_buckets_py(a, b) == jd.diff_buckets_py(a, b) > 0
    assert pd.digest_to_hex(a) == jd.digest_to_hex(a)
    assert pd.digest_from_hex(pd.digest_to_hex(a)) == a
    arr = np.asarray(a, np.uint32).reshape(64, 2)
    assert pd.digest_value(arr) == pd.digest_value(torch.as_tensor(
        arr.astype(np.int64))) == jd.digest_value(arr) == a
    for bad in ("", "abc", "0" * 15):
        with pytest.raises(ValueError):
            pd.digest_from_hex(bad)
    with pytest.raises(ValueError):
        pd.fold_digest_py(a[:2])
    with pytest.raises(ValueError):
        pd.diff_bucket_ids(a, a[:4])
    with pytest.raises(ValueError):
        pd.LadderDigest(64, 0)
    with pytest.raises(ValueError):
        pd.IncrementalDigest(48)


# -- sessions ----------------------------------------------------------------------

def catalog(side, clock, host, n, offset=0, step=1, **kw):
    st = make_state(side, clock, host, gate=False, damper=False,
                    listeners=False, **kw)
    for i in range(0, n, step):
        st.add_service_entry(service(side, f"h{i % 5}", f"h{i % 5}-s{i}",
                                     T0 + i + offset,
                                     (0, 0, 2, 1)[i % 4]))
    return st


def fail_hook(side, failures):
    """A channel hook that fails the first ``failures`` attempts."""
    seen = []

    def fail(doc):
        seen.append(doc.get("T"))
        if len(seen) <= failures:
            raise side.transport_antientropy.ChannelError(
                f"attempt {len(seen)} lost")
    return fail


CASES = ("digest", "noop", "plainwire", "geometry", "retry", "exhaust",
         "failed", "disabled")


def run_session(side, case, monkeypatch):
    clock = Clock(T0 + 10 * NS)
    ae = side.transport_antientropy
    a = catalog(side, clock, "alpha", 60)
    if case == "noop":
        b = catalog(side, clock, "beta", 60)
    elif case == "geometry":
        if side is JAX:
            monkeypatch.setenv("SIDECAR_TPU_ANTIENTROPY_DEPTH", "3")
            b = catalog(side, clock, "beta", 50, offset=2, step=2)
            monkeypatch.delenv("SIDECAR_TPU_ANTIENTROPY_DEPTH")
        else:
            b = catalog(side, clock, "beta", 50, offset=2, step=2,
                        ladder_depth=3)
    else:
        b = catalog(side, clock, "beta", 50, offset=2, step=2)
    fail = {"retry": 2, "exhaust": 4, "failed": 10**6}.get(case)
    channel = ae.LoopbackChannel(ae.AntiEntropyResponder(b),
                                 fail=fail_hook(side, fail) if fail else None)
    peer_doc = None
    if case == "plainwire":
        peer_doc = {k: v for k, v in b.digest_doc().items()
                    if k != "Ladder"}
    slept = []
    before = counters(side, ("antientropy.",))
    rep = ae.ReconcileSession(
        a, channel, peer_doc=peer_doc, enabled=case != "disabled",
        rng=random.Random(7), sleep=slept.append).run()
    after = counters(side, ("antientropy.",))
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    return dict(report=dict(vars(rep)), total=rep.total_bytes,
                a=a.encode(), b=b.encode(), ladders=(ladder(a), ladder(b)),
                requests=json.dumps(channel.requests), slept=slept,
                counters=delta)


@pytest.mark.parametrize("case", CASES)
def test_session_equals_reference(live, monkeypatch, case):
    port = run_session(PORT, case, monkeypatch)
    ref = run_session(JAX, case, monkeypatch)
    assert port == ref
    rep = port["report"]
    want_mode = {"digest": "digest", "noop": "digest", "retry": "digest",
                 "failed": "failed"}.get(case, "full")
    assert rep["mode"] == want_mode
    if case in ("digest", "retry"):
        assert rep["coherent"] is True and rep["levels_walked"] == 4
        assert port["ladders"][0] == port["ladders"][1]
    if case == "noop":
        assert rep["states"] == ["HELLO", "DONE"] and rep["coherent"]
    if case in ("retry", "exhaust"):
        assert port["slept"] and rep["retries"] == len(port["slept"])
    if case == "geometry":
        assert "ladder mismatch" in rep["fallback_reason"]


def records(st) -> dict:
    """The catalog's records (its hosts' change stamps depend on the
    order records arrived in)."""
    return {h: srv["Services"]
            for h, srv in json.loads(st.encode())["Servers"].items()}


class JsonChannel:
    """A channel onto a responder of either package that passes every
    request and answer through ``json.dumps``/``json.loads``."""

    def __init__(self, responder):
        self.responder = responder
        self.requests = []

    def send(self, doc, timeout):
        wire = json.loads(json.dumps(doc))
        self.requests.append(wire)
        return json.loads(json.dumps(self.responder.handle(wire)))


@pytest.mark.parametrize("initiator", ["port", "jax"])
@pytest.mark.parametrize("plain", [False, True])
def test_session_across_packages_heals(live, initiator, plain):
    clock = Clock(T0 + 10 * NS)
    other = "jax" if initiator == "port" else "port"
    ini, res = SIDES[initiator], SIDES[other]
    a = catalog(ini, clock, "alpha", 60)
    b = catalog(res, clock, "beta", 50, offset=2, step=2)
    peer_doc = {"Buckets": 64} if plain else None
    rep = ini.transport_antientropy.reconcile(
        a, JsonChannel(res.transport_antientropy.AntiEntropyResponder(b)),
        peer_doc=peer_doc, enabled=True, rng=random.Random(1),
        sleep=lambda s: None)
    assert rep.mode == ("full" if plain else "digest")
    if not plain:
        assert rep.coherent is True
    assert a.digest_snapshot == b.digest_snapshot
    assert ladder(a) == ladder(b)
    assert records(a) == records(b)
    # The same session inside one package gives the same report.
    a2 = catalog(ini, clock, "alpha", 60)
    b2 = catalog(ini, clock, "beta", 50, offset=2, step=2)
    same = ini.transport_antientropy.reconcile(
        a2, JsonChannel(ini.transport_antientropy.AntiEntropyResponder(b2)),
        peer_doc=peer_doc, enabled=True, rng=random.Random(1),
        sleep=lambda s: None)
    assert vars(same) == vars(rep)


def test_responder_answers_errors_and_shed_records(live):
    """Unknown requests and bad levels answer an error document in both
    packages; ``deliver_records`` skips a malformed record and counts
    the rest; ``merge_body`` refuses a non-object."""
    out = {}
    for k, side in SIDES.items():
        ae = side.transport_antientropy
        clock = Clock(T0 + 10 * NS)
        st = catalog(side, clock, "alpha", 10)
        r = ae.AntiEntropyResponder(st)
        good = service(side, "h9", "h9-s1", T0 + 5, 0).to_json()
        n = ae.deliver_records(st, [good, {"Ports": 5}], origin="peer")
        with pytest.raises(ae.ProtocolError):
            ae.merge_body(st, [1])
        out[k] = (r.handle({"T": "nope"}), r.handle({"T": "level",
                                                     "Level": 9,
                                                     "Buckets": {}}),
                  r.handle({"T": "level"}), n, st.encode(),
                  counters(side, ("antientropy.",)))
    assert out["port"] == out["jax"]
    assert out["port"][0]["T"] == "error" and out["port"][3] == 1


# -- live against the model ---------------------------------------------------------

def test_partitioned_model_and_live_sessions_agree(live):
    """One partition plan over 8 nodes on the port's ``ChaosExactSim``
    (on the CPU): the two sides stay diverged; two catalogs rebuilt from
    node 0's and node 7's beliefs through the writer heal with a digest
    session to the digest of the merged beliefs, at every level, by the
    NumPy ladder and the torch one."""
    from sidecar_tpu_torch.chaos import ChaosExactSim, FaultPlan
    from sidecar_tpu_torch.models.exact import SimParams
    from sidecar_tpu_torch.models.timecfg import TimeConfig
    from sidecar_tpu_torch.ops import topology

    n, spn = 8, 2
    m = n * spn
    a_side, b_side = tuple(range(n // 2)), tuple(range(n // 2, n))
    plan = FaultPlan(seed=16).with_edges(
        *FaultPlan.partition(a_side, b_side, 0, 1000))
    names = [(f"h{j // spn}", f"s{j}") for j in range(m)]
    pd = PORT.ops_digest
    idents = pd.catalog_idents(names)
    sim = ChaosExactSim(SimParams(n=n, services_per_node=spn, fanout=3,
                                  budget=8),
                        topology.complete(n),
                        TimeConfig(refresh_interval_s=10_000.0), plan,
                        device="cpu")
    final, dt, _ = sim.run_with_digest(
        sim.init_state(), 12, cap=12, idents=idents,
        generator=torch.Generator().manual_seed(16))
    rec = dt.rec[:int(dt.count)].numpy()
    assert (rec[:, pd.DIG_DIFF_TOTAL] > 0).all()
    known = final.known.numpy()
    k_a, k_b = known[0], known[n - 1]
    assert not np.array_equal(k_a, k_b)

    def rebuild(host, beliefs):
        st = PORT.catalog_state.ServicesState(hostname=host,
                                              cluster_name="twin")
        st.set_clock(lambda: 1_000_000)
        for j, packed in enumerate(beliefs.tolist()):
            if packed:
                st.add_service_entry(PORT.service.Service(
                    id=names[j][1], name="app", image="i",
                    hostname=names[j][0], updated=packed >> 3,
                    status=packed & 7))
        return st

    live_a, live_b = rebuild("node0", k_a), rebuild("node7", k_b)
    assert live_a.digest_snapshot != live_b.digest_snapshot
    ae = PORT.transport_antientropy
    rep = ae.reconcile(live_a, ae.LoopbackChannel(
        ae.AntiEntropyResponder(live_b)))
    assert rep.mode == "digest" and rep.coherent is True
    assert live_a.digest_snapshot == live_b.digest_snapshot
    merged = np.maximum(k_a, k_b)[None, :]
    base, depth = live_a.ladder_geometry()
    np_levels = pd.ladder_digests_np(merged, idents, base, depth)
    t_levels = pd.ladder_digests(torch.as_tensor(merged),
                                 torch.as_tensor(idents.astype(np.int64)),
                                 base, depth)
    for k in range(depth):
        assert live_a.digest_level(k) == pd.digest_value(np_levels[k][0]) \
            == pd.digest_value(t_levels[k][0]), k
    assert live_a.digest_snapshot[1] == JAX.ops_digest.digest_value(
        JAX.ops_digest.node_digests_np(merged, idents, base)[0])
