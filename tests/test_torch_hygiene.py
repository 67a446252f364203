"""Ground rules of the PyTorch port: it imports neither ``jax`` nor
anything of ``sidecar_tpu`` (nor does ``chip_smoke.py``), its entry
points (both models) refuse to fall back to the CPU when no GPU is
present, options it does not port yet raise and name their ROADMAP
item, and state, params, time configs and graphs survive the trip
through ``convert``.
"""

import ast
import dataclasses
import pathlib

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

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "sidecar_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "sidecar_tpu"), (path, mod)


def test_every_port_module_is_checked():
    names = {p.name for p in PORT_FILES}
    for expected in ("status.py", "merge.py", "ttl.py", "suspicion.py",
                     "gossip.py", "knobs.py", "topology.py",
                     "publish_gather.py", "build.py", "compressed.py",
                     "timecfg.py", "convert.py", "mesh.py",
                     "sharded_compressed.py", "chip_smoke.py", "exact.py",
                     "scatter_max.py", "common.py"):
        assert expected in names, expected


def small_sim(**kw):
    p = CompressedParams(n=16, services_per_node=2, cache_lines=8,
                         budget=4)
    return CompressedSim(p, topology.complete(16), TimeConfig(), **kw)


def small_exact(**kw):
    p = SimParams(n=16, services_per_node=2, budget=4)
    return ExactSim(p, topology.ring(16), TimeConfig(), **kw)


@pytest.mark.parametrize("make", [small_sim, small_exact],
                         ids=["compressed", "exact"])
def test_default_device_needs_a_gpu(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("option,value", [
    ("perturb", lambda st, key, now: st),
    ("cut_mask", np.zeros((16, 1), bool)),
    ("node_side", np.zeros(16, np.int32)),
    ("sparse", "auto"),
    ("pipeline", "1"),
    ("tick_period", 2),
])
def test_deferred_options_raise(option, value):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        small_sim(device="cpu", **{option: value})


@pytest.mark.parametrize("option,value,item", [
    ("perturb", lambda st, key, now: st, "item 8"),
    ("cut_mask", np.zeros((16, 2), bool), "item 8"),
    ("sparse", "auto", "item 6"),
    ("pipeline", "1", "item 6"),
    ("tick_period", 2, "item 6"),
    ("tick_phase", 1, "item 6"),
])
def test_exact_deferred_options_raise(option, value, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md Queue 1 {item}"):
        small_exact(device="cpu", **{option: value})


def test_exact_staggered_topology_raises():
    topo = dataclasses.replace(topology.ring(16),
                               stagger=np.zeros(16, np.int32),
                               stagger_period=2)
    with pytest.raises(NotImplementedError, match="item 6.*stagger"):
        ExactSim(SimParams(n=16, services_per_node=2), topo, TimeConfig(),
                 device="cpu")


def test_staggered_topology_raises():
    p = CompressedParams(n=16, services_per_node=2, cache_lines=8,
                         budget=4)
    topo = dataclasses.replace(topology.ring(16),
                               stagger=np.zeros(16, np.int32),
                               stagger_period=2)
    with pytest.raises(NotImplementedError, match="stagger"):
        CompressedSim(p, topo, TimeConfig(), device="cpu")


def test_convert_round_trip():
    sim = small_sim(device="cpu")
    st = sim.mint(sim.init_state(), [3, 17, 30], 10)
    st = sim.run_fast(st, 3, generator=torch.Generator().manual_seed(0))
    arrays = convert.state_to_numpy(st)
    assert arrays["cache_sent"].dtype == np.int8
    assert arrays["round_idx"].dtype == np.int32
    back = convert.state_from_numpy(arrays, "cpu")
    for name, value in convert.state_to_numpy(back).items():
        np.testing.assert_array_equal(value, arrays[name], err_msg=name)
    with pytest.raises(ValueError, match="missing"):
        convert.state_from_numpy({"own": arrays["own"]}, "cpu")


def test_convert_round_trip_exact():
    sim = small_exact(device="cpu")
    st = sim.run_fast(sim.init_state(0.8, seed=3), 4,
                      generator=torch.Generator().manual_seed(0))
    arrays = convert.state_to_numpy(st)
    assert arrays["sent"].dtype == np.int8
    assert arrays["round_idx"].dtype == np.int32
    back = convert.exact_state_from_numpy(arrays, "cpu")
    assert back.round_idx == 4
    for name, value in convert.state_to_numpy(back).items():
        np.testing.assert_array_equal(value, arrays[name], err_msg=name)
    with pytest.raises(ValueError, match="missing"):
        convert.exact_state_from_numpy({"known": arrays["known"]}, "cpu")
    p = SimParams(n=40, drop_prob=0.25, retransmit_limit=9)
    assert convert.exact_params_from_jax_fields(
        dict(dataclasses.asdict(p), sparse_cap=0)) == p
    with pytest.raises(NotImplementedError, match="sparse_cap"):
        convert.exact_params_from_jax_fields(
            dict(dataclasses.asdict(p), sparse_cap=8))


def test_convert_params_timecfg_topology():
    p = CompressedParams(n=40, drop_prob=0.25, fold_quorum=1.0)
    assert convert.params_from_jax_fields(
        dict(dataclasses.asdict(p), sparse_cap=0)) == p
    with pytest.raises(NotImplementedError, match="sparse_cap"):
        convert.params_from_jax_fields(
            dict(dataclasses.asdict(p), sparse_cap=8))
    t = TimeConfig(push_pull_interval_s=4.0, origin_budget=3)
    assert convert.timecfg_from_fields(dataclasses.asdict(t)) == t
    er = topology.erdos_renyi(40, 4.0, seed=1)
    again = convert.topology_from_numpy(40, er.nbrs, er.deg, er.name)
    np.testing.assert_array_equal(again.nbrs, er.nbrs)
    assert convert.topology_from_numpy(40).nbrs is None
