"""The slice as a whole against the JAX reference with its Pallas
kernels (interpret mode on the CPU), fused and with
``SIDECAR_TPU_FUSED_GATHER=0`` — the port runs the matching path
(``fused_gather=True``/``False``).  Exact, every state field and every
behind sample (see ``test_torch_lockstep.py`` for the run's shape).
"""

import pytest

from tests.test_torch_lockstep import run_lockstep

pytestmark = pytest.mark.pallas


@pytest.mark.parametrize("fused", [True, False])
def test_bench_shaped_run_matches_pallas(monkeypatch, fused):
    curve = run_lockstep(monkeypatch, mode="pallas", n=32, fused=fused,
                         burst=0.5)
    assert curve[0] > 0          # premise: the burst was in flight
