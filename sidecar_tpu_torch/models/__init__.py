"""Models of the port: the compressed large-cluster model, the exact
record-level model and the protocol time configuration."""

from sidecar_tpu_torch.models.compressed import (  # noqa: F401
    CompressedParams,
    CompressedSim,
    CompressedState,
)
from sidecar_tpu_torch.models.exact import (  # noqa: F401
    ExactSim,
    SimParams,
    SimState,
)
from sidecar_tpu_torch.models.timecfg import TimeConfig  # noqa: F401
