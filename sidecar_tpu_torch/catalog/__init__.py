"""The catalog's read side and wire form (``state.py``) and the flap
damper (``damping.py``) — what the simulator bridge reads."""

from sidecar_tpu_torch.catalog.damping import (  # noqa: F401
    FlapDamper,
    TransitionReplay,
)
from sidecar_tpu_torch.catalog.state import (  # noqa: F401
    Server,
    ServicesState,
    decode,
)
