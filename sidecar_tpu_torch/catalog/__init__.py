"""The replicated catalog (``state.py``: the writer path, the digest
ladder, the wire form), the URL listener that posts its changes
(``url_listener.py``) and the flap damper (``damping.py``)."""

from sidecar_tpu_torch.catalog.damping import (  # noqa: F401
    FlapDamper,
    TransitionReplay,
)
from sidecar_tpu_torch.catalog.state import (  # noqa: F401
    ALIVE_BROADCAST_INTERVAL,
    ALIVE_COUNT,
    ChangeEvent,
    LISTENER_EVENT_BUFFER_SIZE,
    Listener,
    QueueListener,
    Server,
    ServicesState,
    TOMBSTONE_COUNT,
    decode,
    decode_stream,
)

__all__ = [
    "ChangeEvent", "Server", "ServicesState", "Listener", "QueueListener",
    "decode", "decode_stream", "ALIVE_COUNT", "TOMBSTONE_COUNT",
    "ALIVE_BROADCAST_INTERVAL", "LISTENER_EVENT_BUFFER_SIZE",
    "FlapDamper", "TransitionReplay",
]
