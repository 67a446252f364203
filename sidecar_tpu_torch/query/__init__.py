"""The versioned snapshot and delta query plane — the port of
``sidecar_tpu/query/``, the read-path half of the live catalog.

* :mod:`sidecar_tpu_torch.query.snapshot` — immutable, monotonically
  versioned, copy-on-write catalog snapshots published by the writer
  path; readers never take ``state._lock``, and each wire form is
  serialized at most once a version (cached on the snapshot).
* :mod:`sidecar_tpu_torch.query.hub` — the subscription hub: bounded
  per-subscriber queues, delta coalescing under backpressure (a
  subscriber that falls behind collapses to one snapshot at the latest
  version), the ``query.*`` drop and coalesce counters, and relay tiers.

Wire shapes and backpressure: ``docs/query.md``.
"""

from sidecar_tpu_torch.query.snapshot import CatalogSnapshot, ServerView
from sidecar_tpu_torch.query.hub import (
    QueryEvent,
    QueryHub,
    RelayHub,
    Subscription,
    relay_tree,
)

__all__ = [
    "CatalogSnapshot",
    "ServerView",
    "QueryEvent",
    "QueryHub",
    "RelayHub",
    "Subscription",
    "relay_tree",
]
