"""Host-side loop runners of the live node (``looper.py``): every
background loop takes a ``Looper``, so a test runs it exactly n times
with ``FreeLooper(n)``."""

from sidecar_tpu_torch.runtime.looper import (
    FreeLooper,
    Looper,
    TimedLooper,
    monotonic_ms,
    run_in_thread,
)

__all__ = ["Looper", "FreeLooper", "TimedLooper", "run_in_thread",
           "monotonic_ms"]
