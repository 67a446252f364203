"""Host-side loop runners of the live node: every background loop takes
a ``Looper`` (``looper.py``), so a test runs it exactly n times with
``FreeLooper(n)``; ``scheduler.py``'s ``Scheduler`` drives any number
of periodic loops on one thread."""

from sidecar_tpu_torch.runtime.looper import (
    FreeLooper,
    Looper,
    TimedLooper,
    monotonic_ms,
    run_in_thread,
)

__all__ = ["Looper", "FreeLooper", "TimedLooper", "run_in_thread",
           "monotonic_ms"]
