"""Deterministic loop runners — the port of
``sidecar_tpu/runtime/looper.py``, the analog of ``go-director``.

Every background loop of the live catalog takes a ``Looper``, so a test
substitutes ``FreeLooper(n)`` and runs exactly n iterations on its own
thread, as the reference's tests do (services_state_test.go:344-351).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Looper:
    """Drives ``fn`` repeatedly until quit or error.

    ``loop(fn)`` blocks until the loop ends (run it under
    :func:`run_in_thread` for a background loop).  ``fn`` returning
    continues the loop; raising stops it and keeps the error in
    ``error``.
    """

    def __init__(self) -> None:
        self._quit = threading.Event()
        self._done = threading.Event()
        self.error: Optional[BaseException] = None
        self._quit_callbacks: list[Callable[[], None]] = []

    def add_quit_callback(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` when this looper is quit."""
        self._quit_callbacks.append(cb)

    def quit(self) -> None:
        self._quit.set()
        for cb in self._quit_callbacks:
            cb()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the loop finishes; True if it did."""
        return self._done.wait(timeout)

    def _iterations(self):
        raise NotImplementedError

    def loop(self, fn: Callable[[], None]) -> None:
        try:
            for _ in self._iterations():
                if self._quit.is_set():
                    break
                fn()
        except BaseException as exc:  # noqa: BLE001 — loop errors are data
            self.error = exc
        finally:
            self._done.set()


class FreeLooper(Looper):
    """Exactly ``count`` iterations, back to back."""

    def __init__(self, count: int) -> None:
        super().__init__()
        self.count = count

    def _iterations(self):
        return range(self.count)


class TimedLooper(Looper):
    """One iteration every ``interval`` seconds; ``count`` ≤ 0 runs
    until quit."""

    def __init__(self, interval: float, count: int = -1,
                 immediate: bool = True) -> None:
        super().__init__()
        self.interval = interval
        self.count = count
        self.immediate = immediate

    def _iterations(self):
        i = 0
        first = True
        while self.count <= 0 or i < self.count:
            if not (first and self.immediate):
                # A sleep that quit() interrupts.
                if self._quit.wait(self.interval):
                    return
            first = False
            yield i
            i += 1


def run_in_thread(looper: Looper, fn: Callable[[], None],
                  name: str = "looper") -> threading.Thread:
    """Start ``looper.loop(fn)`` on a daemon thread and return it."""
    t = threading.Thread(target=looper.loop, args=(fn,), name=name,
                         daemon=True)
    t.start()
    return t


def monotonic_ms() -> int:
    return int(time.monotonic() * 1000)
