"""One scheduler thread for every periodic loop of the live node — the
port of ``sidecar_tpu/runtime/scheduler.py``.

The reference multiplexes its periodic duties over goroutines and
advertises "a few execution threads"; a thread per ``TimedLooper``
loses that.  :class:`Scheduler` drives any number of periodic tasks
from one deadline heap on one thread.

Contract:

* Tasks run on the scheduler thread, one after another: a slow tick
  delays its siblings.  Blocking work (the writer's queue drain, the
  health check that waits on its pool) keeps a thread of its own.
* ``drive(looper, fn)`` keeps a ``TimedLooper``'s contract: its
  ``interval`` and ``immediate``, a prompt ``quit()`` (through
  ``add_quit_callback``), a raising tick kept in ``looper.error`` that
  stops only that task, and the looper's done event, so
  ``looper.wait()`` works.
* The next deadline is the end of ``fn`` plus the interval, as a
  ``TimedLooper`` sleeps the interval between runs.
* A tick that outlives ``stop()``'s join keeps the thread handle, and
  ``drive()`` refuses to start a second scheduler until it has ended.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from typing import Callable, Optional

from sidecar_tpu_torch.runtime.looper import TimedLooper

log = logging.getLogger(__name__)


class Scheduler:
    def __init__(self, name: str = "scheduler",
                 join_timeout: float = 5.0) -> None:
        self._name = name
        self._join_timeout = join_timeout
        self._heap: list = []       # (deadline, seq, task)
        self._seq = itertools.count()
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- registration -------------------------------------------------------

    def drive(self, looper: TimedLooper, fn: Callable[[], None],
              name: str = "task") -> None:
        """Drive ``fn`` at ``looper``'s interval until ``looper.quit()``
        (or until ``fn`` raises).  Starts the thread on first use."""
        first = time.monotonic() + \
            (0.0 if looper.immediate else looper.interval)
        task = _Task(looper, fn, name)
        # A quit wakes the scheduler and retires the task at once, not
        # at its next deadline.
        looper.add_quit_callback(self._reap_quit)
        with self._cond:
            if self._thread is not None and not self._thread.is_alive():
                # An ended thread (a finished stop(), or one whose join
                # timed out and has since drained): replace it.
                self._thread = None
            if self._thread is None:
                self._stop = False
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True)
                self._thread.start()
            elif self._stop:
                # stop() timed out on a slow tick and the old thread
                # still runs: a second one would run every task twice.
                raise RuntimeError(
                    f"scheduler {self._name!r} is still stopping (a slow "
                    "tick outlived the stop timeout); retry drive() after "
                    "the previous thread exits")
            heapq.heappush(self._heap, (first, next(self._seq), task))
            self._cond.notify()

    def _reap_quit(self) -> None:
        with self._cond:
            alive = []
            for entry in self._heap:
                task = entry[2]
                if task.looper._quit.is_set():
                    task.looper._done.set()
                else:
                    alive.append(entry)
            if len(alive) != len(self._heap):
                self._heap[:] = alive
                heapq.heapify(self._heap)
            self._cond.notify()

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self._join_timeout)
            if thread.is_alive():
                # Keep the handle: drive() reads it to refuse a second
                # scheduler while this one finishes its tick.
                log.warning(
                    "scheduler %r thread did not stop within %.1f s (slow "
                    "tick still running); keeping the handle to prevent "
                    "a duplicate scheduler", self._name, self._join_timeout)
            else:
                self._thread = None

    # -- the loop -----------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stop and \
                        (not self._heap or
                         self._heap[0][0] > time.monotonic()):
                    delay = None if not self._heap else \
                        max(0.0, self._heap[0][0] - time.monotonic())
                    self._cond.wait(timeout=delay)
                if self._stop:
                    for _, _, task in self._heap:
                        task.looper._done.set()
                    self._heap.clear()
                    return
                _, _, task = heapq.heappop(self._heap)
            if task.looper._quit.is_set():
                task.looper._done.set()
                continue
            try:
                task.fn()
            except BaseException as exc:  # noqa: BLE001 — Looper.loop's rule
                task.looper.error = exc
                task.looper._done.set()
                log.exception("scheduled task %s failed; stopped",
                              task.name)
                continue
            if task.looper._quit.is_set():
                task.looper._done.set()
                continue
            nxt = time.monotonic() + task.looper.interval
            with self._cond:
                heapq.heappush(self._heap, (nxt, next(self._seq), task))


class _Task:
    __slots__ = ("looper", "fn", "name")

    def __init__(self, looper: TimedLooper, fn: Callable[[], None],
                 name: str) -> None:
        self.looper = looper
        self.fn = fn
        self.name = name
