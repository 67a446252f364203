"""The port's node scheduler (``sidecar_tpu_torch/runtime/scheduler.py``)
against the JAX package's.

* The reference's ``tests/test_scheduler.py`` cases and the two
  lifecycle cases of ``tests/test_chaos.py`` (restart after stop, a
  slow tick that outlives stop) run on the port.
* On a virtual clock (each scheduler module's ``time`` and its
  condition's ``wait`` replaced, so a wait advances the clock instead of
  sleeping), the same loopers give the same ticks in the same order at
  the same times on both schedulers, the raising task's stop included.
"""

import importlib
import threading
import time
import types

import pytest

from sidecar_tpu_torch.runtime.looper import TimedLooper
from sidecar_tpu_torch.runtime.scheduler import Scheduler

PACKAGES = ("sidecar_tpu_torch", "sidecar_tpu")


@pytest.fixture
def sched():
    s = Scheduler(name="test-scheduler")
    yield s
    s.stop()


def wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


# -- the reference's cases on the port ------------------------------------------

def test_periodic_ticks(sched):
    ticks = []
    looper = TimedLooper(0.05)
    sched.drive(looper, lambda: ticks.append(time.monotonic()))
    assert wait_for(lambda: len(ticks) >= 4)
    looper.quit()
    gaps = [b - a for a, b in zip(ticks, ticks[1:])]
    assert all(g >= 0.04 for g in gaps), gaps


def test_immediate_flag(sched):
    t0 = time.monotonic()
    first = []
    looper = TimedLooper(0.5, immediate=True)
    sched.drive(looper, lambda: first.append(time.monotonic()))
    assert wait_for(lambda: first)
    assert first[0] - t0 < 0.4
    looper.quit()

    delayed = []
    looper2 = TimedLooper(0.2, immediate=False)
    sched.drive(looper2, lambda: delayed.append(time.monotonic()))
    t1 = time.monotonic()
    assert wait_for(lambda: delayed)
    assert delayed[0] - t1 >= 0.15
    looper2.quit()


def test_many_tasks_one_thread(sched):
    thread_ids = set()
    counts = [0] * 5
    loopers = [TimedLooper(0.03) for _ in range(5)]

    def mk(i):
        def fn():
            thread_ids.add(threading.get_ident())
            counts[i] += 1
        return fn

    for i, looper in enumerate(loopers):
        sched.drive(looper, mk(i), name=f"task-{i}")
    assert wait_for(lambda: all(c >= 3 for c in counts))
    for looper in loopers:
        looper.quit()
    assert len(thread_ids) == 1


def test_quit_is_prompt_and_sets_done(sched):
    ran = []
    looper = TimedLooper(5.0)
    sched.drive(looper, lambda: ran.append(1))
    assert wait_for(lambda: ran)
    t0 = time.monotonic()
    looper.quit()
    assert looper.wait(timeout=1.0), "done not set promptly on quit"
    assert time.monotonic() - t0 < 1.0
    n = len(ran)
    time.sleep(0.15)
    assert len(ran) == n


def test_stop_retires_everything():
    sched = Scheduler(name="stop-test")
    loopers = [TimedLooper(0.05) for _ in range(3)]
    for looper in loopers:
        sched.drive(looper, lambda: None)
    sched.stop()
    for looper in loopers:
        assert looper.wait(timeout=1.0)


def test_raising_task_stops_and_records(sched):
    boom = RuntimeError("tick failed")
    ran = []

    def fn():
        ran.append(1)
        raise boom

    looper = TimedLooper(0.02)
    sched.drive(looper, fn)
    assert wait_for(lambda: looper.wait(0.01))
    assert looper.error is boom
    assert len(ran) == 1


def test_sibling_survives_a_raising_task(sched):
    good = []
    bad_looper = TimedLooper(0.02)
    good_looper = TimedLooper(0.02)
    sched.drive(bad_looper, lambda: 1 / 0, name="bad")
    sched.drive(good_looper, lambda: good.append(1), name="good")
    assert wait_for(lambda: len(good) >= 5)
    assert isinstance(bad_looper.error, ZeroDivisionError)
    good_looper.quit()


def test_restart_after_stop():
    sched = Scheduler("chaos-restart")
    ticks = []
    looper = TimedLooper(0.02)
    sched.drive(looper, lambda: ticks.append(1))
    assert wait_for(lambda: ticks)
    sched.stop()
    ticks2 = []
    looper2 = TimedLooper(0.02)
    sched.drive(looper2, lambda: ticks2.append(1))
    assert wait_for(lambda: len(ticks2) >= 2)
    looper2.quit()
    sched.stop()


def test_slow_tick_cannot_double_run_scheduler():
    sched = Scheduler("chaos-slow", join_timeout=0.1)
    release = time.monotonic() + 0.8
    looper = TimedLooper(0.01)

    def slow_tick():
        while time.monotonic() < release:
            time.sleep(0.01)

    sched.drive(looper, slow_tick)
    time.sleep(0.05)
    sched.stop()                    # the join times out; the handle stays
    assert sched._thread is not None
    with pytest.raises(RuntimeError, match="still stopping"):
        sched.drive(TimedLooper(0.01), lambda: None)
    assert wait_for(lambda: not sched._thread.is_alive())
    ticks = []
    looper3 = TimedLooper(0.02)
    sched.drive(looper3, lambda: ticks.append(1))
    assert wait_for(lambda: ticks)
    looper3.quit()
    sched.stop()


# -- the same loopers on both schedulers, on a virtual clock ---------------------

class VirtualClock:
    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


class VirtualCondition(threading.Condition):
    """A condition whose timed wait advances the clock by the timeout
    and returns at once; an untimed wait (an empty heap) is real."""

    def __init__(self, clock: VirtualClock) -> None:
        super().__init__()
        self.clock = clock

    def wait(self, timeout=None):
        if timeout is None:
            return super().wait(0.05)
        self.clock.t += timeout
        return False


TASKS = (("a", 0.3, True, 0.0), ("b", 0.5, False, 0.0),
         ("c", 0.7, True, 0.1), ("d", 0.2, True, 0.0))
TICKS = 40


def virtual_run(package, monkeypatch):
    """Drive ``TASKS`` on ``package``'s scheduler in virtual time until
    ``TICKS`` ticks have run: task c's body takes 0.1 s, task d raises on
    its third tick.  Returns ``[(task, virtual time), ...]``, the error
    types and whether every looper reports done."""
    mod = importlib.import_module(f"{package}.runtime.scheduler")
    looper_mod = importlib.import_module(f"{package}.runtime.looper")
    clock = VirtualClock()
    monkeypatch.setattr(mod, "time",
                        types.SimpleNamespace(monotonic=clock.monotonic))
    sched = mod.Scheduler(name=f"virtual-{package}")
    sched._cond = VirtualCondition(clock)
    log, done = [], threading.Event()
    loopers = {}

    def fn(name, body):
        def tick():
            log.append((name, round(clock.t - 1000.0, 9)))
            clock.t += body
            if name == "d" and sum(n == "d" for n, _ in log) == 3:
                raise ValueError("d failed")
            if len(log) >= TICKS:
                for looper in loopers.values():
                    looper.quit()
                done.set()
        return tick

    for name, interval, immediate, body in TASKS:
        loopers[name] = looper_mod.TimedLooper(interval, immediate=immediate)
    with sched._cond:
        # Register every task before the thread takes the first one.
        for name, interval, immediate, body in TASKS:
            sched.drive(loopers[name], fn(name, body), name=name)
    try:
        assert done.wait(10.0)
    finally:
        sched.stop()
    errors = {k: type(v.error).__name__ for k, v in loopers.items()
              if v.error is not None}
    return log, errors, all(v.wait(1.0) for v in loopers.values())


def test_same_ticks_and_order_as_reference(monkeypatch):
    runs = [virtual_run(p, monkeypatch) for p in PACKAGES]
    assert runs[0] == runs[1]
    log, errors, all_done = runs[0]
    assert errors == {"d": "ValueError"}
    assert all_done
    assert len(log) == TICKS
    # Premise: the cadence is fn-end + interval, and b waits an interval.
    c_times = [t for n, t in log if n == "c"]
    assert [round(b - a, 6) for a, b in zip(c_times, c_times[1:])] == \
        [0.8] * (len(c_times) - 1)
    assert min(t for n, t in log if n == "b") >= 0.5
