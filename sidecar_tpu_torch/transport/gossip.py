"""The ctypes bridge to the native gossip engine and the delegate loop
that drives the catalog's writer path — the port of
``sidecar_tpu/transport/gossip.py``.

The engine is the repo's C++ source ``native/transport.cc``: it owns the
sockets and IO threads (UDP gossip packed into ~1,398-byte packets,
SWIM-style ping/ack failure detection, TCP full-state push-pull).  This
module builds it with ``g++`` at the flags of ``native/Makefile`` into
``_build/`` beside this file (listed in ``.gitignore``), under a name
that carries a hash of the source and the flags, and loads it with
``ctypes``.  It never runs ``make`` and never writes ``native/build/``;
a failed build raises with the compiler's output.

:class:`GossipTransport` is the Python half of the reference's
``servicesDelegate`` (services_delegate.go:16-223):

* outbound — drains ``state.broadcasts`` into the engine's queue and
  keeps the engine's local-state snapshot (the push-pull reply) fresh;
* inbound — polls received records into the single-writer queue
  (NotifyMsg), full push-pull bodies into ``state.merge``
  (MergeRemoteState) and ``leave`` events into ``state.expire_server``
  (NotifyLeave).

Metrics: ``transport.shedInbound``, ``transport.shedBroadcasts``,
``transport.pushpull.retries``, ``.failures``, ``.backoff_ms``, the
``engine.*`` gauges, ``pendingBroadcasts``, and the timers
``getBroadcasts``, ``notifyMsg`` and ``mergeRemoteState``; spans:
``gossip.receive``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import pathlib
import queue as queue_mod
import random
import shutil
import subprocess
import threading
import time
from typing import Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch import service as svc_mod
from sidecar_tpu_torch.catalog import ServicesState, decode
from sidecar_tpu_torch.telemetry.span import span as _span

log = logging.getLogger(__name__)

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE.parent.parent / "native" / "transport.cc"
BUILD_DIR = _HERE / "_build"
# native/Makefile's CXXFLAGS, and -shared.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")

_lib = None
_lib_lock = threading.Lock()


def compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native gossip engine needs a "
                           "C++17 compiler to build")
    return found


def library_path() -> pathlib.Path:
    """Where the engine built from the current source lies."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsidecar_transport-{digest}.so"


def build_native() -> pathlib.Path:
    """Compile the engine unless the current source is built; returns
    the library's path.  The build goes to a temporary name and is
    renamed into place under a file lock, so processes that load the
    engine at once build it once."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native transport build failed ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)
    return out


def load_native() -> ctypes.CDLL:
    """Load the engine (building it first if the current source is not
    built), once a process.  ``ctypes.CDLL`` loads it ``RTLD_LOCAL``, so
    its symbols stay apart from any other copy of the engine."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native()))
        lib.st_create.restype = ctypes.c_void_p
        lib.st_create.argtypes = [ctypes.c_char_p] * 3 + [ctypes.c_int] + \
            [ctypes.c_char_p] + [ctypes.c_int] * 4
        lib.st_start.restype = ctypes.c_int
        lib.st_start.argtypes = [ctypes.c_void_p]
        lib.st_join.restype = ctypes.c_int
        lib.st_join.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int]
        lib.st_broadcast.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
        lib.st_set_local_state.argtypes = [ctypes.c_void_p,
                                           ctypes.c_char_p, ctypes.c_int]
        lib.st_configure_probe.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_int] * 4
        lib.st_set_handoff_depth.argtypes = [ctypes.c_void_p,
                                             ctypes.c_int]
        lib.st_test_drop_types.argtypes = [ctypes.c_void_p,
                                           ctypes.c_char_p, ctypes.c_uint]
        for fn in (lib.st_poll_msg, lib.st_poll_state, lib.st_poll_event,
                   lib.st_poll_log, lib.st_members):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.st_next_state_len.restype = ctypes.c_int
        lib.st_next_state_len.argtypes = [ctypes.c_void_p]
        lib.st_stats.restype = ctypes.c_int
        lib.st_stats.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_ulonglong),
                                 ctypes.c_int]
        lib.st_port.restype = ctypes.c_int
        lib.st_port.argtypes = [ctypes.c_void_p]
        lib.st_stop.argtypes = [ctypes.c_void_p]
        lib.st_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


# Packet-type bits of the engine's one-way receive-drop hook
# (st_test_drop_types).  DROP_PUSH_PULL refuses the node's TCP
# anti-entropy exchanges, so an injected partition cuts push-pull as it
# cuts UDP gossip.
DROP_GOSSIP = 1 << 0
DROP_PING = 1 << 1
DROP_ACK = 1 << 2
DROP_PING_REQ = 1 << 3
DROP_ACK_FWD = 1 << 4
DROP_PUSH_PULL = 1 << 5
DROP_ALL_UDP = DROP_GOSSIP | DROP_PING | DROP_ACK | DROP_PING_REQ | \
    DROP_ACK_FWD
DROP_ALL = DROP_ALL_UDP | DROP_PUSH_PULL

_LOG_LEVELS = {"E": logging.ERROR, "W": logging.WARNING,
               "I": logging.INFO, "D": logging.DEBUG}


class GossipTransport:
    """The memberlist equivalent: one native engine and the delegate
    thread that wires it to a ``ServicesState``."""

    def __init__(self, node_name: Optional[str] = None,
                 cluster_name: str = "default",
                 bind_ip: str = "0.0.0.0", bind_port: int = 7946,
                 advertise_ip: str = "127.0.0.1",
                 gossip_interval: float = 0.2,
                 push_pull_interval: float = 20.0,
                 gossip_nodes: int = 3,
                 gossip_messages: int = 15,
                 probe_interval: float = 0.0,
                 probe_timeout: float = 0.0,
                 suspect_timeout: float = 0.0,
                 indirect_probes: int = -1,
                 handoff_queue_depth: int = 1024,
                 fault_injector=None,
                 max_pending_broadcasts: int = 4096,
                 push_pull_retries: int = 3,
                 push_pull_backoff_ms: float = 100.0,
                 push_pull_jitter: float = 0.5,
                 push_pull_attempt_timeout: float = 5.0) -> None:
        import socket

        self.node_name = node_name or socket.gethostname()
        self.cluster_name = cluster_name
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        self.advertise_ip = advertise_ip or "127.0.0.1"
        self.gossip_interval = gossip_interval
        self.push_pull_interval = push_pull_interval
        self.gossip_nodes = gossip_nodes
        self.gossip_messages = gossip_messages
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.suspect_timeout = suspect_timeout
        self.indirect_probes = indirect_probes
        # memberlist's HandoffQueueDepth: the bound of the engine's
        # received-record queue; a stalled consumer sheds the oldest
        # records and anti-entropy re-delivers them.  There is no
        # unbounded mode, so 0 or less is refused rather than kept.
        if handoff_queue_depth <= 0:
            raise ValueError(
                f"handoff_queue_depth must be positive, got "
                f"{handoff_queue_depth} (there is no unbounded mode)")
        self.handoff_queue_depth = handoff_queue_depth
        # The chaos shim (chaos/live_inject.py): an object with
        # on_recv / due_records / filter_send / accept_push_pull,
        # consulted at the send and receive boundary.  None: no faults.
        self.fault_injector = fault_injector
        # state.broadcasts never blocks its producers, so the bridge
        # keeps the outbound bound: past it the oldest batches are shed
        # (freshest wins) and counted.
        if max_pending_broadcasts <= 0:
            raise ValueError("max_pending_broadcasts must be positive")
        self.max_pending_broadcasts = max_pending_broadcasts
        # The push-pull client's retries: a failed seed join gets
        # push_pull_retries more attempts, each under
        # push_pull_attempt_timeout, apart by an exponential backoff
        # (base push_pull_backoff_ms) with uniform jitter.
        if push_pull_retries < 0:
            raise ValueError("push_pull_retries must be >= 0")
        self.push_pull_retries = push_pull_retries
        self.push_pull_backoff_ms = push_pull_backoff_ms
        self.push_pull_jitter = push_pull_jitter
        self.push_pull_attempt_timeout = push_pull_attempt_timeout
        # Replaceable for deterministic backoff tests.
        self._retry_rng = random.Random()
        self._lib = load_native()
        self._handle: Optional[int] = None
        self._quit = threading.Event()
        self._threads: list[threading.Thread] = []
        self.state: Optional[ServicesState] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self, state: ServicesState,
              seeds: Optional[list[str]] = None) -> int:
        """Bind the sockets, start the IO and delegate threads, join the
        seeds.  Returns the bound port."""
        self.state = state
        self._handle = self._lib.st_create(
            self.node_name.encode(), self.cluster_name.encode(),
            self.bind_ip.encode(), self.bind_port,
            self.advertise_ip.encode(),
            int(self.gossip_interval * 1000),
            int(self.push_pull_interval * 1000),
            self.gossip_nodes, self.gossip_messages)
        self._lib.st_configure_probe(
            self._handle, int(self.probe_interval * 1000),
            int(self.probe_timeout * 1000),
            int(self.suspect_timeout * 1000), self.indirect_probes)
        self._lib.st_set_handoff_depth(self._handle,
                                       self.handoff_queue_depth)
        port = self._lib.st_start(self._handle)
        if port < 0:
            raise OSError(
                f"failed to start gossip transport on "
                f"{self.bind_ip}:{self.bind_port}")
        self.bind_port = port
        self._push_local_state()

        t = threading.Thread(target=self._bridge_loop,
                             name="gossip-bridge", daemon=True)
        t.start()
        self._threads.append(t)

        for seed in seeds or []:
            host, _, port_s = seed.partition(":")
            self.join_with_retry(host, int(port_s) if port_s else 7946)
        return port

    def join(self, host: str, port: int = 7946) -> None:
        """TCP dial and full-state exchange (memberlist.Join), one
        attempt; raises ``OSError`` on failure (:meth:`join_with_retry`
        retries)."""
        if self._lib.st_join(self._handle, host.encode(), port) != 0:
            raise OSError(f"join {host}:{port} failed")

    def _join_once(self, host: str, port: int, timeout: float) -> None:
        """One join attempt under a timeout.  ``st_join`` blocks, so it
        runs on a worker thread; on timeout the attempt counts as failed
        and the dial is left to the engine's own socket timeouts."""
        outcome: list = []

        def work() -> None:
            try:
                self.join(host, port)
                outcome.append(None)
            except OSError as exc:
                outcome.append(exc)

        t = threading.Thread(target=work, name="gossip-join",
                             daemon=True)
        t.start()
        t.join(timeout)
        if t.is_alive():
            raise OSError(
                f"join {host}:{port} timed out after {timeout:.1f}s")
        if outcome and outcome[0] is not None:
            raise outcome[0]

    def join_with_retry(self, host: str, port: int = 7946) -> bool:
        """Seed join with bounded retries, a per-attempt timeout and
        exponential backoff with jitter.  Returns True on success;
        running out of attempts counts ``transport.pushpull.failures``."""
        last: Optional[OSError] = None
        for attempt in range(self.push_pull_retries + 1):
            if attempt:
                delay_ms = self.push_pull_backoff_ms * (2 ** (attempt - 1))
                delay_ms *= 1.0 + self.push_pull_jitter \
                    * self._retry_rng.random()
                metrics.histogram("transport.pushpull.backoff_ms",
                                  delay_ms)
                metrics.incr("transport.pushpull.retries")
                if self._quit.wait(delay_ms / 1000.0):
                    break   # stopping: no redial of a dead transport
            try:
                self._join_once(host, port,
                                self.push_pull_attempt_timeout)
                return True
            except OSError as exc:
                last = exc
                log.warning("Join %s:%d attempt %d/%d failed: %s",
                            host, port, attempt + 1,
                            self.push_pull_retries + 1, exc)
        metrics.incr("transport.pushpull.failures")
        log.warning("Giving up on seed %s:%d after %d attempts: %s",
                    host, port, self.push_pull_retries + 1, last)
        return False

    def stop(self) -> None:
        self._quit.set()
        # The delegate thread polls the native handle: join it before
        # the handle is freed.
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = [t for t in self._threads if t.is_alive()]
        if self._handle is None:
            return
        self._lib.st_stop(self._handle)
        if self._threads:
            # Still inside a blocking hand-off (a push-pull body into a
            # full writer queue), the thread would next poll a freed
            # handle: the stopped engine stays allocated until a later
            # stop() finds the thread gone.
            log.warning("gossip bridge of %s still running after 5 s; "
                        "keeping its stopped engine", self.node_name)
            return
        self._lib.st_destroy(self._handle)
        self._handle = None

    def members(self) -> list[str]:
        """memberlist.Members: the node names, this node's included."""
        if self._handle is None:
            return [self.node_name]
        buf = ctypes.create_string_buffer(1 << 20)
        n = self._lib.st_members(self._handle, buf, len(buf))
        return [m for m in ctypes.string_at(buf, n).decode().split("\n") if m]

    def test_drop_types(self, node: str, type_mask: int) -> None:
        """One-way fault injection: drop received packets of the masked
        types (``DROP_*`` bits) that come from ``node``."""
        if self._handle is not None:
            self._lib.st_test_drop_types(self._handle, node.encode(),
                                         type_mask)

    # -- delegate loop -----------------------------------------------------

    def _push_local_state(self) -> None:
        """Refresh the engine's LocalState snapshot
        (services_delegate.go:146-151): the push-pull body with its
        digest annotation (``encode_annotated``), or plain ``encode()``
        for a state that has no annotation."""
        if self.state is not None and self._handle is not None:
            enc = getattr(self.state, "encode_annotated", None) \
                or self.state.encode
            data = enc()
            self._lib.st_set_local_state(self._handle, data, len(data))

    # The order of the engine's stats (native/transport.cc
    # Transport::stats); the [:n] clamp takes what the engine returns.
    _STAT_NAMES = ("engine.udpOut", "engine.udpBytesOut", "engine.udpIn",
                   "engine.udpBytesIn", "engine.pushPullOut",
                   "engine.pushPullIn", "engine.udpSendDrops")

    def engine_stats(self) -> dict[str, int]:
        """The engine's counters, read now, by their gauge names
        (``engine.udpOut``, ...)."""
        vals = (ctypes.c_ulonglong * len(self._STAT_NAMES))()
        n = self._lib.st_stats(self._handle, vals, len(vals))
        return {name: int(val)
                for name, val in zip(self._STAT_NAMES[:n], vals[:n])}

    def _poll_engine_stats(self) -> None:
        for name, val in self.engine_stats().items():
            metrics.set_gauge(name, val)

    # How long, and how often, the bridge waits on a full single-writer
    # queue before it sheds a record: at most retries × timeout a
    # record, far below the gossip interval (anti-entropy re-delivers
    # what is shed).
    INBOUND_PUT_RETRIES = 3
    INBOUND_PUT_TIMEOUT = 0.005

    def _deliver_inbound(self, svc) -> None:
        """Hand a record to the single-writer queue with bounded retries
        instead of a blocking put, so a stalled writer cannot wedge the
        bridge thread; past the retries the record is shed and counted."""
        for _ in range(self.INBOUND_PUT_RETRIES):
            if self.state.offer_service(svc,
                                        timeout=self.INBOUND_PUT_TIMEOUT):
                return
            if self._quit.is_set():
                return
        metrics.incr("transport.shedInbound")
        log.warning("Single-writer queue full; shedding inbound record "
                    "%s (anti-entropy will re-deliver)", svc.id)

    def _shed_broadcast_backlog(self) -> None:
        """Keep the outbound bound: drop the oldest pending batches
        beyond ``max_pending_broadcasts`` (push-pull still carries their
        records) and count them."""
        q = self.state.broadcasts
        shed = 0
        while q.qsize() > self.max_pending_broadcasts:
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
            shed += 1
        if shed:
            metrics.incr("transport.shedBroadcasts", shed)
            log.warning("Outbound broadcast backlog over %d; shed %d "
                        "oldest batches", self.max_pending_broadcasts, shed)

    def _bridge_loop(self) -> None:
        """One delegate thread for both directions.  Outbound: drain
        ``state.broadcasts`` into the engine (timed as
        ``getBroadcasts``), push the local state and poll the engine's
        stats every second.  Inbound: release the injector's delayed
        records, then drain at most 64 rounds of the engine's queues —
        records (NotifyMsg), full-state bodies sized by
        ``st_next_state_len`` (MergeRemoteState), log lines and
        membership events (a ``leave`` expires the node's services on a
        thread of its own).  The outbound ``get`` is the idle wait, but
        only when the last inbound drain went idle: a backlog drains at
        full rate."""
        # Each read copies its n bytes out with ``string_at``: ``buf.raw``
        # would copy the whole 4 MiB buffer a record (≈ 0.5 ms under the
        # interpreter lock), enough to let the engine's hand-off queue
        # overflow when many nodes share one process.
        buf = ctypes.create_string_buffer(1 << 22)
        last_state_push = 0.0
        inbound_backlogged = False
        while not self._quit.is_set():
            # -- outbound ---------------------------------------------------
            try:
                if inbound_backlogged:
                    prepared = self.state.broadcasts.get_nowait()
                else:
                    prepared = self.state.broadcasts.get(timeout=0.02)
            except queue_mod.Empty:
                prepared = None
            if self._quit.is_set():
                return
            if prepared and self.fault_injector is not None:
                prepared = self.fault_injector.filter_send(prepared)
            if prepared:
                t0 = time.perf_counter()
                for payload in prepared:
                    self._lib.st_broadcast(self._handle, payload,
                                           len(payload))
                metrics.measure_since("getBroadcasts", t0)
            self._shed_broadcast_backlog()
            metrics.set_gauge("pendingBroadcasts",
                              self.state.broadcasts.qsize())
            now = time.monotonic()
            if now - last_state_push > 1.0:
                self._push_local_state()
                self._poll_engine_stats()
                last_state_push = now

            # Records the injector delayed whose time has come.
            if self.fault_injector is not None:
                for svc in self.fault_injector.due_records():
                    self._deliver_inbound(svc)

            # -- inbound, bounded a cycle so the outbound half above is
            # not starved; what is left waits for the next cycle.
            busy = True
            drained = 0
            while busy and drained < 64 and not self._quit.is_set():
                drained += 1
                busy = False

                n = self._lib.st_poll_msg(self._handle, buf, len(buf))
                if n > 0:
                    busy = True
                    t0 = time.perf_counter()
                    # The receive span covers decode and the hand-off to
                    # the writer's queue; the merge runs on the writer
                    # thread under a trace of its own.
                    with _span("gossip.receive"):
                        try:
                            svc = svc_mod.decode(ctypes.string_at(buf, n))
                            if self.fault_injector is not None:
                                records = self.fault_injector.on_recv(svc)
                            else:
                                records = (svc,)
                            for record in records:
                                self._deliver_inbound(record)
                        except ValueError as exc:
                            log.warning("Error decoding gossip message: %s",
                                        exc)
                    metrics.measure_since("notifyMsg", t0)

                # A full-state body is the whole catalog: size the read
                # from the engine's queue so it is never truncated.
                need = self._lib.st_next_state_len(self._handle)
                if need > 0:
                    sbuf = buf if need <= len(buf) else \
                        ctypes.create_string_buffer(need)
                    n = self._lib.st_poll_state(self._handle, sbuf, len(sbuf))
                    if n > 0:
                        busy = True
                        # A paused or crashed node merges nothing; this
                        # path bypasses the per-record shim, so it has
                        # its own gate.
                        if self.fault_injector is not None and \
                                not self.fault_injector.accept_push_pull():
                            continue
                        t0 = time.perf_counter()
                        try:
                            remote = decode(ctypes.string_at(sbuf, n))
                            self.state.merge(remote)
                        except (ValueError, KeyError) as exc:
                            log.warning("Error merging remote state: %s", exc)
                        metrics.measure_since("mergeRemoteState", t0)

                n = self._lib.st_poll_log(self._handle, buf, len(buf))
                if n > 0:
                    busy = True
                    line = ctypes.string_at(buf, n).decode(errors="replace")
                    level, _, msg = line.partition("|")
                    log.log(_LOG_LEVELS.get(level, logging.INFO),
                            "engine: %s", msg)

                n = self._lib.st_poll_event(self._handle, buf, len(buf))
                if n > 0:
                    busy = True
                    parts = ctypes.string_at(buf, n).decode().split()
                    if parts and parts[0] == "leave" and len(parts) > 1:
                        log.info("Member left: %s", parts[1])
                        threading.Thread(
                            target=self.state.expire_server, args=(parts[1],),
                            daemon=True).start()
                    elif parts and parts[0] == "join" and len(parts) > 1:
                        log.info("Member joined: %s", parts[1])

            # The drain stopped at its cap with work left: skip the next
            # cycle's idle wait.
            inbound_backlogged = busy
