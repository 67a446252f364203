"""Start a group of ranks on this machine: :func:`spawn_group`.

Each rank is a fresh process (the ``spawn`` start method) that opens the
default process group through a ``FileStore`` in a temporary directory
(no port to pick, so concurrent groups never collide), runs ``fn(ctx,
*args)`` with one thread for the CPU's kernels, and hands its result
back through a queue as numpy arrays.  ``ctx`` (:class:`RankContext`)
carries the rank, the world size, the backend, the rank's device and
the store, and builds the rank's shard groups (:meth:`RankContext.
group`) and a fleet's scenario × node layout (:meth:`RankContext.
fleet_groups`).

The backend is the caller's choice: ``"nccl"`` needs one card a rank;
``"gloo"`` runs on the CPU or, on the cards, copies each exchanged
tensor through the host (counted by the group), and may put every rank
on ``cuda:0`` of a one-card machine.  On the card the kernels are built
in the parent before any rank starts, so two ranks never build into the
one cache directory at once; the ranks load them.

Nothing is swallowed: a rank that raises, exits non-zero or is still
running at the deadline makes :func:`spawn_group` stop every rank and
raise, naming the rank and carrying its traceback.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch

from sidecar_tpu_torch.parallel.dist import (
    BACKENDS,
    DEFAULT_TIMEOUT_S,
    DistShardGroup,
)


@dataclasses.dataclass
class RankContext:
    """What a rank's body gets: its place in the group and its device."""

    rank: int
    world: int
    backend: str
    device: torch.device
    store: object
    timeout_s: float

    def group(self, d: int) -> DistShardGroup:
        """A shard group of ``d`` shards over this group's ranks."""
        return DistShardGroup(d, backend=self.backend, rank=self.rank,
                              world=self.world, store=self.store,
                              device=self.device, timeout_s=self.timeout_s)

    def fleet_groups(self, node_devices: int):
        """The groups of a fleet laid over ``world / node_devices``
        scenario blocks of ``node_devices`` ranks: ``(g, node group)`` —
        ``g`` the whole world, which ``FleetSim`` takes as ``group=``
        with ``node_devices=``, and this rank's block of consecutive
        ranks, ``g.split(node_devices)`` (the one ``FleetSim`` uses)."""
        g = self.group(self.world)
        return g, g.split(node_devices)


def to_host(obj):
    """``obj`` with every tensor replaced by its numpy copy (through
    dicts, lists and tuples)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_device(device: str, rank: int, world: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count()
    return torch.device("cuda", rank if count >= world else 0)


def _rank_main(fn, rank, world, backend, store_path, device, timeout_s,
               args, results):
    """A rank's process: open the group, run the body, post ``(rank,
    ok, result or traceback)``."""
    torch.set_num_threads(1)
    try:
        dev = _rank_device(device, rank, world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        import torch.distributed as dist

        store = dist.FileStore(store_path, world)
        ctx = RankContext(rank=rank, world=world, backend=backend,
                          device=dev, store=store, timeout_s=timeout_s)
        out = to_host(fn(ctx, *args))
    except BaseException:  # noqa: BLE001 — the process's boundary: the
        # parent raises with this traceback; the rank exits non-zero.
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)
    results.put((rank, True, out))
    results.close()
    results.join_thread()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def spawn_group(fn, world: int, backend: str, args=(), *, device="cuda",
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(ctx, *args)`` on ``world`` ranks and return their results
    in rank order, tensors as numpy arrays.  ``fn`` and ``args`` are
    pickled (``fn`` by its import path).  ``device`` is ``"cuda"`` (the
    default: each rank its card, or ``cuda:0`` for every gloo rank of a
    one-card machine) or ``"cpu"`` (gloo only).  Raises ``RuntimeError``
    when a rank fails and ``TimeoutError`` past ``timeout_s``, after
    stopping every rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if world < 1:
        raise ValueError(f"a group needs at least 1 rank, got {world}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spawn_group runs its ranks on the GPU by default and no "
                "CUDA device is available; pass device='cpu' (gloo)")
        if backend == "nccl" and torch.cuda.device_count() < world:
            raise ValueError(
                f"nccl needs one card a rank: {world} ranks, "
                f"{torch.cuda.device_count()} cards (use gloo)")
        from sidecar_tpu_torch.ops.kernels import build

        build.build()
    elif backend == "nccl":
        raise ValueError("the nccl backend needs device='cuda'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="sidecar-group-") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, rank, world, backend, store_path, str(dev), timeout_s,
                  args, results)) for rank in range(world)]
        try:
            for proc in procs:
                proc.start()
            deadline = time.monotonic() + timeout_s
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} "
                        f"still running after {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    for rank, proc in enumerate(procs):
                        if rank not in out and proc.exitcode not in (None,
                                                                     0):
                            raise RuntimeError(
                                f"rank {rank} exited with code "
                                f"{proc.exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} raised:\n{payload}")
                out[rank] = payload
            for rank, proc in enumerate(procs):
                proc.join(max(deadline - time.monotonic(), 1.0))
                if proc.exitcode != 0:
                    raise RuntimeError(f"rank {rank} exited with code "
                                       f"{proc.exitcode}")
        finally:
            for proc in procs:
                if proc.pid is None:
                    continue
                if proc.is_alive():
                    proc.kill()
                proc.join(5.0)
            results.close()
    return [out[r] for r in range(world)]

