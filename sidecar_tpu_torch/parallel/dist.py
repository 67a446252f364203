"""The shard group over ``torch.distributed`` ranks — the port's
counterpart of the reference's device mesh (``sidecar_tpu/parallel/
mesh.py`` ``make_mesh``) and of the XLA collectives its ``shard_map``
bodies call (``lax.all_gather``, ``lax.all_to_all``, ``lax.ppermute``,
``lax.pmax``, ``lax.psum``).

:class:`DistShardGroup` has the contract of ``parallel/mesh.py``: ``d``
global shards, ``world`` ranks, each rank holding the contiguous shard
range ``local = [rank·dl, (rank+1)·dl)`` and the node rows of those
shards.  Its collectives take and return one tensor per local shard, and
its row collectives serve the global phases of the sharded twins (the
stride push-pull, the census, the convergence metric, the telemetry
planes' reductions) — among them ``fetch_rows`` and
``scatter_max_rows``, which route rows named by global id to and from
their owner ranks (one exchange of the per-rank counts, read on the
host, then uneven ``all_to_all_single`` calls; the pipelined exact
round's uniform push-pull).

Construction is explicit: the caller names the backend (``"nccl"`` or
``"gloo"``; there is no automatic choice), the rank, the world size and
the rendezvous store (``torch.distributed.FileStore`` or ``TCPStore``),
and the first group a process builds opens the default process group
with a timeout, so a rank that never arrives fails the run.  Nothing is
read from the environment.  A group of the whole world splits into
groups of consecutive ranks (:meth:`DistShardGroup.split`, the fleet's
node groups): each a ``torch.distributed`` subgroup, within which the
split group's ``rank`` and ``world`` count and over which its every
collective runs.

On the wire: NCCL takes the CUDA tensors as they are (a CPU tensor
raises: there is no quiet host fallback); gloo takes host tensors, so a
CUDA tensor is copied to the host and the result back, and those copies
are counted apart (``staging_bytes``).  ``bool`` tensors travel as
``uint8`` (the backends reduce ``bool`` differently).

Accounting, per group object (``stats``) and in the registry: the
collectives called, ``parallel.exchange.bytes_sent`` — the payload this
rank hands a collective for the OTHER ranks (an all-gather its block
once a peer, an all-to-all or a point-to-point exchange the chunks bound
elsewhere, an all-reduce its input once a peer) — and
``parallel.exchange.staging_bytes``, gloo's host copies both ways.  The
analytic ``exchange_bytes_per_round`` of the twins stands beside it.
"""

from __future__ import annotations

import datetime
import math

import torch
import torch.distributed as dist

from sidecar_tpu_torch import metrics

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0


def open_process_group(*, backend: str, rank: int, world: int, store,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Open this process's default process group, or check that the one
    already open is this one (same backend, rank and world size)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_rank(), dist.get_world_size())
        if have != (backend, rank, world):
            raise ValueError(f"the process group open here is {have}, "
                             f"not {(backend, rank, world)}")
        return
    if store is None:
        raise ValueError("pass store= (a FileStore or TCPStore): the "
                         "group reads no environment variable")
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


class DistShardGroup:
    """``d`` shards over the ``world`` ranks of the default process
    group, ``d / world`` a rank, on ``device`` (the rank's card, or the
    CPU under gloo)."""

    def __init__(self, d: int, *, backend: str, rank: int, world: int,
                 store=None, device="cuda",
                 timeout_s: float = DEFAULT_TIMEOUT_S, process_group=None,
                 ranks=None):
        """With ``process_group`` (a subgroup :meth:`split` built, over
        the global ranks ``ranks``) ``rank`` and ``world`` are this
        process's place within it; the default process group is then
        already open."""
        if d < 1 or d % world:
            raise ValueError(f"d={d} shards must divide over {world} ranks")
        if backend == "nccl" and torch.device(device).type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        if process_group is None:
            open_process_group(backend=backend, rank=rank, world=world,
                               store=store, timeout_s=timeout_s)
        self.backend = backend
        self.device = torch.device(device)
        self.timeout_s = timeout_s
        self.rank, self.world, self.d = rank, world, d
        self.ranks = tuple(range(world) if ranks is None else ranks)
        self.dl = d // world
        self.local = tuple(range(rank * self.dl, (rank + 1) * self.dl))
        self.stats = {"collectives": 0, "bytes_sent": 0,
                      "staging_bytes": 0}
        self._pg = process_group
        self._splits: dict = {}

    def split(self, size: int) -> "DistShardGroup":
        """This rank's block of ``size`` consecutive ranks (block ``rank
        // size``) as a group of its own, one shard a rank.
        ``torch.distributed.new_group`` is collective over the default
        group, so every rank builds every block's subgroup, in block
        order: every rank of the world must call ``split`` with the same
        sizes in the same order.  Built once a size."""
        if size in self._splits:
            return self._splits[size]
        if self._pg is not None:
            raise ValueError("only a group of the whole world splits")
        if size < 1 or self.world % size:
            raise ValueError(f"blocks of {size} ranks do not divide a "
                             f"world of {self.world}")
        timeout = datetime.timedelta(seconds=self.timeout_s)
        blocks = [list(range(b * size, (b + 1) * size))
                  for b in range(self.world // size)]
        subgroups = [dist.new_group(ranks, timeout=timeout)
                     for ranks in blocks]
        mine = self.rank // size
        sub = DistShardGroup(size, backend=self.backend,
                             rank=self.rank % size, world=size,
                             device=self.device, timeout_s=self.timeout_s,
                             process_group=subgroups[mine],
                             ranks=blocks[mine])
        self._splits[size] = sub
        return sub

    # -- the wire -------------------------------------------------------------

    def _count(self, sent: int) -> None:
        self.stats["collectives"] += 1
        self.stats["bytes_sent"] += int(sent)
        metrics.incr("parallel.exchange.bytes_sent", int(sent))

    def _stage(self, nbytes: int) -> None:
        self.stats["staging_bytes"] += int(nbytes)
        metrics.incr("parallel.exchange.staging_bytes", int(nbytes))

    def _to_wire(self, x):
        """``x`` as the backend takes it: contiguous, ``bool`` as
        ``uint8``, on the host under gloo (counted)."""
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if self.backend == "nccl":
            if x.device.type != "cuda":
                raise ValueError("the nccl group exchanges CUDA tensors; "
                                 f"got one on {x.device}")
        elif x.device.type != "cpu":
            self._stage(x.numel() * x.element_size())
            x = x.cpu()
        return x.contiguous()

    def _from_wire(self, y, like):
        """A received tensor back on ``like``'s device and dtype."""
        if y.device != like.device:
            self._stage(y.numel() * y.element_size())
            y = y.to(like.device)
        return y.to(like.dtype) if y.dtype != like.dtype else y

    def _gather(self, x):
        """``x`` of every rank, concatenated along dim 0 in rank order."""
        w = self._to_wire(x)
        parts = [torch.empty_like(w) for _ in range(self.world)]
        dist.all_gather(parts, w, group=self._pg)
        self._count(w.numel() * w.element_size() * (self.world - 1))
        return self._from_wire(torch.cat(parts), x)

    def _all_reduce(self, x, op):
        w = self._to_wire(x)
        if w is x:
            w = w.clone()
        dist.all_reduce(w, op=op, group=self._pg)
        self._count(w.numel() * w.element_size() * (self.world - 1))
        return self._from_wire(w, x)

    def _exchange(self, sends, recv_numel, like):
        """Send ``sends[q]`` (a tensor of ``like``'s dtype and device, or
        None for nothing) to rank ``q``, and receive ``recv_numel[p]``
        elements from rank ``p``: one ``all_to_all_single`` with
        uneven splits.  Returns the received elements per source rank,
        flat, on ``like``'s device and dtype.  Under gloo the chunk a
        rank sends itself stays where it is: only the other ranks'
        chunks are staged through the host."""
        recv_numel = list(recv_numel)
        me = self.rank
        keep = None
        if self.backend == "gloo":
            keep = sends[me]
            keep = torch.empty(0, dtype=like.dtype, device=like.device) \
                if keep is None else keep.reshape(-1).clone()
            sends = [None if q == me else t for q, t in enumerate(sends)]
            recv_numel[me] = 0
        flat = [None if t is None else self._to_wire(t).reshape(-1)
                for t in sends]
        dtype = torch.uint8 if like.dtype == torch.bool else like.dtype
        dev = like.device if self.backend == "nccl" else torch.device("cpu")
        in_splits = [0 if t is None else t.numel() for t in flat]
        send = torch.cat([t for t in flat if t is not None]
                         or [torch.empty(0, dtype=dtype, device=dev)])
        recv = torch.empty(sum(recv_numel), dtype=dtype, device=dev)
        dist.all_to_all_single(recv, send, recv_numel, in_splits,
                               group=self._pg)
        self._count((sum(in_splits) - in_splits[me]) * send.element_size())
        got = list(torch.split(self._from_wire(recv, like), recv_numel))
        if keep is not None:
            got[me] = keep
        return got

    def _check(self, xs):
        if len(xs) != self.dl:
            raise ValueError(f"expected one tensor per local shard "
                             f"({self.dl}), got {len(xs)}")

    def owner(self, shard: int) -> int:
        """The rank that holds shard ``shard``."""
        return shard // self.dl

    # -- the shard collectives ------------------------------------------------

    def all_gather(self, xs):
        """Every shard's block, concatenated along dim 0 (tiled)."""
        self._check(xs)
        full = self._gather(torch.cat(xs) if self.dl > 1 else xs[0])
        return [full] * self.dl

    def all_to_all(self, xs):
        """Each ``xs[j]`` is ``[d, ...]``: ``out[s][j] = xs[j][s]``, ``j``
        over every shard."""
        self._check(xs)
        dl, w = self.dl, self.world
        x = torch.stack(xs)                                  # [dl_j, d, …]
        tail = x.shape[2:]
        send = x.transpose(0, 1).reshape(w, dl, dl, *tail)   # [q, s, j, …]
        got = self._exchange(list(send), [send[0].numel()] * w, x)
        recv = torch.stack(got).reshape(w, dl, dl, *tail)    # [p, s, j, …]
        out = recv.transpose(0, 1).reshape(dl, self.d, *tail)
        return [out[s] for s in range(dl)]

    def ppermute(self, xs, perm):
        """``perm`` holds ``(source, destination)`` shard pairs over the
        global shards; a local shard that no pair names as destination
        receives zeros."""
        self._check(xs)
        pairs = sorted((dst, src) for src, dst in perm)
        lo, size = self.local[0], xs[0].numel()
        sends = [[] for _ in range(self.world)]
        recv_numel = [0] * self.world
        for dst, src in pairs:
            if self.owner(src) == self.rank:
                sends[self.owner(dst)].append(xs[src - lo].reshape(-1))
            if self.owner(dst) == self.rank:
                recv_numel[self.owner(src)] += size
        got = self._exchange([torch.cat(c) if c else None for c in sends],
                             recv_numel, xs[0])
        out = [None] * self.dl
        taken = [0] * self.world
        for dst, src in pairs:
            if self.owner(dst) == self.rank:
                p = self.owner(src)
                out[dst - lo] = got[p][taken[p] * size:(taken[p] + 1)
                                       * size].reshape(xs[0].shape)
                taken[p] += 1
        return [torch.zeros_like(xs[i]) if o is None else o
                for i, o in enumerate(out)]

    def pmax(self, xs):
        """Elementwise max over the ``d`` replicas."""
        self._check(xs)
        m = self._all_reduce(torch.stack(xs).amax(dim=0), dist.ReduceOp.MAX)
        return [m] * self.dl

    def psum(self, xs):
        """Elementwise sum over the ``d`` shards (the local sum's dtype,
        as :class:`~sidecar_tpu_torch.parallel.mesh.LocalShardGroup`
        gives it)."""
        self._check(xs)
        total = self._all_reduce(torch.stack(xs).sum(dim=0),
                                 dist.ReduceOp.SUM)
        return [total] * self.dl

    # -- the row collectives of the global phases ---------------------------

    def gather_rows(self, x):
        """Every rank's node rows ``x``, concatenated in rank order: the
        global tensor."""
        return self._gather(x)

    def shift_rows(self, x, k: int):
        """This rank's rows of the global tensor shifted by ``k``: row
        ``i`` of the result is global row ``(R0 + i + k) mod N``, where
        ``R0`` is the rank's first row.  Only those rows travel, from at
        most two owner ranks."""
        rows = x.shape[0]
        n = rows * self.world
        row_numel = x[0].numel()

        def need(q):
            # The global rows rank q needs, in its row order.
            return (q * rows + k + torch.arange(rows)) % n

        sends = []
        for q in range(self.world):
            src = need(q)
            sel = src[src // rows == self.rank] - self.rank * rows
            sends.append(x[sel.to(x.device)] if sel.numel() else None)
        owner = need(self.rank) // rows
        counts = [int((owner == p).sum()) for p in range(self.world)]
        got = self._exchange(sends, [c * row_numel for c in counts], x)
        out = torch.empty_like(x)
        for p in range(self.world):
            if counts[p]:
                out[(owner == p).to(x.device)] = \
                    got[p].reshape(counts[p], *x.shape[1:])
        return out

    def _route(self, dest, payloads):
        """Send item ``i`` of each tensor of ``payloads`` (items along
        dim 0) to rank ``dest[i]``: one exchange of the per-rank counts
        (read on the host), then one uneven ``all_to_all_single`` a
        payload.  Returns ``(order, sent, recv, received)``: the stable
        order the items left in, the host counts sent to and received
        from each rank, and per payload the items received, rank 0's
        first, each rank's in its send order."""
        order = torch.argsort(dest, stable=True)
        counts = torch.bincount(dest, minlength=self.world).to(torch.int64)
        got = self._exchange([counts[q:q + 1] for q in range(self.world)],
                             [1] * self.world, counts)
        recv = torch.cat(got).tolist()
        sent = counts.tolist()
        out = []
        for x in payloads:
            row = math.prod(x.shape[1:])
            parts = torch.split(x[order], sent)
            flat = self._exchange([t if t.shape[0] else None for t in parts],
                                  [c * row for c in recv], x)
            out.append(torch.cat(flat).reshape(sum(recv), *x.shape[1:]))
        return order, sent, recv, out

    def route(self, dest, x):
        """Item ``i`` of ``x`` (items along dim 0) to rank ``dest[i]``
        (int64): the items this rank receives, rank 0's first, each
        rank's in its send order."""
        return self._route(dest, [x])[3][0]

    def fetch_rows(self, x, idx):
        """Rows ``idx`` (int64 global row ids, any rank's) of the global
        tensor whose rows ``x`` this rank holds, in ``idx``'s order: the
        requests travel to the owner ranks, the rows come back."""
        rows = x.shape[0]
        owner = torch.div(idx, rows, rounding_mode="floor")
        order, sent, recv, (req,) = self._route(owner, [idx - owner * rows])
        served = x[req]
        parts = list(torch.split(served, recv))
        back = self._exchange([t if t.shape[0] else None for t in parts],
                              [c * x[0].numel() for c in sent], x)
        out = torch.empty((idx.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        out[order] = torch.cat(back).reshape(-1, *x.shape[1:])
        return out

    def scatter_max_rows(self, x, idx, vals):
        """Fold row ``vals[i]`` into global row ``idx[i]`` by an
        elementwise max, in place on the rows ``x`` this rank holds (any
        rank's rows may name it): the rows travel to their owner ranks.
        Returns ``x``."""
        rows = x.shape[0]
        owner = torch.div(idx, rows, rounding_mode="floor")
        _, _, _, (at, got) = self._route(owner, [idx - owner * rows, vals])
        return x.scatter_reduce_(0, at[:, None].expand_as(got), got, "amax")

    def all_reduce_max(self, x):
        """The elementwise max of ``x`` over the ranks."""
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_reduce_sum(self, x):
        """The elementwise sum of ``x`` over the ranks."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

