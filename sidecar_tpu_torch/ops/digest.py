"""Order-invariant catalog digests — the port of
``sidecar_tpu/ops/digest.py``: the coherence plane's one fingerprint
definition, its device form over a packed belief matrix, the
reference's NumPy and pure-Python helpers, copied, and the live
catalog's host half: :class:`IncrementalDigest` and the Merkle ladder
:class:`LadderDigest`, kept record by record by the catalog's writer,
with the pure-Python fold and compares the anti-entropy session reads.

A record ``(ident, packed key)`` hashes into two 32-bit lanes; the lanes
add up, mod 2³², into one of ``B`` buckets chosen by the ident alone.
The sum is commutative (any order gives the same digest), invertible
(removal is a subtraction) and its differing-bucket count lower-bounds
the records two catalogs disagree on.  A ladder of bucket counts
``base << k`` folds coarse levels out of the finest one.

Device arithmetic: PyTorch has no unsigned 32-bit arithmetic, so a
uint32 value lives in an int64 tensor, masked to 32 bits after every
add and multiply.  Every multiply is by a constant, split into its
16-bit halves so that no product exceeds 2⁴⁸ (:func:`_mul32_`); the
bucket sum is an int64 ``index_add_`` (at most M · 2³² < 2⁶³) masked
at the end.  The hash runs in place on its own temporaries, which
saves an allocation a step.  A digest is an int64 ``[..., B, 2]`` tensor of uint32
values; ``.numpy().astype(np.uint32)`` is the reference's array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sidecar_tpu_torch.ops.status import is_known
from sidecar_tpu_torch.ops.trace import append_record

I32, I64 = torch.int32, torch.int64

# Default bucket count B (64 buckets × 2 lanes = 512 B a digest) and
# ladder depth (64 → 128 → 256 → 512 → 1024).
DEFAULT_BUCKETS = 64
DEFAULT_LADDER_DEPTH = 5

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF

# Knuth's multiplicative constant, the murmur3 finalizer pair, and the
# 32-bit golden ratio as the lane separator.
_K1 = 2654435761
_K2 = 0x85EBCA6B
_K3 = 0xC2B2AE35
_GOLD = 0x9E3779B9


def _bucket_shift(buckets: int) -> int:
    """Validate ``buckets`` (a power of two) and return the top-bits
    shift that selects a bucket from a mixed 32-bit ident."""
    if buckets < 1 or buckets & (buckets - 1):
        raise ValueError(f"buckets must be a power of two, got {buckets}")
    return 32 - (buckets.bit_length() - 1)


# -- device form ---------------------------------------------------------------

def _mul32_(x, k: int):
    """``x · k mod 2³²`` in place, for uint32 values in an int64 tensor:
    the high half of ``k`` contributes only its product's low 16 bits,
    shifted up, so each partial product stays below 2⁴⁸."""
    hi = x * (k >> 16)
    hi.bitwise_and_(0xFFFF).bitwise_left_shift_(16)
    return x.mul_(k & 0xFFFF).add_(hi).bitwise_and_(_M32)


def _mix32_(x):
    """murmur3 fmix32 in place."""
    x.bitwise_xor_(x >> 16)
    _mul32_(x, _K2)
    x.bitwise_xor_(x >> 13)
    _mul32_(x, _K3)
    return x.bitwise_xor_(x >> 16)


def _u32(x):
    """A fresh int64 copy of ``x``'s low 32 bits."""
    return x.to(I64) & _M32


def mix32(x):
    """murmur3 fmix32 over uint32 values (a new int64 tensor)."""
    return _mix32_(_u32(x))


def record_lanes(idents, lo, hi):
    """The 64-bit record hash as two uint32 lanes (int64 tensors);
    ``lo``/``hi`` are the packed key's halves.  ``hi`` may be a Python
    int (the sim's int32 keys pass 0): its mixed term is then a
    constant.  The work is done in place on fresh temporaries."""
    k = _mix32_(_u32(lo))
    if isinstance(hi, int):
        k.bitwise_xor_((fmix32_py((hi & _M32) ^ _GOLD) * _K1) & _M32)
    else:
        k.bitwise_xor_(_mul32_(_mix32_(_u32(hi) ^ _GOLD), _K1))
    idents = _u32(idents)
    lane0 = _mix32_(idents ^ k)
    lane1 = _mix32_(((idents + _GOLD) & _M32) ^ _mul32_(k, _K1))
    return lane0, lane1


def bucket_ids(idents, buckets: int):
    """Per-slot bucket index (int64 ``[M]``), a function of the ident
    alone."""
    shift = _bucket_shift(buckets)
    if shift >= 32:
        return torch.zeros(idents.shape, dtype=I64, device=idents.device)
    return _mix32_(_mul32_(_u32(idents), _K1)) >> shift


def node_digests(packed, idents, buckets: int):
    """Every row's digest of a packed belief matrix: int32 ``[N, M]``
    → uint32 values ``[N, B, 2]`` (int64).  Unknown cells (tick 0)
    add nothing."""
    unknown = ~is_known(packed)
    lane0, lane1 = record_lanes(idents[None, :], packed, 0)
    seg = bucket_ids(idents, buckets)
    n = packed.shape[0]
    out = torch.zeros((n, buckets, 2), dtype=I64, device=packed.device)
    for i, lane in enumerate((lane0, lane1)):
        out[:, :, i] = torch.zeros((n, buckets), dtype=I64,
                                   device=packed.device).index_add_(
                                       1, seg, lane.masked_fill_(unknown, 0))
    return out & _M32


def diff_counts(dig, ref):
    """Differing-bucket counts against a reference digest: ``[N, B, 2]``
    × ``[B, 2]`` → int32 ``[N]``."""
    differ = (dig != ref[None, :, :]).any(dim=-1)
    return differ.sum(dim=-1, dtype=I64).to(I32)


def fold_digest(dig):
    """One ladder fold: ``[..., 2B, 2]`` → ``[..., B, 2]``, children
    ``2b`` and ``2b + 1`` summed mod 2³² into parent ``b``."""
    b2 = dig.shape[-2]
    if b2 < 2 or b2 % 2:
        raise ValueError(f"cannot fold {b2} buckets")
    return dig.reshape(dig.shape[:-2] + (b2 // 2, 2, 2)).sum(dim=-2) & _M32


def ladder_digests(packed, idents, base: int = DEFAULT_BUCKETS,
                   depth: int = DEFAULT_LADDER_DEPTH) -> list:
    """Every row's digest at each ladder level, coarse → fine: one hash
    at the leaf level (``base << (depth − 1)`` buckets), then folds."""
    if depth < 1:
        raise ValueError(f"ladder depth must be >= 1, got {depth}")
    levels = [node_digests(packed, idents, base << (depth - 1))]
    for _ in range(depth - 1):
        levels.append(fold_digest(levels[-1]))
    return levels[::-1]


# Digest-record layout: int32 [DIGEST_WIDTH].
DIG_ROUND = 0
DIG_ALIVE = 1
DIG_AGREE = 2
DIG_DIFF_TOTAL = 3
DIG_DIFF_MAX = 4
DIGEST_WIDTH = 5
DIGEST_FIELDS = ("round", "alive", "agree", "diff_total", "diff_max")


def state_digest_record(round_idx: int, packed, node_alive, idents,
                        buckets: int, group=None):
    """One round's coherence record: live members (``alive``), alive
    nodes whose digest equals the truth's (``agree``; the truth is the
    alive-max catalog), differing buckets summed over alive nodes
    (``diff_total``) and the worst node's (``diff_max``).

    ``group`` (a shard group's row collectives, ``parallel/mesh.py``):
    ``packed`` and ``node_alive`` are then a rank's node rows; the truth
    is max-reduced over the ranks before its digest is taken, the
    three counts are integer sums over the ranks (int64, narrowed once)
    and ``diff_max`` a max — every rank returns the one-process
    record."""
    dig = node_digests(packed, idents, buckets)
    truth = torch.where(node_alive[:, None], packed, 0).amax(dim=0)
    if group is not None:
        truth = group.all_reduce_max(truth)
    ref = node_digests(truth[None, :], idents, buckets)[0]
    diffs = diff_counts(dig, ref)
    alive_i = node_alive.to(I32)
    masked = torch.where(node_alive, diffs, 0)
    counts = torch.stack([alive_i.sum(dtype=I64),
                          (alive_i * (diffs == 0).to(I32)).sum(dtype=I64),
                          masked.sum(dtype=I64)])
    worst = masked.amax().reshape(1)
    if group is not None:
        counts = group.all_reduce_sum(counts)
        worst = group.all_reduce_max(worst)
    return torch.cat([
        torch.full((1,), int(round_idx), dtype=I32, device=packed.device),
        counts.to(I32), worst.to(I32)])


@dataclasses.dataclass
class DigestTrace:
    """A bounded stream of coherence records — the
    :class:`~sidecar_tpu_torch.ops.trace.RoundTrace` contract (host
    ``count`` and ``overflow``, ``rec`` appended in place)."""

    count: int           # rounds digested (exact)
    rec: torch.Tensor    # int32 [cap, DIGEST_WIDTH]
    overflow: bool       # count > cap


def zero_digest(cap: int, device="cpu") -> DigestTrace:
    return DigestTrace(count=0, rec=torch.zeros((cap, DIGEST_WIDTH),
                                                dtype=I32, device=device),
                       overflow=False)


# Append one record; past the capacity it is dropped while ``count``
# stays exact (the flight recorder's buffer contract).
append_digest = append_record


def digest_to_dicts(dt: DigestTrace) -> list:
    """One dict a recorded round (padding dropped), the raw columns and
    ``agreement`` (agree / alive) — the bridge's ``digest.rounds``."""
    rec = dt.rec.cpu().numpy()
    out = []
    for row in rec[:min(int(dt.count), rec.shape[0])]:
        doc = {name: int(row[i]) for i, name in enumerate(DIGEST_FIELDS)}
        doc["agreement"] = (doc["agree"] / doc["alive"]
                            if doc["alive"] else 1.0)
        out.append(doc)
    return out


# -- NumPy helpers (the reference's oracle, copied) ----------------------------

def mix32_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_K2)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(_K3)
    return x ^ (x >> np.uint32(16))


def record_lanes_np(idents, lo, hi):
    idents = np.asarray(idents, np.uint32)
    lo = np.asarray(lo, np.uint32)
    hi = np.asarray(hi, np.uint32)
    k = mix32_np(lo) ^ (mix32_np(hi ^ np.uint32(_GOLD)) * np.uint32(_K1))
    lane0 = mix32_np(idents ^ k)
    lane1 = mix32_np((idents + np.uint32(_GOLD)) ^ (k * np.uint32(_K1)))
    return lane0, lane1


def bucket_ids_np(idents, buckets: int) -> np.ndarray:
    shift = _bucket_shift(buckets)
    idents = np.asarray(idents, np.uint32)
    if shift >= 32:
        return np.zeros(idents.shape, np.int64)
    mixed = mix32_np(idents * np.uint32(_K1))
    return (mixed >> np.uint32(shift)).astype(np.int64)


def digest_np(idents, keys, buckets: int = DEFAULT_BUCKETS) -> np.ndarray:
    """One catalog's digest from parallel idents (uint32) and 64-bit
    packed keys (uint64): uint32 ``[B, 2]``."""
    idents = np.asarray(idents, np.uint32)
    keys = np.asarray(keys, np.uint64)
    lo = (keys & np.uint64(_M32)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lane0, lane1 = record_lanes_np(idents, lo, hi)
    seg = bucket_ids_np(idents, buckets)
    dig = np.zeros((buckets, 2), np.uint32)
    np.add.at(dig[:, 0], seg, lane0)
    np.add.at(dig[:, 1], seg, lane1)
    return dig


def node_digests_np(packed, idents, buckets: int = DEFAULT_BUCKETS
                    ) -> np.ndarray:
    """Row by row, :func:`digest_np` of each row's known cells."""
    packed = np.asarray(packed, np.int64)
    idents = np.asarray(idents, np.uint32)
    n = packed.shape[0]
    out = np.zeros((n, buckets, 2), np.uint32)
    for i in range(n):
        row = packed[i]
        known = (row >> 3) > 0
        out[i] = digest_np(idents[known], row[known].astype(np.uint64),
                           buckets)
    return out


def diff_counts_np(dig, ref) -> np.ndarray:
    dig = np.asarray(dig)
    ref = np.asarray(ref)
    return np.any(dig != ref[None, :, :], axis=-1).sum(axis=-1)


def fold_digest_np(dig) -> np.ndarray:
    dig = np.asarray(dig, np.uint32)
    b2 = dig.shape[-2]
    if b2 < 2 or b2 % 2:
        raise ValueError(f"cannot fold {b2} buckets")
    return dig.reshape(dig.shape[:-2] + (b2 // 2, 2, 2)).sum(
        axis=-2, dtype=np.uint32)


def ladder_digests_np(packed, idents, base: int = DEFAULT_BUCKETS,
                      depth: int = DEFAULT_LADDER_DEPTH) -> list:
    if depth < 1:
        raise ValueError(f"ladder depth must be >= 1, got {depth}")
    levels = [node_digests_np(packed, idents, base << (depth - 1))]
    for _ in range(depth - 1):
        levels.append(fold_digest_np(levels[-1]))
    return levels[::-1]


def default_idents(m: int) -> np.ndarray:
    """The pure-sim slot identity table (uint32 ``[M]``)."""
    slots = np.arange(1, m + 1, dtype=np.uint32)
    return mix32_np(slots * np.uint32(_K1))


def catalog_idents(slot_names) -> np.ndarray:
    """Identity table from ``(hostname, service_id)`` pairs per slot."""
    return np.asarray([ident_of(h, s) for h, s in slot_names], np.uint32)


def digest_to_hex(dig) -> str:
    """A digest in its wire form (the push-pull annotation and
    ``/api/digest.json``): 8 hex characters a lane, 16 a bucket.  Takes
    any form :func:`digest_value` takes."""
    return "".join(f"{v:08x}" for v in digest_value(dig))


# -- pure-Python helpers --------------------------------------------------------

def fmix32_py(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * _K2) & _M32
    x ^= x >> 13
    x = (x * _K3) & _M32
    return x ^ (x >> 16)


def ident_of(hostname: str, service_id: str) -> int:
    """FNV-1a 32 over ``host\\x1fservice-id``: the live identity of a
    record."""
    h = 2166136261
    for b in f"{hostname}\x1f{service_id}".encode("utf-8"):
        h = ((h ^ b) * 16777619) & _M32
    return h


def live_key(updated: int, status: int) -> int:
    """The live record's 64-bit packed key ``(updated << 3) | status``
    mod 2⁶⁴."""
    return ((int(updated) << 3) | (int(status) & 7)) & _M64


def bucket_of(ident: int, buckets: int) -> int:
    """An ident's bucket at any power-of-two bucket count, the
    pure-Python :func:`bucket_ids`.  The index at 2B buckets is the one
    at B shifted left plus one more bit: a deeper ladder level refines
    and never reshuffles."""
    shift = _bucket_shift(buckets)
    if shift >= 32:
        return 0
    return fmix32_py(((ident & _M32) * _K1) & _M32) >> shift


def record_hash(ident: int, key: int, buckets: int = DEFAULT_BUCKETS):
    """``(bucket, lane0, lane1)`` of one record in pure Python."""
    ident &= _M32
    key &= _M64
    lo = key & _M32
    hi = key >> 32
    k = fmix32_py(lo) ^ ((fmix32_py(hi ^ _GOLD) * _K1) & _M32)
    lane0 = fmix32_py(ident ^ k)
    lane1 = fmix32_py(((ident + _GOLD) & _M32) ^ ((k * _K1) & _M32))
    return bucket_of(ident, buckets), lane0, lane1


class IncrementalDigest:
    """The live catalog's flat digest: O(1) add and remove a record
    (lane sums mod 2³² are invertible).  :meth:`value` is the canonical
    form, a flat tuple of ``2 · B`` uint32 ints, lane-interleaved per
    bucket, equal to the device and NumPy digests of the same records."""

    __slots__ = ("buckets", "count", "_lanes")

    def __init__(self, buckets: int = DEFAULT_BUCKETS):
        _bucket_shift(buckets)
        self.buckets = buckets
        self.count = 0
        self._lanes = [0] * (2 * buckets)

    def add(self, ident: int, key: int) -> None:
        b, l0, l1 = record_hash(ident, key, self.buckets)
        i = 2 * b
        self._lanes[i] = (self._lanes[i] + l0) & _M32
        self._lanes[i + 1] = (self._lanes[i + 1] + l1) & _M32
        self.count += 1

    def remove(self, ident: int, key: int) -> None:
        b, l0, l1 = record_hash(ident, key, self.buckets)
        i = 2 * b
        self._lanes[i] = (self._lanes[i] - l0) & _M32
        self._lanes[i + 1] = (self._lanes[i + 1] - l1) & _M32
        self.count -= 1

    def value(self) -> tuple:
        return tuple(self._lanes)

    def hex(self) -> str:
        return digest_to_hex(self._lanes)

    @classmethod
    def of(cls, records, buckets: int = DEFAULT_BUCKETS
           ) -> "IncrementalDigest":
        """From an iterable of ``(ident, key)`` pairs."""
        dig = cls(buckets)
        for ident, key in records:
            dig.add(ident, key)
        return dig


class LadderDigest:
    """The live catalog's Merkle ladder: one lane table a level (level k
    has ``base << k`` buckets), all kept incrementally — one
    :func:`record_hash` a mutation (the lanes do not depend on the
    level, only the bucket does), then ``depth`` O(1) updates.
    ``level(0)`` equals ``IncrementalDigest(base)`` over the same
    records; the deeper levels serve the anti-entropy session's
    narrowing."""

    __slots__ = ("base", "depth", "count", "_shifts", "_lanes")

    def __init__(self, base: int = DEFAULT_BUCKETS,
                 depth: int = DEFAULT_LADDER_DEPTH):
        if depth < 1:
            raise ValueError(f"ladder depth must be >= 1, got {depth}")
        self._shifts = [_bucket_shift(base << k) for k in range(depth)]
        self.base = base
        self.depth = depth
        self.count = 0
        self._lanes = [[0] * (2 * (base << k)) for k in range(depth)]

    def _apply(self, ident: int, key: int, sign: int) -> None:
        ident &= _M32
        _, l0, l1 = record_hash(ident, key, 1)
        mixed = fmix32_py((ident * _K1) & _M32)
        for lanes, shift in zip(self._lanes, self._shifts):
            i = 2 * (0 if shift >= 32 else mixed >> shift)
            lanes[i] = (lanes[i] + sign * l0) & _M32
            lanes[i + 1] = (lanes[i + 1] + sign * l1) & _M32

    def add(self, ident: int, key: int) -> None:
        self._apply(ident, key, 1)
        self.count += 1

    def remove(self, ident: int, key: int) -> None:
        self._apply(ident, key, -1)
        self.count -= 1

    def buckets_at(self, level: int) -> int:
        return self.base << level

    @property
    def buckets(self) -> int:
        """The level-0 bucket count (``IncrementalDigest.buckets``)."""
        return self.base

    @property
    def leaf_level(self) -> int:
        return self.depth - 1

    @property
    def leaf_buckets(self) -> int:
        return self.base << (self.depth - 1)

    def level(self, k: int) -> tuple:
        """Level ``k``'s digest as a canonical flat tuple."""
        return tuple(self._lanes[k])

    def hex(self, k: int = 0) -> str:
        return digest_to_hex(self._lanes[k])

    def value(self) -> tuple:
        """The level-0 digest (``IncrementalDigest.value``)."""
        return tuple(self._lanes[0])

    def leaf_bucket(self, ident: int) -> int:
        """The leaf bucket an ident's record lies in."""
        return bucket_of(ident, self.leaf_buckets)

    @classmethod
    def of(cls, records, base: int = DEFAULT_BUCKETS,
           depth: int = DEFAULT_LADDER_DEPTH) -> "LadderDigest":
        """From an iterable of ``(ident, key)`` pairs."""
        dig = cls(base, depth)
        for ident, key in records:
            dig.add(ident, key)
        return dig


def fold_digest_py(value) -> tuple:
    """One ladder fold in pure Python, canonical flat tuple at 2B
    buckets → B buckets (children ``2b`` and ``2b + 1`` lane-summed into
    parent ``b``) — the reference's host ``fold_digest``
    (``sidecar_tpu/ops/digest.py:549``); this module's
    :func:`fold_digest` is the tensor fold."""
    v = digest_value(value)
    if len(v) < 4 or len(v) % 4:
        raise ValueError(f"cannot fold digest of {len(v) // 2} buckets")
    out = []
    for i in range(0, len(v), 4):
        out.append((v[i] + v[i + 2]) & _M32)
        out.append((v[i + 1] + v[i + 3]) & _M32)
    return tuple(out)


def diff_bucket_ids(a, b) -> list:
    """The ids of the buckets where two same-size digests differ."""
    a = digest_value(a)
    b = digest_value(b)
    if len(a) != len(b):
        raise ValueError(f"digest sizes differ: {len(a)} vs {len(b)}")
    return [i // 2 for i in range(0, len(a), 2)
            if a[i] != b[i] or a[i + 1] != b[i + 1]]


def digest_value(dig) -> tuple:
    """The canonical flat tuple of any digest form: a ``[B, 2]`` tensor
    on the CPU or a card (the device digests), a NumPy array, or a flat
    sequence of ints."""
    if isinstance(dig, (tuple, list)) and \
            all(type(v) is int for v in dig):
        return tuple(map(_M32.__and__, dig))
    if isinstance(dig, torch.Tensor):
        dig = dig.detach().cpu().numpy()
    arr = np.asarray(dig)
    if arr.ndim == 2:
        arr = arr.reshape(-1)
    return tuple(map(_M32.__and__, arr.astype(np.int64).tolist()))


def digest_from_hex(text: str) -> tuple:
    """:func:`digest_to_hex`'s output back to the canonical flat tuple;
    malformed input raises ``ValueError``."""
    if len(text) % 16 or not text:
        raise ValueError(f"digest hex length {len(text)} not a "
                         "multiple of 16")
    return tuple(int(text[i:i + 8], 16) for i in range(0, len(text), 8))


def diff_buckets_py(a, b) -> int:
    """The count of buckets where two digests differ — a lower bound on
    the records they disagree on (the coherence monitor's estimate)."""
    return len(diff_bucket_ids(a, b))
