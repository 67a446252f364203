// Publish selection and board row gather of the compressed gossip round,
// for Hopper (sm_90a).
//
// Replaces the three TPU kernels of sidecar_tpu/ops/kernels/publish_gather.py:
//   * publish_board_kernel         <- publish_board_pallas         (:193)
//   * board_row_gather_kernel      <- board_row_gather_pallas      (:265)
//   * fused_publish_select_kernel, then
//     fused_publish_gather_kernel  <- fused_publish_gather_pallas  (:371)
// and computes exactly what their XLA twins (publish_board_xla :142,
// board_row_gather_xla :251, fused_publish_gather_xla :355) compute:
// integer arithmetic only, held equal with torch.equal against the port's
// plain PyTorch versions.  The board row gather is described above its
// kernel below.
//
// Selection of one row of K cache lines (B = min(budget, K)):
//   priority = eligible ? val : 0          eligible = slot >= 0 && sent < limit
//   t        = B-th largest priority, counting repeats
//   above    = priority > t
//   tie      = priority == t && priority > 0
//   ties are admitted in the row's rotated column order while their rank
//   is <= B - #above, rot = (uint32(gid) * 2654435761) & (K - 1), gid the
//   row's global id: row_offset + row, or row_ids[row] where the caller
//   gives ids (the sparse round's compacted rows, K2 only)
//   bval/bslot = selected ? (val, slot) : (0, -1)
//   sent       = min(sent + fanout * selected, limit)          (int8)
// t is the largest t with count(priority >= t) >= B, found greedily bit by
// bit, as the Pallas kernel does: no sort.
//
// Every selection is a warp per row (warp_select_lines, in publish_rows):
//   * A block holds kPublishWarps warps, one row each.  Lane l holds the
//     L = max(1, K/32) consecutive lines [L*l, L*l + L) in registers
//     (templated on L in {1, 2, 4, 8, 16, 32}); for K < 32 the lanes at and
//     past K carry priority 0 and write nothing.
//   * Loads and stores are vectors where L >= 4 and the buffers are
//     aligned: val and slot as int4 (two of each a lane at K = 256), sent
//     as L bytes (8 at K = 256), the outputs alike.  A misaligned buffer
//     takes the same layout with scalar accesses.
//   * Threshold: each count of the bit search is the lane's L compares and
//     one __reduce_add_sync; no block barrier.  The search starts at the
//     highest set bit of the row's largest priority (__reduce_max_sync):
//     t <= that priority, since B >= 1 lines must reach t.  Where fewer
//     than B priorities are positive, t = 0 and no search runs.  Both give
//     the t of the full 31-step search for every B the wrapper passes.
//   * Tie rank: per-lane tie counts, a warp exclusive scan (__shfl_up_sync)
//     and each line's inclusive prefix inside its lane; the ties in columns
//     < rot are one masked count and a __reduce_add_sync.  Where every tie
//     fits (#ties <= B - #above) no rank is needed.
// publish_board_kernel (K2) writes the board and sent.  The fused publish
// gather (K1) is two launches of one call, in stream order:
//   1. fused_publish_select_kernel: the same pass over every row once,
//      writing the own rows' sent and, in place of the board, the row's
//      selection as K bits in line order (mask, max(1, K/32) 32-bit words a
//      row: 32 B at K = 256).
//   2. fused_publish_gather_kernel: the board row gather's windowed walk
//      (windowed_row_gather) over the requests src[r, f], each row clamped
//      to [0, N): for each unit of the named row whose mask bits are set it
//      reads cache_val/cache_slot and writes pv = gate(val), ps = slot;
//      for the other units it writes (0, -1) and reads nothing.  gate
//      zeroes a val whose ts = val >> 3 is in (0, now - stale_ticks); ps
//      keeps its slot.  The rotation is seeded by the row's own id, which
//      is src[r, f] for every peer in [0, N), the only ones sample_peers
//      draws.
//
// Bound on an H100 SXM (3.35 TB/s; the work is a few integer ops per byte,
// far below the card's operation rate, so bytes bound it):
//   publish_board_kernel at N=100,000, K=256: reads 9 B and writes 9 B per
//     line, 460.8 MB, 0.1376 ms.
//   fused publish gather at N=100,000, K=256, F=3: reads the cache once
//     (230.4 MB) and src (1.2 MB), writes sent (25.6 MB) and pv/ps
//     (614.4 MB): 871.6 MB, 0.2602 ms.
// What the designs do about it.  publish_board_kernel reads and writes
// each byte once, in vector accesses, and keeps the rest on the warp: at
// K = 256 a row is at most 31 steps of 8 compares and one warp reduction,
// and with no block barrier the other rows' loads stay in flight while a
// warp searches.  On an H100 it reads 0.16 ms at N = 100,000, K = 256
// (86 % of the bound), the same at 0, 7 and 23 search steps: the
// selection hides under the bytes.  The fused form the two passes
// replace, a block per (r, f) pull with a block-barrier search, selected
// every row F+1 times and read 2.03 ms.  The two passes select each row
// once and move 0.26 GB (select: the cache, sent and the mask) plus
// 0.62-0.70 GB (gather: the 614.4 MB of pv/ps, and of each named row
// only the mask and the 32-byte sectors of val and slot that hold a
// selected line, at most B of each row's K/8, from device memory about
// once thanks to the windows).  On an H100 they read 0.32-0.40 ms at
// N = 100,000, K = 256, F = 3 (select 0.09-0.11, gather 0.22-0.28; the
// gather pass's floor is the pv/ps writes, 0.22 ms where no line is
// selected).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPhaseMult = 2654435761u;
constexpr unsigned kFull = 0xffffffffu;

// Rows (warps) a block of the publish passes.  4, 8 and 16 read within
// 1 % of each other on an H100 (PERF.md).
constexpr int kPublishWarps = 8;

// The publish selection of one row held by a warp: lane l holds the L
// consecutive lines [first, first + L), first = L * l, with priority 0
// past the row's end.  Every lane of the warp must call it, with the same
// gid, k and budget.  Returns the lane's selected lines as a bit mask
// (bit i: line first + i).
template <int L>
__device__ __forceinline__ unsigned warp_select_lines(
    const int (&priority)[L], int first, uint32_t gid, int k, int budget) {
  static_assert(L >= 1 && L <= 32, "a lane holds 1 to 32 lines");
  int positive = 0, largest = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    positive += priority[i] > 0;
    largest = max(largest, priority[i]);
  }
  if (__reduce_add_sync(kFull, positive) < budget) {
    // t = 0: every positive priority is above it, and none ties.
    unsigned sel = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) sel |= (priority[i] > 0 ? 1u : 0u) << i;
    return sel;
  }
  // No bit above the largest priority's highest set bit can be in t.
  const unsigned top = __reduce_max_sync(kFull,
                                         static_cast<unsigned>(largest));
  int thresh = 0;
  for (int b = 31 - __clz(top); b >= 0; --b) {
    const int cand = thresh | (1 << b);
    int count = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) count += priority[i] >= cand;
    if (__reduce_add_sync(kFull, count) >= budget) thresh = cand;
  }
  unsigned above = 0, tie = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    above |= (priority[i] > thresh ? 1u : 0u) << i;
    tie |= (priority[i] == thresh && priority[i] > 0 ? 1u : 0u) << i;
  }
  const int need = budget - __reduce_add_sync(kFull, __popc(above));
  const int mine = __popc(tie);
  const int total = __reduce_add_sync(kFull, mine);
  if (total <= need) return above | tie;   // every tie fits
  const int rot = static_cast<int>((gid * kPhaseMult) &
                                   static_cast<uint32_t>(k - 1));
  const int left = rot - first;            // this lane's lines left of rot
  const unsigned left_mask =
      left <= 0 ? 0u : (left >= 32 ? kFull : (1u << left) - 1u);
  const int before_rot = __reduce_add_sync(kFull, __popc(tie & left_mask));
  // Ties in columns < first: a warp exclusive scan of the lane counts.
  const unsigned lane = threadIdx.x & 31u;
  int inclusive = mine;
#pragma unroll
  for (unsigned d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFull, inclusive, d);
    if (lane >= d) inclusive += x;
  }
  int prefix = inclusive - mine;
  unsigned sel = above;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (!(tie >> i & 1u)) continue;
    ++prefix;                              // inclusive count at column first+i
    const int rank = first + i >= rot ? prefix - before_rot
                                      : prefix + total - before_rot;
    if (rank <= need) sel |= 1u << i;
  }
  return sel;
}

template <typename T> struct Vec;
template <> struct Vec<int> { using x2 = int2; using x4 = int4; };
template <> struct Vec<unsigned> { using x2 = uint2; using x4 = uint4; };

// W 32-bit words at p in the widest accesses: 16 bytes where W % 4 == 0
// (p 16-byte aligned), 8 where W == 2 (p 8-byte aligned), else 4.
template <int W, typename T>
__device__ __forceinline__ void load_words(const T* __restrict__ p,
                                           T (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const typename Vec<T>::x4 v =
          reinterpret_cast<const typename Vec<T>::x4*>(p)[c];
      w[4 * c] = v.x;
      w[4 * c + 1] = v.y;
      w[4 * c + 2] = v.z;
      w[4 * c + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const typename Vec<T>::x2 v =
        *reinterpret_cast<const typename Vec<T>::x2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = p[i];
  }
}

template <int W, typename T>
__device__ __forceinline__ void store_words(T* __restrict__ p,
                                            const T (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      typename Vec<T>::x4 v;
      v.x = w[4 * c];
      v.y = w[4 * c + 1];
      v.z = w[4 * c + 2];
      v.w = w[4 * c + 3];
      reinterpret_cast<typename Vec<T>::x4*>(p)[c] = v;
    }
  } else if constexpr (W == 2) {
    typename Vec<T>::x2 v;
    v.x = w[0];
    v.y = w[1];
    *reinterpret_cast<typename Vec<T>::x2*>(p) = v;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = w[i];
  }
}

// 32-bit words of a row's selection mask.
__host__ __device__ inline int mask_words(int k) {
  return k < 32 ? 1 : k / 32;
}

// The publish pass, a warp per row: L lines a lane (K = 32 L, or K < 32
// with L = 1); VEC: vector accesses (L >= 4, val/slot/bval/bslot 16-byte
// aligned, the sent buffers aligned to min(L, 16) bytes).  BOARD: write
// the board (bval/bslot, K2); else the row's selection mask (K1's select
// pass).  Both write sent.
template <int L, bool VEC, bool BOARD>
__device__ __forceinline__ void publish_rows(
    const int* __restrict__ cache_val, const int* __restrict__ cache_slot,
    const int8_t* __restrict__ cache_sent, int n, int k, int budget,
    int limit, int fanout, int row_offset, const int* __restrict__ row_ids,
    int* __restrict__ bval, int* __restrict__ bslot,
    unsigned* __restrict__ mask, int8_t* __restrict__ sent_out) {
  static_assert(!VEC || L >= 4, "vector accesses need 4 lines a lane");
  const int row = static_cast<int>(blockIdx.x) * kPublishWarps +
                  static_cast<int>(threadIdx.x >> 5);
  if (row >= n) return;                    // the whole warp
  const unsigned lane = threadIdx.x & 31u;
  const int first = static_cast<int>(lane) * L;
  const bool in_row = first < k;           // false only where K < 32
  const int64_t at = static_cast<int64_t>(row) * k + first;
  int val[L], slot[L], sent[L];
  if constexpr (VEC) {
    load_words<L>(cache_val + at, val);
    load_words<L>(cache_slot + at, slot);
    unsigned w[L / 4];
    load_words<L / 4>(reinterpret_cast<const unsigned*>(cache_sent + at), w);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      sent[i] = static_cast<int8_t>(w[i / 4] >> (8 * (i % 4)));
    }
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      val[i] = in_row ? cache_val[at + i] : 0;
      slot[i] = in_row ? cache_slot[at + i] : -1;
      sent[i] = in_row ? cache_sent[at + i] : 0;
    }
  }
  int priority[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    priority[i] = slot[i] >= 0 && sent[i] < limit ? val[i] : 0;
  }
  const uint32_t gid = row_ids != nullptr
                           ? static_cast<uint32_t>(row_ids[row])
                           : static_cast<uint32_t>(row_offset) +
                                 static_cast<uint32_t>(row);
  const unsigned sel = warp_select_lines<L>(priority, first, gid, k, budget);
  if constexpr (!BOARD) {
    // Line j is bit j % 32 of word j / 32: the 32 / L lanes of a word OR
    // their bits together, and the first of them stores it.
    constexpr unsigned kLanesPerWord = 32 / L;
    unsigned word = sel << (L * (lane % kLanesPerWord));
#pragma unroll
    for (unsigned d = 1; d < kLanesPerWord; d <<= 1) {
      word |= __shfl_xor_sync(kFull, word, d);
    }
    if (lane % kLanesPerWord == 0) {
      mask[static_cast<int64_t>(row) * mask_words(k) +
           lane / kLanesPerWord] = word;
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const bool s = sel >> i & 1u;
    const int bumped = sent[i] + (s ? fanout : 0);
    if constexpr (BOARD) {
      val[i] = s ? val[i] : 0;
      slot[i] = s ? slot[i] : -1;
    }
    sent[i] = bumped < limit ? bumped : limit;
  }
  if constexpr (VEC) {
    if constexpr (BOARD) {
      store_words<L>(bval + at, val);
      store_words<L>(bslot + at, slot);
    }
    unsigned w[L / 4] = {};
#pragma unroll
    for (int i = 0; i < L; ++i) {
      w[i / 4] |= (static_cast<unsigned>(sent[i]) & 0xffu) << (8 * (i % 4));
    }
    store_words<L / 4>(reinterpret_cast<unsigned*>(sent_out + at), w);
  } else if (in_row) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if constexpr (BOARD) {
        bval[at + i] = val[i];
        bslot[at + i] = slot[i];
      }
      sent_out[at + i] = static_cast<int8_t>(sent[i]);
    }
  }
}

// The two publish passes share their arguments; each leaves alone the
// outputs it does not write (K2: mask; K1's select pass: bval, bslot).
template <int L, bool VEC>
__global__ void __launch_bounds__(kPublishWarps * 32) publish_board_kernel(
    const int* __restrict__ cache_val, const int* __restrict__ cache_slot,
    const int8_t* __restrict__ cache_sent, int n, int k, int budget,
    int limit, int fanout, int row_offset, const int* __restrict__ row_ids,
    int* __restrict__ bval, int* __restrict__ bslot,
    unsigned* __restrict__ mask, int8_t* __restrict__ sent_out) {
  publish_rows<L, VEC, true>(cache_val, cache_slot, cache_sent, n, k, budget,
                             limit, fanout, row_offset, row_ids, bval, bslot,
                             mask, sent_out);
}

template <int L, bool VEC>
__global__ void __launch_bounds__(kPublishWarps * 32)
    fused_publish_select_kernel(
        const int* __restrict__ cache_val, const int* __restrict__ cache_slot,
        const int8_t* __restrict__ cache_sent, int n, int k, int budget,
        int limit, int fanout, int row_offset,
        const int* __restrict__ row_ids, int* __restrict__ bval,
        int* __restrict__ bslot, unsigned* __restrict__ mask,
        int8_t* __restrict__ sent_out) {
  publish_rows<L, VEC, false>(cache_val, cache_slot, cache_sent, n, k,
                              budget, limit, fanout, row_offset, row_ids,
                              bval, bslot, mask, sent_out);
}

template <int L, bool BOARD>
int launch_publish(const void* cache_val, const void* cache_slot,
                   const void* cache_sent, int n, int k, int budget,
                   int limit, int fanout, int row_offset,
                   const void* row_ids, void* bval, void* bslot, void* mask,
                   void* sent, bool vec, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kPublishWarps - 1) / kPublishWarps);
  auto run = [&](auto kernel) {
    kernel<<<blocks, kPublishWarps * 32, 0, stream>>>(
        static_cast<const int*>(cache_val),
        static_cast<const int*>(cache_slot),
        static_cast<const int8_t*>(cache_sent), n, k, budget, limit, fanout,
        row_offset, static_cast<const int*>(row_ids),
        static_cast<int*>(bval), static_cast<int*>(bslot),
        static_cast<unsigned*>(mask), static_cast<int8_t*>(sent));
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (L >= 4) {
    if (vec) {
      return run(BOARD ? publish_board_kernel<L, true>
                       : fused_publish_select_kernel<L, true>);
    }
  }
  return run(BOARD ? publish_board_kernel<L, false>
                   : fused_publish_select_kernel<L, false>);
}

// The publish pass over n rows, with its L and access width chosen from
// k and the buffers' alignment (bval/bslot null for the mask, mask null
// for the board; row_ids null for the ids row_offset + row).
template <bool BOARD>
int launch_publish_rows(const void* cache_val, const void* cache_slot,
                        const void* cache_sent, int n, int k, int budget,
                        int limit, int fanout, int row_offset,
                        const void* row_ids, void* bval, void* bslot,
                        void* mask, void* sent, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int lines = k < 32 ? 1 : k / 32;   // L, lines a lane
  const uintptr_t words = reinterpret_cast<uintptr_t>(cache_val) |
                          reinterpret_cast<uintptr_t>(cache_slot) |
                          reinterpret_cast<uintptr_t>(bval) |
                          reinterpret_cast<uintptr_t>(bslot);
  const uintptr_t bytes = reinterpret_cast<uintptr_t>(cache_sent) |
                          reinterpret_cast<uintptr_t>(sent);
  const uintptr_t sent_align = lines < 16 ? lines : 16;
  const bool vec = lines >= 4 && (words & 15u) == 0 &&
                   (bytes & (sent_align - 1)) == 0;
  switch (lines) {
#define SIDECAR_PUBLISH_CASE(L)                                              \
  case L:                                                                    \
    return launch_publish<L, BOARD>(cache_val, cache_slot, cache_sent, n, k, \
                                    budget, limit, fanout, row_offset,       \
                                    row_ids, bval, bslot, mask, sent, vec,   \
                                    stream);
    SIDECAR_PUBLISH_CASE(1)
    SIDECAR_PUBLISH_CASE(2)
    SIDECAR_PUBLISH_CASE(4)
    SIDECAR_PUBLISH_CASE(8)
    SIDECAR_PUBLISH_CASE(16)
    SIDECAR_PUBLISH_CASE(32)
#undef SIDECAR_PUBLISH_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Board row gather (the node-sharded round's delivery gather).  A shard
// holds a board block of R rows whose row 0 is global node `base` (its own
// rows, or the whole gathered board at base 0), and serves the rows its
// nodes sampled:
//   pv[r, f] = bval[src[r, f] - base], ps[r, f] = bslot[src[r, f] - base]
//   where 0 <= src[r, f] - base < R, else (0, -1) -- the merge no-op.
//
// Bound on an H100 SXM (3.35 TB/s; no arithmetic beyond the index, so bytes
// bound it): at N=100,000 rows, F=3, K=256 it writes 614.4 MB of pv/ps and
// reads src (1.2 MB) plus every board row some request names, once: 95-98 %
// of the 204.8 MB board at d=1 (ER(8): each named row named ~3 times),
// 0.24 ms.  A copy per request reads 614.4 MB instead (0.37 ms): the board
// is 4x the 50 MB L2, so in request order a row named again has left the
// L2 and is read again from HBM.
//
// Design: one ordinary launch whose blocks walk the board in windows of
// rows, so that the requests naming a row meet while the row is in the L2.
// Block b takes pass p = b / chunks and the chunk of 256 consecutive
// requests c = b % chunks; pass p copies only the requests of its chunk
// whose row lies in window p, [p * W, (p + 1) * W) with W rows of 3 MiB of
// bval and bslot (W = 1,536 at K = 256).  Blocks start in about the order of
// their index, so the blocks in flight name rows of one or a few windows:
// a row comes from HBM once and its other requests find it in the L2.
// Each warp loads its 32 requests' src (one coalesced load), and copies
// its requests in the window one after another, the whole warp on one row:
// 16-byte int4 loads and stores where K % 4 == 0 and the four buffers are
// 16-byte aligned (K = 256: two int4 of bval and two of bslot a lane),
// int32 otherwise.  Pass 0 also writes (0, -1) to the out-of-block requests
// and reads nothing for them.  The passes re-read src from the L2 (1.2 MB
// a pass); no scratch, no atomics, no grid-wide sync.  The output index is
// 64-bit (nl*F*K is 76.8 M at N=100,000, F=3, K=256).  K1's gather pass is
// the same walk over the cache's rows (R = N, base 0, rows clamped), with
// the selection mask deciding what each unit reads and writes.
constexpr int kGatherThreads = 256;   // one chunk: 8 warps x 32 requests
// chip_smoke.py's row_gather_windows phase builds the kernel with other
// windows (-DSIDECAR_ROW_GATHER_WINDOW_BYTES=...) and times each.
#ifndef SIDECAR_ROW_GATHER_WINDOW_BYTES
#define SIDECAR_ROW_GATHER_WINDOW_BYTES (3LL << 20)
#endif
constexpr long long kWindowBytes = SIDECAR_ROW_GATHER_WINDOW_BYTES;

template <typename T> __device__ __forceinline__ T splat(int x);
template <> __device__ __forceinline__ int splat<int>(int x) { return x; }
template <> __device__ __forceinline__ int4 splat<int4>(int x) {
  return make_int4(x, x, x, x);
}

// One published line of K1: the board's (val, slot) where selected, else
// (0, -1), with the staleness gate on val (ts = val >> 3 in (0, horizon),
// horizon = now - stale_ticks, zeroes it; the slot stays).
__device__ __forceinline__ void publish_line(bool selected, int horizon,
                                             int& val, int& slot) {
  val = selected ? val : 0;
  const int ts = val >> 3;
  if (ts > 0 && ts < horizon) val = 0;
  slot = selected ? slot : -1;
}

__device__ __forceinline__ void publish_unit(unsigned bits, int horizon,
                                             int& val, int& slot) {
  publish_line(bits & 1u, horizon, val, slot);
}

__device__ __forceinline__ void publish_unit(unsigned bits, int horizon,
                                             int4& val, int4& slot) {
  publish_line(bits & 1u, horizon, val.x, slot.x);
  publish_line(bits >> 1 & 1u, horizon, val.y, slot.y);
  publish_line(bits >> 2 & 1u, horizon, val.z, slot.z);
  publish_line(bits >> 3 & 1u, horizon, val.w, slot.w);
}

// The windowed walk.  T is the unit of a copy (int4, or int on the scalar
// path); `e` the row width in units; `window` the rows of a pass; `chunks`
// the request chunks.  PUBLISH = false (K3): copy rows of the board block
// (val = bval, slot = bslot), (0, -1) outside it.  PUBLISH = true (K1's
// gather pass): rows of the cache (rows = N, base 0), src clamped to
// [0, N), each unit published from its `words`-word row of `mask`.
template <typename T, bool PUBLISH>
__device__ __forceinline__ void windowed_row_gather(
    const T* __restrict__ val, const T* __restrict__ slot,
    const unsigned* __restrict__ mask, int words, int horizon,
    const int* __restrict__ src, int rows, int n_req, int e, int base,
    int window, int chunks, T* __restrict__ pv, T* __restrict__ ps) {
  const unsigned lane = threadIdx.x & 31u;
  const int pass = blockIdx.x / chunks;
  const int chunk = blockIdx.x - pass * chunks;
  const int64_t lo = static_cast<int64_t>(pass) * window;
  const int64_t first = static_cast<int64_t>(chunk) * kGatherThreads +
                        (threadIdx.x & ~31u);
  const int64_t i = first + lane;
  int row = -1;        // -1: out of block
  bool mine = false;   // this pass copies request i
  if (i < n_req) {
    int64_t rel = static_cast<int64_t>(src[i]) - base;
    if constexpr (PUBLISH) rel = rel < 0 ? 0 : (rel < rows ? rel : rows - 1);
    const bool in_block = rel >= 0 && rel < rows;
    row = in_block ? static_cast<int>(rel) : -1;
    mine = in_block ? rel >= lo && rel < lo + window : pass == 0;
  }
  for (unsigned todo = __ballot_sync(kFull, mine); todo; todo &= todo - 1) {
    const int t = __ffs(todo) - 1;
    const int r = __shfl_sync(kFull, row, t);
    const int64_t out = (first + t) * e;
    const int64_t in = static_cast<int64_t>(r) * e;
    if constexpr (PUBLISH) {
      // Lines a unit: its mask bits are U consecutive bits of one word.
      constexpr int U = static_cast<int>(sizeof(T) / sizeof(int));
      const unsigned* __restrict__ m = mask + static_cast<int64_t>(r) * words;
      for (int x = static_cast<int>(lane); x < e; x += 32) {
        const unsigned bits =
            (m[U * x / 32] >> (U * x % 32)) & ((1u << U) - 1u);
        T v = splat<T>(0), s = splat<T>(-1);
        if (bits) {                // an unselected unit reads nothing
          v = val[in + x];
          s = slot[in + x];
          publish_unit(bits, horizon, v, s);
        }
        pv[out + x] = v;
        ps[out + x] = s;
      }
    } else {
      for (int x = static_cast<int>(lane); x < e; x += 32) {
        pv[out + x] = r >= 0 ? val[in + x] : splat<T>(0);
        ps[out + x] = r >= 0 ? slot[in + x] : splat<T>(-1);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads) board_row_gather_kernel(
    const T* __restrict__ bval, const T* __restrict__ bslot,
    const int* __restrict__ src, int rows, int n_req, int e, int base,
    int window, int chunks, T* __restrict__ pv, T* __restrict__ ps) {
  windowed_row_gather<T, false>(bval, bslot, nullptr, 0, 0, src, rows, n_req,
                                e, base, window, chunks, pv, ps);
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads) fused_publish_gather_kernel(
    const T* __restrict__ cache_val, const T* __restrict__ cache_slot,
    const unsigned* __restrict__ mask, int words, int horizon,
    const int* __restrict__ src, int n, int n_req, int e, int window,
    int chunks, T* __restrict__ pv, T* __restrict__ ps) {
  windowed_row_gather<T, true>(cache_val, cache_slot, mask, words, horizon,
                               src, n, n_req, e, 0, window, chunks, pv, ps);
}

// The walk's grid: `window` rows a pass (3 MiB of the two row buffers,
// `row_bytes` a row), `chunks` of kGatherThreads requests, passes * chunks
// blocks.
struct GatherGrid {
  int window;
  int chunks;
  unsigned blocks;
};

GatherGrid gather_grid(int rows, int n_req, long long row_bytes) {
  const long long chunks = (n_req + kGatherThreads - 1LL) / kGatherThreads;
  long long window = kWindowBytes / row_bytes;
  if (window < 1) window = 1;
  if (window > rows) window = rows > 0 ? rows : 1;
  // At most 2^31 - 1 blocks: widen the window where the passes would not fit.
  const long long max_passes = 0x7fffffffLL / chunks;
  if ((rows + window - 1) / window > max_passes) {
    window = (rows + max_passes - 1) / max_passes;
  }
  const long long passes = rows > 0 ? (rows + window - 1) / window : 1;
  return {static_cast<int>(window), static_cast<int>(chunks),
          static_cast<unsigned>(passes * chunks)};
}

template <typename T>
int launch_row_gather(const void* bval, const void* bslot, const void* src,
                      int rows, int n_req, int e, int base, void* pv,
                      void* ps, cudaStream_t stream) {
  const GatherGrid g = gather_grid(rows, n_req, 2LL * e * sizeof(T));
  board_row_gather_kernel<T><<<g.blocks, kGatherThreads, 0, stream>>>(
      static_cast<const T*>(bval), static_cast<const T*>(bslot),
      static_cast<const int*>(src), rows, n_req, e, base, g.window, g.chunks,
      static_cast<T*>(pv), static_cast<T*>(ps));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused_gather(const void* cache_val, const void* cache_slot,
                        const void* mask, int words, int horizon,
                        const void* src, int n, int n_req, int e, void* pv,
                        void* ps, cudaStream_t stream) {
  const GatherGrid g = gather_grid(n, n_req, 2LL * e * sizeof(T));
  fused_publish_gather_kernel<T><<<g.blocks, kGatherThreads, 0, stream>>>(
      static_cast<const T*>(cache_val), static_cast<const T*>(cache_slot),
      static_cast<const unsigned*>(mask), words, horizon,
      static_cast<const int*>(src), n, n_req, e, g.window, g.chunks,
      static_cast<T*>(pv), static_cast<T*>(ps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes.  Pointers are device pointers of
// contiguous tensors; `stream` is a cudaStream_t.  Returns the launch's
// cudaError_t (0 on success).  The wrapper has checked shapes, dtypes and
// that k is a power of two in [1, 1024].  `row_ids` is null (row ids
// row_offset + row) or n int32 global row ids.
extern "C" int sidecar_publish_board(
    const void* cache_val, const void* cache_slot, const void* cache_sent,
    int n, int k, int budget, int limit, int fanout, int row_offset,
    const void* row_ids, void* bval, void* bslot, void* sent, void* stream) {
  return launch_publish_rows<true>(cache_val, cache_slot, cache_sent, n, k,
                                   budget, limit, fanout, row_offset, row_ids,
                                   bval, bslot, nullptr, sent,
                                   static_cast<cudaStream_t>(stream));
}

// `n_req` = nl * F requests.  The int4 path takes K % 4 == 0 with bval,
// bslot, pv and ps 16-byte aligned; the int32 path the rest.
extern "C" int sidecar_board_row_gather(
    const void* bval, const void* bslot, const void* src, int rows,
    long long n_req, int k, int base, void* pv, void* ps, void* stream) {
  if (n_req <= 0 || k <= 0) return 0;
  if (n_req > 0x7fffffffLL || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t bufs = reinterpret_cast<uintptr_t>(bval) |
                         reinterpret_cast<uintptr_t>(bslot) |
                         reinterpret_cast<uintptr_t>(pv) |
                         reinterpret_cast<uintptr_t>(ps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(n_req);
  if (k % 4 == 0 && (bufs & 15u) == 0) {
    return launch_row_gather<int4>(bval, bslot, src, rows, n, k / 4, base,
                                   pv, ps, s);
  }
  return launch_row_gather<int>(bval, bslot, src, rows, n, k, base, pv, ps,
                                s);
}

// Two launches on `stream`: the select pass (sent, and the [n,
// max(1, k/32)] int32 `mask` the wrapper allocated), then the gather pass
// (pv, ps), int4 where k % 4 == 0 and cache_val, cache_slot, pv and ps are
// 16-byte aligned, int32 otherwise.
extern "C" int sidecar_fused_publish_gather(
    const void* cache_val, const void* cache_slot, const void* cache_sent,
    const void* src, int n, int f, int k, int budget, int limit, int fanout,
    int now, int stale_ticks, void* mask, void* sent, void* pv, void* ps,
    void* stream) {
  if (n <= 0) return 0;
  const long long n_req = static_cast<long long>(n) * f;
  if (f < 0 || n_req > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_publish_rows<false>(
      cache_val, cache_slot, cache_sent, n, k, budget, limit, fanout, 0,
      nullptr, nullptr, nullptr, mask, sent, s);
  if (err != 0 || n_req == 0) return err;
  // The gate's horizon in int32, as the reference computes it.
  const int horizon = static_cast<int>(static_cast<uint32_t>(now) -
                                       static_cast<uint32_t>(stale_ticks));
  const uintptr_t bufs = reinterpret_cast<uintptr_t>(cache_val) |
                         reinterpret_cast<uintptr_t>(cache_slot) |
                         reinterpret_cast<uintptr_t>(pv) |
                         reinterpret_cast<uintptr_t>(ps);
  const int req = static_cast<int>(n_req);
  if (k % 4 == 0 && (bufs & 15u) == 0) {
    return launch_fused_gather<int4>(cache_val, cache_slot, mask,
                                     mask_words(k), horizon, src, n, req,
                                     k / 4, pv, ps, s);
  }
  return launch_fused_gather<int>(cache_val, cache_slot, mask, mask_words(k),
                                  horizon, src, n, req, k, pv, ps, s);
}
