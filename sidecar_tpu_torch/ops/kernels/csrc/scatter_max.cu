// Scatter-max apply and in-place max of the exact gossip round, for Hopper
// (sm_90a).
//
// Replaces the two TPU kernels of benchmarks/pallas_scatter.py:
//   * scatter_max_apply_kernel <- make_pallas_scatter(n, m, u_max).apply
//                                 (:106, pallas_call at :122)
//   * rmw_max_kernel           <- pallas_rmw_max (:144, pallas_call at :146)
// and computes exactly what sidecar_tpu/ops/gossip.py apply_updates
// (:458-475) and jnp.maximum compute: integer arithmetic only, held equal
// with torch.equal against the port's plain PyTorch versions.
//
// scatter_max_apply_kernel, for U update triples (row, col, val) into the
// int32 [N, M] belief tensor `known`:
//   known[row, col] = max(known[row, col], val)   where 0 <= row < N and
//                                                 0 <= col < M
//   sent[row, col]  = 0                            there too, where advanced
// An entry out of range on EITHER axis is dropped: the round pads with row
// N ("not due" announce cells) and column M (unfilled message slots), and
// (r, M) must not alias (r + 1, 0), so each axis is checked before the
// 64-bit flat index is formed.  The reset is optional (sent == nullptr
// skips it; the scatter experiment has none).
//
// Design.  The TPU kernel buckets updates per 8-row block, sorts them and
// RMWs a masked (8, 1024) segment per update, because Mosaic has no scalar
// stores.  None of that is needed here: each thread takes four triples,
// loaded as int4 vectors (rows, cols, vals; advanced as a uchar4) when the
// buffers are 16-byte aligned (4-byte for advanced), with a scalar tail for
// U % 4 and a scalar loop for a misaligned buffer.  It reads the four cells
// first, all loads in flight together, and issues an int32 atomicMax only
// where val > known[cell].  Skipping is exact: `known` only grows during
// the launch, so a stale read can cost a needless atomic, never a missed
// one; max is commutative and associative, so the result is independent
// of the order the atomics land in, and duplicate (row, col) pairs need no
// sort.  In a late round most deliveries do not advance, so most triples
// cost a load and no atomic.  The reset keys on `advanced` alone, as the
// reference's does, and every writer stores the same 0, so plain stores do.
// Bound on an H100 SXM (3.35 TB/s): at the exact model's bench shape
// (N = 4,096, M = 40,960, U = N*F*B + M = 225,280) the triples are 2.9 MB
// and each update touches one 32-byte sector of `known` (and of `sent` when
// it resets), read and written once: ~17 MB, ~0.005 ms.  Scattered
// single-sector reads and atomics at L2 make it latency-bound in practice;
// four independent loads a thread keep enough of them in flight.
//
// rmw_max_kernel: known = max(known, other), elementwise, in place, over a
// whole buffer of `count` int32.  Bound: every element read twice and
// written once, 12 B an element (2.01 GB at 4,096 x 40,960, 0.6010 ms);
// nothing else.  Design: both 671 MB buffers are far larger than the L2,
// so all that matters is keeping enough bytes in flight.  Each block of
// 512 threads takes one tile of 512 * 8 int4 of each buffer (no
// grid-stride loop), each thread issuing its eight pairs of 16-byte loads
// before any store: 128 KiB in flight a block.  A count not divisible by 4
// leaves a scalar tail, and a misaligned buffer takes the scalar loop
// whole.  On an H100 this form is level with torch.maximum(..., out=known)
// warm and after an L2 flush; the slice before kept a grid-stride loop
// over 132 * 32 blocks with one int4 a trip, 3 % behind it.  The other
// forms measured (128 and 256 threads, 2 and 4 int4 a thread, evict-first
// __ldcs/__stcs hints, which cost 3 % after an L2 flush) are in PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;   // 32 blocks per SM of an H100

// The cell of (r, c), or -1 where either axis is out of range: each axis
// is checked before the 64-bit flat index is formed, so (r, M) never
// aliases (r + 1, 0).
__device__ __forceinline__ long long cell_of(int r, int c, int n, int m) {
  if (r < 0 || r >= n || c < 0 || c >= m) return -1;
  return static_cast<long long>(r) * m + c;
}

// Applies up to four triples: every cell read before any atomic, so the
// loads are in flight together.
template <int W>
__device__ __forceinline__ void apply_triples(
    int* __restrict__ known, int8_t* __restrict__ sent, const int (&r)[W],
    const int (&c)[W], const int (&v)[W], const bool (&adv)[W], int n,
    int m) {
  long long at[W];
  int cur[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    at[k] = cell_of(r[k], c[k], n, m);
    cur[k] = at[k] >= 0 ? __ldcg(known + at[k]) : 0;
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (at[k] < 0) continue;
    if (v[k] > cur[k]) atomicMax(known + at[k], v[k]);
    if (sent != nullptr && adv[k]) sent[at[k]] = 0;
  }
}

__global__ void scatter_max_apply_kernel(
    int* __restrict__ known, int8_t* __restrict__ sent,
    const int* __restrict__ rows, const int* __restrict__ cols,
    const int* __restrict__ vals, const uint8_t* __restrict__ advanced,
    long long u, int n, int m, bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long u4 = u / 4;
    const int4* r4 = reinterpret_cast<const int4*>(rows);
    const int4* c4 = reinterpret_cast<const int4*>(cols);
    const int4* v4 = reinterpret_cast<const int4*>(vals);
    const uchar4* a4 = reinterpret_cast<const uchar4*>(advanced);
    for (long long j = first; j < u4; j += stride) {
      const int4 r = r4[j], c = c4[j], v = v4[j];
      const uchar4 a = sent != nullptr ? a4[j] : make_uchar4(0, 0, 0, 0);
      const int rr[4] = {r.x, r.y, r.z, r.w};
      const int cc[4] = {c.x, c.y, c.z, c.w};
      const int vv[4] = {v.x, v.y, v.z, v.w};
      const bool aa[4] = {a.x != 0, a.y != 0, a.z != 0, a.w != 0};
      apply_triples<4>(known, sent, rr, cc, vv, aa, n, m);
    }
    tail = u4 * 4;
  }
  for (long long j = tail + first; j < u; j += stride) {
    const int rr[1] = {rows[j]};
    const int cc[1] = {cols[j]};
    const int vv[1] = {vals[j]};
    const bool aa[1] = {sent != nullptr && advanced[j] != 0};
    apply_triples<1>(known, sent, rr, cc, vv, aa, n, m);
  }
}

constexpr unsigned kRmwThreads = 512;
constexpr int kRmwUnroll = 8;
constexpr long long kRmwTile = static_cast<long long>(kRmwThreads) *
                               kRmwUnroll;                    // int4 a block

__global__ void __launch_bounds__(kRmwThreads) rmw_max_kernel(
    int* __restrict__ known, const int* __restrict__ other, long long count,
    bool vec) {
  long long tail = 0;
  if (vec) {
    const long long count4 = count / 4;
    const long long first =
        static_cast<long long>(blockIdx.x) * kRmwTile + threadIdx.x;
    int4* k4 = reinterpret_cast<int4*>(known);
    const int4* o4 = reinterpret_cast<const int4*>(other);
    int4 a[kRmwUnroll], b[kRmwUnroll];
#pragma unroll
    for (int u = 0; u < kRmwUnroll; ++u) {
      const long long j = first + u * static_cast<long long>(kRmwThreads);
      if (j < count4) {
        a[u] = k4[j];
        b[u] = o4[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kRmwUnroll; ++u) {
      const long long j = first + u * static_cast<long long>(kRmwThreads);
      if (j < count4) {
        a[u].x = max(a[u].x, b[u].x);
        a[u].y = max(a[u].y, b[u].y);
        a[u].z = max(a[u].z, b[u].z);
        a[u].w = max(a[u].w, b[u].w);
        k4[j] = a[u];
      }
    }
    tail = count4 * 4;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = tail + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < count; j += stride) {
    known[j] = max(known[j], other[j]);
  }
}

inline unsigned blocks_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// Plain C interface, bound with ctypes.  Pointers are device pointers of
// contiguous tensors; `stream` is a cudaStream_t.  Returns the launch's
// cudaError_t (0 on success).  The wrapper has checked shapes and dtypes.

// `advanced` is a bool (one byte) per triple; pass sent == nullptr (and any
// `advanced`) for the scatter-max alone.
extern "C" int sidecar_scatter_max_apply(
    void* known, void* sent, const void* rows, const void* cols,
    const void* vals, const void* advanced, long long u, int n, int m,
    void* stream) {
  if (u <= 0) return 0;
  const uintptr_t triples = reinterpret_cast<uintptr_t>(rows) |
                            reinterpret_cast<uintptr_t>(cols) |
                            reinterpret_cast<uintptr_t>(vals);
  const bool vec = (triples & 15u) == 0 &&
                   (sent == nullptr ||
                    (reinterpret_cast<uintptr_t>(advanced) & 3u) == 0);
  scatter_max_apply_kernel<<<blocks_for(vec ? (u + 3) / 4 : u), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(known), static_cast<int8_t*>(sent),
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const int*>(vals), static_cast<const uint8_t*>(advanced),
      u, n, m, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sidecar_rmw_max(void* known, const void* other,
                               long long count, void* stream) {
  if (count <= 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(known) |
                     reinterpret_cast<uintptr_t>(other)) & 15u) == 0;
  // One tile a block; a misaligned buffer's scalar loop over at most
  // kMaxBlocks.
  long long blocks = vec ? (count / 4 + kRmwTile - 1) / kRmwTile
                         : (count + kRmwThreads - 1) / kRmwThreads;
  if (!vec && blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rmw_max_kernel<<<static_cast<unsigned>(blocks), kRmwThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(known), static_cast<const int*>(other), count, vec);
  return static_cast<int>(cudaGetLastError());
}
