// The fastpath's bus chain for Hopper (sm_90a): `chain_fold`, a strict left fold.
//
// Replaces the JAX package's `lax.scan` bus chain (`jax_chain` over `_scan_chain`,
// src/repro/pimsys/fastpath/jax_backend.py), which is not a Pallas kernel but the
// fastpath's one sequential recurrence.  Over K rounds x n banks it writes
//   out[0] = b0;  per round k, per bank:  s = B + pn[k] -> out[2m + 1],
//                                         B = s + t_bus -> out[2m + 2]   (m = k * n + bank),
// each value with exactly the float adds the interpreted arbiter performs, in its order,
// so the chain is bit-identical to `np.cumsum` over [b0, pn[0], t_bus, pn[0], t_bus, ...].
// A parallel scan (`torch.cumsum` on CUDA) reassociates the adds and is not.
//
// Bound on the H100: one chain of 2*K*n dependent float64 adds, so no design beats 2*K*n
// times the latency of one dependent DADD (`fold_dadd_probe` measures it: ~8 cycles); the
// bytes (K doubles in, 2*K*n + 1 out) and the card's FP64 rate are far below that.  So the
// design keeps everything but the adds off that chain:
// - One thread (lane 0 of warp 0, the walker) adds in order, one add after another (no
//   multiply, so nvcc contracts nothing).  It reads the round time of each bank step from
//   a shared-memory array expanded per bank step (`steps`), so its walk has no round
//   boundary, branch or index arithmetic: chunks of kChunk bank steps, unrolled, their
//   round times in registers, the next chunk's loaded one 16-byte load per two bank steps
//   while this one is walked.
// - It stores the pair (B, s) of each bank step with one 16-byte store, which it does not
//   wait on: ptxas rotates the stored registers over three groups, so an add that reuses
//   one comes three bank steps after the store that reads it.
// - The helper warps (1-3) fill `steps` a segment ahead: segments of kSegPairs bank
//   steps, two buffers (the walker reads one while the helpers fill the other),
//   __syncthreads at each segment's edge.  The K round times
//   are staged in shared memory first when they fit (kRoundsCap), so the expansion reads
//   no memory off the SM.
// The pointers may be pinned host memory (the round trip's zero-copy path): the round times
// are then read over the bus once, and the chain written there as it is walked.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // warp 0: the walker (lane 0); warps 1-3: the helpers
constexpr int kHelperBase = 32;
constexpr int kHelpers = kThreads - kHelperBase;
constexpr int kChunk = 32;                      // bank steps walked from registers at a time
constexpr int kSegPairs = 1024;                 // bank steps (2048 adds) in a segment
constexpr int kRoundsCap = 2048;                // round times staged whole, up to this
constexpr size_t kSmemBytes = sizeof(double) * (kRoundsCap + 2 * kSegPairs);  // 32 KiB
// pairs = K * n is held in an int: at most 2^30 bank steps (a chain of 16 GiB).
constexpr long long kMaxPairs = 1LL << 30;

__device__ __forceinline__ int segment_pairs(int g, int pairs) {
  const int left = pairs - g * kSegPairs;
  return left < kSegPairs ? left : kSegPairs;
}

// Segment g's round time per bank step, steps[i] = src[(g * kSegPairs + i) / n], by the
// threads first, first + stride, ...
__device__ __forceinline__ void expand(const double* src, double* steps, int g, int pairs,
                                       int n, int first, int stride) {
  const int m0 = g * kSegPairs;
  const int np = segment_pairs(g, pairs);
#pragma unroll 4
  for (int i = first; i < np; i += stride) steps[i] = src[(m0 + i) / n];
}

// One chunk of the walk: `count` bank steps (kChunk, or fewer at the chain's end) with
// their round times in q, each one's pair (B, s) to dst; the next chunk's round times,
// when `next` is not null, load into nq, one 16-byte load per two bank steps.
template <bool kFull>
__device__ __forceinline__ void walk_chunk(double& B, const double2 (&q)[kChunk / 2],
                                           double2 (&nq)[kChunk / 2], const double2* next,
                                           int count, double t_bus, double2* dst) {
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) {
    if (next != nullptr) nq[i] = next[i];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (kFull || 2 * i + u < count) {
        const double s = B + (u ? q[i].y : q[i].x);
        dst[2 * i + u] = make_double2(B, s);
        B = s + t_bus;
      }
    }
  }
}

__device__ __forceinline__ void walk_any(double& B, const double2 (&q)[kChunk / 2],
                                         double2 (&nq)[kChunk / 2], const double2* next, int left,
                                         double t_bus, double2* dst) {
  if (left >= kChunk)
    walk_chunk<true>(B, q, nq, next, kChunk, t_bus, dst);
  else
    walk_chunk<false>(B, q, nq, next, left, t_bus, dst);
}

// The walker's segment: its np bank steps, round times from steps[], pairs to dst[].  Two
// register sets of round times: one walked, the other loading.
__device__ __forceinline__ void walk_segment(double& B, const double* steps, double2* dst, int np,
                                             double t_bus) {
  const double2* q2 = reinterpret_cast<const double2*>(steps);
  const int nch = (np + kChunk - 1) / kChunk;
  constexpr int kStride = kChunk / 2;
  double2 qa[kStride], qb[kStride];
  if (nch > 0) {
#pragma unroll
    for (int i = 0; i < kStride; ++i) qa[i] = q2[i];
  }
  for (int c = 0; c < nch; c += 2) {
    walk_any(B, qa, qb, c + 1 < nch ? q2 + (c + 1) * kStride : nullptr, np - c * kChunk, t_bus,
             dst + c * kChunk);
    if (c + 1 >= nch) break;
    walk_any(B, qb, qa, c + 2 < nch ? q2 + (c + 2) * kStride : nullptr, np - (c + 1) * kChunk,
             t_bus, dst + (c + 1) * kChunk);
  }
}

__global__ void __launch_bounds__(kThreads)
    chain_fold_kernel(const double* __restrict__ pn, double* __restrict__ out, int rounds, int n,
                      int pairs, double t_bus, double b0) {
  extern __shared__ __align__(16) uint32_t fold_smem[];
  double* staged = reinterpret_cast<double*>(fold_smem);  // the round times, when they fit
  double* steps = staged + kRoundsCap;                    // 2 x kSegPairs
  const int tid = threadIdx.x;
  const int h = tid - kHelperBase;
  const int nseg = (pairs + kSegPairs - 1) / kSegPairs;
  const double* src = pn;
  if (rounds <= kRoundsCap && nseg > 0) {
    for (int k = tid; k < rounds; k += kThreads) staged[k] = pn[k];
    src = staged;
    __syncthreads();
  }
  if (nseg > 0) expand(src, steps, 0, pairs, n, tid, kThreads);
  __syncthreads();

  double B = b0;  // the walker's running sum
  for (int g = 0; g < nseg; ++g) {
    if (tid == 0) {
      double2* dst = reinterpret_cast<double2*>(out) + static_cast<long long>(g) * kSegPairs;
      walk_segment(B, steps + (g & 1) * kSegPairs, dst, segment_pairs(g, pairs), t_bus);
    } else if (h >= 0 && g + 1 < nseg) {
      expand(src, steps + ((g + 1) & 1) * kSegPairs, g + 1, pairs, n, h, kHelpers);
    }
    __syncthreads();
  }
  if (tid == 0) out[2LL * pairs] = B;
}

// One thread, `iters` dependent register DADDs (a multiple of 16), the sum stored so that
// nothing is dropped: the latency of one dependent DADD, the chain's bound per add.  A
// measurement kernel, launched by chip_smoke.py only.
__global__ void fold_dadd_probe_kernel(double* out, long long iters, double x, double inc) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  double acc = x;
#pragma unroll 1
  for (long long i = 0; i < iters; i += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) acc = acc + inc;
  }
  out[0] = acc;
}

int launch(const double* pn, double* out, long long rounds, int banks, double t_bus, double b0,
           cudaStream_t st) {
  if (rounds < 0 || banks < 0 || (banks > 0 && rounds > kMaxPairs / banks) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = static_cast<int>(rounds), pairs = static_cast<int>(rounds * banks);
  chain_fold_kernel<<<1, kThreads, kSmemBytes, st>>>(pn, out, k, banks, pairs, t_bus, b0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The chain over `rounds` round times `pn` into `out` (2 * rounds * banks + 1 doubles,
// 16-byte aligned), on `stream`; both on the card or in pinned host memory.
int chain_fold_launch(const double* pn, double* out, long long rounds, int banks, double t_bus,
                      double b0, void* stream) {
  return launch(pn, out, rounds, banks, t_bus, b0, static_cast<cudaStream_t>(stream));
}

// One chain on `device`'s `stream` from pinned host memory to pinned host memory, read and
// written by the kernel itself (zero-copy), then one sync.
int chain_fold_roundtrip(const double* host_pn, double* host_out, long long rounds, int banks,
                         double t_bus, double b0, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = static_cast<cudaError_t>(launch(host_pn, host_out, rounds, banks, t_bus, b0, st));
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

int fold_dadd_probe_launch(double* out, long long iters, double x, double inc, void* stream) {
  if (iters < 0 || iters % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  fold_dadd_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, x, inc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
