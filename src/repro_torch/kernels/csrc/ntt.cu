// Negacyclic NTT kernels for Hopper (sm_90a): B1 `ntt_tile` and B2 `ntt_pair`.
//
// Butterfly k of a stage with stride t = 2^s: blk = k >> s, j = k & (t-1),
// u = blk*2t + j, v = u + t, twiddle table[B + blk] for a stage of B
// blocks (the full table's layout: stage B at [B, 2B)).  Every butterfly
// is deterministic and leaves canonical residues, so any order of the
// independent butterflies of a stage gives the same bits.
//
// Both kernels hold words in registers across several stages.  A thread
// takes 2^r words whose positions differ only in the r stride bits
// [a, a + r): position(hi, i, lo) = hi * 2^(a+r) + i * 2^a + lo with
// lo < 2^a.  The r stages with strides 2^a .. 2^(a+r-1) then pair words of
// the same thread: the stage with stride 2^(a+k) pairs i and i + 2^k, and
// its 2^(r-1-k) twiddles are an aligned run of the table, read as 16-byte
// words.  A group costs 2^r - 1 (w, w_shoup) pairs, not one per butterfly.
// Threads with neighbouring lo take neighbouring words.
//
// B1 ntt_tile replaces the Pallas kernel `_ntt_tile_kernel`
// (src/repro/kernels/ntt.py, body `_stage_block`): the whole run of the
// log2(tile) stages with stride < tile (CT strides going down, GS going
// up), one CTA per (row, tile), optionally scaled by N^-1.
//   Bound on the H100: device-memory bytes (one read and one write of the
//   tile), with integer issue close behind (8 instructions per butterfly in
//   SASS, log2(tile) stages).  What held PR 11's kernel at 6.4x that bound
//   was on chip: one shared-memory round trip, barrier and two twiddle
//   gathers per stage.
//   Design: the stages go in groups of at most 5 (32 words per thread):
//   the stride bits [0, 5) as one group, the bits above split evenly.  A
//   tile of 8192 runs its 13 stages as 3 groups, 2 shared-memory round
//   trips.  A group whose smallest stride is >= 32 reads the tile from
//   device memory (the first CT group) or writes it there (the last GS
//   group) straight from registers, coalesced; the bottom group goes
//   through shared memory, which the CTA fills and drains with 16-byte
//   accesses.  Shared memory holds the tile once (tile * 4 bytes per CTA,
//   32 KiB at 8192), each 32-word row's 4-word chunks permuted by the row
//   number (`swz`), so that the bottom group's 16-byte reads of 32
//   contiguous words per thread, the upper groups' 4-byte reads and the
//   16-byte fills are free of bank conflicts.  Twiddles come through the
//   read-only cache: the tile's packed row, or the full table when the
//   tile is the row.  ptxas (CUDA 12.8): 64 registers (CT) and 80 (GS) per
//   thread, no stack frame, no spill; up to 256 threads per CTA.
//   What still holds it at ~2.4x its bound (PERF.md, PR 12): the bottom
//   group's twiddle gathers, where every lane reads its own run, and the
//   latency of each group's loads; more registers per thread (fewer CTAs)
//   and a persistent, double-buffered CTA were both measured slower.
//
// B2 ntt_pair replaces the Pallas kernel `_ntt_pair_kernel`
// (src/repro/kernels/ntt.py): here a group of up to 4 consecutive stages
// with stride >= tile per launch, one thread per 2^r words of 4
// neighbouring columns, read and written as 16-byte words when the
// smallest stride is >= 4 (else one column, 4-byte words).
//   Bound on the H100: device-memory bytes, now one read and one write of
//   the data per group of stages instead of per stage.  ptxas: 64
//   registers per thread for 3 stages x 4 columns (99-104 for 4 stages),
//   no shared memory, no stack frame, no spill; 256 threads per CTA.
//   The optional N^-1 scale folds the inverse's final scaling pass (plain
//   jnp at src/repro/kernels/ntt.py:273-275) into the last launch.
//
// Both kernels take a source and a destination pointer.  They may be equal
// (in place): every word is read and written by one CTA (B1) or one thread
// (B2) only, and read before it is written.  The first launch of a
// transform reads the caller's tensor and writes the fresh output, which
// saves a separate copy.
#include <cuda_runtime.h>

#include <cstdint>

#include "modmath.cuh"

namespace {

constexpr int kMaxLogTile = 15;     // tile <= 2^15 words (128 KiB of shared memory)
constexpr int kMaxGroupBits = 5;    // B1: at most 2^5 words per thread per group
constexpr int kDirectBits = 5;      // smallest stride >= 2^5: straight to or from device memory
constexpr int kTileThreads = 256;
constexpr int kPairMaxStages = 4;   // B2: at most 2^4 words per column per thread
constexpr int kPairThreads = 256;

// B1's register groups for a tile of 2^log_tile words: the stride bits
// [0, 5) make one group, the bits above it split evenly into groups of at
// most kMaxGroupBits.  Group g in run order (GS from the bottom up, CT from
// the top down) covers the stride bits [*lo, *lo + *bits).
__device__ __forceinline__ int tile_groups(int log_tile) {
  const int upper = log_tile - (log_tile < kMaxGroupBits ? log_tile : kMaxGroupBits);
  return 1 + (upper + kMaxGroupBits - 1) / kMaxGroupBits;
}

__device__ __forceinline__ void tile_group_bits(int log_tile, int g, bool gs, int* lo, int* bits) {
  const int bottom = log_tile < kMaxGroupBits ? log_tile : kMaxGroupBits;
  const int count = tile_groups(log_tile);
  const int from_bottom = gs ? g : count - 1 - g;
  if (from_bottom == 0) {
    *lo = 0;
    *bits = bottom;
    return;
  }
  const int u = from_bottom - 1, n_upper = count - 1, upper = log_tile - bottom;
  const int size = upper / n_upper, extra = upper % n_upper;
  *lo = bottom + u * size + (u < extra ? u : extra);
  *bits = size + (u < extra ? 1 : 0);
}

// Shared-memory slot of tile word p: the eight 4-word chunks of each
// 32-word row are permuted by the row's low three bits.
__device__ __forceinline__ int swz(int p) { return p ^ (((p >> 5) & 7) << 2); }

__device__ __forceinline__ uint32_t finish(uint32_t y, uint32_t q, bool scale, uint32_t n_inv,
                                           uint32_t n_inv_sh) {
  return scale ? repro_torch::shoup_mulmod(y, n_inv, n_inv_sh, q) : y;
}

// N consecutive twiddles from p, N a power of two: 16-byte loads from N = 4
// on, one 8-byte load for N = 2 (p aligned to N words, up to 4).
template <int N>
__device__ __forceinline__ void load_run(uint32_t (&out)[N], const uint32_t* __restrict__ p) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + c);
      out[4 * c] = t.x;
      out[4 * c + 1] = t.y;
      out[4 * c + 2] = t.z;
      out[4 * c + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = __ldg(p);
  }
}

// Butterflies of chunk J (twiddles J*W .. J*W + W - 1) of the stage with
// stride 2^(a + k) of a group, and the chunks after it; `off` is the
// stage's first twiddle.
template <int LR, int V, bool GS, int k, int J>
__device__ __forceinline__ void radix_chunk(uint32_t (&x)[V][1 << LR], int off,
                                            const uint32_t* __restrict__ tw,
                                            const uint32_t* __restrict__ tw_sh, uint32_t q) {
  constexpr int M = 1 << (LR - 1 - k);  // twiddles of this stage
  constexpr int W = M < 4 ? M : 4;      // twiddles per load
  uint32_t w[W], w_sh[W];
  load_run<W>(w, tw + off + J * W);
  load_run<W>(w_sh, tw_sh + off + J * W);
#pragma unroll
  for (int dm = 0; dm < W; ++dm) {
#pragma unroll
    for (int l = 0; l < (1 << k); ++l) {
      const int i = ((J * W + dm) << (k + 1)) | l;
#pragma unroll
      for (int v = 0; v < V; ++v)
        repro_torch::butterfly(x[v][i], x[v][i + (1 << k)], w[dm], w_sh[dm], q, GS);
    }
  }
  if constexpr ((J + 1) * W < M) radix_chunk<LR, V, GS, k, J + 1>(x, off, tw, tw_sh, q);
}

// The LR stages of one group on V columns of 2^LR words each, in place in
// registers, from the group's stage KK (run order) on.  Twiddles are in
// the full table's layout: the stage with B blocks at [B, 2B), block b at
// B + b.  For the columns' common high position bits hi, the stage with
// stride 2^(a + k) then takes the 2^(LR-1-k) twiddles from
// heap << (LR-1-k), with heap = 2^(log_len - a - LR) + hi, log_len the
// log2 of the tile (B1) or row (B2): an aligned run.  Template recursion
// over stages and twiddle chunks, and loops only of constant length, keep
// every register index a compile-time constant, so the words never leave
// the register file.
template <int LR, int V, bool GS, int KK = 0>
__device__ __forceinline__ void radix_group(uint32_t (&x)[V][1 << LR], int heap,
                                            const uint32_t* __restrict__ tw,
                                            const uint32_t* __restrict__ tw_sh, uint32_t q) {
  constexpr int k = GS ? KK : LR - 1 - KK;  // CT: strides go down; GS: up
  radix_chunk<LR, V, GS, k, 0>(x, heap << (LR - 1 - k), tw, tw_sh, q);
  if constexpr (KK + 1 < LR) radix_group<LR, V, GS, KK + 1>(x, heap, tw, tw_sh, q);
}

// ---------------------------------------------------------------------------
// B1 ntt_tile
// ---------------------------------------------------------------------------

// One group of B1 over every item of the tile.  Words come from `in`
// (device memory) when it is given, else from shared memory; they go to
// `out` (device memory, finished) when it is given, else back to shared
// memory.
template <int LR, bool GS>
__device__ __forceinline__ void tile_group(uint32_t* sx, const uint32_t* in, uint32_t* out,
                                           int log_tile, int a, const uint32_t* __restrict__ tw,
                                           const uint32_t* __restrict__ tw_sh, uint32_t q,
                                           bool scale, uint32_t n_inv, uint32_t n_inv_sh) {
  constexpr int R = 1 << LR;
  const int items = 1 << (log_tile - LR);
  const int heap_top = 1 << (log_tile - a - LR);
  const int lo_mask = (1 << a) - 1;
  // With a == 0 a thread's words are contiguous: 16-byte shared accesses.
  const bool chunks = R >= 4 && a == 0;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int hi = it >> a;
    const int base = (hi << (a + LR)) | (it & lo_mask);
    uint32_t x[1][R];
    if (in != nullptr) {
#pragma unroll
      for (int i = 0; i < R; ++i) x[0][i] = in[base + (i << a)];
    } else if (chunks) {
#pragma unroll
      for (int c = 0; c < R / 4; ++c) {
        const uint4 t = *reinterpret_cast<const uint4*>(sx + swz(base + 4 * c));
        x[0][4 * c] = t.x;
        x[0][4 * c + 1] = t.y;
        x[0][4 * c + 2] = t.z;
        x[0][4 * c + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) x[0][i] = sx[swz(base + (i << a))];
    }
    radix_group<LR, 1, GS>(x, heap_top | hi, tw, tw_sh, q);
    if (out != nullptr) {
#pragma unroll
      for (int i = 0; i < R; ++i) out[base + (i << a)] = finish(x[0][i], q, scale, n_inv, n_inv_sh);
    } else if (chunks) {
#pragma unroll
      for (int c = 0; c < R / 4; ++c) {
        *reinterpret_cast<uint4*>(sx + swz(base + 4 * c)) =
            make_uint4(x[0][4 * c], x[0][4 * c + 1], x[0][4 * c + 2], x[0][4 * c + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) sx[swz(base + (i << a))] = x[0][i];
    }
  }
}

template <bool GS>
__global__ void __launch_bounds__(kTileThreads)
    ntt_tile_kernel(const uint32_t* src, uint32_t* dst, const uint32_t* __restrict__ tw,
                    const uint32_t* __restrict__ tw_sh, int n_tiles, int log_tile, bool vec,
                    uint32_t q, bool scale, uint32_t n_inv, uint32_t n_inv_sh) {
  extern __shared__ __align__(16) uint32_t sx[];
  const long long b = blockIdx.x;  // (row, tile) flattened: row * n_tiles + j
  const int tile = 1 << log_tile;
  const long long row_tw = static_cast<long long>(b % n_tiles) * tile;
  const uint32_t* in = src + b * tile;
  uint32_t* out = dst + b * tile;
  tw += row_tw;
  tw_sh += row_tw;
  const int last = tile_groups(log_tile) - 1;
  int a, bits;
  tile_group_bits(log_tile, 0, GS, &a, &bits);
  const bool direct_in = a >= kDirectBits;
  tile_group_bits(log_tile, last, GS, &a, &bits);
  const bool direct_out = a >= kDirectBits;

  if (!direct_in) {
    if (vec) {
      for (int c = threadIdx.x; c < tile / 4; c += blockDim.x)
        *reinterpret_cast<uint4*>(sx + swz(4 * c)) = reinterpret_cast<const uint4*>(in)[c];
    } else {
      for (int p = threadIdx.x; p < tile; p += blockDim.x) sx[swz(p)] = in[p];
    }
    __syncthreads();
  }
  for (int g = 0; g <= last; ++g) {
    const uint32_t* gin = g == 0 && direct_in ? in : nullptr;
    uint32_t* gout = g == last && direct_out ? out : nullptr;
    tile_group_bits(log_tile, g, GS, &a, &bits);
    switch (bits) {
      case 1: tile_group<1, GS>(sx, gin, gout, log_tile, a, tw, tw_sh, q, scale, n_inv, n_inv_sh); break;
      case 2: tile_group<2, GS>(sx, gin, gout, log_tile, a, tw, tw_sh, q, scale, n_inv, n_inv_sh); break;
      case 3: tile_group<3, GS>(sx, gin, gout, log_tile, a, tw, tw_sh, q, scale, n_inv, n_inv_sh); break;
      case 4: tile_group<4, GS>(sx, gin, gout, log_tile, a, tw, tw_sh, q, scale, n_inv, n_inv_sh); break;
      default: tile_group<5, GS>(sx, gin, gout, log_tile, a, tw, tw_sh, q, scale, n_inv, n_inv_sh); break;
    }
    __syncthreads();
  }
  if (!direct_out) {
    if (vec) {
      for (int c = threadIdx.x; c < tile / 4; c += blockDim.x) {
        const uint4 t = *reinterpret_cast<const uint4*>(sx + swz(4 * c));
        reinterpret_cast<uint4*>(out)[c] =
            make_uint4(finish(t.x, q, scale, n_inv, n_inv_sh), finish(t.y, q, scale, n_inv, n_inv_sh),
                       finish(t.z, q, scale, n_inv, n_inv_sh), finish(t.w, q, scale, n_inv, n_inv_sh));
      }
    } else {
      for (int p = threadIdx.x; p < tile; p += blockDim.x)
        out[p] = finish(sx[swz(p)], q, scale, n_inv, n_inv_sh);
    }
  }
}

// ---------------------------------------------------------------------------
// B2 ntt_pair
// ---------------------------------------------------------------------------

// One thread per unit: V neighbouring columns of 2^LR words each, the
// LR stages with strides 2^a .. 2^(a+LR-1) over rows of 2^log_n words.
template <int LR, int V, bool GS>
__global__ void __launch_bounds__(kPairThreads)
    ntt_pair_kernel(const uint32_t* src, uint32_t* dst, const uint32_t* __restrict__ tw,
                    const uint32_t* __restrict__ tw_sh, long long units, int log_n, int a,
                    uint32_t q, bool scale, uint32_t n_inv, uint32_t n_inv_sh) {
  constexpr int R = 1 << LR;
  const int heap_top = 1 << (log_n - a - LR);
  const int log_row_units = log_n - LR - (V == 4 ? 2 : 0);
  const long long row_mask = (1LL << log_row_units) - 1;
  const int lo_mask = (1 << a) - 1;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; u < units;
       u += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = u >> log_row_units;
    const int item = static_cast<int>(u & row_mask) * V;
    const int hi = item >> a;
    const long long base =
        (row << log_n) + (static_cast<long long>(hi) << (a + LR)) + (item & lo_mask);
    uint32_t x[V][R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long at = base + (static_cast<long long>(i) << a);
      if constexpr (V == 4) {
        const uint4 t = *reinterpret_cast<const uint4*>(src + at);
        x[0][i] = t.x;
        x[1][i] = t.y;
        x[2][i] = t.z;
        x[3][i] = t.w;
      } else {
        x[0][i] = src[at];
      }
    }
    radix_group<LR, V, GS>(x, heap_top | hi, tw, tw_sh, q);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long at = base + (static_cast<long long>(i) << a);
      if constexpr (V == 4) {
        *reinterpret_cast<uint4*>(dst + at) = make_uint4(
            finish(x[0][i], q, scale, n_inv, n_inv_sh), finish(x[1][i], q, scale, n_inv, n_inv_sh),
            finish(x[2][i], q, scale, n_inv, n_inv_sh), finish(x[3][i], q, scale, n_inv, n_inv_sh));
      } else {
        dst[at] = finish(x[0][i], q, scale, n_inv, n_inv_sh);
      }
    }
  }
}

template <int LR>
void launch_pair(bool vec, bool gs, unsigned grid, cudaStream_t stream, const uint32_t* src,
                 uint32_t* dst, const uint32_t* tw, const uint32_t* tw_sh, long long units,
                 int log_n, int a, uint32_t q, bool scale, uint32_t n_inv, uint32_t n_inv_sh) {
  if (vec && gs)
    ntt_pair_kernel<LR, 4, true><<<grid, kPairThreads, 0, stream>>>(
        src, dst, tw, tw_sh, units, log_n, a, q, scale, n_inv, n_inv_sh);
  else if (vec)
    ntt_pair_kernel<LR, 4, false><<<grid, kPairThreads, 0, stream>>>(
        src, dst, tw, tw_sh, units, log_n, a, q, scale, n_inv, n_inv_sh);
  else if (gs)
    ntt_pair_kernel<LR, 1, true><<<grid, kPairThreads, 0, stream>>>(
        src, dst, tw, tw_sh, units, log_n, a, q, scale, n_inv, n_inv_sh);
  else
    ntt_pair_kernel<LR, 1, false><<<grid, kPairThreads, 0, stream>>>(
        src, dst, tw, tw_sh, units, log_n, a, q, scale, n_inv, n_inv_sh);
}

bool aligned16(const void* p, const void* q) {
  return ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(q)) & 15) == 0;
}

}  // namespace

extern "C" {

// B1 launch: `blocks` = batch * n_tiles CTAs over tiles of 2^log_tile
// words; tile j takes its twiddles from row j of tw (n_tiles rows of
// 2^log_tile words, 16-byte aligned) in the full table's layout.  gs = 0
// runs the strides 2^(log_tile-1) .. 1 (CT), gs = 1 the strides 1 ..
// 2^(log_tile-1) (GS).
int ntt_tile_launch(const uint32_t* src, uint32_t* dst, const uint32_t* tw, const uint32_t* tw_sh,
                    long long blocks, int log_tile, int n_tiles, int gs, uint32_t q, int scale,
                    uint32_t n_inv, uint32_t n_inv_sh, void* stream) {
  if (log_tile < 1 || log_tile > kMaxLogTile || n_tiles < 1 || blocks < 1 ||
      blocks > 0x7FFFFFFFLL || !aligned16(tw, tw_sh))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = 1 << log_tile;
  const size_t smem = static_cast<size_t>(tile) * sizeof(uint32_t);
  const void* kernel = gs ? reinterpret_cast<const void*>(ntt_tile_kernel<true>)
                          : reinterpret_cast<const void*>(ntt_tile_kernel<false>);
  if (smem > 48 * 1024) {  // above the default needs the opt-in (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = tile >> kMaxGroupBits;  // one bottom-group item per thread
  threads = threads < 32 ? 32 : threads > kTileThreads ? kTileThreads : threads;
  const bool vec = log_tile >= 2 && aligned16(src, dst);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gs)
    ntt_tile_kernel<true><<<static_cast<unsigned>(blocks), threads, smem, st>>>(
        src, dst, tw, tw_sh, n_tiles, log_tile, vec, q, scale != 0, n_inv, n_inv_sh);
  else
    ntt_tile_kernel<false><<<static_cast<unsigned>(blocks), threads, smem, st>>>(
        src, dst, tw, tw_sh, n_tiles, log_tile, vec, q, scale != 0, n_inv, n_inv_sh);
  return static_cast<int>(cudaGetLastError());
}

// B2 launch: the n_stages consecutive stages with strides 2^a ..
// 2^(a + n_stages - 1) over `rows` rows of 2^log_n words, twiddles from the
// full tables (16-byte aligned).  GS runs them from the smallest stride up,
// CT from the largest down.
int ntt_pair_launch(const uint32_t* src, uint32_t* dst, const uint32_t* tw, const uint32_t* tw_sh,
                    long long rows, int log_n, int a, int n_stages, int gs, uint32_t q, int scale,
                    uint32_t n_inv, uint32_t n_inv_sh, void* stream) {
  if (rows < 1 || n_stages < 1 || n_stages > kPairMaxStages || a < 0 || a + n_stages > log_n ||
      log_n > 30 || !aligned16(tw, tw_sh))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = a >= 2 && aligned16(src, dst);
  const long long units = rows << (log_n - n_stages - (vec ? 2 : 0));
  long long grid = (units + kPairThreads - 1) / kPairThreads;
  if (grid > (1LL << 20)) grid = 1LL << 20;  // grid-stride beyond this
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  const bool s = scale != 0;
  switch (n_stages) {
    case 1: launch_pair<1>(vec, gs, g, st, src, dst, tw, tw_sh, units, log_n, a, q, s, n_inv, n_inv_sh); break;
    case 2: launch_pair<2>(vec, gs, g, st, src, dst, tw, tw_sh, units, log_n, a, q, s, n_inv, n_inv_sh); break;
    case 3: launch_pair<3>(vec, gs, g, st, src, dst, tw, tw_sh, units, log_n, a, q, s, n_inv, n_inv_sh); break;
    default: launch_pair<4>(vec, gs, g, st, src, dst, tw, tw_sh, units, log_n, a, q, s, n_inv, n_inv_sh); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
