// Negacyclic NTT kernels for Hopper (sm_90a): B1 `ntt_tile` and B2 `ntt_pair`.
//
// B1 ntt_tile replaces the Pallas kernel `_ntt_tile_kernel`
// (src/repro/kernels/ntt.py, body `_stage_block`): every butterfly stage
// with stride < tile, fused over one tile held on chip.  One CTA per
// (row, tile) loads the tile into dynamic shared memory, runs the stage
// plan it is given with a barrier between stages, and writes the tile back
// (optionally scaled by N^-1).  Twiddles come from the per-tile packed
// table (or the full table on the fused path) through the read-only cache;
// they are shared by every row of the batch and stay in L2.
// Bound on the H100: device-memory bytes.  A tile of log2(tile) stages
// costs one read and one write of the data, ~3 integer ops per word per
// stage, far below the card's integer rate.  The design keeps the whole
// tile in shared memory so those log2(tile) stages cost one HBM pass.
//
// B2 ntt_pair replaces the Pallas kernel `_ntt_pair_kernel`
// (src/repro/kernels/ntt.py): one radix-2 stage with stride >= tile.  One
// thread per butterfly over batch x n/2; neighbouring threads take
// neighbouring j, so both the u and v loads are coalesced.  Bound on the
// H100: device-memory bytes (one read and one write of the data per
// stage).  The optional N^-1 scale folds the inverse's final scaling pass
// (plain jnp at src/repro/kernels/ntt.py:273-275) into the last launch, so
// it costs no pass of its own.
//
// Both kernels take a source and a destination pointer.  They may be equal
// (in place): every word is read and written by one CTA (B1) or one thread
// (B2) only, and read before it is written.  The first launch of a
// transform reads the caller's tensor and writes the fresh output, which
// saves a separate copy.
//
// Butterfly k of a stage with stride t (both kernels): blk = k / t,
// j = k % t, u = blk*2t + j, v = u + t, twiddle table[tw_lo + blk].
#include <cuda_runtime.h>

#include <cstdint>

#include "modmath.cuh"

namespace {

constexpr int kMaxStages = 16;  // tile <= 2^15 words => <= 15 fused stages
constexpr int kTileThreads = 512;
constexpr int kPairThreads = 256;

struct StagePlan {
  int count;
  int log_stride[kMaxStages];
  int tw_lo[kMaxStages];
};

__global__ void ntt_tile_kernel(const uint32_t* src, uint32_t* dst,
                                const uint32_t* __restrict__ tw,
                                const uint32_t* __restrict__ tw_sh, int tile, int n_tiles,
                                StagePlan plan, bool gs, uint32_t q, bool scale, uint32_t n_inv,
                                uint32_t n_inv_sh) {
  extern __shared__ uint32_t sx[];
  const long long b = blockIdx.x;  // (row, tile) flattened: row * n_tiles + j
  const int j = static_cast<int>(b % n_tiles);
  const uint32_t* in = src + b * tile;
  uint32_t* out = dst + b * tile;
  const uint32_t* twr = tw + static_cast<long long>(j) * tile;
  const uint32_t* twsr = tw_sh + static_cast<long long>(j) * tile;

  for (int i = threadIdx.x; i < tile; i += blockDim.x) sx[i] = in[i];
  __syncthreads();

  const int half = tile >> 1;
  for (int s = 0; s < plan.count; ++s) {
    const int ls = plan.log_stride[s];
    const int lo = plan.tw_lo[s];
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int blk = k >> ls;
      const int u = (blk << (ls + 1)) + (k & ((1 << ls) - 1));
      const int v = u + (1 << ls);
      uint32_t a = sx[u], c = sx[v];
      repro_torch::butterfly(a, c, __ldg(twr + lo + blk), __ldg(twsr + lo + blk), q, gs);
      sx[u] = a;
      sx[v] = c;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const uint32_t y = sx[i];
    out[i] = scale ? repro_torch::shoup_mulmod(y, n_inv, n_inv_sh, q) : y;
  }
}

__global__ void ntt_pair_kernel(const uint32_t* src, uint32_t* dst,
                                const uint32_t* __restrict__ tw,
                                const uint32_t* __restrict__ tw_sh, long long total,
                                int log_half_n, int log_stride, int tw_lo, bool gs, uint32_t q,
                                bool scale, uint32_t n_inv, uint32_t n_inv_sh) {
  const long long half_mask = (1LL << log_half_n) - 1;
  const int stride_mask = (1 << log_stride) - 1;
  for (long long k = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; k < total;
       k += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = k >> log_half_n;
    const int kk = static_cast<int>(k & half_mask);
    const int blk = kk >> log_stride;
    const long long u = (row << (log_half_n + 1)) + (static_cast<long long>(blk) << (log_stride + 1)) +
                        (kk & stride_mask);
    const long long v = u + (1LL << log_stride);
    uint32_t a = src[u], c = src[v];
    repro_torch::butterfly(a, c, __ldg(tw + tw_lo + blk), __ldg(tw_sh + tw_lo + blk), q, gs);
    if (scale) {
      a = repro_torch::shoup_mulmod(a, n_inv, n_inv_sh, q);
      c = repro_torch::shoup_mulmod(c, n_inv, n_inv_sh, q);
    }
    dst[u] = a;
    dst[v] = c;
  }
}

}  // namespace

extern "C" {

// B1 launch: `blocks` = batch * n_tiles CTAs; stage i has stride
// 2^log_strides[i] and twiddles at tw_lo[i] of its tile's table row.
int ntt_tile_launch(const uint32_t* src, uint32_t* dst, const uint32_t* tw, const uint32_t* tw_sh,
                    long long blocks, int tile, int n_tiles, const int* log_strides,
                    const int* tw_los, int n_stages, int gs, uint32_t q, int scale,
                    uint32_t n_inv, uint32_t n_inv_sh, void* stream) {
  if (n_stages < 0 || n_stages > kMaxStages || tile < 2 || blocks < 1 || blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  StagePlan plan{};
  plan.count = n_stages;
  for (int i = 0; i < n_stages; ++i) {
    plan.log_stride[i] = log_strides[i];
    plan.tw_lo[i] = tw_los[i];
  }
  const size_t smem = static_cast<size_t>(tile) * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // above the default needs the opt-in (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = tile / 2 < kTileThreads ? tile / 2 : kTileThreads;
  ntt_tile_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(src, dst, tw, tw_sh, tile, n_tiles, plan,
                                                         gs != 0, q, scale != 0, n_inv, n_inv_sh);
  return static_cast<int>(cudaGetLastError());
}

// B2 launch: one stage of stride 2^log_stride over batch rows of
// 2^(log_half_n + 1) words; `total` = batch * n / 2 butterflies.
int ntt_pair_launch(const uint32_t* src, uint32_t* dst, const uint32_t* tw, const uint32_t* tw_sh,
                    long long total, int log_half_n, int log_stride, int tw_lo, int gs,
                    uint32_t q, int scale, uint32_t n_inv, uint32_t n_inv_sh, void* stream) {
  if (total < 1 || log_stride < 0 || log_stride > log_half_n)
    return static_cast<int>(cudaErrorInvalidValue);
  long long grid = (total + kPairThreads - 1) / kPairThreads;
  if (grid > (1LL << 20)) grid = 1LL << 20;  // grid-stride beyond this
  ntt_pair_kernel<<<static_cast<unsigned>(grid), kPairThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(src, dst, tw, tw_sh, total, log_half_n,
                                                         log_stride, tw_lo, gs != 0, q,
                                                         scale != 0, n_inv, n_inv_sh);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
