// Merge sums of the fused DeepONet merge + Gaussian NLL, chain-batched, for Hopper.
//
// Replaces the Pallas TPU kernels `_merge_sums_pallas` /
// `_merge_sums_pallas_batched` (vihmc_tpu/ops/deeponet_merge.py:72-136,
// bodies `_sums_kernel` :58 / `_batched_sums_kernel` :94), which
// `fused_merge_nll` launches once per density evaluation for all chains.
//
// For every chain c, with m = bout[c] @ tout[c]^T over the (B, P) grid, it
// returns
//
//     S1 = sum m (m - 2 y)        S2 = sum m
//
// without writing the (B, P) product to device memory. y (B, P) is shared by
// all chains. The host-side closure (vihmc_torch/ops/deeponet_merge.py) turns
// them into ll = -0.5 (N log var + SSE / var) with
// SSE = S1 + sum y^2 + 2 b (S2 - sum y) + N b^2.
//
// What bounds it on an H100: f32 FMA. Per chain it does 2 B P K flops of
// product against (B K + P K) * 4 bytes of features; at the stage-3 shape
// (C = 16, B = 1000, P = 10201, K = 100) that is 3.3e10 flop per call against
// ~72 MB of features plus the 41 MB y, which stays resident in the 50 MB L2
// across chains: ~0.50 ms at the 67 TFLOP/s f32 peak versus ~0.034 ms at
// 3.35 TB/s. This sum IS the unpaired MH density: the products stay IEEE f32
// FMA (no TF32, no bf16, so no tensor cores), although JAX's kernel runs at
// default precision, and the sums accumulate in f64. S1 ~ -sum y^2 + SSE
// cancels heavily at reference scale (|S1| ~ 1.7e6 against an ll of ~1.4e5):
// an f32 running sum over the tiles would put tenths of a nat of noise into
// every ll, and an f32 result alone up to 0.03 nats; the f64 sums keep the
// in-step lp0 recompute meaningful.
//
// Design (simple and right first): one block per (chain, 128 x 128 output
// tile); K runs through shared memory in chunks of 16, stored k-major so the
// inner loop reads rows as broadcasts and columns conflict-free; each of 256
// threads keeps an 8 x 8 register tile (rows ty + 16 i, columns tx + 16 j),
// 16 shared loads per 64 FMAs. The epilogue forms each cell's term
// m (m - 2 y) in f32, as JAX does, and adds it to f64 per-thread sums. The
// ragged edge is masked in the kernel: rows and columns past B or P load as
// zeros and are skipped in the epilogue, so they add nothing, as JAX's zero
// padding does. Each block reduces its two f64 partials (warp shuffles, then
// the 8 warps in order) into a scratch array; a second kernel reduces each
// chain's partials in a FIXED order (no atomics), so two launches on the same
// inputs agree bit for bit and no MH decision depends on the block schedule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;         // output tile edge along B and along P
constexpr int KC = 16;            // K chunk held in shared memory
constexpr int THREADS = 256;      // 16 x 16 threads, 8 x 8 cells each
constexpr int CELLS = TILE / 16;  // cells per thread along each edge
constexpr int LD = TILE + 1;      // padded shared row for the transposed stores
constexpr int NSUM = 2;           // S1, S2
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS, 2)
merge_tiles(const float* __restrict__ bout, const float* __restrict__ tout,
            const float* __restrict__ y, double* __restrict__ partials,
            int B, int P, int K) {
  __shared__ float sb[KC][LD];
  __shared__ float st[KC][LD];
  __shared__ double red[NSUM][THREADS / 32];

  const int c = blockIdx.z;
  const int row0 = blockIdx.y * TILE;   // along B
  const int col0 = blockIdx.x * TILE;   // along P
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* bo = bout + (size_t)c * B * K;
  const float* to = tout + (size_t)c * P * K;

  float m[CELLS][CELLS];
#pragma unroll
  for (int i = 0; i < CELLS; ++i)
#pragma unroll
    for (int j = 0; j < CELLS; ++j) m[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    // consecutive threads read consecutive k of one feature row
    for (int e = tid; e < TILE * KC; e += THREADS) {
      const int r = e / KC;
      const int kk = e % KC;
      const int k = k0 + kk;
      const bool kin = k < K;
      const int br = row0 + r;
      const int pr = col0 + r;
      sb[kk][r] = (kin && br < B) ? bo[(size_t)br * K + k] : 0.f;
      st[kk][r] = (kin && pr < P) ? to[(size_t)pr * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[CELLS], b[CELLS];
#pragma unroll
      for (int i = 0; i < CELLS; ++i) {
        a[i] = sb[kk][ty + 16 * i];
        b[i] = st[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < CELLS; ++i)
#pragma unroll
        for (int j = 0; j < CELLS; ++j) m[i][j] = fmaf(a[i], b[j], m[i][j]);
    }
    __syncthreads();
  }

  double s1 = 0.0, s2 = 0.0;
#pragma unroll
  for (int i = 0; i < CELLS; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < CELLS; ++j) {
      const int p = col0 + tx + 16 * j;
      if (p >= P) continue;
      const float x = m[i][j];
      const float yv = y[(size_t)r * P + p];
      s1 += (double)(x * (x - 2.f * yv));
      s2 += (double)x;
    }
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const double w1 = warp_sum(s1);
  const double w2 = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = w1;
    red[1][warp] = w2;
  }
  __syncthreads();
  if (tid < NSUM) {
    double acc = 0.0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) acc += red[tid][w];
    const size_t nblk = (size_t)gridDim.x * gridDim.y;
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    partials[((size_t)c * nblk + blk) * NSUM + tid] = acc;
  }
}

// one block per chain: strided f64 sums per thread, then a fixed-order tree
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_partials(const double* __restrict__ partials, double* __restrict__ out,
                int nblk) {
  __shared__ double red[NSUM][REDUCE_THREADS];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  double acc[NSUM] = {0.0, 0.0};
  for (int i = tid; i < nblk; i += REDUCE_THREADS) {
    const double* p = partials + ((size_t)c * nblk + i) * NSUM;
#pragma unroll
    for (int v = 0; v < NSUM; ++v) acc[v] += p[v];
  }
#pragma unroll
  for (int v = 0; v < NSUM; ++v) red[v][tid] = acc[v];
  __syncthreads();
  for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int v = 0; v < NSUM; ++v) red[v][tid] += red[v][tid + s];
    }
    __syncthreads();
  }
  if (tid < NSUM) out[(size_t)c * NSUM + tid] = red[tid][0];
}

}  // namespace

extern "C" {

// doubles of scratch the wrapper allocates per chain for the block partials
int vihmc_merge_sums_scratch(int B, int P) {
  return ((B + TILE - 1) / TILE) * ((P + TILE - 1) / TILE) * NSUM;
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// bout (C, B, K), tout (C, P, K), y (B, P) are contiguous f32 device arrays;
// partials (C, scratch(B, P)) and out (C, 2) are f64.
int vihmc_merge_sums(const float* bout, const float* tout, const float* y,
                     double* partials, double* out, int C, int B, int P, int K,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((P + TILE - 1) / TILE, (B + TILE - 1) / TILE, C);
  merge_tiles<<<grid, THREADS, 0, st>>>(bout, tout, y, partials, B, P, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<C, REDUCE_THREADS, 0, st>>>(partials, out,
                                                (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

}  // extern "C"
