// Paired MH log-density sums of the DeepONet merge, chain-batched, for Hopper.
//
// Replaces the Pallas TPU kernels `_paired_sums_pallas` /
// `_paired_sums_pallas_batched` (vihmc_tpu/ops/deeponet_merge.py:304-375,
// bodies `_paired_kernel` / `_paired_batched_kernel`), which `fused_paired_delta`
// launches once per draw for all chains.
//
// For every chain c, with m1 = bout1[c] @ tout1[c]^T and m0 = bout0[c] @ tout0[c]^T
// over the (B, P) grid, it returns
//
//     D  = sum (m1 - m0) (m1 + m0 - 2 y)      Bd = sum (m1 - m0)
//     Sm = sum (m1 + m0)                      Q1 = sum m1^2        C1 = sum m1 y
//
// without writing either (B, P) product to device memory. y (B, P) is shared
// by all chains. The host-side closure (vihmc_torch/ops/deeponet_merge.py)
// turns these into (delta log-likelihood, lp1).
//
// What bounds it on an H100: f32 FMA. Per chain it does 4 B P K flops of
// products (2 B P K per merge) against (2 B K + 2 P K) * 4 bytes of features;
// at the operator row (C = 48, B = 1000, P = 10201, K = 100) that is
// 1.96e11 flop per draw against ~0.43 GB of features plus the 41 MB y, which
// stays resident in the 50 MB L2 across chains: ~2.9 ms at the 67 TFLOP/s f32
// peak versus ~0.14 ms at 3.35 TB/s. The products must stay IEEE f32 -- TF32
// or bf16 would put ~1e-3-relative noise into m1 - m0, the noise the paired
// form exists to remove -- so the tensor cores are not used here.
//
// Design (simple and right first): one block per (chain, 64 x 64 output
// tile); K runs through shared memory in chunks of 16, stored k-major so the
// inner product loop reads rows as broadcasts and columns conflict-free; each
// of 256 threads keeps a 4 x 4 register tile of BOTH products (rows ty + 16 i,
// columns tx + 16 j) and folds them into the five sums in the epilogue. The
// ragged edge is masked in the kernel: rows and columns past B or P load as
// zeros and are skipped in the epilogue, so they add nothing, as JAX's zero
// padding does. Each block reduces its five f32 partials (warp shuffles, then
// the 8 warps in order) into a scratch array; a second kernel reduces each
// chain's partials in a FIXED order in f64 (no atomics), so an MH decision
// never depends on the block schedule. Faster variants (3xTF32 split products
// on the tensor cores, reuse of the accepted endpoint's features) are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // output tile edge along B and along P
constexpr int KC = 16;            // K chunk held in shared memory
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 cells each
constexpr int LD = TILE + 1;      // padded shared row: conflict-free transposed stores
constexpr int NSUM = 5;           // D, Bd, Sm, Q1, C1
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
paired_tiles(const float* __restrict__ bout1, const float* __restrict__ tout1,
             const float* __restrict__ bout0, const float* __restrict__ tout0,
             const float* __restrict__ y, float* __restrict__ partials,
             int B, int P, int K) {
  __shared__ float sb1[KC][LD];
  __shared__ float sb0[KC][LD];
  __shared__ float st1[KC][LD];
  __shared__ float st0[KC][LD];
  __shared__ float red[NSUM][THREADS / 32];

  const int c = blockIdx.z;
  const int row0 = blockIdx.y * TILE;   // along B
  const int col0 = blockIdx.x * TILE;   // along P
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* b1 = bout1 + (size_t)c * B * K;
  const float* b0 = bout0 + (size_t)c * B * K;
  const float* t1 = tout1 + (size_t)c * P * K;
  const float* t0 = tout0 + (size_t)c * P * K;

  float m1[4][4], m0[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { m1[i][j] = 0.f; m0[i][j] = 0.f; }

  for (int k0 = 0; k0 < K; k0 += KC) {
    // consecutive threads read consecutive k of one feature row
    for (int e = tid; e < TILE * KC; e += THREADS) {
      const int r = e / KC;
      const int kk = e % KC;
      const int k = k0 + kk;
      const bool kin = k < K;
      const int br = row0 + r;
      const int pr = col0 + r;
      const bool bin = kin && br < B;
      const bool pin = kin && pr < P;
      sb1[kk][r] = bin ? b1[(size_t)br * K + k] : 0.f;
      sb0[kk][r] = bin ? b0[(size_t)br * K + k] : 0.f;
      st1[kk][r] = pin ? t1[(size_t)pr * K + k] : 0.f;
      st0[kk][r] = pin ? t0[(size_t)pr * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a1[4], a0[4], c1[4], c0[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a1[i] = sb1[kk][ty + 16 * i];
        a0[i] = sb0[kk][ty + 16 * i];
        c1[i] = st1[kk][tx + 16 * i];
        c0[i] = st0[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m1[i][j] = fmaf(a1[i], c1[j], m1[i][j]);
          m0[i][j] = fmaf(a0[i], c0[j], m0[i][j]);
        }
    }
    __syncthreads();
  }

  float s[NSUM] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = col0 + tx + 16 * j;
      if (p >= P) continue;
      const float yv = y[(size_t)r * P + p];
      const float x1 = m1[i][j];
      const float x0 = m0[i][j];
      const float dm = x1 - x0;
      const float sm = x1 + x0;
      s[0] += dm * (sm - 2.f * yv);
      s[1] += dm;
      s[2] += sm;
      s[3] += x1 * x1;
      s[4] += x1 * yv;
    }
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
#pragma unroll
  for (int v = 0; v < NSUM; ++v) {
    const float w = warp_sum(s[v]);
    if (lane == 0) red[v][warp] = w;
  }
  __syncthreads();
  if (tid < NSUM) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) acc += red[tid][w];
    const size_t nblk = (size_t)gridDim.x * gridDim.y;
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    partials[((size_t)c * nblk + blk) * NSUM + tid] = acc;
  }
}

// one block per chain: strided f64 sums per thread, then a fixed-order tree
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_partials(const float* __restrict__ partials, float* __restrict__ out,
                int nblk) {
  __shared__ double red[NSUM][REDUCE_THREADS];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  double acc[NSUM] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = tid; i < nblk; i += REDUCE_THREADS) {
    const float* p = partials + ((size_t)c * nblk + i) * NSUM;
#pragma unroll
    for (int v = 0; v < NSUM; ++v) acc[v] += (double)p[v];
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
  if (tid < NSUM) out[(size_t)c * NSUM + tid] = (float)red[tid][0];
}

}  // namespace

extern "C" {

// floats of scratch the wrapper allocates per chain for the block partials
int vihmc_paired_sums_scratch(int B, int P) {
  return ((B + TILE - 1) / TILE) * ((P + TILE - 1) / TILE) * NSUM;
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// All pointers are contiguous f32 device arrays: bout1/bout0 (C, B, K),
// tout1/tout0 (C, P, K), y (B, P), partials (C, scratch(B, P)), out (C, 5).
int vihmc_paired_sums(const float* bout1, const float* tout1,
                      const float* bout0, const float* tout0, const float* y,
                      float* partials, float* out, int C, int B, int P, int K,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((P + TILE - 1) / TILE, (B + TILE - 1) / TILE, C);
  paired_tiles<<<grid, THREADS, 0, st>>>(bout1, tout1, bout0, tout0, y,
                                         partials, B, P, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<C, REDUCE_THREADS, 0, st>>>(partials, out,
                                                (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

}  // extern "C"
