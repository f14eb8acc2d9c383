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
// Split products (split_mma.cuh): the JAX kernel takes both products at
// Precision.HIGHEST, f32 accuracy from the matrix unit. Here each f32 operand
// is split into three bf16 parts and each product is the sum of the six
// leading part products on the tensor cores (wgmma, f32 accumulators; a fresh
// accumulator per K chunk, because the tensor cores round toward zero, with
// the truncation's mean added back). A single bf16 or TF32 pass would put
// ~1e-3-relative noise into m1 - m0, the noise the paired form exists to
// remove; the split keeps the error at an IEEE f32 matmul's.
//
// Bounds on an H100 SXM at 700 W, at the operator row (C = 48, B = 1000,
// P = 10201, K = 100): the two products are 1.959e11 flop per call, 2.92 ms at
// the 67 TFLOP/s f32-FMA peak (3.011 ms with the epilogue: the ceiling of the
// CUDA-core design) and, as six bf16 products each, 1.188 ms at the
// 989 TFLOP/s dense bf16 peak: the bound this kernel is held against. The
// inputs (0.43 GB of features, 41 MB of y) take 0.14 ms at 3.35 TB/s.
//
// Traffic the design reckons with (not measured): one 128 x 128 tile per
// block, 640 blocks walking all 48 chains. Each block reads its y tile once
// into shared memory (41 MB in all; the old design read it once per chain,
// 1.96 GB). Per chain a block reads 128 rows of each of the four feature
// matrices (205 KB at K = 100), so features cross the L2 P/128 = 80 times
// (bout) and B/128 = 8 times (tout): 48 x (64 + 65) MB = 6.2 GB per call, by
// TMA boxes (copies of these 64-byte row pieces by cp.async stalled at their
// issue on the card).
//
// What the design does about the old one's limits: the products run on the
// tensor cores instead of f32 FMA with a 4 x 4 register tile; K arrives by TMA
// into a 3-stage ring filled by a producer thread while the consumers
// multiply, with no block-wide barrier per chunk; K pads to 112 in shared
// memory only (the TMA box's zero fill); y is read once per tile, not once
// per chain. What holds it back now: the split of each chunk's B tiles by the
// producer's three warps, repeated by the 8 blocks that share a P column.

// Epilogue, as before: per chain, each thread folds its cells of m1 and m0
// (dm = m1 - m0 and sm = m1 + m0 per cell, so q1 = q0 gives D = Bd = 0
// exactly: both products run the same instructions on the same bits) into
// five f32 sums; each warp reduces them by shuffles into its own slot of a
// scratch array, and a second kernel adds each chain's slots in a FIXED order
// in f64 (no atomics), so two launches agree bit for bit.

// The small-problem kernel (paired_small, the wrapper's path at C <= 2 and at
// B < 128; its design is in split_mma.cuh, namespace small) replaces the
// unbatched `_paired_sums_pallas` (vihmc_tpu/ops/deeponet_merge.py:304).
// Its bounds on an H100 SXM at 700 W:
//   - C = 1, B = 1000, P = 10201, K = 100: 4.203e9 flop with the epilogue,
//     0.063 ms at the f32-FMA peak; twelve bf16 part products 0.0248 ms at
//     the bf16 peak (the 50 MB of inputs take 0.0149 ms at 3.35 TB/s);
//   - C = 1, B = 10: 4.2e7 flop (0.0006 ms) against 8.6 MB of inputs,
//     0.0026 ms: bytes, and a launch's own latency, bound it.
// What it does about the tiled path's limits at these shapes: 2560 blocks of
// 128 threads and 45 KB instead of 640 blocks of 209 KB, three on each SM
// (its registers capped so), so one block's loads, splits and epilogue
// overlap another's products; P on wgmma's M side, so at small B the
// padding is at most 15 rows of 16, not 118 of 128; y copied once,
// asynchronously, while the block multiplies; no second launch: the last
// block of each chain adds the chain's slots in a fixed order. The sums per
// thread stay f32 (32 cells each, not 64) and the slots are added in f64.
// What holds it back: as merge_small (merge_sums.cu), with two products in
// each chunk's chain and 162 registers a thread, so three blocks an SM.

#include "split_mma.cuh"

namespace {

using namespace split_mma;

constexpr int NSUM = 5;  // D, Bd, Sm, Q1, C1
constexpr int REDUCE_THREADS = 256;
constexpr int STAGES = 3;
constexpr int SMEM_BYTES = launch_smem(2, STAGES);  // 209 KB: one block per SM

template <bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
paired_tiles(const __grid_constant__ TmaMaps<4> maps,
             const float* __restrict__ bout1, const float* __restrict__ tout1,
             const float* __restrict__ bout0, const float* __restrict__ tout0,
             const float* __restrict__ y, float* __restrict__ partials,
             int C, int B, int P, int K) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = align_smem(smem_raw);
  float* ys = reinterpret_cast<float*>(smem + y_offset(2, STAGES));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const size_t ntiles = (size_t)gridDim.x * gridDim.y;
  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;

  load_y_tile(ys, y, B, P, row0, col0, tid);
  const float* const fa[2] = {bout1, bout0};  // product 0 is m1, product 1 is m0
  const float* const fb[2] = {tout1, tout0};
  walk_chains<2, STAGES, TMA>(smem, maps, fa, fb, C, B, P, K, row0, col0,
                      [&](int c, float (&acc)[2][NACC]) {
    float s[NSUM] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for_each_cell(ys, tid, [&](int i, float yv) {
      const float x1 = acc[0][i];
      const float x0 = acc[1][i];
      const float dm = x1 - x0;
      const float sm = x1 + x0;
      s[0] += dm * (sm - 2.f * yv);
      s[1] += dm;
      s[2] += sm;
      s[3] += x1 * x1;
      s[4] += x1 * yv;
    });
#pragma unroll
    for (int v = 0; v < NSUM; ++v) s[v] = warp_sum(s[v]);
    if (lane == 0) {
      float* out = partials + (((size_t)c * ntiles + tile) * WARPS + warp) * NSUM;
#pragma unroll
      for (int v = 0; v < NSUM; ++v) out[v] = s[v];
    }
  });
}

// one block per chain: strided f64 sums per thread, then a fixed-order tree
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_partials(const float* __restrict__ partials, float* __restrict__ out, int nslot) {
  __shared__ double red[NSUM][REDUCE_THREADS];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  double acc[NSUM] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = tid; i < nslot; i += REDUCE_THREADS) {
    const float* p = partials + ((size_t)c * nslot + i) * NSUM;
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

template <bool TMA>
cudaError_t launch_tiles(const TmaMaps<4>& maps, const float* bout1, const float* tout1,
                         const float* bout0, const float* tout0, const float* y,
                         float* partials, int C, int B, int P, int K, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(paired_tiles<TMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // B tiles vary fastest: a wave of blocks shares few tout rows per chain
  const dim3 grid((B + BM - 1) / BM, (P + BN - 1) / BN);
  paired_tiles<TMA><<<grid, THREADS, SMEM_BYTES, st>>>(maps, bout1, tout1, bout0, tout0, y,
                                                       partials, C, B, P, K);
  return cudaGetLastError();
}

// The small path: one chain and 64 P rows x NB B rows per block (split_mma.cuh).
// At NB = 64 its registers are capped so that 3 blocks share an SM: the
// card measured this faster than leaving the compiler its registers
// (more blocks hide more of each block's load and wgmma latency).
constexpr int SMALL_BLOCKS_PER_SM = 3;
template <int NB>
__global__ void __launch_bounds__(small::THREADS, NB == 64 ? SMALL_BLOCKS_PER_SM : 1)
paired_small(const float* __restrict__ bout1, const float* __restrict__ tout1,
             const float* __restrict__ bout0, const float* __restrict__ tout0,
             const float* __restrict__ y, double* __restrict__ slots,
             unsigned* __restrict__ tickets, float* __restrict__ out, int B, int P, int K,
             int vec) {
  extern __shared__ __align__(16) char smem[];
  const int c = blockIdx.z, p0 = blockIdx.x * small::MP, b0 = blockIdx.y * NB;
  const int nblk = gridDim.x * gridDim.y, blk = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t ob = ((size_t)c * B + b0) * K, op = ((size_t)c * P + p0) * K;
  const float* const fb[2] = {bout1 + ob, bout0 + ob};  // product 0 is m1, product 1 is m0
  const float* const fp[2] = {tout1 + op, tout0 + op};
  float acc[2][NB / 2];
  float* ys = reinterpret_cast<float*>(smem + small::parts_bytes(2, NB));
  small::prefetch_y<NB>(ys, y + (size_t)b0 * P + p0, P, B - b0, P - p0, threadIdx.x);
  small::products<2, NB>(smem, fb, fp, B - b0, P - p0, K, vec != 0, acc);
  small::wait_y();
  float s[NSUM] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) {
    const float x1 = acc[0][i];
    const float x0 = acc[1][i];
    const float dm = x1 - x0;
    const float sm = x1 + x0;
    const float yv = ys[i * small::THREADS + threadIdx.x];
    s[0] += dm * (sm - 2.f * yv);
    s[1] += dm;
    s[2] += sm;
    s[3] += x1 * x1;
    s[4] += x1 * yv;
  }
  small::fold<NSUM>(s, slots + (size_t)c * nblk * NSUM, tickets + c, out + (size_t)c * NSUM,
                    blk, nblk);
}

template <int NB>
cudaError_t launch_small(const float* bout1, const float* tout1, const float* bout0,
                         const float* tout0, const float* y, double* slots, unsigned* tickets,
                         float* out, int C, int B, int P, int K, int vec, cudaStream_t st) {
  const int bytes = small::smem_bytes(2, NB);
  cudaError_t err = cudaFuncSetAttribute(paired_small<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  paired_small<NB><<<small::grid(C, B, P), small::THREADS, bytes, st>>>(
      bout1, tout1, bout0, tout0, y, slots, tickets, out, B, P, K, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// floats of scratch the wrapper allocates per chain: one slot per (tile, warp)
int vihmc_paired_sums_scratch(int B, int P) { return num_tiles(B, P) * WARPS * NSUM; }

// Launches both kernels on `stream`; returns a CUDA error code (0 = ok).
// All pointers are contiguous f32 device arrays: bout1/bout0 (C, B, K),
// tout1/tout0 (C, P, K), y (B, P), partials (C, scratch(B, P)), out (C, 5).
int vihmc_paired_sums(const float* bout1, const float* tout1,
                      const float* bout0, const float* tout0, const float* y,
                      float* partials, float* out, int C, int B, int P, int K,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TmaMaps<4> maps = {};
  const bool tma = K % 4 == 0 && aligned16(bout1) && aligned16(tout1) && aligned16(bout0) &&
                   aligned16(tout0);
  if (tma) {  // A tiles (bout1, bout0), then B tiles (tout1, tout0)
    const int e = encode_maps<4>(maps, {bout1, bout0, tout1, tout0}, {B, B, P, P}, C, K);
    if (e != 0) return e;
  }
  cudaError_t err = tma ? launch_tiles<true>(maps, bout1, tout1, bout0, tout0, y, partials, C,
                                             B, P, K, st)
                        : launch_tiles<false>(maps, bout1, tout1, bout0, tout0, y, partials, C,
                                              B, P, K, st);
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<C, REDUCE_THREADS, 0, st>>>(partials, out, num_tiles(B, P) * WARPS);
  return (int)cudaGetLastError();
}

// The small path in one launch; returns a CUDA error code (0 = ok). Inputs
// as vihmc_paired_sums; slots (C, nblk, 5) f64 scratch, where nblk must be
// the kernel's blocks per chain (the wrapper's count, checked here); tickets
// (C) u32 counters that are 0 before the launch and are left at 0; out (C, 5).
int vihmc_paired_sums_small(const float* bout1, const float* tout1, const float* bout0,
                            const float* tout0, const float* y, double* slots,
                            unsigned* tickets, float* out, int C, int B, int P, int K, int nblk,
                            void* stream) {
  if (nblk != small::blocks(B, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = K % 4 == 0 && aligned16(bout1) && aligned16(tout1) && aligned16(bout0) &&
                  aligned16(tout0);
  switch (small::tile_n(B)) {
    case 16:
      return (int)launch_small<16>(bout1, tout1, bout0, tout0, y, slots, tickets, out, C, B, P,
                                   K, vec, st);
    case 32:
      return (int)launch_small<32>(bout1, tout1, bout0, tout0, y, slots, tickets, out, C, B, P,
                                   K, vec, st);
    default:
      return (int)launch_small<64>(bout1, tout1, bout0, tout0, y, slots, tickets, out, C, B, P,
                                   K, vec, st);
  }
}

}  // extern "C"
