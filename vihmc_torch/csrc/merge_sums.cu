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
// Split products (split_mma.cuh): this sum IS the unpaired MH density, so the
// product keeps f32 accuracy: each f32 operand is split into three bf16 parts
// and the product is the sum of the six leading part products on the tensor
// cores (wgmma, f32 accumulators; a fresh accumulator per K chunk, because the
// tensor cores round toward zero, with the truncation's mean added back), the
// scheme of the TPU's Precision.HIGHEST.
// A single bf16 or TF32 pass would put ~1e-3-relative noise into every m. The
// sums accumulate in f64: S1 ~ -sum y^2 + SSE cancels heavily at reference
// scale (|S1| ~ 1.7e6 against an ll of ~1.4e5); an f32 running sum over the
// tiles would put tenths of a nat of noise into every ll, and an f32 result
// alone up to 0.03 nats.
//
// Bounds on an H100 SXM at 700 W, at the stage-3 shape (C = 16, B = 1000,
// P = 10201, K = 100): the product is 3.264e10 flop per call, 0.497 ms at the
// 67 TFLOP/s f32-FMA peak with the epilogue (the ceiling of the CUDA-core
// design) and, as six bf16 products, 0.198 ms at the 989 TFLOP/s dense bf16
// peak: the bound this kernel is held against. The inputs (72 MB of features,
// 41 MB of y) take 0.034 ms at 3.35 TB/s.
//
// Traffic the design reckons with (not measured): one 128 x 128 tile per
// block, 640 blocks walking all 16 chains. Each block reads its y tile once
// into shared memory (41 MB in all, not the 0.65 GB of one read per chain).
// Features cross the L2 P/128 = 80 times (bout) and B/128 = 8 times (tout):
// 16 x (32 + 33) MB = 1.04 GB per call, by TMA boxes into a 5-stage ring.
//
// What the design does about the old one's limits: the product runs on the
// tensor cores instead of f32 FMA; K arrives by TMA into a ring filled by a
// producer thread while the consumers multiply, with no block-wide barrier
// per chunk; K pads to 112 in shared memory only (the TMA box's zero fill);
// y is read once per tile, not once per chain. What holds it back now: the
// producer's split of the B tiles, repeated by the 8 blocks of a P column.
//
// Epilogue, as before: each cell's term m (m - 2 y) is formed in f32, as JAX
// does, and added to f64 per-thread sums; each warp reduces its two f64 sums
// by shuffles into its own slot of a scratch array, and a second kernel adds
// each chain's slots in a FIXED order (no atomics), so two launches on the same
// inputs agree bit for bit and no MH decision depends on the block schedule.

// The small-problem kernel (merge_small, the wrapper's path at C <= 2 and at
// B < 128; its design is in split_mma.cuh, namespace small) replaces the
// unbatched `_merge_sums_pallas` (vihmc_tpu/ops/deeponet_merge.py:72) and
// the batched one at B < 128. Its bounds on an H100 SXM at 700 W:
//   - C = 1, B = 1000 (--extras' fused gradient), P = 10201, K = 100:
//     2.081e9 flop, 0.031 ms at the f32-FMA peak; six bf16 part products
//     0.0124 ms at the bf16 peak, below the 45 MB of inputs at 3.35 TB/s,
//     0.0135 ms: the split tensor-core bound is the byte bound;
//   - C = 1, B = 10 (hmc_nuts, num_chains=1): 2.08e7 flop (0.0003 ms) against
//     4.5 MB of inputs, 0.0013 ms: bytes, and a launch's own latency, bound it.
// What it does about the tiled path's limits at these shapes:
//   - 640 blocks of one 169 KB block per SM ran about 4.85 bare waves at
//     C = 1: here 2560 blocks of 128 threads and 30 KB (12 KB of part tiles,
//     16 KB of y), five on each SM, whose loads, splits and epilogues overlap
//     each other's products;
//   - 118 of 128 rows were zeros at B = 10: here P is wgmma's M side and B
//     pads only to 16, so the ceil(P / 64) = 160 blocks all do useful rows;
//   - the staged y tile and its up-front load: each thread's y cells are
//     copied once, asynchronously, while the block multiplies;
//   - the fixed-order reduction's second launch (one 256-thread block at
//     C = 1): the last block of each chain adds the chain's slots itself, in
//     a fixed order.
// What holds it back (found on an NVIDIA H100 80GB HBM3 at 700 W): each
// block runs its 7 chunks as a chain of dependent steps (load, split,
// barrier, six wgmmas, wait, fold), so instruction dispatch and latency
// bound it more than the tensor cores or bytes do; each bout row is split
// again by all 160 blocks of its B tile, each tout row by the 16 B tiles.
// Loading two chunks ahead, or splitting chunk c + 1 while chunk c's batch ran, took more
// registers and so fewer blocks per SM, and was slower; so was a pre-pass
// that split bout once per call into an image the blocks copied (its launch
// cost more than the per-block split it saved).

#include "split_mma.cuh"

namespace {

using namespace split_mma;

constexpr int NSUM = 2;  // S1, S2
constexpr int REDUCE_THREADS = 256;
constexpr int STAGES = 5;
constexpr int SMEM_BYTES = launch_smem(1, STAGES);  // 169 KB: one block per SM

template <bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
merge_tiles(const __grid_constant__ TmaMaps<2> maps,
            const float* __restrict__ bout, const float* __restrict__ tout,
            const float* __restrict__ y, double* __restrict__ partials,
            int C, int B, int P, int K) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = align_smem(smem_raw);
  float* ys = reinterpret_cast<float*>(smem + y_offset(1, STAGES));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const size_t ntiles = (size_t)gridDim.x * gridDim.y;
  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;

  load_y_tile(ys, y, B, P, row0, col0, tid);
  const float* const fa[1] = {bout};
  const float* const fb[1] = {tout};
  walk_chains<1, STAGES, TMA>(smem, maps, fa, fb, C, B, P, K, row0, col0,
                      [&](int c, float (&acc)[1][NACC]) {
    double s1 = 0.0, s2 = 0.0;
    for_each_cell(ys, tid, [&](int i, float yv) {
      const float x = acc[0][i];
      s1 += (double)(x * (x - 2.f * yv));
      s2 += (double)x;
    });
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      double* out = partials + (((size_t)c * ntiles + tile) * WARPS + warp) * NSUM;
      out[0] = s1;
      out[1] = s2;
    }
  });
}

// one block per chain: strided f64 sums per thread, then a fixed-order tree
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_partials(const double* __restrict__ partials, double* __restrict__ out, int nslot) {
  __shared__ double red[NSUM][REDUCE_THREADS];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  double acc[NSUM] = {0.0, 0.0};
  for (int i = tid; i < nslot; i += REDUCE_THREADS) {
    const double* p = partials + ((size_t)c * nslot + i) * NSUM;
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

template <bool TMA>
cudaError_t launch_tiles(const TmaMaps<2>& maps, const float* bout, const float* tout,
                         const float* y, double* partials, int C, int B, int P, int K,
                         cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(merge_tiles<TMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // B tiles vary fastest: a wave of blocks shares few tout rows per chain
  const dim3 grid((B + BM - 1) / BM, (P + BN - 1) / BN);
  merge_tiles<TMA><<<grid, THREADS, SMEM_BYTES, st>>>(maps, bout, tout, y, partials, C, B, P,
                                                      K);
  return cudaGetLastError();
}

// The small path: one chain and 64 P rows x NB B rows per block (split_mma.cuh).
// At NB = 64 its registers are capped so that 5 blocks share an SM: the
// card measured this faster than leaving the compiler its registers
// (more blocks hide more of each block's load and wgmma latency).
constexpr int SMALL_BLOCKS_PER_SM = 5;
template <int NB>
__global__ void __launch_bounds__(small::THREADS, NB == 64 ? SMALL_BLOCKS_PER_SM : 1)
merge_small(const float* __restrict__ bout, const float* __restrict__ tout,
            const float* __restrict__ y, double* __restrict__ slots,
            unsigned* __restrict__ tickets, double* __restrict__ out, int B, int P, int K,
            int vec) {
  extern __shared__ __align__(16) char smem[];
  const int c = blockIdx.z, p0 = blockIdx.x * small::MP, b0 = blockIdx.y * NB;
  const int nblk = gridDim.x * gridDim.y, blk = blockIdx.y * gridDim.x + blockIdx.x;
  const float* const fb[1] = {bout + ((size_t)c * B + b0) * K};
  const float* const fp[1] = {tout + ((size_t)c * P + p0) * K};
  float acc[1][NB / 2];
  float* ys = reinterpret_cast<float*>(smem + small::parts_bytes(1, NB));
  small::prefetch_y<NB>(ys, y + (size_t)b0 * P + p0, P, B - b0, P - p0, threadIdx.x);
  small::products<1, NB>(smem, fb, fp, B - b0, P - p0, K, vec != 0, acc);
  small::wait_y();
  double s[NSUM] = {0.0, 0.0};
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) {
    const float x = acc[0][i], yv = ys[i * small::THREADS + threadIdx.x];
    s[0] += (double)(x * (x - 2.f * yv));
    s[1] += (double)x;
  }
  small::fold<NSUM>(s, slots + (size_t)c * nblk * NSUM, tickets + c, out + (size_t)c * NSUM,
                    blk, nblk);
}

template <int NB>
cudaError_t launch_small(const float* bout, const float* tout, const float* y, double* slots,
                         unsigned* tickets, double* out, int C, int B, int P, int K, int vec,
                         cudaStream_t st) {
  const int bytes = small::smem_bytes(1, NB);
  cudaError_t err = cudaFuncSetAttribute(merge_small<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  merge_small<NB><<<small::grid(C, B, P), small::THREADS, bytes, st>>>(
      bout, tout, y, slots, tickets, out, B, P, K, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// doubles of scratch the wrapper allocates per chain: one slot per (tile, warp)
int vihmc_merge_sums_scratch(int B, int P) { return num_tiles(B, P) * WARPS * NSUM; }

// Launches both kernels on `stream`; returns a CUDA error code (0 = ok).
// bout (C, B, K), tout (C, P, K), y (B, P) are contiguous f32 device arrays;
// partials (C, scratch(B, P)) and out (C, 2) are f64.
int vihmc_merge_sums(const float* bout, const float* tout, const float* y,
                     double* partials, double* out, int C, int B, int P, int K,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TmaMaps<2> maps = {};
  const bool tma = K % 4 == 0 && aligned16(bout) && aligned16(tout);
  if (tma) {
    const int e = encode_maps<2>(maps, {bout, tout}, {B, P}, C, K);
    if (e != 0) return e;
  }
  cudaError_t err = tma ? launch_tiles<true>(maps, bout, tout, y, partials, C, B, P, K, st)
                        : launch_tiles<false>(maps, bout, tout, y, partials, C, B, P, K, st);
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<C, REDUCE_THREADS, 0, st>>>(partials, out, num_tiles(B, P) * WARPS);
  return (int)cudaGetLastError();
}

// The small path in one launch; returns a CUDA error code (0 = ok). Inputs
// as vihmc_merge_sums; slots (C, nblk, 2) f64 scratch, where nblk must be the
// kernel's blocks per chain (the wrapper's count, checked here); tickets (C)
// u32 counters that are 0 before the launch and are left at 0; out (C, 2).
int vihmc_merge_sums_small(const float* bout, const float* tout, const float* y,
                           double* slots, unsigned* tickets, double* out, int C, int B, int P,
                           int K, int nblk, void* stream) {
  if (nblk != small::blocks(B, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = K % 4 == 0 && aligned16(bout) && aligned16(tout);
  switch (small::tile_n(B)) {
    case 16: return (int)launch_small<16>(bout, tout, y, slots, tickets, out, C, B, P, K, vec, st);
    case 32: return (int)launch_small<32>(bout, tout, y, slots, tickets, out, C, B, P, K, vec, st);
    default: return (int)launch_small<64>(bout, tout, y, slots, tickets, out, C, B, P, K, vec, st);
  }
}

}  // extern "C"
