// The bf16 Gram field's two tanh feature stacks (DeepONet branch and trunk),
// chain-batched, as fused layers for Hopper: pack, forward and backward.
//
// Replaces no TPU kernel: the JAX field runs the stacks as XLA matmuls. On the
// card the same stacks ran as one cuBLAS GEMM, a bias add and a tanh per layer,
// and autograd mirrored them (tanh backward, bias sum and two GEMMs per layer),
// all on 200-byte bf16 rows (width 100) that keep cuBLAS on sm75/sm80 kernels:
// ~39 ms of a 63 ms draw of the operator row (4 field calls).
//
// Layout. Every layer's output width pads to WP = 112 and every input width to
// a multiple of 16 (5 -> 16, 100 and 101 -> 112), so each operand row starts on
// 16 bytes and wgmma's K runs in whole chunks of 16. Zero weights make the
// padding exact. One padded input column (the last) holds 1: the inputs carry
// it, and each hidden layer's bias is PAD_BIAS there (tanh(16) rounds to 1),
// so the weight gradient's last column is the bias gradient, summed by the
// same products. Packed weights and smem tiles use one "blocked" layout: 8-row
// groups of kp * 16 bytes, each a run of 8 x 8 core matrices along k. It is
// wgmma's K-major layout without swizzle (LBO 128 bytes, SBO kp * 16), and,
// read with the rows as K, its MN-major layout (LBO kp * 16, SBO 128): the
// weight gradient takes g^T and y from the very tiles the other product uses.
//
//   pack           one launch: the f32 flat (C, D) vector -> per chain and
//                  layer a bf16 tile of W (forward) and of W^T (backward) and
//                  the f32 bias. Rounded once, to nearest.
//   stack_forward  one launch for both stacks: a block takes one chain and 128
//                  rows and runs every layer with the activation in registers
//                  (two warpgroups of 64 rows; the f32 accumulator of one
//                  wgmma m64n112k16 chain is the A fragment of the next layer
//                  once rounded to bf16). W of the next layer arrives by
//                  cp.async while this one multiplies. Epilogue in f32: bias,
//                  tanh, one rounding to bf16; the rows the backward reads go
//                  out through shared memory in 16-byte stores. The last layer
//                  adds its bias and stores the features.
//   layer_backward one launch per layer for both stacks: a block takes one
//                  chain and walks a run of 128-row tiles, each g (the
//                  cotangent at the layer's output) and y (the layer's input,
//                  112 wide) tile staged by cp.async into a two-stage ring.
//                  wgmma gives g W (A = the g tile, B = W^T); the epilogue
//                  multiplies by 1 - y^2 in f32, rounds once to bf16 and
//                  stores g_below through shared memory. dW = g^T y (bias in
//                  the last column) accumulates in f32 by wgmma on the same
//                  two tiles read transposed, in flight during those stores.
//                  Each block writes its f32 partial into a slot; the last
//                  block of a chain (an integer ticket) adds the slots in a
//                  fixed order and writes the f32 result into the (C, D)
//                  gradient at the layer's offsets. No float atomics: two calls
//                  agree bit for bit, so the field stays deterministic.
//
// Bounds on an H100 SXM at 700 W, at the operator row (C = 48, B = 1000,
// P = 10,201, K = 100, nine layers per stack; reckoned, not measured; each
// input read and each output written once, at the layers' own widths): the
// forward moves 1.00 GB, 0.30 ms at 3.35 TB/s (87.5 GFLOP, 0.09 ms at 989
// TFLOP/s); the backward 2.74 GB, 0.82 ms (173.5 GFLOP, 0.18 ms). Bytes bound
// both. What the design does about it: no pre-activation, bias or tanh-
// derivative pass reaches device memory, every activation is written once and
// read once, and W stays on chip for all the tiles a block walks. What holds
// it back (measured on the card, chip_smoke.py): the backward's blocks are
// short-lived, so each pays its first tile's load and its slot unhidden, and
// its tile loads overlap the products only in part; the forward's tanh costs
// a quarter of its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "split_mma.cuh"  // smem_addr, fence_proxy_async

namespace {

using split_mma::fence_proxy_async;
using split_mma::smem_addr;

constexpr int WP = 112;                   // padded output width of every layer
constexpr int NJ = WP / 8;                // accumulator column groups of 8
constexpr int NK = WP / 16;               // k chunks of a padded width
constexpr int TR = 128;                   // rows of a block's tile: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int MAX_LAYERS = 16;
constexpr int TILE_BYTES = WP * WP * 2;   // one packed weight tile
constexpr int ROWS_BYTES = TR * WP * 2;   // one staged g or y tile
constexpr int STAGES = 2;                 // the backward's ring of (g, y) tile pairs
constexpr int MAX_SPLITS = 16;            // backward blocks per chain and stack, at most
constexpr int SROW = WP * 2 + 16;         // a staged output row: 240 bytes, so the
                                          // epilogue's 4-byte writes hit 32 banks
constexpr int STAGE_OUT = 64 * SROW;      // one warpgroup's staged output rows
constexpr int FWD_SMEM = 2 * TILE_BYTES + 2 * STAGE_OUT;
constexpr int BWD_SMEM = TILE_BYTES + STAGES * 2 * ROWS_BYTES + 2 * STAGE_OUT;
constexpr float PAD_BIAS = 16.f;          // tanh(16) rounds to 1: the ones column

struct Layer {
  int b, w, din, dout;  // offsets of bias and weight in the flat vector, widths
};

struct Stack {
  const __nv_bfloat16* x;  // (n, kin) shared input, ones in column kin - 1
  __nv_bfloat16* acts;     // (nl - 1, C, n, WP) tanh outputs
  __nv_bfloat16* out;      // (C, n, dout of the last layer) features
  __nv_bfloat16* wf;       // (C, nl, WP * WP) tiles of W
  __nv_bfloat16* wb;       // (C, nl, WP * WP) tiles of W^T (layer 0's unused)
  float* bias;             // (C, nl, WP)
  int n, kin, nl, tiles;
  Layer layer[MAX_LAYERS];
};

struct Stacks {
  Stack s[2];  // branch, trunk
  int C;
  long long D;
  const float* flat;  // (C, D)
};

struct Step {  // one layer of one stack in a backward launch
  const __nv_bfloat16* g;   // (C, n, gld) cotangent at the layer's output
  const __nv_bfloat16* y;   // the layer's input: chain stride y_cs (0: shared x)
  __nv_bfloat16* gout;      // (C, n, WP) cotangent at the layer below, or null
  const __nv_bfloat16* wb;  // the layer's W^T tile of chain 0; chain stride wb_cs
  float* slots;             // (C, splits, WP * kin) partial weight gradients
  unsigned* tickets;        // (C) counters, 0 before the launch and after it
  float* grad;              // (C, D)
  long long g_cs, y_cs, wb_cs, D;
  int gld, gwidth, gvec, yld, kin, yvec, n, tiles, splits, per_block;
  Layer layer;
};

struct Steps {
  Step s[2];
  int blocks0;  // blocks of step 0; the rest belong to step 1
};

// byte offset of (r, k) in a blocked bf16 tile of width kp (header note)
__host__ __device__ __forceinline__ int blk(int r, int k, int kp) {
  return (r >> 3) * (kp * 16) + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// wgmma descriptor without swizzle: start p, leading and stride byte offsets
__device__ __forceinline__ uint64_t make_desc(const void* p, int lbo, int sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}

// a blocked tile of width kp at p as a K-major operand (rows are M or N):
// the next 8 k 128 bytes on, the next 8 rows kp * 16 bytes on
__device__ __forceinline__ uint64_t desc(const void* p, int kp) {
  return make_desc(p, 128, kp * 16);
}

// The same tile as an MN-major operand, its rows the K dimension and its
// columns M or N (the weight gradient's g^T and y): a core matrix is 8
// columns x 8 rows, 128 contiguous bytes either way. The leading offset
// steps K (8 rows: kp * 16 bytes), the stride offset steps M or N (8
// columns: 128 bytes); the other way round gives garbage on the card.
__device__ __forceinline__ uint64_t desc_mn(const void* p, int kp) {
  return make_desc(p, kp * 16, 128);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return reinterpret_cast<const uint32_t&>(b);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162&>(v));
}

// ---- cp.async ----

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// `bytes` (a multiple of 16) from src to dst, 16 at a time over the block
__device__ __forceinline__ void copy_linear(char* dst, const void* src, int bytes, int tid) {
  const char* s = static_cast<const char*>(src);
  for (int o = 16 * tid; o < bytes; o += 16 * THREADS) cp_async<16>(dst + o, s + o, 16);
}

// Rows [row0, row0 + TR) of a (n, ld) bf16 matrix into a blocked tile WP
// wide, VEC elements per copy (ld, width and the base are VEC-aligned);
// columns at or past `width` and rows at or past n arrive as zeros.
template <int VEC>
__device__ __forceinline__ void load_rows_vec(char* dst, const __nv_bfloat16* src, int n, int ld,
                                              int width, int row0, int tid) {
  constexpr int PER_ROW = WP / VEC;
#pragma unroll 4
  for (int e = tid; e < TR * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, k = (e - r * PER_ROW) * VEC, gr = row0 + r;
    const bool ok = gr < n && k < width;
    cp_async<2 * VEC>(dst + blk(r, k, WP), ok ? src + (size_t)gr * ld + k : src, ok ? 2 * VEC : 0);
  }
}

__device__ __forceinline__ void load_rows(char* dst, const __nv_bfloat16* src, int n, int ld,
                                          int width, int row0, int vec, int tid) {
  if (vec == 8) load_rows_vec<8>(dst, src, n, ld, width, row0, tid);
  else if (vec == 4) load_rows_vec<4>(dst, src, n, ld, width, row0, tid);
  else load_rows_vec<2>(dst, src, n, ld, width, row0, tid);
}

// ---- output rows through shared memory ----

// barrier of warpgroup wg alone (barrier 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// the accumulator pair (row r, columns col, col + 1) of a warpgroup's
// epilogue into its staged rows
__device__ __forceinline__ void stage_pair(char* stg, int r, int col, uint32_t v) {
  *reinterpret_cast<uint32_t*>(stg + r * SROW + 2 * col) = v;
}

// The first `bytes` of a warpgroup's 64 staged rows to rows [row0, row0 + 64)
// of a row-major matrix of `ld` bytes a row (rows at or past n left out), CH
// bytes a copy, consecutive threads on consecutive chunks of a row: whole
// sectors instead of the 16 bytes a row that the accumulator's layout gives.
template <int CH>
__device__ __forceinline__ void rows_out(const char* stg, char* dst, int n, int row0, int bytes,
                                         int ld, int t) {
  using V = typename std::conditional<CH == 16, uint4, uint2>::type;
  const int per = bytes / CH;
  for (int e = t; e < 64 * per; e += 128) {
    const int r = e / per, k = e - r * per;
    if (row0 + r < n)
      *reinterpret_cast<V*>(dst + (size_t)(row0 + r) * ld + k * CH) =
          *reinterpret_cast<const V*>(stg + r * SROW + k * CH);
  }
}

// ---- wgmma m64n112k16, f32 accumulators ----

#define VIHMC_D8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VIHMC_D56                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55}"

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are pending; the empty asm on each
// accumulator of the awaited products keeps the compiler from reading one
// before the wait
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&d)[56]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
#pragma unroll
  for (int i = 0; i < 56; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait(float (&d)[56]) {
  wgmma_commit();
  wgmma_wait<0>(d);
}

// d (+)= A (64 x 16, registers) B (112 x 16, shared)^T
__device__ __forceinline__ void wgmma_rs(float (&d)[56], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 " VIHMC_D56
      ", {%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
      : VIHMC_D8(0), VIHMC_D8(8), VIHMC_D8(16), VIHMC_D8(24), VIHMC_D8(32), VIHMC_D8(40),
        VIHMC_D8(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 16, shared) B (112 x 16, shared)^T
__device__ __forceinline__ void wgmma_ss(float (&d)[56], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 " VIHMC_D56
      ", %56, %57, p, 1, 1, 0, 0;\n}\n"
      : VIHMC_D8(0), VIHMC_D8(8), VIHMC_D8(16), VIHMC_D8(24), VIHMC_D8(32), VIHMC_D8(40),
        VIHMC_D8(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A^T B, A (16 x 64) and B (16 x 112) in shared memory as MN-major
// operands (desc_mn): both transposed on the way in
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[56], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 " VIHMC_D56
      ", %56, %57, p, 1, 1, 1, 1;\n}\n"
      : VIHMC_D8(0), VIHMC_D8(8), VIHMC_D8(16), VIHMC_D8(24), VIHMC_D8(32), VIHMC_D8(40),
        VIHMC_D8(48)
      : "l"(da), "l"(db), "r"(1));
}

#undef VIHMC_D56
#undef VIHMC_D8

// ---- pack ----

// grid (layers of both stacks, C): layer l of one stack for one chain
__global__ void __launch_bounds__(THREADS) pack(const __grid_constant__ Stacks a) {
  const int c = blockIdx.y;
  int si = 0, l = blockIdx.x;
  if (l >= a.s[0].nl) {
    si = 1;
    l -= a.s[0].nl;
  }
  const Stack& s = a.s[si];
  const Layer ly = s.layer[l];
  const float* f = a.flat + (size_t)c * a.D;
  const size_t slot = (size_t)c * s.nl + l;
  const int kp = l == 0 ? s.kin : WP;
  char* wf = reinterpret_cast<char*>(s.wf + slot * WP * WP);
  for (int e = threadIdx.x; e < WP * kp; e += THREADS) {
    const int r = e / kp, k = e - r * kp;  // output row, input column
    const float v = r < ly.dout && k < ly.din ? f[ly.w + (size_t)r * ly.din + k] : 0.f;
    *reinterpret_cast<__nv_bfloat16*>(wf + blk(r, k, kp)) = __float2bfloat16_rn(v);
  }
  if (l > 0) {
    char* wb = reinterpret_cast<char*>(s.wb + slot * WP * WP);
    for (int e = threadIdx.x; e < WP * WP; e += THREADS) {
      const int r = e / WP, k = e - r * WP;  // input row, output column
      const float v = r < ly.din && k < ly.dout ? f[ly.w + (size_t)k * ly.din + r] : 0.f;
      *reinterpret_cast<__nv_bfloat16*>(wb + blk(r, k, WP)) = __float2bfloat16_rn(v);
    }
  }
  float* b = s.bias + slot * WP;
  for (int o = threadIdx.x; o < WP; o += THREADS)
    b[o] = o < ly.dout ? f[ly.b + o] : (l + 1 < s.nl && o == WP - 1 ? PAD_BIAS : 0.f);
}

// ---- forward ----

// grid (tiles of both stacks, C)
__global__ void __launch_bounds__(THREADS, 2) stack_forward(const __grid_constant__ Stacks a) {
  extern __shared__ __align__(128) char smem[];
  const int c = blockIdx.y;
  int si = 0, tile = blockIdx.x;
  if (tile >= a.s[0].tiles) {
    si = 1;
    tile -= a.s[0].tiles;
  }
  const Stack& s = a.s[si];
  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3, wg = tid >> 7, t = tid & 127;
  const int lr0 = ((tid >> 5) & 3) * 16 + (lane >> 2);  // this thread's rows in its warpgroup's 64
  const int row0 = tile * TR + wg * 64, r0 = row0 + lr0, r1 = r0 + 8;
  char* stg = smem + 2 * TILE_BYTES + wg * STAGE_OUT;
  const size_t tstride = (size_t)WP * WP;
  const __nv_bfloat16* wf = s.wf + (size_t)c * s.nl * tstride;
  const float* bias = s.bias + (size_t)c * s.nl * WP;

  copy_linear(smem, wf, WP * s.kin * 2, tid);
  cp_commit();
  // layer 0's A fragments straight from the shared input
  uint32_t af[NK][4];
  const int nk0 = s.kin / 16;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int k = 16 * kk + 2 * q;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = (h & 1) ? r1 : r0, kh = k + 8 * (h >> 1);
      af[kk][h] = kk < nk0 && r < s.n
                      ? __ldg(reinterpret_cast<const unsigned*>(s.x + (size_t)r * s.kin + kh))
                      : 0u;
    }
  }

  for (int l = 0; l < s.nl; ++l) {
    const char* wt = smem + (l & 1) * TILE_BYTES;
    if (l + 1 < s.nl) {
      copy_linear(smem + ((l + 1) & 1) * TILE_BYTES, wf + (l + 1) * tstride, TILE_BYTES, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const int kp = l == 0 ? s.kin : WP, nk = kp / 16;
    float acc[56];
#pragma unroll
    for (int i = 0; i < 56; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      if (kk < nk) wgmma_rs(acc, af[kk], desc(wt + kk * 256, kp), kk);
    wgmma_commit_wait(acc);

    const float* bl = bias + l * WP;
    const int dout = s.layer[l].dout;
    if (l + 1 < s.nl) {
      __nv_bfloat16* h = s.acts + ((size_t)l * a.C + c) * s.n * WP;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 b = __ldg(reinterpret_cast<const float2*>(bl + col));
        const uint32_t p0 = pack_bf16(tanhf(acc[4 * j] + b.x), tanhf(acc[4 * j + 1] + b.y));
        const uint32_t p1 = pack_bf16(tanhf(acc[4 * j + 2] + b.x), tanhf(acc[4 * j + 3] + b.y));
        stage_pair(stg, lr0, col, p0);
        stage_pair(stg, lr0 + 8, col, p1);
        af[j >> 1][(j & 1) * 2] = p0;
        af[j >> 1][(j & 1) * 2 + 1] = p1;
      }
      wg_sync(wg);
      rows_out<16>(stg, reinterpret_cast<char*>(h), s.n, row0, WP * 2, WP * 2, t);
    } else if (dout % 4 == 0) {  // the features, 8 or 16 bytes a copy
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 b = __ldg(reinterpret_cast<const float2*>(bl + col));
        stage_pair(stg, lr0, col, pack_bf16(acc[4 * j] + b.x, acc[4 * j + 1] + b.y));
        stage_pair(stg, lr0 + 8, col, pack_bf16(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y));
      }
      wg_sync(wg);
      char* o = reinterpret_cast<char*>(s.out + (size_t)c * s.n * dout);
      if (dout % 8 == 0)
        rows_out<16>(stg, o, s.n, row0, dout * 2, dout * 2, t);
      else
        rows_out<8>(stg, o, s.n, row0, dout * 2, dout * 2, t);
    } else {
      __nv_bfloat16* o = s.out + (size_t)c * s.n * dout;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * q;
        if (col >= dout) continue;
        const float2 b = __ldg(reinterpret_cast<const float2*>(bl + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? r1 : r0;
          if (r >= s.n) continue;
          const float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
          __nv_bfloat16* p = o + (size_t)r * dout + col;
          if ((dout & 1) == 0) {
            *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
          } else {
            p[0] = __float2bfloat16_rn(v0);
            if (col + 1 < dout) p[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
    __syncthreads();  // tile l & 1 and the staged rows are read before they are written again
  }
}

// ---- backward ----

// grid (blocks of both steps, C)
__global__ void __launch_bounds__(THREADS, 1) layer_backward(const __grid_constant__ Steps a) {
  extern __shared__ __align__(128) char smem[];
  __shared__ bool last;
  const int c = blockIdx.y;
  int si = 0, split = blockIdx.x;
  if (split >= a.blocks0) {
    si = 1;
    split -= a.blocks0;
  }
  const Step& s = a.s[si];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const int wg = tid >> 7, rl0 = wg * 64 + (warp & 3) * 16 + (lane >> 2), rl1 = rl0 + 8;
  const bool below = s.gout != nullptr;
  char* wt = smem;
  char* ring = smem + TILE_BYTES;  // [stage][g tile, y tile]
  char* stg = ring + STAGES * 2 * ROWS_BYTES + wg * STAGE_OUT;
  const __nv_bfloat16* g = s.g + c * s.g_cs;
  const __nv_bfloat16* y = s.y + c * s.y_cs;
  const int t0 = split * s.per_block, t1 = min(t0 + s.per_block, s.tiles);

  // tile t goes to stage (t - t0) % STAGES in its own commit group (empty
  // past the run), so waiting for all but the newest STAGES - 1 groups
  // waits for tile t; W^T joins the first group. The y tile is WP wide
  // whatever kin is: its columns past kin arrive as zeros.
  auto load = [&](int t) {
    if (t < t1) {
      char* gs = ring + ((t - t0) % STAGES) * 2 * ROWS_BYTES;
      load_rows(gs, g, s.n, s.gld, s.gwidth, t * TR, s.gvec, tid);
      load_rows(gs + ROWS_BYTES, y, s.n, s.yld, s.kin, t * TR, s.yvec, tid);
    }
    cp_commit();
  };
  if (below) copy_linear(wt, s.wb + c * s.wb_cs, TILE_BYTES, tid);
  for (int k = 0; k < STAGES - 1; ++k) load(t0 + k);

  // dW (outputs 64 wg .. 64 wg + 63, every input column) over the run's rows
  float dw[56];
#pragma unroll
  for (int i = 0; i < 56; ++i) dw[i] = 0.f;

  for (int t = t0; t < t1; ++t) {
    load(t + STAGES - 1);
    cp_wait<STAGES - 1>();
    fence_proxy_async();
    __syncthreads();
    const char* gs = ring + ((t - t0) % STAGES) * 2 * ROWS_BYTES;
    const char* ys = gs + ROWS_BYTES;
    // dW += g^T y over the tile's 128 rows (the warpgroup's outputs 112 .. 127
    // read past g's columns and are dropped); issued once no instruction
    // reads an accumulator until the wait, so the tensor cores are not
    // serialized, and in flight during the rows' stores
    auto weight_gradient = [&]() {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TR / 16; ++kk)
        wgmma_ss_tt(dw, desc_mn(gs + 2 * kk * (WP * 16) + wg * 8 * 128, WP),
                    desc_mn(ys + 2 * kk * (WP * 16), WP));
      wgmma_commit();
    };
    if (below) {  // g_below = (g W) * (1 - y^2) for this warpgroup's 64 rows; kin == WP
      float acc[56];
#pragma unroll
      for (int i = 0; i < 56; ++i) acc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        wgmma_ss(acc, desc(gs + wg * 8 * (WP * 16) + kk * 256, WP), desc(wt + kk * 256, WP), kk);
      wgmma_commit_wait(acc);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 y0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(ys + blk(rl0, col, WP)));
        const float2 y1 = unpack_bf16(*reinterpret_cast<const uint32_t*>(ys + blk(rl1, col, WP)));
        stage_pair(stg, rl0 - wg * 64, col,
                   pack_bf16(acc[4 * j] * (1.f - y0.x * y0.x), acc[4 * j + 1] * (1.f - y0.y * y0.y)));
        stage_pair(stg, rl1 - wg * 64, col, pack_bf16(acc[4 * j + 2] * (1.f - y1.x * y1.x),
                                                      acc[4 * j + 3] * (1.f - y1.y * y1.y)));
      }
      weight_gradient();
      wg_sync(wg);
      rows_out<16>(stg, reinterpret_cast<char*>(s.gout + (size_t)c * s.n * WP), s.n,
                   t * TR + wg * 64, WP * 2, WP * 2, tid & 127);
    } else {
      weight_gradient();
    }
    wgmma_wait<0>(dw);
    __syncthreads();  // this stage is read before tile t + STAGES lands in it
  }

  // this block's partial (WP x WP, outputs x inputs), then the chain's last
  // block adds them in a fixed order
  const int m = WP * WP;
  float* slot = s.slots + ((size_t)c * s.splits + split) * m;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int i = 8 * j + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = rl0 + 8 * h;  // the warpgroup's rows are outputs here
      if (o < WP)
        *reinterpret_cast<float2*>(slot + (size_t)o * WP + i) =
            make_float2(dw[4 * j + 2 * h], dw[4 * j + 2 * h + 1]);
    }
  }
  __threadfence();  // the slot is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) last = atomicAdd(s.tickets + c, 1u) == (unsigned)(s.splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // four columns of one row a thread at a time, every slot's load in flight
  // before the adds, which run in slot order
  const int m4 = m / 4;
  const float4* sl = reinterpret_cast<const float4*>(s.slots + (size_t)c * s.splits * m);
  float* gr = s.grad + c * s.D;
  const Layer ly = s.layer;
  for (int e4 = tid; e4 < m4; e4 += THREADS) {
    const int o = 4 * e4 / WP, i0 = 4 * e4 - o * WP;
    if (o >= ly.dout) continue;
    float4 v[MAX_SPLITS];
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < s.splits) v[k] = __ldcg(sl + (size_t)k * m4 + e4);
    float sum[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int k = 1; k < MAX_SPLITS; ++k)
      if (k < s.splits) {
        sum[0] += v[k].x;
        sum[1] += v[k].y;
        sum[2] += v[k].z;
        sum[3] += v[k].w;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      if (i < ly.din)
        gr[ly.w + (size_t)o * ly.din + i] = sum[u];
      else if (i == s.kin - 1)
        gr[ly.b + o] = sum[u];
    }
  }
  if (tid == 0) s.tickets[c] = 0u;
}

// ---- descriptors from the host's int64 arrays ----

constexpr int STACK_WORDS = 10 + 4 * MAX_LAYERS;
constexpr int STEP_WORDS = 25;

template <class T>
T* ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(v));
}

Stack read_stack(const long long* d) {
  Stack s;
  s.x = ptr<const __nv_bfloat16>(d[0]);
  s.acts = ptr<__nv_bfloat16>(d[1]);
  s.out = ptr<__nv_bfloat16>(d[2]);
  s.wf = ptr<__nv_bfloat16>(d[3]);
  s.wb = ptr<__nv_bfloat16>(d[4]);
  s.bias = ptr<float>(d[5]);
  s.n = (int)d[6];
  s.kin = (int)d[7];
  s.nl = (int)d[8];
  s.tiles = (int)d[9];
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const long long* e = d + 10 + 4 * l;
    s.layer[l] = {(int)e[0], (int)e[1], (int)e[2], (int)e[3]};
  }
  return s;
}

Step read_step(const long long* d) {
  Step s;
  s.g = ptr<const __nv_bfloat16>(d[0]);
  s.y = ptr<const __nv_bfloat16>(d[1]);
  s.gout = ptr<__nv_bfloat16>(d[2]);
  s.wb = ptr<const __nv_bfloat16>(d[3]);
  s.slots = ptr<float>(d[4]);
  s.tickets = ptr<unsigned>(d[5]);
  s.grad = ptr<float>(d[6]);
  s.g_cs = d[7];
  s.y_cs = d[8];
  s.wb_cs = d[9];
  s.D = d[10];
  s.gld = (int)d[11];
  s.gwidth = (int)d[12];
  s.gvec = (int)d[13];
  s.yld = (int)d[14];
  s.kin = (int)d[15];
  s.yvec = (int)d[16];
  s.n = (int)d[17];
  s.tiles = (int)d[18];
  s.splits = (int)d[19];
  s.per_block = (int)d[20];
  s.layer = {(int)d[21], (int)d[22], (int)d[23], (int)d[24]};
  return s;
}

}  // namespace

extern "C" {

// Pack and forward of both stacks, two launches on `stream`; returns a CUDA
// error code (0 = ok). desc: [C, D, flat] then STACK_WORDS words per stack:
// x, acts, out, wf, wb, bias, n, kin, nl, tiles, then (b, w, din, dout) for
// each of MAX_LAYERS layers (the first nl used).
int vihmc_field_forward(const long long* desc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Stacks a;
  a.C = (int)desc[0];
  a.D = desc[1];
  a.flat = ptr<const float>(desc[2]);
  int layers = 0, tiles = 0;
  for (int i = 0; i < 2; ++i) {
    a.s[i] = read_stack(desc + 3 + i * STACK_WORDS);
    if (a.s[i].nl < 1 || a.s[i].nl > MAX_LAYERS || a.s[i].kin % 16 || a.s[i].kin > WP)
      return (int)cudaErrorInvalidValue;
    layers += a.s[i].nl;
    tiles += a.s[i].tiles;
  }
  pack<<<dim3(layers, a.C), THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(stack_forward, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  stack_forward<<<dim3(tiles, a.C), THREADS, FWD_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

// One backward layer step of up to two stacks, one launch on `stream`; returns
// a CUDA error code (0 = ok). desc: [C, active0, active1] then STEP_WORDS
// words per step: g, y, gout, wb, slots, tickets, grad, g_cs, y_cs, wb_cs, D,
// gld, gwidth, gvec, yld, kin, yvec, n, tiles, splits, per_block, b, w, din, dout.
int vihmc_field_backward(const long long* desc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = (int)desc[0];
  Steps a;
  int k = 0, blocks = 0;
  for (int i = 0; i < 2; ++i) {
    if (!desc[1 + i]) continue;
    a.s[k] = read_step(desc + 3 + i * STEP_WORDS);
    const Step& s = a.s[k];
    if (s.kin % 16 || s.kin > WP || (s.gout && s.kin != WP) || s.splits < 1 ||
        s.splits > MAX_SPLITS || (long long)s.splits * s.per_block < s.tiles)
      return (int)cudaErrorInvalidValue;
    if (k == 0) a.blocks0 = s.splits;
    blocks += s.splits;
    ++k;
  }
  if (k == 0) return 0;
  if (k == 1) a.s[1] = a.s[0];
  cudaError_t err = cudaFuncSetAttribute(layer_backward,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  layer_backward<<<dim3(blocks, C), THREADS, BWD_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
