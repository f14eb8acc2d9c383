// The FNO2d's projection on the bf16 field, fc1 + exact GELU + fc2, as one
// fused kernel each way for Hopper: out = fc2(gelu(fc1(x))) over the padded
// grid, and its backward, with the fc_dim-wide hidden never in device memory.
//
// Replaces no TPU kernel: the JAX package has no FNO. On the card the
// projection ran as cuBLAS GEMMs around elementwise passes over the hidden z1
// (C, fc_dim, n S1 S2) in f32, written, biased, GELU'd and cast forward, and
// recomputed, multiplied by w2, GELU-differentiated, cast twice and summed
// backward, plus the slice copy of the unpadded x and the zero fill of dx:
// ~450 GB a field call at the FNO cell's shapes (C 4, 1000 functions, width
// 32, fc_dim 128, 110 x 110 padded, 101 x 101 real).
//
// Layout. x is the last Fourier layer's output (C, W, n, P1, P2) f32: per
// chain and channel n P1 P2 contiguous values, so a tile of TP = 64
// consecutive padded points x 32 channels is 32 runs of 256 bytes and needs
// no slice copy. A block is one warpgroup: it takes one chain and walks the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... Each thread loads 2 x 8
// channels of one point (128 contiguous bytes a warp a load), rounds them to
// bf16 once and stores them as 16-byte rows of a "blocked" smem tile (8-row
// groups of kp * 16 bytes, each a run of 8 x 8 core matrices along k, as in
// field_stack.cu), which wgmma reads K-major (x W1^T) and MN-major (dz1^T x).
// The next tile's x is in flight in registers while this one computes.
// Channels pad to WC = 32 with zero weights and inputs; fc_dim pads to a
// multiple of HC = 64 (one hidden chunk: the wgmma N of fc1) with zero W1
// rows, b1 and w2, which adds nothing forward (gelu(0) w2 = 0) or backward
// (dz1 = gelu'(0) 0 g = 0). Pad points are computed and dropped: the forward
// stores out at the S1 x S2 real points only; the backward reads g as 0 at
// the pad points, so dz1 and dx are exactly 0 there and dx needs no zero fill.
//
//   project_forward   per tile and hidden chunk: z1 = x W1^T by wgmma
//                     m64n64k16 (bf16 operands, f32 sums); in registers the
//                     epilogue adds b1, applies the exact GELU (erff), rounds
//                     to bf16, multiplies by the bf16 w2 and sums the chunk's
//                     columns; the quad's lanes add their sums, b2 is added
//                     and out is stored in f32.
//   project_backward  per tile and hidden chunk: z1 again, as forward; in
//                     f32 dz1 = gelu'(z1) (w2 g), gelu' = Phi(z) + z phi(z) as
//                     torch's gelu_backward, w2 unrounded; dw2 += bf16(g)
//                     bf16(gelu(z1)) and db1 += dz1 in f32 (each tile's column
//                     sums reduced over the warp's rows by shuffles, in a
//                     fixed order); dz1 rounded once to bf16 is the A fragment
//                     of dxu = dz1 W1 (wgmma m64n32k16, A in registers, the
//                     sum over the chunks in one f32 accumulator, stored in
//                     f32 into dx) and, staged in smem, the A of dw1 = dz1^T
//                     xu (wgmma m64n32k16, both operands MN-major, summed over
//                     all the block's tiles). db2 = sum g in f32. Each block
//                     writes its partials into a slot; the chain's last block
//                     (an integer ticket) adds the slots in slot order and
//                     writes dw1, db1, dw2 and db2. No float atomics: two calls
//                     give bit-equal gradients.
//
// Bounds on an H100 SXM at 700 W, one field call of the FNO cell (C 4, 1000
// functions): bytes, x read forward (6.2 GB) and backward (6.2 GB) with g
// (0.16 GB) and dx written (6.2 GB): ~19 GB, 5.6 ms at 3.35 TB/s. Products:
// 2 C N F (3 W + 2) = 1.35e12 FLOP at the real points, 1.4 ms at 989 TFLOP/s.
// What binds is the instruction stream of the hidden values' elementwise
// math: 6.2e9 values (pad points included) of ~35 FP32-pipe instructions
// forward (erff with both of its branches ~28, the bias, the GELU, half a
// bf16 round trip, the w2 FMA) and ~58 backward (erff, expf, the GELU and its
// derivative, the rounds, the dw2 FMA and db1 add), ~5.8e11 in all: 17 ms at
// 132 SMs x 128 lanes x 1.98 GHz. What the design does about it: the hidden
// stays in registers, so the bytes fall well below the instructions' time;
// the products run on the tensor cores beside them (async wgmma, two or more
// warpgroups an SM); erff is shared by the GELU and its derivative. Measured
// (chip_smoke.py phase 4, one chunk of 336 functions): forward 3.36 ms, 65 %
// of its instruction bound, backward 7.05 ms, 51 % (255 registers: two blocks
// an SM); the autograd path took 19.3 + 35.6 ms. Not done: skipping the
// tiles that hold only pad rows (~8 % of them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_mma.cuh"  // smem_addr, fence_proxy_async

namespace {

using split_mma::fence_proxy_async;
using split_mma::smem_addr;

constexpr int TP = 64;                 // padded points of a tile: wgmma M
constexpr int THREADS = 128;           // one warpgroup a block
constexpr int WC = 32;                 // channels, padded
constexpr int HC = 64;                 // hidden units of a chunk: fc1's wgmma N
constexpr int XT_BYTES = TP * WC * 2;  // one bf16 x tile
constexpr int DZ_BYTES = TP * HC * 2;  // one chunk of bf16 dz1
constexpr float K_ALPHA = 0.70710678118654752440f;  // M_SQRT1_2, as torch's GELU
constexpr float K_BETA = 0.39894228040143267794f;   // M_2_SQRTPI M_SQRT1_2 / 2

struct Params {
  const float* x;      // (C, W, np) the padded input, np = n P1 P2 a chain
  const float* w1;     // chain c at w1 + c w1_cs: (F, W) row-major
  const float* b1;     // (F) at b1 + c b1_cs
  const float* w2;     // (F) at w2 + c w2_cs
  const float* b2;     // (1) at b2 + c b2_cs
  const float* g;      // backward: (C, n, S1, S2) the cotangent of out
  float* out;          // forward: (C, n, S1, S2)
  float* dx;           // backward: (C, W, np)
  float* slots;        // backward: (C, gridDim.x, slot_words) partial weight gradients
  unsigned* tickets;   // backward: (C) counters, 0 before the launch and after it
  float* dw1;          // (C, F, W)
  float* db1;          // (C, F)
  float* dw2;          // (C, F)
  float* db2;          // (C)
  long long np, w1_cs, b1_cs, w2_cs, b2_cs;
  int W, F, n, p1, p2, s1, s2, tiles;
};

// byte offset of (r, k) in a blocked bf16 tile of width kp (field_stack.cu)
__host__ __device__ __forceinline__ int blk(int r, int k, int kp) {
  return (r >> 3) * (kp * 16) + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// wgmma descriptor without swizzle: start p, leading and stride byte offsets
__device__ __forceinline__ uint64_t make_desc(const void* p, int lbo, int sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}

// a blocked tile as a K-major operand (its rows are M or N)
__device__ __forceinline__ uint64_t desc(const void* p, int kp) {
  return make_desc(p, 128, kp * 16);
}

// the same tile as an MN-major operand, its rows the K dimension: the leading
// offset steps K (8 rows), the stride offset steps M or N (8 columns)
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

// both values rounded to bf16, back in f32
__device__ __forceinline__ float2 round_bf16(float lo, float hi) {
  return unpack_bf16(pack_bf16(lo, hi));
}

// ---- wgmma, f32 accumulators ----

#define VIHMC_D8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VIHMC_D16                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define VIHMC_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// the accumulators of products in flight: the empty asm keeps the compiler
// from reading or moving one across a wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A (64 x 16, shared, K-major) B (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VIHMC_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VIHMC_D8(0), VIHMC_D8(8), VIHMC_D8(16), VIHMC_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (64 x 16, registers) B (32 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_n32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " VIHMC_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : VIHMC_D8(0), VIHMC_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A^T B, A (16 x 64) and B (16 x 32) in shared memory as MN-major
// operands (desc_mn): both transposed on the way in
__device__ __forceinline__ void wgmma_n32_tt(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " VIHMC_D16
      ", %16, %17, p, 1, 1, 1, 1;\n}\n"
      : VIHMC_D8(0), VIHMC_D8(8)
      : "l"(da), "l"(db), "r"(1));
}

#undef VIHMC_D32
#undef VIHMC_D16
#undef VIHMC_D8

// ---- pieces of both kernels ----

// the chain's weights into shared memory: W1 as a blocked (FP x WC) bf16
// tile (fc1's B operand), optionally W1^T as a blocked (WC x FP) tile (dxu's
// B operand), b1 and w2 in f32 (w2 rounded to bf16 for the forward)
template <int FP>
__device__ __forceinline__ void load_weights(const Params& a, int c, char* w1s, char* w1ts,
                                             float* b1s, float* w2s, bool round_w2, int tid) {
  const float* w1 = a.w1 + c * a.w1_cs;
  for (int e = tid; e < FP * WC; e += THREADS) {
    const int f = e / WC, k = e - f * WC;
    const float v = f < a.F && k < a.W ? w1[(size_t)f * a.W + k] : 0.f;
    const __nv_bfloat16 b = __float2bfloat16_rn(v);
    *reinterpret_cast<__nv_bfloat16*>(w1s + blk(f, k, WC)) = b;
    if (w1ts) *reinterpret_cast<__nv_bfloat16*>(w1ts + blk(k, f, FP)) = b;
  }
  const float* b1 = a.b1 + c * a.b1_cs;
  const float* w2 = a.w2 + c * a.w2_cs;
  for (int f = tid; f < FP; f += THREADS) {
    b1s[f] = f < a.F ? b1[f] : 0.f;
    const float w = f < a.F ? w2[f] : 0.f;
    w2s[f] = round_w2 ? __bfloat162float(__float2bfloat16_rn(w)) : w;
  }
}

// this thread's share of the x tile at padded point p0 (of its chain's xc):
// channels 8 (cg + 2 i) .. + 7 of point p0 + (tid & 63), cg = tid >> 6;
// zeros past the width and past the chain's last point
__device__ __forceinline__ void load_x(const Params& a, const float* xc, long long p0, int tid,
                                       float (&v)[16]) {
  const long long p = p0 + (tid & (TP - 1));
  const int cg = tid / TP;
  const bool in = p < a.np;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ch = 8 * (cg + 2 * i) + e;
      v[8 * i + e] = in && ch < a.W ? __ldcs(xc + ch * a.np + p) : 0.f;
    }
}

// the same share, rounded to bf16, as two 16-byte rows of the blocked tile
__device__ __forceinline__ void store_x(char* xt, const float (&v)[16], int tid) {
  const int r = tid & (TP - 1), cg = tid / TP;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u =
        make_uint4(pack_bf16(v[8 * i], v[8 * i + 1]), pack_bf16(v[8 * i + 2], v[8 * i + 3]),
                   pack_bf16(v[8 * i + 4], v[8 * i + 5]), pack_bf16(v[8 * i + 6], v[8 * i + 7]));
    *reinterpret_cast<uint4*>(xt + blk(r, 8 * (cg + 2 * i), WC)) = u;
  }
}

// index of padded point p of chain c in (C, n, S1, S2), or -1 at a pad point
// or past the chain's last point
__device__ __forceinline__ long long real_index(const Params& a, int c, long long p) {
  if (p >= a.np) return -1;
  const int plane = a.p1 * a.p2;
  const long long fn = p / plane;
  const int rem = (int)(p - fn * plane);
  const int i = rem / a.p2, j = rem - i * a.p2;
  if (i >= a.s1 || j >= a.s2) return -1;
  return (((long long)c * a.n + fn) * a.s1 + i) * a.s2 + j;
}

__device__ __forceinline__ float gelu(float z) {
  return z * 0.5f * (1.0f + erff(z * K_ALPHA));  // torch's GELU, 'none'
}

// One half of a reduce-scatter over the lanes `mask` apart: of v[0, 2m) this
// lane keeps v[0, m) or v[m, 2m) (by its lane bit) plus the partner's same
// half, in v[0, m).
template <int M>
__device__ __forceinline__ void fold(float* v, int mask, int lane) {
  const bool upper = lane & mask;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float keep = upper ? v[k + M] : v[k];
    const float send = upper ? v[k] : v[k + M];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// ---- forward ----

// grid (blocks a chain, C)
template <int NCH>
__global__ void __launch_bounds__(THREADS, 3) project_forward(const __grid_constant__ Params a) {
  constexpr int FP = NCH * HC;
  extern __shared__ __align__(128) char smem[];
  char* w1s = smem;
  float* b1s = reinterpret_cast<float*>(smem + FP * WC * 2);
  float* w2s = b1s + FP;
  char* xs = reinterpret_cast<char*>(w2s + FP);  // [2][XT_BYTES], 128-byte aligned
  const int c = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const int lr0 = warp * 16 + (lane >> 2);  // this thread's rows: lr0 and lr0 + 8
  const float* xc = a.x + (size_t)c * a.W * a.np;

  load_weights<FP>(a, c, w1s, nullptr, b1s, w2s, true, tid);
  const float b2 = a.b2[c * a.b2_cs];
  float v[16];
  int t = blockIdx.x;
  if (t < a.tiles) {
    load_x(a, xc, (long long)t * TP, tid, v);
    store_x(xs, v, tid);
  }
  fence_proxy_async();
  __syncthreads();

  for (int buf = 0; t < a.tiles; t += gridDim.x, buf ^= 1) {
    const int tn = t + gridDim.x;
    if (tn < a.tiles) load_x(a, xc, (long long)tn * TP, tid, v);
    const char* xt = xs + buf * XT_BYTES;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int h = 0; h < NCH; ++h) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      const char* wh = w1s + h * HC * WC * 2;
      wgmma_fence();
      wgmma_n64(acc, desc(xt, WC), desc(wh, WC), 0);
      wgmma_n64(acc, desc(xt + 256, WC), desc(wh + 256, WC), 1);
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        const int col = h * HC + 8 * j + 2 * q;
        const float2 b = *reinterpret_cast<const float2*>(b1s + col);
        const float2 w = *reinterpret_cast<const float2*>(w2s + col);
        const float2 u0 = round_bf16(gelu(acc[4 * j] + b.x), gelu(acc[4 * j + 1] + b.y));
        const float2 u1 = round_bf16(gelu(acc[4 * j + 2] + b.x), gelu(acc[4 * j + 3] + b.y));
        s0 = fmaf(u0.x, w.x, fmaf(u0.y, w.y, s0));
        s1 = fmaf(u1.x, w.x, fmaf(u1.y, w.y, s1));
      }
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (q < 2) {  // lane q = 0 stores row lr0, q = 1 row lr0 + 8
      const long long o = real_index(a, c, (long long)t * TP + lr0 + 8 * q);
      if (o >= 0) a.out[o] = (q ? s1 : s0) + b2;
    }
    if (tn < a.tiles) store_x(xs + (buf ^ 1) * XT_BYTES, v, tid);
    fence_proxy_async();
    __syncthreads();  // the next tile is in smem for every warp
  }
}

// ---- backward ----

template <int FP>
__host__ __device__ constexpr int slot_words() {
  return FP * WC + 2 * FP + 4;  // dw1 (FP x WC), dw2, db1, db2 and padding
}

template <int NCH>
__host__ __device__ constexpr int bwd_smem() {
  return 2 * NCH * HC * WC * 2 + 2 * NCH * HC * 4 + 2 * XT_BYTES + 2 * DZ_BYTES +
         4 * 2 * NCH * HC * 4 + 16;
}

template <int NCH>
__host__ __device__ constexpr int fwd_smem() {
  return NCH * HC * WC * 2 + 2 * NCH * HC * 4 + 2 * XT_BYTES;
}

// grid (blocks a chain, C)
template <int NCH>
__global__ void __launch_bounds__(THREADS, 2) project_backward(const __grid_constant__ Params a) {
  constexpr int FP = NCH * HC;
  constexpr int SLOT = slot_words<FP>();
  extern __shared__ __align__(128) char smem[];
  __shared__ bool last;
  char* w1s = smem;
  char* w1ts = w1s + FP * WC * 2;
  float* b1s = reinterpret_cast<float*>(w1ts + FP * WC * 2);
  float* w2s = b1s + FP;
  char* xs = reinterpret_cast<char*>(w2s + FP);  // [2][XT_BYTES]
  char* dzs = xs + 2 * XT_BYTES;                 // [2][DZ_BYTES]
  float* red = reinterpret_cast<float*>(dzs + 2 * DZ_BYTES);  // [4 warps][dw2, db1][FP]
  float* redg = red + 4 * 2 * FP;                             // [4 warps]
  const int c = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const int lr0 = warp * 16 + (lane >> 2);
  const float* xc = a.x + (size_t)c * a.W * a.np;
  float* dxc = a.dx + (size_t)c * a.W * a.np;

  load_weights<FP>(a, c, w1s, w1ts, b1s, w2s, false, tid);
  // dw1 of hidden chunk h: rows (hidden) lr0, lr0 + 8, columns (channels) 8 j + 2 q + {0, 1}
  float dw1[NCH][16];
  // dw2 and db1 after each tile's fold: columns h HC + 8 (lane >> 2) + 2 q + {0, 1}
  float kw2[NCH][2], kb1[NCH][2], gsum = 0.f;
#pragma unroll
  for (int h = 0; h < NCH; ++h) {
#pragma unroll
    for (int i = 0; i < 16; ++i) dw1[h][i] = 0.f;
    kw2[h][0] = kw2[h][1] = kb1[h][0] = kb1[h][1] = 0.f;
  }
  float v[16];
  int t = blockIdx.x;
  if (t < a.tiles) {
    load_x(a, xc, (long long)t * TP, tid, v);
    store_x(xs, v, tid);
  }
  fence_proxy_async();
  __syncthreads();

  for (int buf = 0; t < a.tiles; t += gridDim.x, buf ^= 1) {
    const int tn = t + gridDim.x;
    if (tn < a.tiles) load_x(a, xc, (long long)tn * TP, tid, v);
    const char* xt = xs + buf * XT_BYTES;
    const long long p0 = (long long)t * TP;
    const long long o0 = real_index(a, c, p0 + lr0), o1 = real_index(a, c, p0 + lr0 + 8);
    const float g0 = o0 >= 0 ? a.g[o0] : 0.f, g1 = o1 >= 0 ? a.g[o1] : 0.f;
    if (q == 0) gsum += g0 + g1;
    const float2 gb = round_bf16(g0, g1);
    float dxa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dxa[i] = 0.f;
#pragma unroll
    for (int h = 0; h < NCH; ++h) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      const char* wh = w1s + h * HC * WC * 2;
      wgmma_fence();
      wgmma_n64(acc, desc(xt, WC), desc(wh, WC), 0);
      wgmma_n64(acc, desc(xt + 256, WC), desc(wh + 256, WC), 1);
      wgmma_commit();
      wgmma_wait_all();  // also the previous chunk's dxu and dw1 products
      pin(acc);
      pin(dxa);
#pragma unroll
      for (int k = 0; k < NCH; ++k) pin(dw1[k]);
      char* dz = dzs + (h & 1) * DZ_BYTES;
      uint32_t af[HC / 16][4];
      float pw2[16], pb1[16];  // this thread's column sums over its two rows
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        const int col = h * HC + 8 * j + 2 * q;
        const float2 b = *reinterpret_cast<const float2*>(b1s + col);
        const float2 w = *reinterpret_cast<const float2*>(w2s + col);
        float d[4], gl[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // (row, column): (lr0, col), (lr0, col + 1), (lr0 + 8, ...)
          const float z = acc[4 * j + u] + ((u & 1) ? b.y : b.x);
          const float e = erff(z * K_ALPHA);
          const float cdf = 0.5f * (1.0f + e);
          const float pdf = expf(-0.5f * z * z) * K_BETA;
          gl[u] = z * 0.5f * (1.0f + e);
          d[u] = (((u & 1) ? w.y : w.x) * ((u & 2) ? g1 : g0)) * (cdf + z * pdf);
        }
        const float2 h0 = round_bf16(gl[0], gl[1]), h1 = round_bf16(gl[2], gl[3]);
        pw2[2 * j] = fmaf(gb.y, h1.x, gb.x * h0.x);
        pw2[2 * j + 1] = fmaf(gb.y, h1.y, gb.x * h0.y);
        pb1[2 * j] = d[0] + d[2];
        pb1[2 * j + 1] = d[1] + d[3];
        const uint32_t k0 = pack_bf16(d[0], d[1]), k1 = pack_bf16(d[2], d[3]);
        af[j >> 1][(j & 1) * 2] = k0;
        af[j >> 1][(j & 1) * 2 + 1] = k1;
        *reinterpret_cast<uint32_t*>(dz + blk(lr0, 8 * j + 2 * q, HC)) = k0;
        *reinterpret_cast<uint32_t*>(dz + blk(lr0 + 8, 8 * j + 2 * q, HC)) = k1;
      }
      fence_proxy_async();
      __syncthreads();  // dz1 of the whole tile is in smem
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HC / 16; ++kk)  // dxu += dz1 W1 over the chunk's hidden units
        wgmma_n32_rs(dxa, af[kk], desc(w1ts + (h * HC / 8 + 2 * kk) * 128, FP));
#pragma unroll
      for (int kk = 0; kk < TP / 16; ++kk)  // dw1 += dz1^T xu over the tile's points
        wgmma_n32_tt(dw1[h], desc_mn(dz + 2 * kk * (HC * 16), HC),
                     desc_mn(xt + 2 * kk * (WC * 16), WC));
      wgmma_commit();
      // the column sums over the warp's 16 rows, in flight beside the products
      fold<8>(pw2, 16, lane);
      fold<4>(pw2, 8, lane);
      fold<2>(pw2, 4, lane);
      fold<8>(pb1, 16, lane);
      fold<4>(pb1, 8, lane);
      fold<2>(pb1, 4, lane);
      kw2[h][0] += pw2[0];
      kw2[h][1] += pw2[1];
      kb1[h][0] += pb1[0];
      kb1[h][1] += pb1[1];
    }
    wgmma_wait_all();
    pin(dxa);
#pragma unroll
    for (int k = 0; k < NCH; ++k) pin(dw1[k]);
    // dx at the tile's points (0 at the pad points), 32 bytes a channel a store
#pragma unroll
    for (int j = 0; j < WC / 8; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ch = 8 * j + 2 * q + (u & 1);
        const long long p = p0 + lr0 + 8 * (u >> 1);
        if (ch < a.W && p < a.np) __stcs(dxc + ch * a.np + p, dxa[4 * j + u]);
      }
    if (tn < a.tiles) store_x(xs + (buf ^ 1) * XT_BYTES, v, tid);
    fence_proxy_async();
    __syncthreads();
  }
  wgmma_wait_all();
#pragma unroll
  for (int k = 0; k < NCH; ++k) pin(dw1[k]);

  // this block's partials into its slot: dw1 straight from the accumulators,
  // dw2 and db1 summed over the four warps in order, db2 over the lanes and
  // warps in order
  float* slot = a.slots + ((size_t)c * gridDim.x + blockIdx.x) * SLOT;
#pragma unroll
  for (int h = 0; h < NCH; ++h)
#pragma unroll
    for (int j = 0; j < WC / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(slot + (h * HC + lr0 + 8 * r) * WC + 8 * j + 2 * q) =
            make_float2(dw1[h][4 * j + 2 * r], dw1[h][4 * j + 2 * r + 1]);
#pragma unroll
  for (int h = 0; h < NCH; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = h * HC + 8 * (lane >> 2) + 2 * q + e;
      red[(warp * 2) * FP + col] = kw2[h][e];
      red[(warp * 2 + 1) * FP + col] = kb1[h][e];
    }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) gsum += __shfl_xor_sync(0xffffffffu, gsum, m);
  if (lane == 0) redg[warp] = gsum;
  __syncthreads();
  for (int e = tid; e < 2 * FP; e += THREADS) {
    const int k = e / FP, col = e - k * FP;
    float s = red[k * FP + col];
#pragma unroll
    for (int w = 1; w < 4; ++w) s += red[(w * 2 + k) * FP + col];
    slot[FP * WC + e] = s;
  }
  if (tid == 0) slot[FP * WC + 2 * FP] = ((redg[0] + redg[1]) + redg[2]) + redg[3];
  __threadfence();  // the slot is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + c, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the chain's slots added in slot order, eight loads in flight at a time
  const float* sl = a.slots + (size_t)c * gridDim.x * SLOT;
  const int nb = gridDim.x;
  for (int e = tid; e < FP * WC + 2 * FP + 1; e += THREADS) {
    float s = 0.f;
    for (int k0 = 0; k0 < nb; k0 += 8) {
      float u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        u[k] = k0 + k < nb ? __ldcg(sl + (size_t)(k0 + k) * SLOT + e) : 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) s += u[k];
    }
    if (e < FP * WC) {
      const int f = e / WC, ch = e - f * WC;
      if (f < a.F && ch < a.W) a.dw1[((size_t)c * a.F + f) * a.W + ch] = s;
    } else if (e < FP * WC + FP) {
      const int f = e - FP * WC;
      if (f < a.F) a.dw2[(size_t)c * a.F + f] = s;
    } else if (e < FP * WC + 2 * FP) {
      const int f = e - FP * WC - FP;
      if (f < a.F) a.db1[(size_t)c * a.F + f] = s;
    } else {
      a.db2[c] = s;
    }
  }
  if (tid == 0) a.tickets[c] = 0u;
}

// ---- the host side ----

template <class T>
T* ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(v));
}

// desc (29 words): x, w1, b1, w2, b2, g, out, dx, slots, tickets, dw1, db1, dw2, db2,
// np, w1_cs, b1_cs, w2_cs, b2_cs, W, F, n, p1, p2, s1, s2, tiles, C, blocks
Params read_params(const long long* d, int* C, int* blocks) {
  Params a;
  a.x = ptr<const float>(d[0]);
  a.w1 = ptr<const float>(d[1]);
  a.b1 = ptr<const float>(d[2]);
  a.w2 = ptr<const float>(d[3]);
  a.b2 = ptr<const float>(d[4]);
  a.g = ptr<const float>(d[5]);
  a.out = ptr<float>(d[6]);
  a.dx = ptr<float>(d[7]);
  a.slots = ptr<float>(d[8]);
  a.tickets = ptr<unsigned>(d[9]);
  a.dw1 = ptr<float>(d[10]);
  a.db1 = ptr<float>(d[11]);
  a.dw2 = ptr<float>(d[12]);
  a.db2 = ptr<float>(d[13]);
  a.np = d[14];
  a.w1_cs = d[15];
  a.b1_cs = d[16];
  a.w2_cs = d[17];
  a.b2_cs = d[18];
  a.W = (int)d[19];
  a.F = (int)d[20];
  a.n = (int)d[21];
  a.p1 = (int)d[22];
  a.p2 = (int)d[23];
  a.s1 = (int)d[24];
  a.s2 = (int)d[25];
  a.tiles = (int)d[26];
  *C = (int)d[27];
  *blocks = (int)d[28];
  return a;
}

template <int NCH>
int launch(bool backward, const long long* desc, cudaStream_t st) {
  int C, blocks;
  const Params a = read_params(desc, &C, &blocks);
  if (a.W < 1 || a.W > WC || a.F < 1 || a.F > NCH * HC || blocks < 1 || C < 1 ||
      a.s1 > a.p1 || a.s2 > a.p2 || (long long)a.tiles * TP < a.np)
    return (int)cudaErrorInvalidValue;
  const int smem = backward ? bwd_smem<NCH>() : fwd_smem<NCH>();
  const void* fn =
      backward ? (const void*)project_backward<NCH> : (const void*)project_forward<NCH>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (backward)
    project_backward<NCH><<<dim3(blocks, C), THREADS, smem, st>>>(a);
  else
    project_forward<NCH><<<dim3(blocks, C), THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int NCH>
int occupancy(bool backward) {
  const int smem = backward ? bwd_smem<NCH>() : fwd_smem<NCH>();
  const void* fn =
      backward ? (const void*)project_backward<NCH> : (const void*)project_forward<NCH>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, THREADS, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" {

// One launch of the forward (backward 0) or the backward (1) on `stream` for
// fc_dim up to 64 nch, nch 2 or 4; returns a CUDA error code (0 = ok). desc:
// DESC_WORDS int64 words (read_params).
int vihmc_fno_project(int backward, int nch, const long long* desc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nch == 2) return launch<2>(backward != 0, desc, st);
  if (nch == 4) return launch<4>(backward != 0, desc, st);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM of the forward (backward 0) or backward (1) kernel
// for nch, or minus a CUDA error code.
int vihmc_fno_project_occupancy(int backward, int nch) {
  if (nch == 2) return occupancy<2>(backward != 0);
  if (nch == 4) return occupancy<4>(backward != 0);
  return -(int)cudaErrorInvalidValue;
}

int vihmc_fno_project_slot_words(int nch) {
  return nch == 2 ? slot_words<2 * HC>() : nch == 4 ? slot_words<4 * HC>() : -1;
}

}  // extern "C"
