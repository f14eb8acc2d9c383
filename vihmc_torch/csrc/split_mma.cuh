// Shared mainloop of the merge-reduction kernels (paired_sums.cu, merge_sums.cu):
// f32 products of DeepONet features at f32 accuracy on Hopper's tensor cores.
//
// Split: every f32 operand x is cut into three bf16 parts x = x0 + x1 + x2,
// each the bf16 rounding of what is left (bf16 keeps f32's exponent range, and
// 3 x 8 significant bits hold all 24 of f32, so the parts sum to x exactly). A
// product a.b is then the six leading part products a2 b0 + a1 b1 + a0 b2 +
// a1 b0 + a0 b1 + a0 b0, each a bf16 `wgmma` with f32 accumulation; the three
// dropped ones are below 2^-24 of |a b|. This is what Precision.HIGHEST asks
// of a matrix unit. A single bf16 or TF32 pass would put ~1e-3 relative noise
// into the MH density.
//
// Rounding: the tensor cores round an accumulation toward zero. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W: chaining all 42 part products of K = 100
// into one accumulator shrank S1 = sum m (m - 2 y) by 9e-7 of its terms'
// magnitudes. So each K chunk's six part products run into a fresh
// accumulator, smallest first; the chunk's sum, truncated once at its own
// magnitude, gets one unit in the last place added to its magnitude when that
// place is odd (half a unit on average, the truncation's mean), and is then
// added to the running f32 sum with an IEEE add. Without that last step the
// paired Delta ll at the operator row drifted 0.0098 nats from float64; with
// it, 0.00195 nats, as the plain IEEE version (same card). The arithmetic is
// modelled on the CPU in tests/test_torch_split.py.
//
// Tiling: one block owns a 128 x 128 output tile and walks all chains. K runs
// in chunks of 16 (one wgmma depth). The block's three warpgroups:
//   - a producer: one thread keeps a ring of STAGES f32 stages full with
//     tensor-memory-accelerator (TMA) boxes of 16 k x 128 rows, which arrive
//     with the 64-byte swizzle and zeros past every edge, so K pads to a
//     multiple of 16 in shared memory only (when K is not a multiple of 4 or
//     the features are not 16-byte aligned, all 128 threads copy 4 bytes at a
//     time with cp.async instead, and all of them split); the other three
//     warps split each chunk's B (tout) tiles once into bf16 part tiles in
//     wgmma's shared-memory layout (double buffered);
//   - two consumers, each owning 64 rows and all 128 columns: a consumer reads
//     its A (bout) wgmma fragments from the f32 stage into registers, splits
//     them there, and runs one batch of six m64n128k16 wgmmas per product,
//     reading and splitting the next batch's fragment while one runs.
// mbarriers hand stages and part tiles between them (`full` when written,
// `empty` when every reader is done: consumers and splitters for a stage,
// consumers for a part buffer), so no barrier spans the block inside the
// loop. setmaxnreg moves registers from the producer (down to 56) to the
// consumers (up to 224), which hold the accumulators: from the 168 a thread
// gets at launch, what the producer frees must cover what the consumers
// take, or their increase never returns. The ring runs across chain
// boundaries, so the next chain's chunks arrive during a chain's epilogue.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace split_mma {

constexpr int BM = 128;                  // output tile rows (along B)
constexpr int BN = 128;                  // output tile columns (along P)
constexpr int KC = 16;                   // K chunk: one wgmma depth
constexpr int CONSUMERS = 256;           // two warpgroups multiply and fold
constexpr int THREADS = CONSUMERS + 128; // and one warpgroup copies and splits
constexpr int WARPS = CONSUMERS / 32;    // consumer warps: one partial slot each
constexpr int ROWS = 128;                // rows of a staged f32 operand tile (BM == BN)
constexpr int NACC = 64;                 // f32 accumulators per thread of a 64 x 128 product
constexpr int F32_TILE = ROWS * KC;      // floats of one f32 operand tile
constexpr int PART_BYTES = ROWS * KC * 2;  // one bf16 part of a B tile
constexpr int SPLIT_BYTES = 3 * PART_BYTES;

static_assert(BM == ROWS && BN == ROWS && CONSUMERS == 2 * 128, "tiling");

// Shared memory of a kernel with NPROD products: the f32 ring (A and B tile of
// each product per stage), the double-buffered B part tiles, the y tile, and
// the mbarriers (full and empty of every stage and of both part buffers).
__host__ __device__ constexpr int y_offset(int nprod, int stages) {
  return stages * 2 * nprod * F32_TILE * 4 + 2 * nprod * SPLIT_BYTES;
}
__host__ __device__ constexpr int smem_bytes(int nprod, int stages) {
  return y_offset(nprod, stages) + BM * BN * 4 + (2 * stages + 4) * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// arrive when all of this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state) : "r"(smem_addr(bar)) : "memory");
  (void)state;
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred P;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, P;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// ---- the tensor-memory accelerator ----

// the tensor maps of a kernel's operands, passed by value as a kernel
// parameter: (K, rows, C) f32, boxes of 16 k x 128 rows x 1 chain
template <int N>
struct TmaMaps {
  CUtensorMap m[N];
};

// announce `bytes` of copies that will complete on `bar`, and arrive
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// box (k0, row0, c) of `map` into shared memory at dst; rows and k past the
// tensor's end arrive as zeros
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int k0, int row0,
                                         int c, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(c),
         "r"(smem_addr(bar))
      : "memory");
}

// ---- the f32 ring ----

// float offset of (row, k) in an f32 tile of 64-byte rows: the 16-byte chunks
// of a row are XOR-swizzled by bits 1-2 of the row. This is the tensor-memory
// accelerator's 64-byte swizzle, and it spreads the split pass's float4 reads
// of one chunk of eight rows over distinct banks.
__device__ __forceinline__ int f32_index(int row, int k) {
  return row * KC + (((k >> 2) ^ ((row >> 1) & 3)) << 2) + (k & 3);
}

// Without tensor maps (K not a multiple of 4, or features not 16-byte
// aligned): the producer's copy of k in [k0, k0 + 16) of rows [0, 128) of a
// (rows, K) f32 matrix whose first tile row is `src` into an f32 tile, four
// bytes at a time (t: thread of the warpgroup); rows >= nrows and k >= K
// become zeros.
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int nrows, int K, int k0,
                                          int t) {
#pragma unroll 4
  for (int e = t; e < ROWS * KC; e += 128) {
    const int r = e >> 4, kk = e & 15, k = k0 + kk;
    const bool ok = r < nrows && k < K;
    cp_async4(dst + f32_index(r, kk), ok ? src + (size_t)r * K + k : src, ok ? 4 : 0);
  }
}

// ---- the split ----

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi, float2& back) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  back = __bfloat1622float2(b);
  return reinterpret_cast<const uint32_t&>(b);
}

// three bf16x2 parts of a pair of neighbouring-k values (lower k in the low half)
__device__ __forceinline__ void split3(float2 v, uint32_t& p0, uint32_t& p1, uint32_t& p2) {
  float2 f;
  p0 = bf16x2_bits(v.x, v.y, f);
  const float rx = v.x - f.x, ry = v.y - f.y;  // exact
  p1 = bf16x2_bits(rx, ry, f);
  p2 = bf16x2_bits(rx - f.x, ry - f.y, f);     // exact, and exact in bf16
}

// Byte offset of (row, k) in a bf16 part tile of 128 rows in wgmma's K-major
// layout without swizzle: 8 x 8 core matrices of 16-byte rows, the two k
// halves of a group of 8 rows 128 bytes apart (the descriptor's leading
// offset), groups of 8 rows 256 bytes apart (its stride offset).
__device__ __forceinline__ int part_offset(int row, int k) {
  return (row >> 3) * 256 + (k >> 3) * 128 + (row & 7) * 16 + (k & 7) * 2;
}

// Split an f32 B tile into three bf16 part tiles at dst, one float4 at a
// time over n splitting threads (t in 0 .. n - 1). A warp takes 8 rows x 4
// float4, so its stores fill whole 128-byte lines.
__device__ __forceinline__ void split_b_tile(char* dst, const float* src, int t, int n) {
#pragma unroll 4
  for (int e = t; e < ROWS * 4; e += n) {
    const int r = (e >> 5) * 8 + (e & 7), q = (e >> 3) & 3;  // k = 4q .. 4q + 3
    const float4 v = *reinterpret_cast<const float4*>(src + f32_index(r, 4 * q));
    uint2 p0, p1, p2;
    split3(make_float2(v.x, v.y), p0.x, p1.x, p2.x);
    split3(make_float2(v.z, v.w), p0.y, p1.y, p2.y);
    const int off = part_offset(r, 4 * q);
    *reinterpret_cast<uint2*>(dst + off) = p0;
    *reinterpret_cast<uint2*>(dst + PART_BYTES + off) = p1;
    *reinterpret_cast<uint2*>(dst + 2 * PART_BYTES + off) = p2;
  }
}

// This thread's wgmma A fragment of 64 rows of an f32 A tile, split:
// a[part][0..3] hold (row g, k 2t), (row g + 8, k 2t), (row g, k 2t + 8),
// (row g + 8, k 2t + 8) and their k + 1 neighbours, rows counted from the
// warp's 16 (t = thread of the warpgroup, g = lane / 4, t % 4 = lane % 4)
__device__ __forceinline__ void load_a_fragment(uint32_t (&a)[3][4], const float* tile,
                                                int t) {
  const int lane = t & 31, row = 16 * (t >> 5) + (lane >> 2), k = 2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = *reinterpret_cast<const float2*>(
        tile + f32_index(row + 8 * (q & 1), k + 8 * (q >> 1)));
    split3(v, a[0][q], a[1][q], a[2][q]);
  }
}

// ---- wgmma ----

// make this thread's shared-memory stores visible to the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a part tile starting at `p`: no swizzle, leading
// (k-half) offset 128 bytes, stride (8-row group) offset 256 bytes
__device__ __forceinline__ uint64_t part_desc(const char* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

// d (64 x 128, f32) = A (64 x 16, registers) B (128 x 16, shared)^T
//                     + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_64x128(float (&d)[NACC], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
#define VIHMC_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,"
      "%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,"
      "%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
      : VIHMC_D8(0), VIHMC_D8(8), VIHMC_D8(16), VIHMC_D8(24), VIHMC_D8(32), VIHMC_D8(40),
        VIHMC_D8(48), VIHMC_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
#undef VIHMC_D8
}

// Start one batch: the six part products of one K chunk and one product into
// the fresh accumulator t (smallest first, a0 b0 last); A parts a, B part
// tiles at sb.
__device__ __forceinline__ void start_batch(float (&t)[NACC], const uint32_t (&a)[3][4],
                                            const char* sb) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_64x128(t, a[2], part_desc(sb), 0);
  wgmma_64x128(t, a[1], part_desc(sb + PART_BYTES), 1);
  wgmma_64x128(t, a[0], part_desc(sb + 2 * PART_BYTES), 1);
  wgmma_64x128(t, a[1], part_desc(sb), 1);
  wgmma_64x128(t, a[0], part_desc(sb + PART_BYTES), 1);
  wgmma_64x128(t, a[0], part_desc(sb), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait for the batch and add it to the running sum acc with IEEE adds
template <int N>
__device__ __forceinline__ void finish_batch(float (&acc)[N], float (&t)[N]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(t[i]) :: "memory");
  // t was rounded toward zero: raising its magnitude by one unit in the last
  // place when that place is odd adds half a unit on average, the mean of the
  // truncation, so the chunk sums add up without a drift toward zero
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int bits = __float_as_int(t[i]);
    acc[i] = __fadd_rn(acc[i], __int_as_float(bits + (bits & 1)));
  }
}

// ---- y and the walk ----

// y column of (row, col) in the shared y tile: 8-column groups XOR-swizzled by
// the row, so the epilogue's float2 reads are free of bank conflicts
__device__ __forceinline__ int y_index(int r, int c) { return r * BN + (c ^ ((r & 7) << 3)); }

// y (B, P) tile at (row0, col0) into shared memory, zeros past the edge
__device__ __forceinline__ void load_y_tile(float* ys, const float* __restrict__ y, int B,
                                            int P, int row0, int col0, int tid) {
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    ys[y_index(r, c)] = (gr < B && gc < P) ? __ldg(y + (size_t)gr * P + gc) : 0.f;
  }
}

// Walk every chain's NPROD products over this block's tile: NPROD pairs
// (fa[p] (C, B, K), fb[p] (C, P, K)). On a consumer thread, after a chain's
// last K chunk, epi(c, acc) folds the accumulators, which are then reset.
// With TMA, maps.m holds the tensor maps of fa, then of fb; smem is 1024-byte
// aligned (the 64-byte swizzle repeats every 512 bytes).
template <int NPROD, int STAGES, bool TMA, class Epilogue>
__device__ __forceinline__ void walk_chains(char* smem, const TmaMaps<2 * NPROD>& maps,
                                            const float* const (&fa)[NPROD],
                                            const float* const (&fb)[NPROD], int C, int B,
                                            int P, int K, int row0, int col0,
                                            Epilogue&& epi) {
  constexpr int STAGE_FLOATS = 2 * NPROD * F32_TILE;  // A tile of each product, then B
  float* ring = reinterpret_cast<float*>(smem);
  char* parts = smem + STAGES * STAGE_FLOATS * 4;    // [buffer][NPROD] part tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + y_offset(NPROD, STAGES) + BM * BN * 4);
  uint64_t* full = bars;              // a ring stage has landed
  uint64_t* empty = bars + STAGES;    // its A tiles and B tiles have been read
  uint64_t* pfull = bars + 2 * STAGES;      // a part buffer is written
  uint64_t* pempty = bars + 2 * STAGES + 2;  // both consumers' wgmmas on it are done
  const int tid = threadIdx.x;
  const int nk = (K + KC - 1) / KC, total = C * nk;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, TMA ? 1 : 128);  // the TMA thread, or every copying thread
      mbar_init(empty + s, CONSUMERS + (TMA ? 96 : 128));  // consumers and splitters
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(pfull + b, TMA ? 96 : 128);  // the splitting threads
      mbar_init(pempty + b, CONSUMERS);
    }
  }
  __syncthreads();  // the mbarriers and the y tile are ready

  if (tid >= CONSUMERS) {  // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int t = tid - CONSUMERS;
    auto load = [&](int step) {
      if (step >= total) return;
      const int s = step % STAGES, use = step / STAGES;
      if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
      const int c = step / nk, k0 = (step % nk) * KC;
      float* st = ring + s * STAGE_FLOATS;
      if (TMA) {
        mbar_arrive_expect_tx(full + s, STAGE_FLOATS * 4);
#pragma unroll
        for (int m = 0; m < 2 * NPROD; ++m)
          tma_load(st + m * F32_TILE, &maps.m[m], k0, m < NPROD ? row0 : col0, c, full + s);
      } else {
#pragma unroll
        for (int p = 0; p < NPROD; ++p) {
          copy_tile(st + p * F32_TILE, fa[p] + ((size_t)c * B + row0) * K, B - row0, K, k0, t);
          copy_tile(st + (NPROD + p) * F32_TILE, fb[p] + ((size_t)c * P + col0) * K, P - col0,
                    K, k0, t);
        }
        mbar_arrive_cp_async(full + s);
      }
    };
    if (TMA) {
      // warp 0 keeps the ring full; warps 1-3 split
      if (t < 32) {
        if (t == 0)
          for (int step = 0; step < total; ++step) load(step);
        return;
      }
    } else {
      for (int step = 0; step < STAGES - 1; ++step) load(step);
    }
    const int st0 = TMA ? t - 32 : t, nst = TMA ? 96 : 128;  // splitting threads
    for (int step = 0; step < total; ++step) {
      if (!TMA) load(step + STAGES - 1);
      const int s = step % STAGES, b = step & 1, use = step >> 1;
      mbar_wait(full + s, (step / STAGES) & 1);
      if (use > 0) mbar_wait(pempty + b, (use - 1) & 1);
      const float* st = ring + s * STAGE_FLOATS;
      char* sp = parts + b * NPROD * SPLIT_BYTES;
#pragma unroll
      for (int p = 0; p < NPROD; ++p)
        split_b_tile(sp + p * SPLIT_BYTES, st + (NPROD + p) * F32_TILE, st0, nst);
      fence_proxy_async();
      mbar_arrive(pfull + b);
      mbar_arrive(empty + s);  // done reading stage s
    }
    if (!TMA) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wg = tid >> 7, t = tid & 127;
  float acc[NPROD][NACC], tb[NACC];
  uint32_t a[2][3][4];  // A fragments of the running batch and of the next
#pragma unroll
  for (int p = 0; p < NPROD; ++p)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[p][i] = 0.f;

  // the split A fragment of (chunk step, product p); a chunk's stage is
  // released after its last one
  auto fragment = [&](int step, int p, uint32_t (&ab)[3][4]) {
    const int s = step % STAGES;
    if (p == 0) mbar_wait(full + s, (step / STAGES) & 1);
    load_a_fragment(ab, ring + s * STAGE_FLOATS + p * F32_TILE + wg * 64 * KC, t);
    if (p == NPROD - 1) mbar_arrive(empty + s);
  };
  // Batch n (chunk n / NPROD, product n % NPROD) runs on a[n % 2] while the
  // fragment of batch n + 1 is read and split into the other set.
  auto chunk = [&](int step, auto first_set) {
    constexpr int F = decltype(first_set)::value;  // (step * NPROD) % 2
    const int b = step & 1;
    mbar_wait(pfull + b, (step >> 1) & 1);
    const char* sp = parts + b * NPROD * SPLIT_BYTES;
#pragma unroll
    for (int p = 0; p < NPROD; ++p) {
      start_batch(tb, a[(F + p) & 1], sp + p * SPLIT_BYTES);
      if (p + 1 < NPROD) {
        fragment(step, p + 1, a[(F + p + 1) & 1]);
      } else if (step + 1 < total) {
        fragment(step + 1, 0, a[(F + p + 1) & 1]);
      }
      finish_batch(acc[p], tb);
    }
    mbar_arrive(pempty + b);  // done with part buffer b
    if (step % nk == nk - 1) {
      epi(step / nk, acc);
#pragma unroll
      for (int p = 0; p < NPROD; ++p)
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[p][i] = 0.f;
    }
  };

  fragment(0, 0, a[0]);
  for (int step = 0; step < total; step += 2) {
    chunk(step, std::integral_constant<int, 0>());
    if (step + 1 < total) chunk(step + 1, std::integral_constant<int, NPROD % 2>());
  }
}

// Visit a consumer thread's accumulator cells: f(i, y) for accumulator i,
// with y at that cell (zero past the edge, where the product is 0). wgmma's
// layout: warp w of consumer g holds rows 64 g + 16 w + lane / 4 (+ 8), and
// of each 8-column group j the columns 8 j + 2 (lane % 4) (+ 1).
template <class CellFn>
__device__ __forceinline__ void for_each_cell(const float* ys, int tid, CellFn&& f) {
  const int lane = tid & 31, w = (tid >> 5) & 3, wg = tid >> 7;
  const int r0 = 64 * wg + 16 * w + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 yv = *reinterpret_cast<const float2*>(ys + y_index(r0 + 8 * h, c0 + 8 * j));
      f(4 * j + 2 * h, yv.x);
      f(4 * j + 2 * h + 1, yv.y);
    }
}

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the dynamic shared memory a kernel asks for: smem_bytes and room to align it
constexpr int launch_smem(int nprod, int stages) { return smem_bytes(nprod, stages) + 1024; }

__device__ __forceinline__ char* align_smem(char* raw) {
  return reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// Host: the tensor maps of N (C, rows[i], K) f32 matrices, in boxes of 16 k x
// 128 rows x 1 chain with the 64-byte swizzle; zeros past every edge. Needs
// K % 4 == 0 and 16-byte aligned bases. Returns a CUDA error code (0 = ok).
template <int N>
inline int encode_maps(TmaMaps<N>& maps, const float* const (&ptr)[N], const int (&rows)[N],
                       int C, int K) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                    cudaEnableDefault);
    if (err != cudaSuccess) return (int)err;
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  for (int i = 0; i < N; ++i) {
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows[i], (cuuint64_t)C};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 4, (cuuint64_t)rows[i] * K * 4};
    const cuuint32_t box[3] = {KC, ROWS, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(&maps.m[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                              const_cast<float*>(ptr[i]), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

inline int num_tiles(int B, int P) { return ((B + BM - 1) / BM) * ((P + BN - 1) / BN); }

// ---- the small-problem path: one chain and one tile per block ----
//
// At one chain, or at B < 128, the tiled walk above has nothing to overlap:
// a block runs K / 16 = 7 chunks, so its y-tile load, the first copies and
// its epilogue stand bare, one 169-209 KB block fills an SM, and at B = 10 a
// 128-row tile is 92 % zeros. Here a block is one warpgroup (128 threads)
// that owns 64 P rows and NB B columns of one chain, with no producer, no
// ring and no mbarrier:
//   - the roles swap: tout is wgmma's A side (m64) and bout the B side
//     (n = NB = 16, 32 or 64 by B), so at B = 10 every one of the
//     ceil(P / 64) blocks computes useful rows;
//   - both stream by K chunk from device memory into registers, one chunk
//     ahead of their use; tout values are split into wgmma fragments in
//     registers, bout values into a double-buffered part tile in shared
//     memory (12 KB per product at NB = 64), so 3-5 blocks share an SM;
//   - each chunk's six part products run into a fresh accumulator and are
//     added with the truncation's mean, as in the tiled path, in the mirror
//     order of its terms (tout part i times bout part j for the tiled path's
//     bout part j times tout part i), so each cell is formed alike;
//   - y is read once: each thread's cells are copied into shared memory with
//     cp.async when the block starts (eight lanes read 32 consecutive bytes
//     of a row of y) and wait there for the epilogue, with no staged tile;
//   - the block folds its sums into one slot, and the last block of a chain
//     to take a ticket (an atomic counter) adds the chain's slots in a fixed
//     order and resets the counter: one launch, and the result does not
//     depend on which block finished last.
namespace small {

constexpr int THREADS = 128;  // one warpgroup: it loads, splits, multiplies and folds
constexpr int MP = 64;        // P rows of a block: wgmma's M
constexpr int BATCH = 4;      // slots each thread of the last block keeps in flight

// the width (wgmma's N) of a block's B-side tile for B rows
__host__ __device__ constexpr int tile_n(int B) { return B <= 16 ? 16 : B <= 32 ? 32 : 64; }
__host__ __device__ constexpr int chunks(int K) { return (K + KC - 1) / KC; }
// shared memory: two buffers of each product's three bf16 part tiles of one
// chunk, then each thread's y values
__host__ __device__ constexpr int parts_bytes(int nprod, int nb) {
  return 2 * nprod * 3 * nb * KC * 2;
}
__host__ __device__ constexpr int smem_bytes(int nprod, int nb) {
  return parts_bytes(nprod, nb) + THREADS * (nb / 2) * 4;
}
// blocks per chain: P tiles along x (fastest, so neighbouring blocks share B rows), B tiles along y
inline dim3 grid(int C, int B, int P) {
  return dim3((P + MP - 1) / MP, (B + tile_n(B) - 1) / tile_n(B), C);
}
inline int blocks(int B, int P) { const dim3 g = grid(1, B, P); return (int)(g.x * g.y); }

#define VIHMC_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
// d (64 x N, f32) = A (64 x 16, registers) B (N x 16, shared)^T + (accumulate ? d : 0)
template <int N>
__device__ __forceinline__ void wgmma_64xn(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
        : VIHMC_D8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, "
        "p, 1, 1, 0;\n}\n"
        : VIHMC_D8(0), VIHMC_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    static_assert(N == 64, "tile widths 16, 32, 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,"
        "%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
        : VIHMC_D8(0), VIHMC_D8(8), VIHMC_D8(16), VIHMC_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}
#undef VIHMC_D8

// One batch: the six part products of one K chunk into the fresh
// accumulator t, smallest first; A (tout) parts a, B (bout) part tiles at sb,
// sb + ps, sb + 2 ps. The tiled path's order with the roles swapped.
template <int N>
__device__ __forceinline__ void start_batch(float (&t)[N / 2], const uint32_t (&a)[3][4],
                                            const char* sb, int ps) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_64xn<N>(t, a[0], part_desc(sb + 2 * ps), 0);
  wgmma_64xn<N>(t, a[1], part_desc(sb + ps), 1);
  wgmma_64xn<N>(t, a[2], part_desc(sb), 1);
  wgmma_64xn<N>(t, a[0], part_desc(sb + ps), 1);
  wgmma_64xn<N>(t, a[1], part_desc(sb), 1);
  wgmma_64xn<N>(t, a[0], part_desc(sb), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// f32 values of row `row`, k .. k + 1 (k + 3) of a (rows, K) matrix whose
// first row is src; zeros past the rows and past K. vec: K % 4 == 0 and src
// 16-byte aligned, so a whole vector is in or out.
__device__ __forceinline__ float2 load_row2(const float* __restrict__ src, int row, int nrows,
                                            int K, int k, bool vec) {
  float2 v = make_float2(0.f, 0.f);
  if (row >= nrows) return v;
  const float* p = src + (size_t)row * K + k;
  if (vec) {
    if (k < K) v = __ldg(reinterpret_cast<const float2*>(p));
  } else {
    if (k < K) v.x = __ldg(p);
    if (k + 1 < K) v.y = __ldg(p + 1);
  }
  return v;
}

__device__ __forceinline__ float4 load_row4(const float* __restrict__ src, int row, int nrows,
                                            int K, int k, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= nrows) return v;
  const float* p = src + (size_t)row * K + k;
  if (vec) {
    if (k < K) v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (k < K) v.x = __ldg(p);
    if (k + 1 < K) v.y = __ldg(p + 1);
    if (k + 2 < K) v.z = __ldg(p + 2);
    if (k + 3 < K) v.w = __ldg(p + 3);
  }
  return v;
}

// this thread's A-fragment values of the chunk at k0 of a 64-row tout tile:
// rows g, g + 8 and k 2 (lane % 4) + {0, 1}, + 8 (t = thread, g = 16 warp + lane / 4)
__device__ __forceinline__ void load_a(float2 (&r)[4], const float* __restrict__ src, int nrows,
                                       int K, int k0, bool vec, int t) {
  const int lane = t & 31, row = 16 * (t >> 5) + (lane >> 2), k = k0 + 2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    r[q] = load_row2(src, row + 8 * (q & 1), nrows, K, k + 8 * (q >> 1), vec);
}

// float4 units of one chunk's NB x 16 bout tile that each thread copies
template <int NB>
__host__ __device__ constexpr int b_units() { return (NB * 4 + THREADS - 1) / THREADS; }

// This thread's float4 units of the chunk at k0 of an NB-row bout tile: unit
// e = t + 128 j covers row 8 (e / 32) + e % 8 and k = k0 + 4 ((e / 8) % 4), so
// a warp reads 8 rows x 64 bytes and later stores 256 contiguous bytes.
template <int NB>
__device__ __forceinline__ void load_b(float4 (&r)[b_units<NB>()], const float* __restrict__ src,
                                       int nrows, int K, int k0, bool vec, int t) {
#pragma unroll
  for (int j = 0; j < b_units<NB>(); ++j) {
    const int e = t + j * THREADS;
    r[j] = e < NB * 4 ? load_row4(src, (e >> 5) * 8 + (e & 7), nrows, K, k0 + 4 * ((e >> 3) & 3),
                                  vec)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Split this thread's units into the chunk's three bf16 part tiles at dst,
// dst + NB x 32, dst + NB x 64 bytes, in wgmma's K-major layout of part_offset.
template <int NB>
__device__ __forceinline__ void split_b(char* dst, const float4 (&r)[b_units<NB>()], int t) {
  constexpr int CB = NB * KC * 2;  // bytes of one part tile
#pragma unroll
  for (int j = 0; j < b_units<NB>(); ++j) {
    const int e = t + j * THREADS, u = e & 31, q = u >> 3;
    if (e >= NB * 4) break;
    uint2 p0, p1, p2;
    split3(make_float2(r[j].x, r[j].y), p0.x, p1.x, p2.x);
    split3(make_float2(r[j].z, r[j].w), p0.y, p1.y, p2.y);
    const int off = (e >> 5) * 256 + (q >> 1) * 128 + (u & 7) * 16 + (q & 1) * 8;
    *reinterpret_cast<uint2*>(dst + off) = p0;
    *reinterpret_cast<uint2*>(dst + CB + off) = p1;
    *reinterpret_cast<uint2*>(dst + 2 * CB + off) = p2;
  }
}

// The NPROD products of one block: acc[p] (64 x NB, this thread's cells) =
// tout tile fp[p] (np valid rows) times the bout tile fb[p] (nb valid rows)^T.
// Both operands stream by K chunk: chunk c + 1's f32 values are loaded into
// registers while chunk c runs; then its bout values are split into part
// buffer (c + 1) % 2 and its tout values into wgmma fragments, and its batch
// runs. One barrier per chunk: buffer c % 2 was last read by chunk c - 2's
// wgmmas, which every warp waited for before the barrier of chunk c - 1.
// (Loading two chunks ahead, or splitting chunk c + 1 while chunk c's batch
// runs, took 140-230 registers a thread, and the blocks an SM lost made
// either slower on the card.)
template <int NPROD, int NB>
__device__ __forceinline__ void products(char* smem, const float* const (&fb)[NPROD],
                                         const float* const (&fp)[NPROD], int nb, int np, int K,
                                         bool vec, float (&acc)[NPROD][NB / 2]) {
  constexpr int CB = NB * KC * 2;
  const int t = threadIdx.x, nch = chunks(K);
  float tb[NB / 2];
  float2 ra[NPROD][4];
  float4 rb[NPROD][b_units<NB>()];
  uint32_t a[3][4];
#pragma unroll
  for (int p = 0; p < NPROD; ++p) {
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[p][i] = 0.f;
    load_a(ra[p], fp[p], np, K, 0, vec, t);
    load_b<NB>(rb[p], fb[p], nb, K, 0, vec, t);
  }
  for (int c = 0; c < nch; ++c) {
    const int next = (c + 1) * KC;
    char* buf = smem + (c & 1) * NPROD * 3 * CB;
#pragma unroll
    for (int p = 0; p < NPROD; ++p) {
      split_b<NB>(buf + p * 3 * CB, rb[p], t);
      load_b<NB>(rb[p], fb[p], nb, K, next, vec, t);
    }
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int p = 0; p < NPROD; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) split3(ra[p][q], a[0][q], a[1][q], a[2][q]);
      load_a(ra[p], fp[p], np, K, next, vec, t);
      start_batch<NB>(tb, a, buf + p * 3 * CB, CB);
      finish_batch(acc[p], tb);
    }
  }
}

// Copy y at this thread's cells of the block's tile into its own column of
// ys (ys[i][t], so the epilogue's reads are free of bank conflicts) with
// cp.async, at the start of the block; y points at the tile's corner, row b0
// and column p0 of the (B, P) array. Accumulator i holds P row 16 warp +
// lane / 4 (+ 8 for bit 1 of i) and B column 8 (i / 4) + 2 (lane % 4) + (i %
// 2); past the edge the copy writes a zero, as the product is 0 there.
template <int NB>
__device__ __forceinline__ void prefetch_y(float* ys, const float* __restrict__ y, int P, int nb,
                                           int np, int t) {
  const int lane = t & 31, r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) {
    const int pr = r0 + 8 * ((i >> 1) & 1), bc = c0 + 8 * (i >> 2) + (i & 1);
    const bool in = pr < np && bc < nb;
    cp_async4(ys + i * THREADS + t, in ? y + (size_t)bc * P + pr : y, in ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for this thread's y copies (no other thread reads them)
__device__ __forceinline__ void wait_y() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Fold the block's per-thread sums s into its slot, slots[blk]; the chain's
// last block to take a ticket adds the chain's nblk slots in a fixed order
// into out (thread t adds slots t, t + 128, ... in turn, then a fixed tree
// over the threads), and sets the ticket back to 0 for the next launch.
template <int NSUM, class T, class Out>
__device__ __forceinline__ void fold(T (&s)[NSUM], double* __restrict__ slots,
                                     unsigned* ticket, Out* __restrict__ out, int blk,
                                     int nblk) {
  __shared__ double red[NSUM][THREADS];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int v = 0; v < NSUM; ++v) s[v] = warp_sum(s[v]);
  if (lane == 0)
#pragma unroll
    for (int v = 0; v < NSUM; ++v) red[v][warp] = (double)s[v];
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int v = 0; v < NSUM; ++v)
      slots[(size_t)blk * NSUM + v] = ((red[v][0] + red[v][1]) + red[v][2]) + red[v][3];
    __threadfence();  // the slot is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == (unsigned)(nblk - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double acc[NSUM];
#pragma unroll
  for (int v = 0; v < NSUM; ++v) acc[v] = 0.0;
  for (int i0 = t; i0 < nblk; i0 += BATCH * THREADS) {
    double sv[BATCH][NSUM];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
#pragma unroll
      for (int v = 0; v < NSUM; ++v) {
        const int i = i0 + j * THREADS;
        sv[j][v] = i < nblk ? __ldcg(slots + (size_t)i * NSUM + v) : 0.0;
      }
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
#pragma unroll
      for (int v = 0; v < NSUM; ++v) acc[v] += sv[j][v];
  }
#pragma unroll
  for (int v = 0; v < NSUM; ++v) red[v][t] = acc[v];
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (t < h)
#pragma unroll
      for (int v = 0; v < NSUM; ++v) red[v][t] += red[v][t + h];
    __syncthreads();
  }
  if (t < NSUM) out[t] = (Out)red[t][0];
  if (t == 0) *ticket = 0u;
}

}  // namespace small

}  // namespace split_mma
