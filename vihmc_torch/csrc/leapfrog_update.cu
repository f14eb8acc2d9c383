// Fused leapfrog half-kick + drift for Hopper.
//
// Replaces the Pallas TPU kernel `_fused_tpu` (vihmc_tpu/ops/leapfrog.py:46-72,
// body `_kernel` :39), which no sampler of the JAX package calls; the port
// keeps it as the building block of a fused trajectory. For every element i
// of the flat (..., D) batch, with the diagonal inverse mass broadcast along
// the last axis,
//
//     p_half = p + (0.5 eps) g
//     q_new  = q + (eps inv_mass) p_half
//
// What bounds it on an H100: bytes. It reads q, p, g once and writes q_new and
// p_half once, 20 bytes per element plus the (D,) inverse mass, and does 5
// flops per element: at C = 16, D = 81,131 that is ~26 MB, ~7.8 us at
// 3.35 TB/s. So the design only moves bytes well: one grid-stride pass, 16-byte
// vector loads and stores of q, p, g and both outputs where the pointers are
// aligned (a scalar kernel otherwise), the inverse mass read per element
// through the read-only cache (D is odd at the reference shape, so it is not
// vectorised). Each product and sum rounds separately (__fmul_rn/__fadd_rn,
// no FMA contraction), in the order of the plain PyTorch version, so the
// kernel agrees with it bit for bit. CUDA rather than Triton keeps the build
// on one route with one tool (nvcc); a Triton kernel would suit the pass as well.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 4096;

__device__ __forceinline__ void update(float q, float p, float g, float im,
                                       float eps, float half_eps,
                                       float* q_new, float* p_half) {
  const float ph = __fadd_rn(p, __fmul_rn(half_eps, g));
  *p_half = ph;
  *q_new = __fadd_rn(q, __fmul_rn(__fmul_rn(eps, im), ph));
}

// float4 over the first 4 * n4 elements, then the n - 4 * n4 tail elements
__global__ void __launch_bounds__(THREADS)
leapfrog_vec4(const float4* __restrict__ q, const float4* __restrict__ p,
              const float4* __restrict__ g, const float* __restrict__ im,
              float4* __restrict__ q_out, float4* __restrict__ p_out,
              long long n, int dim_im, float eps, float half_eps) {
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long t = gid; t < n4; t += stride) {
    const float4 qv = q[t], pv = p[t], gv = g[t];
    int j = (int)((4 * t) % dim_im);
    float4 qn, pn;
    update(qv.x, pv.x, gv.x, __ldg(im + j), eps, half_eps, &qn.x, &pn.x);
    if (++j == dim_im) j = 0;
    update(qv.y, pv.y, gv.y, __ldg(im + j), eps, half_eps, &qn.y, &pn.y);
    if (++j == dim_im) j = 0;
    update(qv.z, pv.z, gv.z, __ldg(im + j), eps, half_eps, &qn.z, &pn.z);
    if (++j == dim_im) j = 0;
    update(qv.w, pv.w, gv.w, __ldg(im + j), eps, half_eps, &qn.w, &pn.w);
    q_out[t] = qn;
    p_out[t] = pn;
  }
  const long long i = 4 * n4 + gid;
  if (i < n) {
    const float* qs = reinterpret_cast<const float*>(q);
    const float* ps = reinterpret_cast<const float*>(p);
    const float* gs = reinterpret_cast<const float*>(g);
    update(qs[i], ps[i], gs[i], __ldg(im + (int)(i % dim_im)), eps, half_eps,
           reinterpret_cast<float*>(q_out) + i, reinterpret_cast<float*>(p_out) + i);
  }
}

__global__ void __launch_bounds__(THREADS)
leapfrog_scalar(const float* __restrict__ q, const float* __restrict__ p,
                const float* __restrict__ g, const float* __restrict__ im,
                float* __restrict__ q_out, float* __restrict__ p_out,
                long long n, int dim_im, float eps, float half_eps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    update(q[i], p[i], g[i], __ldg(im + (int)(i % dim_im)), eps, half_eps,
           q_out + i, p_out + i);
}

}  // namespace

extern "C" {

// Launches one kernel on `stream`; returns cudaGetLastError() (0 = ok).
// q, p, g, q_out, p_out hold n contiguous f32 values; im holds dim_im f32
// values (dim_im = D, or 1 for a scalar inverse mass) broadcast along the
// last axis. vec = 1 takes the float4 kernel (all five big pointers 16-byte
// aligned), vec = 0 the scalar one.
int vihmc_leapfrog_update(const float* q, const float* p, const float* g,
                          const float* im, float* q_out, float* p_out,
                          long long n, int dim_im, float eps, float half_eps,
                          int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  if (vec) {
    leapfrog_vec4<<<(unsigned)blocks, THREADS, 0, st>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(p),
        reinterpret_cast<const float4*>(g), im, reinterpret_cast<float4*>(q_out),
        reinterpret_cast<float4*>(p_out), n, dim_im, eps, half_eps);
  } else {
    leapfrog_scalar<<<(unsigned)blocks, THREADS, 0, st>>>(q, p, g, im, q_out, p_out,
                                                          n, dim_im, eps, half_eps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
