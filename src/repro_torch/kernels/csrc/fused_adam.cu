// Fused masked AdamW for Hopper (sm_90a): one streaming pass over a
// stacked (N, M) leaf, updating p, m and v in place.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_adam.py::fused_adamw_2d
// and computes the same function, element by element, in fp32:
//
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   p' = p - lr*((m'/bc1) / (sqrt(v'/bc2) + eps) + wd*p)
//
// then blends each row with its freeze mask mk (mask == nullptr: every row
// on): p <- mk*p' + (1-mk)*p, and the same for m and v, so a row with
// mk = 0 keeps its p, m and v (the paper's non-participant semantics).
// The blend is computed, not skipped, so the result equals the plain
// PyTorch version bit for bit on every input, signed zeros included.
//
// Numerics.  Every operation is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn): nvcc would
// otherwise contract b1*m + (1-b1)*g into an FMA, which rounds once where
// the plain version (one PyTorch op per step) rounds twice.  With this op
// order fp32 results are bit-exact against kernels/ref.py::fused_adamw_2d.
// A bf16 p is widened to fp32 and rounded back once (round to nearest
// even, as Tensor.to(torch.bfloat16)); m and v are fp32 always.
//
// Layout: p (N, M) fp32 or bf16; g (N, M) fp32 or bf16; m, v (N, M) fp32;
// mask (N,) fp32 or nullptr; the nine hyper-parameters by value.  All
// indices are 64-bit: a Gemma-2B client embedding leaf at N = 2 is
// 1.05e9 elements, and four clients pass 2^31.
//
// What bounds it.  Each element reads p, g, m, v and writes p, m, v: 28
// bytes at fp32 for ~20 flops, far below the card's ~20 flops per byte at
// fp32, so memory bounds it.  Design: blockIdx.y is the row (its mask read
// once), a grid-stride loop over the row's columns in x; each step a block
// covers VEC * 256 columns, warp accesses stay coalesced, 64-bit offsets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;

struct Hypers {
  float lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

template <typename P, typename G>
__global__ void __launch_bounds__(THREADS)
fused_adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   const float* __restrict__ mask, int64_t cols, Hypers h) {
  const int64_t row = blockIdx.y;
  const float mk = mask ? mask[row] : 1.0f;
  const float omk = __fsub_rn(1.0f, mk);
  const int64_t base = row * cols;
  const int64_t stride = (int64_t)gridDim.x * THREADS * VEC;
  for (int64_t c0 = (int64_t)blockIdx.x * THREADS * VEC + threadIdx.x;
       c0 < cols; c0 += stride) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int64_t c = c0 + (int64_t)k * THREADS;
      if (c >= cols) break;
      const int64_t i = base + c;
      const float p32 = to_f32(p[i]);
      const float g32 = to_f32(g[i]);
      const float m0 = m[i];
      const float v0 = v[i];
      const float mn = __fadd_rn(__fmul_rn(h.b1, m0), __fmul_rn(h.omb1, g32));
      const float vn = __fadd_rn(__fmul_rn(h.b2, v0),
                                 __fmul_rn(h.omb2, __fmul_rn(g32, g32)));
      const float mhat = __fdiv_rn(mn, h.bc1);
      const float vhat = __fdiv_rn(vn, h.bc2);
      const float den = __fadd_rn(__fsqrt_rn(vhat), h.eps);
      const float step = __fadd_rn(__fdiv_rn(mhat, den), __fmul_rn(h.wd, p32));
      const float pn = __fsub_rn(p32, __fmul_rn(h.lr, step));
      from_f32(&p[i], __fadd_rn(__fmul_rn(mk, pn), __fmul_rn(omk, p32)));
      m[i] = __fadd_rn(__fmul_rn(mk, mn), __fmul_rn(omk, m0));
      v[i] = __fadd_rn(__fmul_rn(mk, vn), __fmul_rn(omk, v0));
    }
  }
}

template <typename P, typename G>
int launch(void* p, const void* g, float* m, float* v, const float* mask,
           int64_t rows, int64_t cols, const Hypers& h, cudaStream_t stream) {
  const int64_t per_block = (int64_t)THREADS * VEC;
  int64_t bx = (cols + per_block - 1) / per_block;
  // enough blocks to fill 132 SMs several times over; the loop strides
  // over the rest of the row
  const int64_t cap = (132 * 16 + rows - 1) / rows;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)rows);
  fused_adamw_kernel<P, G><<<grid, THREADS, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), m, v, mask, cols, h);
  return (int)cudaGetLastError();
}

}  // namespace

// p_dtype / g_dtype: 0 = float32, 1 = bfloat16.  mask may be null (every
// row on).  rows <= 65535.  Returns 0 or the cudaError_t of the launch.
extern "C" int fused_adamw_2d(void* p, const void* g, void* m, void* v,
                              const void* mask, long long rows, long long cols,
                              int p_dtype, int g_dtype, float lr, float b1,
                              float b2, float omb1, float omb2, float eps,
                              float wd, float bc1, float bc2, void* stream) {
  if (rows < 1 || rows > 65535 || cols < 1) return (int)cudaErrorInvalidValue;
  const Hypers h{lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  const float* mk = static_cast<const float*>(mask);
  if (p_dtype == 0 && g_dtype == 0)
    return launch<float, float>(p, g, mm, vv, mk, rows, cols, h, st);
  if (p_dtype == 0 && g_dtype == 1)
    return launch<float, __nv_bfloat16>(p, g, mm, vv, mk, rows, cols, h, st);
  if (p_dtype == 1 && g_dtype == 0)
    return launch<__nv_bfloat16, float>(p, g, mm, vv, mk, rows, cols, h, st);
  if (p_dtype == 1 && g_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, g, mm, vv, mk, rows, cols, h, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
