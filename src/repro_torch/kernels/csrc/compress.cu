// Update- and activation-path compression for Hopper (sm_90a): three
// streaming elementwise passes over a (N, M) row-major fp32 matrix with one
// value per row.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/compress.py:
//
//   quantize_stochastic_2d (:53)  q = clip(floor(x * inv_step[r] + u), +-levels)
//                                 -> int8 codes
//   dequantize_2d          (:89)  out = float(q) * step[r]
//   topk_mask_2d           (:120) out = |x| >= thresh[r] ? x : 0
//
// and computes the same functions element by element.  The per-row
// inputs (inv_step, step, thresh) come from plain reductions outside the
// kernels, as in the JAX package; the uniform draws u are an input.
//
// Numerics.  The pre-floor value x * inv_step + u is one fmaf, rounded
// once: XLA contracts the JAX oracle's multiply-add into a fused
// multiply-add, and a product rounded first would move a value across an
// integer (and its code by one) about once in 8 M elements.  The plain
// PyTorch version (kernels/ref.py) rounds once too, so codes are
// bit-exact.  The clip bounds are integral, so the conversion to int8 is
// exact.  Dequantize is one rounded product; the mask is a comparison and
// a select: both bit-exact.
//
// Layout: x, u (N, M) fp32; q (N, M) int8; inv_step, step, thresh (N,)
// fp32; levels by value.  Offsets are 64-bit (a Gemma-2B client
// embedding leaf at N = 4 passes 2^31 elements).  Rows stride over
// gridDim.y (any N), columns over a grid-stride loop in x.
//
// What bounds them.  Per element quantize moves 9 bytes (x, u in; q out)
// for ~4 flops, dequantize 5 bytes for 1, the mask 8 bytes for 2: far
// below the card's ~20 fp32 flops per byte, so memory bounds all three.
// Design: each step of a block covers VEC * 256 consecutive columns with
// coalesced warp accesses; no shared memory, no reduction across blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ u,
                const float* __restrict__ inv_step, int8_t* __restrict__ q,
                int64_t rows, int64_t cols, float levels) {
  const int64_t stride = (int64_t)gridDim.x * THREADS * VEC;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const float inv = inv_step[row];
    const int64_t base = row * cols;
    for (int64_t c0 = (int64_t)blockIdx.x * THREADS * VEC + threadIdx.x;
         c0 < cols; c0 += stride) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int64_t c = c0 + (int64_t)k * THREADS;
        if (c >= cols) break;
        const int64_t i = base + c;
        float v = floorf(fmaf(x[i], inv, u[i]));
        v = fminf(fmaxf(v, -levels), levels);
        q[i] = (int8_t)__float2int_rz(v);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ step,
                  float* __restrict__ out, int64_t rows, int64_t cols) {
  const int64_t stride = (int64_t)gridDim.x * THREADS * VEC;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const float s = step[row];
    const int64_t base = row * cols;
    for (int64_t c0 = (int64_t)blockIdx.x * THREADS * VEC + threadIdx.x;
         c0 < cols; c0 += stride) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int64_t c = c0 + (int64_t)k * THREADS;
        if (c >= cols) break;
        const int64_t i = base + c;
        out[i] = __fmul_rn((float)q[i], s);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
topk_mask_kernel(const float* __restrict__ x, const float* __restrict__ thresh,
                 float* __restrict__ out, int64_t rows, int64_t cols) {
  const int64_t stride = (int64_t)gridDim.x * THREADS * VEC;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const float t = thresh[row];
    const int64_t base = row * cols;
    for (int64_t c0 = (int64_t)blockIdx.x * THREADS * VEC + threadIdx.x;
         c0 < cols; c0 += stride) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int64_t c = c0 + (int64_t)k * THREADS;
        if (c >= cols) break;
        const int64_t i = base + c;
        const float v = x[i];
        out[i] = fabsf(v) >= t ? v : 0.0f;
      }
    }
  }
}

// enough blocks to fill 132 SMs several times over; the loops stride over
// the rest
dim3 grid_for(int64_t rows, int64_t cols) {
  const int64_t per_block = (int64_t)THREADS * VEC;
  const int64_t gy = rows < MAX_GRID_Y ? rows : MAX_GRID_Y;
  int64_t bx = (cols + per_block - 1) / per_block;
  const int64_t cap = (132 * 16 + gy - 1) / gy;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  return dim3((unsigned)bx, (unsigned)gy);
}

bool bad_shape(long long rows, long long cols) { return rows < 1 || cols < 1; }

}  // namespace

// Each entry point returns 0 or the cudaError_t of its launch.  rows >= 1
// and cols >= 1: the wrapper returns an empty result itself for M = 0.
extern "C" int quantize_stochastic_2d(const void* x, const void* u,
                                      const void* inv_step, void* q,
                                      long long rows, long long cols,
                                      float levels, void* stream) {
  if (bad_shape(rows, cols)) return (int)cudaErrorInvalidValue;
  quantize_kernel<<<grid_for(rows, cols), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(inv_step), static_cast<int8_t*>(q), rows, cols,
      levels);
  return (int)cudaGetLastError();
}

extern "C" int dequantize_2d(const void* q, const void* step, void* out,
                             long long rows, long long cols, void* stream) {
  if (bad_shape(rows, cols)) return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<grid_for(rows, cols), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(step),
      static_cast<float*>(out), rows, cols);
  return (int)cudaGetLastError();
}

extern "C" int topk_mask_2d(const void* x, const void* thresh, void* out,
                            long long rows, long long cols, void* stream) {
  if (bad_shape(rows, cols)) return (int)cudaErrorInvalidValue;
  topk_mask_kernel<<<grid_for(rows, cols), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(thresh),
      static_cast<float*>(out), rows, cols);
  return (int)cudaGetLastError();
}

extern "C" const char* compress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
