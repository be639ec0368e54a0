// Weighted client average for Hopper (sm_90a): theta = w^T X over a
// stacked (N, M) leaf, one pass over the stack.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wavg.py::weighted_average_2d
// and computes the same function: out[j] = sum_i w[i] * x[i, j], summed in
// fp32 in index order i = 0 .. N-1 (one fmaf per client), written once in
// the stack's dtype (fp32 or bf16, rounded to nearest even).  The plain
// version is an fp32 matrix product (cuBLAS on the card), which may order
// or fuse the N products otherwise: the two agree within a few fp32 ulps
// of the output, the band chip_smoke.py holds them to.
//
// Layout: x (N, M) fp32 or bf16, w (N,) fp32, out (M,) in x's dtype.  All
// offsets are 64-bit (a Gemma-2B client embedding stack at N = 2 has
// 1.05e9 elements).
//
// What bounds it.  Each column reads N values and writes one, for 2N
// flops: memory bounds it (N*M*itemsize + M*itemsize bytes).  Design: the
// N weights go to shared memory once per block; each thread owns a column
// at a time in a grid-stride loop, so the N reads of a warp are N
// coalesced row segments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 4096;   // weights staged in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wavg_kernel(const T* __restrict__ x, const float* __restrict__ w,
            T* __restrict__ out, int rows, int64_t cols) {
  __shared__ float sw[MAX_ROWS];
  for (int i = threadIdx.x; i < rows; i += THREADS) sw[i] = w[i];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x; c < cols;
       c += stride) {
    float acc = 0.0f;
    for (int i = 0; i < rows; ++i) acc = fmaf(sw[i], to_f32(x[(int64_t)i * cols + c]), acc);
    from_f32(&out[c], acc);
  }
}

template <typename T>
int launch(const void* x, const float* w, void* out, int rows, int64_t cols,
           cudaStream_t stream) {
  int64_t blocks = (cols + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  wavg_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), rows, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  1 <= rows <= 4096, cols >= 1.
// Returns 0 or the cudaError_t of the launch.
extern "C" int weighted_average_2d(const void* x, const void* w, void* out,
                                   int rows, long long cols, int dtype,
                                   void* stream) {
  if (rows < 1 || rows > MAX_ROWS || cols < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ww = static_cast<const float*>(w);
  if (dtype == 0) return launch<float>(x, ww, out, rows, cols, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, ww, out, rows, cols, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* weighted_average_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
