// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rg_lru.py::rg_lru_scan
// and computes the same function: h_t = exp(log_a_t) * h_{t-1} + b_t over
// the sequence, from h_0 = 0, per (batch row, channel), in fp32; h is
// stored in b's type.  Each step rounds as the plain version does (expf,
// then a rounded multiply, then a rounded add: __fmul_rn / __fadd_rn keep
// nvcc from contracting them into an FMA), so the two agree bit for bit
// where torch's CUDA exp and expf agree.
//
// Layout: log_a (B, S, W) fp32; b and h (B, S, W) in T (fp32 or bf16).
//
// Design.  One thread per (batch row, channel) walks the whole sequence
// with h in a register; neighbouring threads take neighbouring channels,
// so every load and store of a step is coalesced across W.  The loads do
// not depend on h, so they run ahead of it: the loop is software-pipelined
// over blocks of U steps, the next block's 2U loads in flight while the
// current block's U dependent multiply-adds run.  Blocks of 64 threads
// spread the B * W threads over as many SMs as there are blocks.
//
// What bounds it.  At RecurrentGemma-2B's prefill shape (B 2, S 4096,
// W 2560, fp32) the function moves 251.7 MB, ~75 us at 3.35 TB/s, and
// does 3 operations an element.  But only B * W = 5120 threads run, 80
// blocks of 64 on 132 SMs, each with a chain of S dependent steps: the
// kernel is bound by latency (the memory latency the pipelining does not
// hide, and the multiply-add chain), not by either rate.  A chunked
// two-pass scan over S (parallel chunk summaries, then a fix-up) is the
// way to fill the card; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 16;          // steps a pipelined block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rg_lru_kernel(const float* __restrict__ log_a, const T* __restrict__ bv,
              T* __restrict__ h_out, int B, int S, int W) {
  const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (gid >= (long long)B * W) return;
  const int b = (int)(gid / W), w = (int)(gid % W);
  const size_t base = (size_t)b * S * W + w;
  const float* la = log_a + base;
  const T* bb = bv + base;
  T* hh = h_out + base;

  float cur_a[U], cur_b[U], nxt_a[U], nxt_b[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    cur_a[u] = u < S ? la[(size_t)u * W] : 0.f;
    cur_b[u] = u < S ? to_f(bb[(size_t)u * W]) : 0.f;
  }
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    const int t1 = t0 + U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = t1 + u < S;
      nxt_a[u] = in ? la[(size_t)(t1 + u) * W] : 0.f;
      nxt_b[u] = in ? to_f(bb[(size_t)(t1 + u) * W]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        h = __fadd_rn(__fmul_rn(expf(cur_a[u]), h), cur_b[u]);
        store(&hh[(size_t)(t0 + u) * W], h);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur_a[u] = nxt_a[u];
      cur_b[u] = nxt_b[u];
    }
  }
}

template <typename T>
int launch(const float* log_a, const void* b, void* h, int B, int S, int W,
           cudaStream_t stream) {
  const long long n = (long long)B * W;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  rg_lru_kernel<T><<<blocks, THREADS, 0, stream>>>(
      log_a, static_cast<const T*>(b), static_cast<T*>(h), B, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of b and h): 0 = float32, 1 = bfloat16; log_a is float32.
// Returns 0 or the cudaError_t of the launch.
extern "C" int rg_lru_fwd(const void* log_a, const void* b, void* h, int B,
                          int S, int W, int dtype, void* stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  if (dtype == 0) return launch<float>(la, b, h, B, S, W, st);
  if (dtype == 1) return launch<__nv_bfloat16>(la, b, h, B, S, W, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rg_lru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
