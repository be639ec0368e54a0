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
// Design.  One CTA per (batch row, CH = 32 consecutive channels): 160
// CTAs at RecurrentGemma-2B's prefill shape (B 2, W 2560).  Warp 0 is the
// chain: lane c walks channel c's whole sequence with h in a register, one
// rounded multiply and one rounded add a step, and stores h (a warp's step
// is one coalesced 128-byte row).  Warps 1-4 are the loaders: they keep a
// ring of STAGES shared-memory stages, each T = 64 steps x 32 channels of
// exp(log_a) and b, AHEAD stages in flight with cp.async (16-byte copies;
// 2 x 16 KB a CTA, ~5 MB across the card at fp32; deeper rings, with 3
// or 5 stages in flight, ran slower on the H100), and turn each landed
// stage's log_a into expf(log_a) in place before they hand it to the
// chain through an mbarrier, so the chain's loop holds no exp.  Positions past S
// and channels past W are zero-filled (exp 1, b 0: h unchanged) and never
// stored; a row that is not 16-byte aligned (W not a multiple of 4, or of
// 8 for bf16 b) or a ragged 16-byte unit is copied element by element.
//
// What bounds it.  At the prefill shape (B 2, S 4096, W 2560, fp32) the
// function moves 251.7 MB, ~75 us at 3.35 TB/s, and does 3 operations an
// element: bytes.  The chain's dependent multiply-add is ~8 cycles a step,
// ~33k cycles (~18 us) over S 4096, so the memory system, fed by the ring,
// sets how close the kernel comes to the bytes' time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int CH = 32;            // channels a CTA: the chain warp's lanes
constexpr int T = 64;             // steps a stage
constexpr int STAGES = 3;
constexpr int AHEAD = 2;          // stages the loaders keep in flight
constexpr int LOADERS = 128;      // warps 1-4
constexpr int THREADS = 32 + LOADERS;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16* p) { *p = __float2bfloat16(0.f); }

template <typename TB>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * T * CH * (sizeof(float) + sizeof(TB)) + 16 * STAGES;
}

// one 16-byte unit (E elements) of a stage row: a cp.async when the unit
// is aligned and wholly inside the tensor, else element by element with
// zeros outside it
template <typename E>
__device__ __forceinline__ void load_unit(E* dst, const E* src, bool vec,
                                          bool t_in, int w, int W) {
  constexpr int N = 16 / sizeof(E);
  if (vec && t_in && w + N <= W) {
    sm90::cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (t_in && w + e < W) dst[e] = src[e];
    else zero(dst + e);
  }
}

template <typename TB>
__global__ void __launch_bounds__(THREADS)
rg_lru_kernel(const float* __restrict__ log_a, const TB* __restrict__ bv,
              TB* __restrict__ h_out, int S, int W, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* se = reinterpret_cast<float*>(smem);                           // [STAGES][T][CH]
  TB* sb = reinterpret_cast<TB*>(smem + (size_t)STAGES * T * CH * 4);   // [STAGES][T][CH]
  const uint32_t bar_full =
      sm90::smem_u32(smem + (size_t)STAGES * T * CH * (4 + sizeof(TB)));
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int w0 = blockIdx.x * CH, b = blockIdx.y, tid = threadIdx.x;
  const int nst = (S + T - 1) / T;
  const size_t base = (size_t)b * S * W + w0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full + 8 * s, LOADERS);
      sm90::mbar_init(bar_empty + 8 * s, 32);
    }
  }
  __syncthreads();

  if (tid < 32) {
    // the chain
    const bool live = w0 + tid < W;
    TB* out = h_out + base + tid;
    float h = 0.f;
    for (int k = 0; k < nst; ++k) {
      const int s = k % STAGES;
      sm90::mbar_wait(bar_full + 8 * s, (k / STAGES) & 1);
      const float* e = se + (size_t)s * T * CH + tid;
      const TB* bb = sb + (size_t)s * T * CH + tid;
      TB* o = out + (size_t)k * T * W;
      if (k * T + T <= S) {
#pragma unroll 16
        for (int u = 0; u < T; ++u) {
          h = __fadd_rn(__fmul_rn(e[u * CH], h), to_f(bb[u * CH]));
          if (live) store(&o[(size_t)u * W], h);
        }
      } else {
        for (int u = 0; u < S - k * T; ++u) {
          h = __fadd_rn(__fmul_rn(e[u * CH], h), to_f(bb[u * CH]));
          if (live) store(&o[(size_t)u * W], h);
        }
      }
      sm90::mbar_arrive(bar_empty + 8 * s);
    }
    return;
  }

  // the loaders: thread lt copies the same 16-byte units of every stage
  const int lt = tid - 32;
  constexpr int A_UNITS = T * CH * 4 / 16;                 // log_a units a stage
  constexpr int B_UNITS = T * CH * (int)sizeof(TB) / 16;   // b units a stage
  constexpr int A_PER_ROW = CH * 4 / 16, B_PER_ROW = CH * (int)sizeof(TB) / 16;
  constexpr int A_ELEMS = 4, B_ELEMS = 16 / (int)sizeof(TB);
  auto load_stage = [&](int k) {
    if (k < nst) {
      const int s = k % STAGES;
      sm90::mbar_wait(bar_empty + 8 * s, ((k / STAGES) & 1) ^ 1);
      for (int i = lt; i < A_UNITS; i += LOADERS) {
        const int row = i / A_PER_ROW, c = (i % A_PER_ROW) * A_ELEMS;
        const int t = k * T + row;
        load_unit(se + ((size_t)s * T + row) * CH + c, log_a + base + (size_t)t * W + c,
                  vec, t < S, w0 + c, W);
      }
      for (int i = lt; i < B_UNITS; i += LOADERS) {
        const int row = i / B_PER_ROW, c = (i % B_PER_ROW) * B_ELEMS;
        const int t = k * T + row;
        load_unit(sb + ((size_t)s * T + row) * CH + c, bv + base + (size_t)t * W + c,
                  vec, t < S, w0 + c, W);
      }
    }
    sm90::cp_async_commit();   // empty past the last stage: one group a stage
  };
  for (int k = 0; k < AHEAD; ++k) load_stage(k);
  for (int k = 0; k < nst; ++k) {
    const int s = k % STAGES;
    sm90::cp_async_wait<AHEAD - 1>();   // this thread's copies of stage k landed
    for (int i = lt; i < A_UNITS; i += LOADERS) {
      float4* p = reinterpret_cast<float4*>(se + (size_t)s * T * CH) + i;
      float4 v = *p;
      v.x = expf(v.x);
      v.y = expf(v.y);
      v.z = expf(v.z);
      v.w = expf(v.w);
      *p = v;
    }
    sm90::mbar_arrive(bar_full + 8 * s);
    load_stage(k + AHEAD);
  }
}

template <typename TB>
int launch(const float* log_a, const void* b, void* h, int B, int S, int W,
           cudaStream_t stream) {
  static size_t granted[sm90::MAX_DEVICES] = {};
  const int err = sm90::ensure_smem(rg_lru_kernel<TB>, smem_bytes<TB>(), granted);
  if (err) return err;
  // 16-byte copies need 16-byte-aligned rows of log_a and b
  const int vec = ((reinterpret_cast<uintptr_t>(log_a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0 &&
                  W % 4 == 0 && W % (16 / (int)sizeof(TB)) == 0;
  dim3 grid((W + CH - 1) / CH, B);
  rg_lru_kernel<TB><<<grid, THREADS, smem_bytes<TB>(), stream>>>(
      log_a, static_cast<const TB*>(b), static_cast<TB*>(h), S, W, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of b and h): 0 = float32, 1 = bfloat16; log_a is float32.
// Returns 0 or the cudaError_t of the attribute call or the launch.
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
