// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan.py::ssd_scan
// and computes the same function: for every batch row and head, the state
// space recurrence
//   state_t = exp(dt_t a) state_{t-1} + dt_t B_t (x) x_t,   y_t = C_t . state_t
// from a zero state, evaluated chunk by chunk in the SSD form.  Per chunk of
// Q positions, with cum = cumsum(dt a) inside the chunk:
//   y_intra[i] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//                (the mask applied before the exp: the upper triangle's
//                exponent is positive and would overflow)
//   y_inter[i] = exp(cum_i) C_i . state
//   state     <- exp(cum_end) state + sum_q B_q (x) exp(cum_end - cum_q) dt_q x_q
// All math in fp32; y is cast to x's type once.
//
// Layout: the model's.  x (B, S, H, P) and y in T (fp32 or bf16); dt
// (B, S, H) fp32; a (H,) fp32; b_, c_ (B, S, N) in T, shared by the heads.
//
// Design.  One CTA of 256 threads per (batch, head, 32-column slice of P).
// The state's columns p are independent of each other (y[:, p] reads only
// state[:, p] and x[:, p]), so the (N, P) state splits over CTAs with no
// exchange: Mamba-2-370M at B = 2 runs 2 x 32 x 2 = 128 CTAs on the 132
// SMs, where one CTA per (batch, head) would run 64.  A loop inside the CTA
// walks the sequence in chunks of QT = 64 positions (its own tile: the TPU
// kernel's chunk is a VMEM block size, and any chunk gives the same
// function).  Shared memory holds fp32 copies of the chunk's B and C
// (QT x N each, row stride N + 1 so both the broadcast and the strided
// reads are free of bank conflicts), its x slice (QT x 32), the masked
// intra-chunk matrix (QT x QT) and the (N x 32) state, which never leaves
// the SM: ~105 KB at N = 128, above the 48 KB default, so the launch raises
// the dynamic shared-memory limit first.  Products are plain fp32 FMAs out
// of shared memory (no tensor cores) in small register tiles.
//
// What bounds it.  At Mamba-2-370M's prefill shape (B 2, S 4096, H 32,
// P 64, N 128, bf16) the function moves ~72.4 MB (x and y in bf16, dt fp32,
// B and C once) — ~21.6 us at 3.35 TB/s — and needs ~13 GFLOP in the SSD
// form, ~13 us at the bf16 tensor-core peak: bytes bound it.  This first
// version re-reads B and C from L2 in every CTA of a batch row, recomputes
// C.B^T in each of the two column slices, and multiplies on the FMA pipes,
// so it sits far above both; tensor cores on the three chunk products and
// TMA-fed tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int QT = 64;         // positions per chunk
constexpr int PT = 32;         // state columns per CTA
constexpr int THREADS = 256;
constexpr int MAX_N = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t smem_floats(int N) {
  const int NS = N + 1;
  return (size_t)2 * QT * NS     // sB, sC
       + (size_t)QT * PT         // sX (then dt-weighted x)
       + (size_t)QT * QT         // sG
       + (size_t)N * PT          // sS, the state
       + 2 * QT;                 // sdt, scum
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int NS = N + 1;
  float* sB = smem;                  // [QT][NS]
  float* sC = sB + QT * NS;          // [QT][NS]
  float* sX = sC + QT * NS;          // [QT][PT]
  float* sG = sX + QT * PT;          // [QT][QT]
  float* sS = sG + QT * QT;          // [N][PT]
  float* sdt = sS + N * PT;          // [QT]
  float* scum = sdt + QT;            // [QT]

  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float ah = a[h];

  for (int i = tid; i < N * PT; i += THREADS) sS[i] = 0.f;

  const size_t x_row = (size_t)H * P;          // x / y stride of a position
  const T* xb = x + (size_t)b * S * x_row + (size_t)h * P + p0;
  T* yb = y + (size_t)b * S * x_row + (size_t)h * P + p0;
  const float* dtb = dt + (size_t)b * S * H + h;
  const T* bb = bm + (size_t)b * S * N;
  const T* cb = cm + (size_t)b * S * N;

  for (int s0 = 0; s0 < S; s0 += QT) {
    __syncthreads();   // the previous chunk's reads of every buffer are done
    // ---- stage the chunk; positions past S read as zero (dt 0: no decay,
    // no input), and are never stored
    for (int idx = tid; idx < QT * N; idx += THREADS) {
      const int q = idx / N, n = idx % N;
      const bool in = s0 + q < S;
      sB[q * NS + n] = in ? to_f(bb[(size_t)(s0 + q) * N + n]) : 0.f;
      sC[q * NS + n] = in ? to_f(cb[(size_t)(s0 + q) * N + n]) : 0.f;
    }
    for (int idx = tid; idx < QT * PT; idx += THREADS) {
      const int q = idx / PT, p = idx % PT;
      sX[idx] = (s0 + q < S && p0 + p < P) ? to_f(xb[(size_t)(s0 + q) * x_row + p]) : 0.f;
    }
    if (tid < 32) {
      // inclusive cumsum of dt * a over the chunk: lane l holds positions
      // 2l and 2l + 1, then a shuffle scan across the warp
      const int q = 2 * tid;
      const float d0 = s0 + q < S ? dtb[(size_t)(s0 + q) * H] : 0.f;
      const float d1 = s0 + q + 1 < S ? dtb[(size_t)(s0 + q + 1) * H] : 0.f;
      const float e0 = d0 * ah, e1 = e0 + d1 * ah;
      float run = e1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += o;
      }
      const float base = run - e1;
      sdt[q] = d0;
      sdt[q + 1] = d1;
      scum[q] = base + e0;
      scum[q + 1] = run;
    }
    __syncthreads();

    // ---- the masked intra-chunk matrix G[i][j] = (C_i . B_j)
    // exp(cum_i - cum_j) dt_j for j <= i, else 0; a 4 x 4 tile a thread
    {
      const int tx = tid & 15, ty = tid >> 4;
      float g[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * NS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          sG[i * QT + j] = j <= i ? g[r][c] * expf(scum[i] - scum[j]) * sdt[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = G x + exp(cum) (C . state); lane = column, 8 rows a thread
    {
      const int p = tid & 31, ty = tid >> 5;
      float acc[8], inter[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = inter[r] = 0.f;
      for (int j = 0; j < QT; ++j) {
        const float xv = sX[j * PT + p];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r] = fmaf(sG[(ty + 8 * r) * QT + j], xv, acc[r]);
      }
      for (int n = 0; n < N; ++n) {
        const float sv = sS[n * PT + p];
#pragma unroll
        for (int r = 0; r < 8; ++r) inter[r] = fmaf(sC[(ty + 8 * r) * NS + n], sv, inter[r]);
      }
      if (p0 + p < P) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = ty + 8 * r;
          if (s0 + i < S)
            store(&yb[(size_t)(s0 + i) * x_row + p], acc[r] + expf(scum[i]) * inter[r]);
        }
      }
    }
    __syncthreads();

    // ---- state <- exp(cum_end) state + sum_q B_q (x) w_q x_q, with
    // w_q = exp(cum_end - cum_q) dt_q folded into x first
    const float cum_end = scum[QT - 1];
    for (int idx = tid; idx < QT * PT; idx += THREADS) {
      const int q = idx / PT;
      sX[idx] *= expf(cum_end - scum[q]) * sdt[q];
    }
    __syncthreads();
    {
      const int p = tid & 31, ty = tid >> 5;
      const float decay = expf(cum_end);
      for (int n0 = 4 * ty; n0 < N; n0 += 32) {
        float acc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = 0.f;
        for (int q = 0; q < QT; ++q) {
          const float xv = sX[q * PT + p];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (n0 + r < N) acc[r] = fmaf(sB[q * NS + n0 + r], xv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (n0 + r < N) sS[(n0 + r) * PT + p] = decay * sS[(n0 + r) * PT + p] + acc[r];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, void* y, int B, int S, int H, int P, int N,
           cudaStream_t stream) {
  const size_t smem = smem_floats(N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + PT - 1) / PT, H, B);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), S, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, b_, c_ and y): 0 = float32, 1 = bfloat16.  dt and a are
// float32.  Returns 0 or the cudaError_t of the attribute call or the
// launch.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, void* y, int B,
                            int S, int H, int P, int N, int dtype,
                            void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  if (dtype == 0)
    return launch<float>(x, dtf, af, bm, cm, y, B, S, H, P, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, af, bm, cm, y, B, S, H, P, N, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
