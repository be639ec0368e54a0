// Flash-attention prefill forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bhsd
// and computes the same function: scores in fp32 times `scale`, an optional
// logit softcap c*tanh(s/c), the causal mask k <= q and an optional window
// q - k < w (positions are arange from 0 on both sides), an online softmax
// with running (m, l, acc) in fp32, and the output cast to the input type.
// Unlike the TPU kernel, any sequence length S >= 1 is taken: the ragged
// edge of the last query and key tiles is masked here.
//
// Layout: the model's (B, S, H, hd), contiguous; q head h reads kv head
// h / g with g = Hq / Hkv.
//
// Design.  One CTA of 256 threads per (batch, kv head, 64-row tile of the
// grouped query matrix).  The tile packs floor(BM / g) positions times all
// g query heads of its kv head, so every K/V tile staged in shared memory
// serves the g heads at once (g = 8 for Gemma's MQA: 8 x 8 rows; g = 10
// for RecurrentGemma: 6 x 10 = 60 rows, the last 4 rows padding that is
// never loaded, never attends and never stored) and the fp32 accumulator
// of the 64 rows (64 x hd) fits in registers.  Any g <= 64 is taken.  A
// loop inside the CTA walks the kv tiles from the first one the window can
// reach to the causal limit;
// tiles wholly above the diagonal or outside the window are never loaded.
// Shared memory holds fp32 copies of the Q tile, the K tile (transposed, so
// the score loop reads it without bank conflicts), the V tile and the
// probability tile: about 214 KB at hd = 256, above the 48 KB default, so
// the launch raises the dynamic shared-memory limit first.
//
// What bounds it.  At the serving shapes (B = 1, S = 512, Hq = 8, Hkv = 1,
// hd = 256, bf16) the least time is set by bytes and flops about equally:
// ~4.7 MB over 3.35 TB/s is ~1.4 us, ~1.08 GFLOP of the causal triangle
// over 989 TFLOP/s is ~1.1 us.  This first version multiplies with plain
// fp32 FMAs out of shared memory (no tensor cores), so it is bound by the
// SM's FMA and shared-memory rate, far above both; wgmma on TMA-fed tiles
// is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;         // rows of the grouped query tile
constexpr int BN = 64;         // keys per kv tile
constexpr int THREADS = 256;   // a 16 x 16 thread grid over the 64 x 64 tile
constexpr float NEG = -1e30f;  // masked-score sentinel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
struct Smem {
  static constexpr int QS = HD + 4;    // sQ row stride: two rows per warp hit distinct banks
  static constexpr int KS = BN + 1;    // sKt row stride: transposed writes are conflict-free
  static constexpr int PS = BN + 16;   // sP row stride: the two rows of a warp use disjoint banks
  static constexpr size_t floats =
      (size_t)BM * QS + (size_t)HD * KS + (size_t)BN * HD + (size_t)BM * PS;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 int Sq, int Sk, int Hq, int Hkv, float scale, float softcap,
                 int window, int causal) {
  using S = Smem<HD>;
  constexpr int DJ = HD / 16;          // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                    // [BM][QS]
  float* sKt = sQ + BM * S::QS;        // [HD][KS]
  float* sV = sKt + HD * S::KS;        // [BN][HD]
  float* sP = sV + BN * HD;            // [BM][PS]

  const int g = Hq / Hkv;
  const int tile_pos = BM / g;         // query positions per tile
  const int rows = tile_pos * g;       // live rows; the rest pad the tile
  const int q0 = blockIdx.x * tile_pos;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;             // score columns tx + 16 j, acc columns tx + 16 jj
  const int ty = tid >> 4;             // rows ty + 16 i

  const size_t q_pos_stride = (size_t)Hq * HD;
  const size_t kv_pos_stride = (size_t)Hkv * HD;

  // Q tile: row r is position q0 + r / g, head kvh * g + r % g; the g heads
  // of one position are contiguous in memory.
  for (int idx = tid; idx < BM * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int p = q0 + r / g;
    float x = 0.f;
    if (r < rows && p < Sq)
      x = to_f(q[((size_t)b * Sq + p) * q_pos_stride + (size_t)(kvh * g + r % g) * HD + d]);
    sQ[r * S::QS + d] = x;
  }

  // a padding row takes position Sq: out of range, so it is masked and
  // never stored
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    qpos[i] = r < rows ? q0 + r / g : Sq;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  // kv tiles that hold at least one key some row of this tile may attend
  const int p_lo = q0;
  const int p_hi = min(q0 + tile_pos, Sq) - 1;
  const int k_hi = causal ? min(p_hi, Sk - 1) : Sk - 1;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int t_lo = k_lo / BN;
  const int t_hi = k_hi < 0 ? -1 : k_hi / BN;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int n0 = t * BN;
    __syncthreads();   // the previous tile's reads of sKt / sV / sP are done
    for (int idx = tid; idx < BN * HD; idx += THREADS) {
      const int n = idx / HD, d = idx % HD;
      const int kp = n0 + n;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk) {
        const size_t off = ((size_t)b * Sk + kp) * kv_pos_stride + (size_t)kvh * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      sKt[d * S::KS + n] = kx;
      sV[n * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * S::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sKt[d * S::KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

    // scale, softcap, mask, and the online-softmax update of each row; the
    // 64 scores of a row live in the 16 lanes that share its ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = n0 + tx + 16 * j;
        float z = s[i][j] * scale;
        if (softcap > 0.f) z = softcap * tanhf(z / softcap);
        bool valid = kp < Sk && qpos[i] < Sq;
        if (causal) valid = valid && kp <= qpos[i];
        if (window > 0) valid = valid && (qpos[i] - kp) < window;
        ok[j] = valid;
        s[i][j] = z;
        if (valid) mt = fmaxf(mt, z);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * S::PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int n = 0; n < BN; ++n) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sP[(ty + 16 * i) * S::PS + n];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vb = sV[n * HD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pa[i], vb, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (qpos[i] >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)b * Sq + qpos[i]) * q_pos_stride + (size_t)(kvh * g + r % g) * HD;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) store(&o[tx + 16 * jj], acc[i][jj] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, float scale, float softcap,
           int window, int causal, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile_pos = BM / (Hq / Hkv);
  dim3 grid((Sq + tile_pos - 1) / tile_pos, Hkv, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, Hq, Hkv, scale, softcap, window, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int Hq, int Hkv, float scale,
                float softcap, int window, int causal, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 and window <= 0 mean
// "none".  Returns 0 or the cudaError_t of the attribute call or the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Sk, int Hq,
                                   int Hkv, int hd, int dtype, float scale,
                                   float softcap, int window, int causal,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > BM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
