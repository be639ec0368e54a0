// Paged decode attention for Hopper (sm_90a): one new token per row,
// attended straight off the paged KV pool through the block table.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_decode_attention
// and computes the same function: for row b and query head h (kv head
// h / g), scores q . k * scale over the entries of logical blocks
// j <= pos[b] / bs (read through table[b, j]), an optional softcap, the
// validity mask 0 <= ppos <= pos[b], and an online softmax in fp32 in which
// an invalid entry gets probability exactly 0 — so a row with no valid
// entry returns exactly 0.  Blocks past pos[b] / bs are never read.
//
// Layout: q (B, Hq, hd); pk / pv (NB, bs, Hkv, hd); ppos (NB, bs) int32;
// table (B, nb) int32; pos (B,) int32; out (B, Hq, hd).
//
// Design.  One CTA of 256 threads per (kv head, row).  The CTA reads pos[b]
// and its table row itself (the TPU kernel got them by scalar prefetch) and
// walks the live logical blocks a chunk at a time: each chunk stages up to
// 64 keys (whole pool blocks) of K and V, with their validity, in shared
// memory as fp32; the g query rows of the kv head score every staged key,
// one warp per head folds the chunk into that head's running (m, l), and
// the threads then rescale and accumulate the (g, hd) fp32 accumulator,
// which also lives in shared memory.
//
// What bounds it.  Decode reads every live K/V entry once and does ~4*g*hd
// flops per entry, ~2 flops per byte at g = 8 in bf16: bytes bound it.  At
// the serving shapes (8 rows x 1 kv head) the grid is only 8 CTAs on 132
// SMs, so each CTA walks its row alone and the kernel runs far below the
// card's memory rate; splitting each row's blocks over several CTAs and
// merging the partial softmaxes (flash decoding) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK_KEYS = 64;   // keys staged per chunk (rounded to whole blocks)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Layout {
  int g, hd, ck;      // heads per kv head, head dim, keys per chunk
  // offsets in floats
  size_t q, k, v, s, ok, m, l, corr, acc, total;
  __host__ __device__ Layout(int g_, int hd_, int ck_) : g(g_), hd(hd_), ck(ck_) {
    q = 0;                                  // [g][hd + 1]
    k = q + (size_t)g * (hd + 1);           // [ck][hd + 1]: score reads are conflict-free
    v = k + (size_t)ck * (hd + 1);          // [ck][hd]
    s = v + (size_t)ck * hd;                // [g][ck] scores, then probabilities
    ok = s + (size_t)g * ck;                // [ck] validity (as float 0 / 1)
    m = ok + ck;                            // [g]
    l = m + g;                              // [g]
    corr = l + g;                           // [g]
    acc = corr + g;                         // [g][hd]
    total = acc + (size_t)g * hd;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                    const T* __restrict__ pv, const int* __restrict__ ppos,
                    const int* __restrict__ table, const int* __restrict__ pos,
                    T* __restrict__ out, int nb, int bs, int Hq, int Hkv,
                    int hd, int blocks_per_chunk, float scale, float softcap) {
  const int g = Hq / Hkv;
  const int ck = blocks_per_chunk * bs;
  const Layout L(g, hd, ck);
  extern __shared__ float smem[];
  float* sQ = smem + L.q;
  float* sK = smem + L.k;
  float* sV = smem + L.v;
  float* sS = smem + L.s;
  float* sOk = smem + L.ok;
  float* sM = smem + L.m;
  float* sL = smem + L.l;
  float* sCorr = smem + L.corr;
  float* sAcc = smem + L.acc;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int pos_b = pos[b];
  // last live logical block; a negative position attends nothing
  const int jmax = pos_b < 0 ? -1 : min(pos_b / bs, nb - 1);
  const int* trow = table + (size_t)b * nb;

  for (int idx = tid; idx < g * hd; idx += THREADS) {
    const int h = idx / hd, d = idx % hd;
    sQ[h * (hd + 1) + d] = to_f(q[((size_t)b * Hq + kvh * g + h) * hd + d]);
    sAcc[idx] = 0.f;
  }
  for (int h = tid; h < g; h += THREADS) {
    sM[h] = NEG;
    sL[h] = 0.f;
  }

  for (int j0 = 0; j0 <= jmax; j0 += blocks_per_chunk) {
    const int keys = min(blocks_per_chunk, jmax - j0 + 1) * bs;
    __syncthreads();   // the previous chunk's reads are done; q / init visible
    for (int idx = tid; idx < keys * hd; idx += THREADS) {
      const int key = idx / hd, d = idx % hd;
      const int phys = trow[j0 + key / bs];
      const size_t off = (((size_t)phys * bs + key % bs) * Hkv + kvh) * hd + d;
      sK[key * (hd + 1) + d] = to_f(pk[off]);
      sV[key * hd + d] = to_f(pv[off]);
    }
    for (int key = tid; key < keys; key += THREADS) {
      const int phys = trow[j0 + key / bs];
      const int pp = ppos[(size_t)phys * bs + key % bs];
      sOk[key] = (pp >= 0 && pp <= pos_b) ? 1.f : 0.f;
    }
    __syncthreads();

    // scores of the g query rows against every staged key
    for (int idx = tid; idx < g * keys; idx += THREADS) {
      const int h = idx / keys, key = idx % keys;
      const float* qr = sQ + h * (hd + 1);
      const float* kr = sK + key * (hd + 1);
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      float z = dot * scale;
      if (softcap > 0.f) z = softcap * tanhf(z / softcap);
      sS[h * ck + key] = z;
    }
    __syncthreads();

    // one warp per head: fold the chunk into (m, l), scores -> probabilities
    for (int h = warp; h < g; h += WARPS) {
      float* srow = sS + h * ck;
      float mt = NEG;
      for (int key = lane; key < keys; key += 32)
        if (sOk[key] != 0.f) mt = fmaxf(mt, srow[key]);
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = sM[h];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int key = lane; key < keys; key += 32) {
        const float p = sOk[key] != 0.f ? expf(srow[key] - m_new) : 0.f;
        srow[key] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sCorr[h] = corr;
        sL[h] = sL[h] * corr + sum;
        sM[h] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < g * hd; idx += THREADS) {
      const int h = idx / hd, d = idx % hd;
      const float* prow = sS + h * ck;
      float a = sAcc[idx] * sCorr[h];
      for (int key = 0; key < keys; ++key) a = fmaf(prow[key], sV[key * hd + d], a);
      sAcc[idx] = a;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < g * hd; idx += THREADS) {
    const int h = idx / hd, d = idx % hd;
    store(&out[((size_t)b * Hq + kvh * g + h) * hd + d], sAcc[idx] / fmaxf(sL[h], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const int* ppos,
           const int* table, const int* pos, void* out, int B, int nb, int bs,
           int Hq, int Hkv, int hd, float scale, float softcap,
           cudaStream_t stream) {
  const int blocks_per_chunk = bs >= CHUNK_KEYS ? 1 : CHUNK_KEYS / bs;
  const Layout L(Hq / Hkv, hd, blocks_per_chunk * bs);
  const size_t smem = L.total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  paged_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      ppos, table, pos, static_cast<T*>(out), nb, bs, Hq, Hkv, hd,
      blocks_per_chunk, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means "none".  Returns 0
// or the cudaError_t of the attribute call (shapes that need more shared
// memory than the card allows) or of the launch.
extern "C" int paged_decode_attention(const void* q, const void* pk,
                                      const void* pv, const void* ppos,
                                      const void* table, const void* pos,
                                      void* out, int B, int nb, int bs, int Hq,
                                      int Hkv, int hd, int dtype, float scale,
                                      float softcap, void* stream) {
  if (B < 1 || nb < 1 || bs < 1 || hd < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(ppos);
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  if (dtype == 0)
    return launch<float>(q, pk, pv, pp, tb, ps, out, B, nb, bs, Hq, Hkv, hd, scale, softcap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pk, pv, pp, tb, ps, out, B, nb, bs, Hq, Hkv, hd, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
