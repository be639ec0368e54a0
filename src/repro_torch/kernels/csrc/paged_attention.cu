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
// Design: split-K (flash decoding), two kernels on one stream.
//
// 1. paged_split_kernel, grid (split, kv head, row).  The table's nb
//    logical blocks are cut into runs of `bps` blocks (the plan comes from
//    the shapes alone, in the wrapper: pos lies on the card, and reading it
//    on the host would synchronise).  A CTA reads its run's table entries,
//    once each, beside pos[b]; if the run lies wholly past pos[b] / bs it
//    writes the neutral partial (m = -1e30, l = 0, acc = 0) without reading
//    K or V.  Otherwise it streams the live blocks through a cp.async
//    double buffer in shared memory — 16-byte copies, neighbouring threads
//    on neighbouring addresses, the next block in flight while the current
//    one is scored.  q of the g heads sits in shared memory as fp32; a warp
//    takes a key, each lane reads its columns of the key once for up to 8
//    heads, and the warp reduces the dot products; one warp per head folds
//    a block into the head's running (m, l); then a thread per column
//    rescales and accumulates the (g, hd) fp32 accumulator.  The CTA
//    writes its fp32 partial (m, l, acc[hd]) per head to scratch that the
//    wrapper allocates.
// 2. paged_merge_kernel, grid (query head, row), merges a row's splits in
//    fp32 (four thread groups take every fourth split, 4 columns a thread,
//    then sum their partial sums), rounding once: m* = max m_s, l* = sum l_s e^(m_s - m*),
//    out = sum acc_s e^(m_s - m*) / max(l*, 1e-30).  If every split is
//    neutral the output is exactly 0.
//
// What bounds it.  Decode reads every live K/V entry once and does ~4*g*hd
// flops per entry, ~2 flops per byte at g = 8 in bf16: bytes bound it, and
// the tensor cores are not needed.  At the serving shape (8 rows x 1 kv
// head x 37 blocks of 16) the split gives 296 CTAs on 132 SMs, so the
// loads of every live block are in flight at once; the floor is then the
// two launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MERGE_COLS = 64;     // float4 columns a merge pass covers
constexpr int MERGE_GROUPS = 4;    // thread groups that share a row's splits
constexpr int MERGE_THREADS = MERGE_COLS * MERGE_GROUPS;
constexpr int HG = 8;            // query heads a thread carries at once
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ size_t a16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// shared memory of one split CTA, offsets in bytes
struct Layout {
  size_t q, k, v, s, pp, phys, m, l, corr, acc, total;
  __host__ __device__ Layout(int g, int hd, int bs, int bps, int elem) {
    q = 0;                                            // [g][hd] fp32
    k = a16(q + (size_t)g * hd * 4);                  // [2][bs][hd] T
    v = a16(k + (size_t)2 * bs * hd * elem);          // [2][bs][hd] T
    s = a16(v + (size_t)2 * bs * hd * elem);          // [g][bs] scores, then p
    pp = a16(s + (size_t)g * bs * 4);                 // [2][bs] int positions
    phys = a16(pp + (size_t)2 * bs * 4);              // [bps] physical blocks
    m = a16(phys + (size_t)bps * 4);                  // [g]
    l = m + (size_t)g * 4;                            // [g]
    corr = l + (size_t)g * 4;                         // [g]
    acc = a16(corr + (size_t)g * 4);                  // [g][hd] fp32
    total = acc + (size_t)g * hd * 4;
  }
};

// one pool block's K and V entries of kv head `kvh` (bs x hd each) and its
// bs positions into shared memory: 16-byte cp.async copies, neighbouring
// threads on neighbouring addresses, where an entry is whole 16-byte words
// at aligned pool bases; plain element copies otherwise
template <typename T>
__device__ __forceinline__ void stage_block(const T* __restrict__ pk,
                                            const T* __restrict__ pv,
                                            const int* __restrict__ ppos,
                                            int phys, int kvh, int bs, int Hkv,
                                            int hd, int vec16, T* dk, T* dv,
                                            int* dpp) {
  const int tid = threadIdx.x;
  const size_t entry_stride = (size_t)Hkv * hd;
  const size_t base = (size_t)phys * bs * entry_stride + (size_t)kvh * hd;
  if (vec16) {
    const int chunks = hd * (int)sizeof(T) / 16;
    for (int c = tid; c < bs * chunks; c += THREADS) {
      const int e = c / chunks, w = c % chunks;
      const size_t src = base + e * entry_stride;
      cp_async16(reinterpret_cast<unsigned char*>(dk + (size_t)e * hd) + 16 * w,
                 reinterpret_cast<const unsigned char*>(pk + src) + 16 * w);
      cp_async16(reinterpret_cast<unsigned char*>(dv + (size_t)e * hd) + 16 * w,
                 reinterpret_cast<const unsigned char*>(pv + src) + 16 * w);
    }
  } else {
    for (int c = tid; c < bs * hd; c += THREADS) {
      const int e = c / hd, d = c % hd;
      const size_t src = base + e * entry_stride + d;
      dk[c] = pk[src];
      dv[c] = pv[src];
    }
  }
  for (int e = tid; e < bs; e += THREADS)
    cp_async4(dpp + e, ppos + (size_t)phys * bs + e);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                   const T* __restrict__ pv, const int* __restrict__ ppos,
                   const int* __restrict__ table, const int* __restrict__ pos,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int nb, int bs, int Hq, int Hkv, int hd, int bps,
                   int splits, float scale, float softcap, int vec16) {
  const int g = Hq / Hkv;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t part = ((size_t)(b * Hkv + kvh) * splits + split) * g;

  const int j0 = split * bps;
  // the run's table entries, read once each, in flight beside pos[b]
  const int run = min(bps, nb - j0);
  const int phys_own = tid < run ? table[(size_t)b * nb + j0 + tid] : 0;
  const int pos_b = pos[b];
  // last live logical block; a negative position attends nothing
  const int jmax = pos_b < 0 ? -1 : min(pos_b / bs, nb - 1);
  const int n_blk = min(j0 + bps - 1, jmax) - j0 + 1;
  if (n_blk <= 0) {
    // the neutral partial; K and V are never read
    for (int idx = tid; idx < g * hd; idx += THREADS) part_acc[part * hd + idx] = 0.f;
    for (int h = tid; h < g; h += THREADS) {
      part_ml[(part + h) * 2] = NEG;
      part_ml[(part + h) * 2 + 1] = 0.f;
    }
    return;
  }

  const Layout L(g, hd, bs, bps, (int)sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L.q);
  T* sK = reinterpret_cast<T*>(smem + L.k);
  T* sV = reinterpret_cast<T*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  int* sPp = reinterpret_cast<int*>(smem + L.pp);
  int* sPhys = reinterpret_cast<int*>(smem + L.phys);
  float* sM = reinterpret_cast<float*>(smem + L.m);
  float* sL = reinterpret_cast<float*>(smem + L.l);
  float* sCorr = reinterpret_cast<float*>(smem + L.corr);
  float* sAcc = reinterpret_cast<float*>(smem + L.acc);

  if (tid < n_blk) sPhys[tid] = phys_own;
  for (int i = THREADS + tid; i < n_blk; i += THREADS) sPhys[i] = table[(size_t)b * nb + j0 + i];
  __syncthreads();

  // stage block i of the run into buffer `buf`
  auto stage = [=](int buf, int i) {
    stage_block(pk, pv, ppos, sPhys[i], kvh, bs, Hkv, hd, vec16,
                sK + (size_t)buf * bs * hd, sV + (size_t)buf * bs * hd,
                sPp + buf * bs);
  };

  // the first block's copies go out first; q and the running state are
  // set up while they are in flight (the loop's first barrier publishes
  // them)
  stage(0, 0);
  cp_async_commit();
  for (int idx = tid; idx < g * hd; idx += THREADS) {
    const int h = idx / hd, d = idx % hd;
    sQ[idx] = to_f(q[((size_t)b * Hq + kvh * g + h) * hd + d]);
    sAcc[idx] = 0.f;
  }
  for (int h = tid; h < g; h += THREADS) {
    sM[h] = NEG;
    sL[h] = 0.f;
  }
  for (int i = 0; i < n_blk; ++i) {
    const int cur = i & 1;
    if (i + 1 < n_blk) {
      stage(cur ^ 1, i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = sK + (size_t)cur * bs * hd;
    const T* vb = sV + (size_t)cur * bs * hd;
    const int* pp = sPp + cur * bs;

    // scores: a warp per key; each lane reads its columns of the key once
    // and keeps up to HG heads' partial dot products, which the warp then
    // reduces (HG independent chains)
    for (int e = warp; e < bs; e += WARPS) {
      const bool ok = pp[e] >= 0 && pp[e] <= pos_b;
      const T* kr = kb + (size_t)e * hd;
      for (int h0 = 0; h0 < g; h0 += HG) {
        float dot[HG];
#pragma unroll
        for (int j = 0; j < HG; ++j) dot[j] = 0.f;
        for (int d = lane; d < hd; d += 32) {
          const float kx = to_f(kr[d]);
#pragma unroll
          for (int j = 0; j < HG; ++j)
            if (h0 + j < g) dot[j] = fmaf(sQ[(h0 + j) * hd + d], kx, dot[j]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int j = 0; j < HG; ++j) dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], off);
        if (lane < HG && h0 + lane < g) {
          float z = dot[0];
#pragma unroll
          for (int j = 1; j < HG; ++j) z = lane == j ? dot[j] : z;
          z *= scale;
          if (softcap > 0.f) z = softcap * tanhf(z / softcap);
          // an invalid entry scores -inf: probability exactly 0
          sS[(h0 + lane) * bs + e] = ok ? z : -INFINITY;
        }
      }
    }
    __syncthreads();

    // one warp per head: fold the block into (m, l), scores -> probabilities
    for (int h = warp; h < g; h += WARPS) {
      float* srow = sS + h * bs;
      float mt = NEG;
      for (int e = lane; e < bs; e += 32) mt = fmaxf(mt, srow[e]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = sM[h];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int e = lane; e < bs; e += 32) {
        const float p = expf(srow[e] - m_new);
        srow[e] = p;
        sum += p;
      }
#pragma unroll
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

    // acc = acc * corr + P V: a thread per column d, up to HG heads at once
    // (HG independent chains, V read once per key)
    for (int d = tid; d < hd; d += THREADS)
      for (int h0 = 0; h0 < g; h0 += HG) {
        float a[HG];
#pragma unroll
        for (int j = 0; j < HG; ++j)
          a[j] = h0 + j < g ? sAcc[(h0 + j) * hd + d] * sCorr[h0 + j] : 0.f;
        for (int e = 0; e < bs; ++e) {
          const float vx = to_f(vb[(size_t)e * hd + d]);
#pragma unroll
          for (int j = 0; j < HG; ++j)
            if (h0 + j < g) a[j] = fmaf(sS[(h0 + j) * bs + e], vx, a[j]);
        }
#pragma unroll
        for (int j = 0; j < HG; ++j)
          if (h0 + j < g) sAcc[(h0 + j) * hd + d] = a[j];
      }
    __syncthreads();   // buffer `cur` is free for block i + 2
  }

  for (int idx = tid; idx < g * hd; idx += THREADS) part_acc[part * hd + idx] = sAcc[idx];
  for (int h = tid; h < g; h += THREADS) {
    part_ml[(part + h) * 2] = sM[h];
    part_ml[(part + h) * 2 + 1] = sL[h];
  }
}

template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
paged_merge_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml, T* __restrict__ out,
                   int Hq, int Hkv, int hd, int splits) {
  // [splits] weights (rounded up to 4 floats), then [MERGE_GROUPS][MERGE_COLS]
  // float4 partial sums
  extern __shared__ __align__(16) float sh[];
  float* sW = sh;
  float4* sRed = reinterpret_cast<float4*>(sh + ((splits + 3) & ~3));
  const int g = Hq / Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t first = (size_t)(b * Hkv + h / g) * splits * g + h % g;  // split 0
  // every warp reduces m* and then l* itself: no barrier for the broadcast
  float mx = NEG;
  for (int s = lane; s < splits; s += 32)
    mx = fmaxf(mx, part_ml[(first + (size_t)s * g) * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  for (int s = tid; s < splits; s += MERGE_THREADS)
    sW[s] = expf(part_ml[(first + (size_t)s * g) * 2] - mx);
  __syncthreads();
  float l = 0.f;
  for (int s = lane; s < splits; s += 32) l += part_ml[(first + (size_t)s * g) * 2 + 1] * sW[s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  const float den = fmaxf(l, 1e-30f);
  T* o = out + ((size_t)b * Hq + h) * hd;
  if (hd % 4 != 0) {
    for (int d = tid; d < hd; d += MERGE_THREADS) {
      float a = 0.f;
      for (int s = 0; s < splits; ++s)
        a = fmaf(part_acc[(first + (size_t)s * g) * hd + d], sW[s], a);
      store(&o[d], a / den);
    }
    return;
  }
  // 4 columns a thread; MERGE_GROUPS groups of threads take every
  // MERGE_GROUPS-th split, so each thread has few loads in flight to wait for
  const int grp = tid / MERGE_COLS, c0 = tid % MERGE_COLS;
  const int cols = hd / 4;
  for (int base = 0; base < cols; base += MERGE_COLS) {
    const int c = base + c0;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < cols) {
#pragma unroll 4
      for (int s = grp; s < splits; s += MERGE_GROUPS) {
        const float4 x = reinterpret_cast<const float4*>(
            part_acc + (first + (size_t)s * g) * hd)[c];
        const float w = sW[s];
        a.x = fmaf(x.x, w, a.x);
        a.y = fmaf(x.y, w, a.y);
        a.z = fmaf(x.z, w, a.z);
        a.w = fmaf(x.w, w, a.w);
      }
    }
    sRed[grp * MERGE_COLS + c0] = a;
    __syncthreads();
    if (grp == 0 && c < cols) {
      for (int k = 1; k < MERGE_GROUPS; ++k) {
        const float4 y = sRed[k * MERGE_COLS + c0];
        a.x += y.x;
        a.y += y.y;
        a.z += y.z;
        a.w += y.w;
      }
      store(&o[4 * c], a.x / den);
      store(&o[4 * c + 1], a.y / den);
      store(&o[4 * c + 2], a.z / den);
      store(&o[4 * c + 3], a.w / den);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const int* ppos,
           const int* table, const int* pos, void* out, float* scratch, int B,
           int nb, int bs, int Hq, int Hkv, int hd, int bps, float scale,
           float softcap, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const int splits = (nb + bps - 1) / bps;
  const Layout L(g, hd, bs, bps, (int)sizeof(T));
  static size_t split_granted[sm90::MAX_DEVICES] = {};
  static size_t merge_granted[sm90::MAX_DEVICES] = {};
  int err = sm90::ensure_smem(paged_split_kernel<T>, L.total, split_granted);
  if (err) return err;
  const size_t merge_smem = (size_t)((splits + 3) & ~3) * sizeof(float) +
                            (size_t)MERGE_THREADS * sizeof(float4);
  if ((err = sm90::ensure_smem(paged_merge_kernel<T>, merge_smem, merge_granted)))
    return err;
  // 16-byte copies need whole 16-byte entries at 16-byte-aligned pool bases
  const int vec16 = (hd * (int)sizeof(T)) % 16 == 0 &&
                    ((reinterpret_cast<uintptr_t>(pk) | reinterpret_cast<uintptr_t>(pv)) & 15) == 0;
  float* part_acc = scratch;
  float* part_ml = scratch + (size_t)B * Hq * splits * hd;
  dim3 grid(splits, Hkv, B);
  paged_split_kernel<T><<<grid, THREADS, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      ppos, table, pos, part_acc, part_ml, nb, bs, Hq, Hkv, hd, bps, splits,
      scale, softcap, vec16);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_merge_kernel<T><<<dim3(Hq, B), MERGE_THREADS, merge_smem, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), Hq, Hkv, hd, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means "none".
// `scratch` holds B * Hq * splits * (hd + 2) floats, splits = ceil(nb /
// blocks_per_split): the split partials, allocated by the caller.  Returns
// 0 or the cudaError_t of an attribute call (shapes that need more shared
// memory than the card allows) or of a launch.
extern "C" int paged_decode_attention(const void* q, const void* pk,
                                      const void* pv, const void* ppos,
                                      const void* table, const void* pos,
                                      void* out, void* scratch, int B, int nb,
                                      int bs, int Hq, int Hkv, int hd,
                                      int dtype, int blocks_per_split,
                                      float scale, float softcap, void* stream) {
  if (B < 1 || nb < 1 || bs < 1 || hd < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      blocks_per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(ppos);
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch<float>(q, pk, pv, pp, tb, ps, out, sc, B, nb, bs, Hq, Hkv, hd,
                         blocks_per_split, scale, softcap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pk, pv, pp, tb, ps, out, sc, B, nb, bs, Hq, Hkv,
                                 hd, blocks_per_split, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
