// Flash-attention prefill forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bhsd
// and computes the same function: scores in fp32 times `scale`, an optional
// logit softcap c*tanh(s/c), the causal mask k <= q and an optional window
// q - k < w (positions are arange from 0 on both sides), an online softmax
// with running (m, l, acc) in fp32, and the output cast to the input type
// once.  Unlike the TPU kernel, any sequence length S >= 1 is taken: the
// ragged edge of the last query and key tiles is masked here.
//
// Layout: the model's (B, S, H, hd), contiguous; q head h reads kv head
// h / g with g = Hq / Hkv.  Both bodies below tile the same way: one CTA
// per (batch, kv head, 64-row tile of the grouped query matrix), the tile
// packing floor(64 / g) positions times all g query heads of its kv head,
// so every K/V tile serves the g heads at once (g = 8 for Gemma's MQA:
// 8 x 8 rows; g = 10 for RecurrentGemma: 6 x 10 = 60 rows, the last 4
// padding that never attends and is never stored).  Any g <= 64 is taken.
// A loop inside the CTA walks the 64-key tiles from the first one the
// window can reach to the causal limit; tiles wholly above the diagonal or
// outside the window are never loaded.
//
// Which body serves which dtype (chosen in the C entry point, by dtype):
//
// * bfloat16 — the tensor-core body (flash_tc_kernel).  One producer warp
//   issues TMA loads of the K and V tiles (64 keys x hd, as 128-byte-
//   swizzled boxes of 64 columns; 64-byte boxes of 32 at hd 32) into a
//   2-stage shared-memory ring guarded by mbarriers; the grouped Q tile is
//   one 4-d box (hd, g heads, positions, batch) per 64 columns, loaded
//   once, its padding rows zeroed first.  One consumer warpgroup owns the
//   64 rows: wgmma computes S = Q K^T from shared memory (bf16 products
//   are exact in fp32; only the order of the sums differs from the plain
//   version), then scale, softcap, mask and the online-softmax update run
//   in registers, then wgmma accumulates O += P V with P from registers
//   and the V tile read from shared memory as the MN-major B operand.  The
//   plain version multiplies fp32 P into V; rounding P to bf16 would move
//   about a quarter of the bf16 outputs, so P is split into P_hi + P_lo,
//   both bf16, and both products run into the same fp32 accumulator (1.5x
//   the minimal tensor-core work, ~16 bits of P kept); l sums the fp32 P.
//   Shared memory: Q plus two stages of K and V, 640 * hd bytes (160 KB at
//   hd 256), so one CTA per SM; the accumulator is hd / 2 registers a
//   thread.
//   Head dims that are not whole 64-column boxes (160: StableLM-2-12B)
//   are padded to whole boxes through TMA: the tensor maps keep the true
//   hd as their inner extent, and the last box of each row reaches past
//   it, where TMA writes zeros (columns 160-191).  S = Q K^T walks only
//   the hd / 16 true column steps; O += P V runs at n = 192 (the padded
//   columns of V are zero, so are those of O) and stores hd columns.
//   That costs 20% more PV work and shared memory (Q, K, V tiles of 192
//   columns: 120 KB) and no extra bytes from device memory; the other
//   design, a 32-column box of 64-byte swizzle for the tail, would need
//   two swizzle modes in one PV operand (a split n = 128 + 32 product).
// * float32 — the SIMT body (flash_fwd_kernel), fp32 FMAs out of shared
//   memory.  Tensor cores in fp32 would mean TF32, about three decimal
//   digits, which the fp32 callers' bands (1e-4 against the plain
//   version) do not allow.  This is a choice by dtype, not a fallback: a
//   bf16 call that fails to encode its tensor maps or to launch returns
//   the error, and the wrapper raises.
//   Shared memory: (64 (hd + 4) + 65 hd + 64 hd + 64 * 80) floats, 145 KB
//   at hd 160 and 219 KB at hd 256; each thread keeps hd / 16 accumulator
//   columns of 4 rows.
//
// What bounds it.  At the serving shape (B = 1, S = 512, Hq = 8, Hkv = 1,
// hd = 256, bf16) the least time is set by bytes and operations about
// equally: ~4.7 MB over 3.35 TB/s is ~1.4 us, ~1.08 GFLOP of the causal
// triangle over 989 TFLOP/s is ~1.1 us.  At RecurrentGemma's prefill (B 2,
// S 4096, g 10, window 2048) operations bound it: ~0.13 ms.  The bf16 body
// runs its products on the tensor cores; one warpgroup per CTA serialises
// each tile's softmax with its products, which the next redesign (two
// consumer warpgroups in ping-pong) would overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the SIMT body
// ---------------------------------------------------------------------------

constexpr int BM = 64;         // rows of the grouped query tile
constexpr int BN = 64;         // keys per kv tile
constexpr int THREADS = 256;   // a 16 x 16 thread grid over the 64 x 64 tile
constexpr float NEG = -1e30f;  // masked-score sentinel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
int launch_simt(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Sk, int Hq, int Hkv, float scale, float softcap,
                int window, int causal, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  static size_t granted[sm90::MAX_DEVICES] = {};
  const int err = sm90::ensure_smem(flash_fwd_kernel<T, HD>, smem, granted);
  if (err) return err;
  const int tile_pos = BM / (Hq / Hkv);
  dim3 grid((Sq + tile_pos - 1) / tile_pos, Hkv, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, Hq, Hkv, scale, softcap, window, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 160;   // warps 0-3: the consumer warpgroup; warp 4: TMA
constexpr int STAGES = 2;         // K/V ring depth

template <int HD>
struct Tc {
  static constexpr int SW = HD < 64 ? HD : 64;        // columns per swizzled box
  // boxes across hd; a partial last box is zero-filled by TMA past hd
  static constexpr int CHUNKS = (HD + SW - 1) / SW;
  static constexpr int HDP = CHUNKS * SW;             // hd padded: 192 at 160
  static constexpr int ROW_BYTES = SW * 2;            // 128 (64 at hd 32)
  static constexpr uint32_t LAYOUT = SW == 64 ? 1 : 2;  // descriptor: 128 / 64 B swizzle
  static constexpr int CHUNK_BYTES = BN * ROW_BYTES;  // 64 rows of one box
  static constexpr int TILE_BYTES = CHUNKS * CHUNK_BYTES;  // 64 x HDP bf16
  static constexpr int Q_OFF = 0;
  static constexpr int KV_OFF = TILE_BYTES;            // stage s: K, then V
  static constexpr int BAR_OFF = TILE_BYTES * (1 + 2 * STAGES);
  // barriers: q, full[STAGES], empty[STAGES]; + slack to align the base
  static constexpr size_t bytes = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// O (64 x HDP, the padded head dim) += P V
template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(HDP == 256 || HDP == 192 || HDP == 128 || HDP == 64 || HDP == 32,
                "no wgmma shape for this padded head dim");
  if constexpr (HDP == 256) sm90::wgmma_rs_m64n256k16(o, a, db);
  else if constexpr (HDP == 192) sm90::wgmma_rs_m64n192k16(o, a, db);
  else if constexpr (HDP == 128) sm90::wgmma_rs_m64n128k16(o, a, db);
  else if constexpr (HDP == 64) sm90::wgmma_rs_m64n64k16(o, a, db);
  else sm90::wgmma_rs_m64n32k16(o, a, db);
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq,
                int Hkv, float scale, float softcap, int window, int causal) {
  using C = Tc<HD>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled boxes and wgmma descriptors assume 1024-byte-aligned tiles
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = sm90::smem_u32(smem);
  const uint32_t bar_q = sbase + C::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                 // + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;    // + 8 s

  const int g = Hq / Hkv;
  const int tile_pos = BM / g;
  const int rows = tile_pos * g;
  // the heaviest tiles (last positions, most keys under the causal limit)
  // go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * tile_pos;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  const int p_lo = q0;
  const int p_hi = min(q0 + tile_pos, Sq) - 1;
  const int k_hi = causal ? min(p_hi, Sk - 1) : Sk - 1;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int t_lo = k_lo / BN;
  const int t_hi = k_hi < 0 ? -1 : k_hi / BN;

  // zero the padding rows of the Q tile (TMA writes rows 0 .. rows - 1)
  {
    const int pad16 = (BM - rows) * C::ROW_BYTES / 16;
    for (int idx = tid; idx < C::CHUNKS * pad16; idx += TC_THREADS) {
      const int c = idx / pad16, j = idx % pad16;
      reinterpret_cast<uint4*>(smem + C::Q_OFF + c * C::CHUNK_BYTES +
                               rows * C::ROW_BYTES)[j] = make_uint4(0, 0, 0, 0);
    }
  }
  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, 128);
    }
    sm90::fence_barrier_init();
  }
  sm90::fence_proxy_async();
  __syncthreads();

  if (tid >= 128) {
    // producer: one thread issues every TMA load of the CTA
    if (tid == 128) {
      // a box's bytes count whole, the zero-filled ones past the
      // tensor's edge (the ragged last tile, hd 160's last box) too
      sm90::mbar_expect_tx(bar_q, C::CHUNKS * rows * C::ROW_BYTES);
      for (int c = 0; c < C::CHUNKS; ++c)
        sm90::tma_load_4d(sbase + C::Q_OFF + c * C::CHUNK_BYTES, &tq, bar_q,
                          c * C::SW, kvh * g, q0, b);
      for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
        const int s = i % STAGES;
        sm90::mbar_wait(bar_empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(bar_full + 8 * s, 2 * C::TILE_BYTES);
        const uint32_t k_dst = sbase + C::KV_OFF + s * 2 * C::TILE_BYTES;
        for (int c = 0; c < C::CHUNKS; ++c) {
          sm90::tma_load_4d(k_dst + c * C::CHUNK_BYTES, &tk, bar_full + 8 * s,
                            c * C::SW, kvh, t * BN, b);
          sm90::tma_load_4d(k_dst + C::TILE_BYTES + c * C::CHUNK_BYTES, &tv,
                            bar_full + 8 * s, c * C::SW, kvh, t * BN, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: thread tid holds rows r0 and r0 + 8 of every
  // accumulator (sm90.cuh), columns 8 j + 2 (tid % 4) + {0, 1}; O spans
  // the padded head dim, its columns past hd stay 0
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  // a padding row takes position Sq: out of range, masked, never stored
  const int qp0 = r0 < rows ? q0 + r0 / g : Sq;
  const int qp1 = r1 < rows ? q0 + r1 / g : Sq;
  const int cq = 2 * (lane & 3);

  constexpr int HDP = C::HDP;
  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  constexpr uint32_t SBO = 8 * C::ROW_BYTES;           // 8 rows

  sm90::mbar_wait(bar_q, 0);
  for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
    const int s = i % STAGES;
    sm90::mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
    const uint32_t k_addr = sbase + C::KV_OFF + s * 2 * C::TILE_BYTES;
    const uint32_t v_addr = k_addr + C::TILE_BYTES;

    // S = Q K^T over the true hd in steps of 16 (32 bytes inside a
    // swizzled row); the zero-filled padding columns are not walked
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / (C::SW / 16)) * C::CHUNK_BYTES + (kk % (C::SW / 16)) * 32;
      sm90::wgmma_ss_m64n64k16(
          sc, sm90::smem_desc(sbase + C::Q_OFF + off, 16, SBO, C::LAYOUT),
          sm90::smem_desc(k_addr + off, 16, SBO, C::LAYOUT), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);

    // scale, softcap, mask; a masked score is -inf, so its probability is
    // exactly 0 whatever the running max
    const int n0 = t * BN;
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kp = n0 + 8 * (j / 4) + cq + (j & 1);
      const int qp = (j & 2) ? qp1 : qp0;
      float z = sc[j] * scale;
      if (softcap > 0.f) z = softcap * tanhf(z / softcap);
      bool valid = kp < Sk && qp < Sq;
      if (causal) valid = valid && kp <= qp;
      if (window > 0) valid = valid && (qp - kp) < window;
      z = valid ? z : -INFINITY;
      sc[j] = z;
      if (j & 2) mx1 = fmaxf(mx1, z);
      else mx0 = fmaxf(mx0, z);
    }
    // a row's 64 scores lie in the 4 lanes of a quad
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(sc[j] - ((j & 2) ? mn1 : mn0));
      sc[j] = p;
      if (j & 2) rs1 += p;
      else rs0 += p;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) o[j] *= (j & 2) ? corr1 : corr0;

    // P = P_hi + P_lo, both bf16, as A fragments: slice k (keys 16 k ..
    // 16 k + 15) packs score registers 8 k .. 8 k + 7 in pairs
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = sc[8 * k + 2 * j], y = sc[8 * k + 2 * j + 1];
        const float xh = __bfloat162float(__float2bfloat16(x));
        const float yh = __bfloat162float(__float2bfloat16(y));
        ahi[k][j] = sm90::pack_bf16(xh, yh);
        alo[k][j] = sm90::pack_bf16(x - xh, y - yh);
      }

    // O += P V: V's tile is the MN-major B operand; 16 keys a step, the
    // next 64 columns of the padded hd one box (CHUNK_BYTES) further on
    sm90::fence_regs(o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sm90::fence_regs(ahi[k]);
      sm90::fence_regs(alo[k]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t db = sm90::smem_desc(v_addr + k * 16 * C::ROW_BYTES,
                                          C::CHUNK_BYTES, SBO, C::LAYOUT);
      wgmma_pv<HDP>(o, ahi[k], db);
      wgmma_pv<HDP>(o, alo[k], db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(o);
    sm90::mbar_arrive(bar_empty + 8 * s);   // this stage's K and V are free
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const size_t q_pos_stride = (size_t)Hq * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    const int qp = half ? qp1 : qp0;
    if (qp >= Sq) continue;
    const float den = half ? d1 : d0;
    __nv_bfloat16* orow = out + ((size_t)b * Sq + qp) * q_pos_stride +
                          (size_t)(kvh * g + r % g) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {   // the true hd columns only
      const float x = o[4 * j + 2 * half] / den;
      const float y = o[4 * j + 2 * half + 1] / den;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) = __floats2bfloat162_rn(x, y);
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int Hq, int Hkv, float scale, float softcap,
              int window, int causal, cudaStream_t stream) {
  using C = Tc<HD>;
  // TMA reads 16-byte-aligned global addresses
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return (int)cudaErrorMisalignedAddress;
  static size_t granted[sm90::MAX_DEVICES] = {};
  int err = sm90::ensure_smem(flash_tc_kernel<HD>, C::bytes, granted);
  if (err) return err;
  const int g = Hq / Hkv;
  const int tile_pos = BM / g;
  const CUtensorMapSwizzle swz =
      C::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // the maps' inner extent is the true hd: TMA zero-fills a box past it
  CUtensorMap tq, tk, tv;
  if ((err = sm90::encode_bshd(&tq, q, HD, Hq, Sq, B, C::SW, g, tile_pos, swz))) return err;
  if ((err = sm90::encode_bshd(&tk, k, HD, Hkv, Sk, B, C::SW, 1, BN, swz))) return err;
  if ((err = sm90::encode_bshd(&tv, v, HD, Hkv, Sk, B, C::SW, 1, BN, swz))) return err;
  dim3 grid((Sq + tile_pos - 1) / tile_pos, Hkv, B);
  flash_tc_kernel<HD><<<grid, TC_THREADS, C::bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, scale,
      softcap, window, causal);
  return (int)cudaGetLastError();
}

int dispatch_hd_f32(int hd, const void* q, const void* k, const void* v,
                    void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                    float scale, float softcap, int window, int causal,
                    cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_simt<float, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 64: return launch_simt<float, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 128: return launch_simt<float, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 160: return launch_simt<float, 160>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 256: return launch_simt<float, 256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_hd_bf16(int hd, const void* q, const void* k, const void* v,
                     void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                     float scale, float softcap, int window, int causal,
                     cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_tc<32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 64: return launch_tc<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 128: return launch_tc<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 160: return launch_tc<160>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    case 256: return launch_tc<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (the SIMT body), 1 = bfloat16 (the tensor-core body).
// softcap <= 0 and window <= 0 mean "none".  Returns 0, a cudaError_t of the
// attribute call or the launch, or sm90::ENCODE_ERR + the CUresult of a failed
// tensor-map encoding.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Sk, int Hq,
                                   int Hkv, int hd, int dtype, float scale,
                                   float softcap, int window, int causal,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > BM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd_f32(hd, q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, st);
  if (dtype == 1)
    return dispatch_hd_bf16(hd, q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, softcap, window, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return sm90::error_string(err);
}
