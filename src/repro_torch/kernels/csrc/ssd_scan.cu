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
// All sums in fp32; y is cast to x's type once.
//
// Layout: the model's.  x (B, S, H, P) and y in T (fp32 or bf16); dt
// (B, S, H) fp32; a (H,) fp32; b_, c_ (B, S, N) in T, shared by the heads.
//
// Both bodies split the work the same way: one CTA per (batch, head,
// 32-column slice of P).  The state's columns p are independent of each
// other (y[:, p] reads only state[:, p] and x[:, p]), so the (N, P) state
// splits over CTAs with no exchange: Mamba-2-370M at B = 2 runs 2 x 32 x 2
// = 128 CTAs on the 132 SMs.  A loop inside the CTA walks the sequence in
// chunks of QT = 64 positions (its own tile: the TPU kernel's chunk is a
// VMEM block size, and any chunk gives the same function); positions past
// S read as zero (dt 0: no decay, no input) and are never stored.  Which
// body runs is chosen in the C entry point (ssd_scan_workspace_floats), by
// dtype and shape:
//
// * bfloat16 at the shapes tc_body admits (every shape the repo's configs
//   give: N 128 / P 64 at full size, N 32 / P 32 reduced) — the
//   tensor-core pair.
//   1. ssd_chunk_kernel, one warp per (batch, chunk, head): the chunk's
//      cumsum of dt a and from it every exp the scan needs — exp(cum),
//      the state update's weights w and G's decay factored through the
//      8-position blocks (see the kernel) — into a record in a workspace
//      the wrapper allocates (3.25 KB per chunk and head, 13.6 MB at the
//      main shape).  The scan runs after it on the same stream: launch order is
//      the only synchronisation.
//   2. ssd_tc_kernel, 288 threads per (batch, head, 32 columns of P):
//      * one producer thread keeps a ring of 3 stages ahead; a stage holds
//        the chunk's x slice (64 x 32 bf16, one TMA box of the 4-d (P, H,
//        S, B) map, 64-byte swizzle), its B and C (64 x 64-column TMA
//        boxes, 128-byte swizzle; columns past N and rows past S
//        zero-filled by TMA) and the head's record (one bulk copy);
//      * the G warpgroup computes C.B^T on wgmma (exact bf16
//        products, fp32 sums) and from its registers the masked decay
//        matrix G[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i, as
//        products of record entries, into a ring of two G tiles in shared
//        memory (the K-major A operand, bf16 hi and lo);
//      * the consumer warpgroup keeps the (N x 32) state S as fp32 wgmma
//        accumulators (N / 64 m64n32 tiles) and per chunk, after one
//        barrier, starts
//          y_i = C . S        A = C (K-major), B = S (shared memory)
//          y_a = G . x        A = G (K-major), B = x (MN-major)
//          S   = exp(cum_end) S + B^T . (w x)
//                             A = B^T (the B tile read MN-major), B = w x
//        and while they run writes the next chunk's w x; y = y_a +
//        exp(cum_i) y_i leaves through a shared-memory tile and a TMA
//        store one chunk later, so no global store and no exp stands in
//        the chain from one chunk's state to the next.
//      C.B^T is computed in every CTA: the 64 CTAs of a batch row repeat
//      it.  On the tensor cores that costs ~0.14 us of one SM a chunk
//      (64 x 64 x 128 MACs), off the state's chain, from the B and C tiles
//      the stage holds anyway; a shared fp32 C.B^T from a first pass would
//      add a 16 KB L2 read a chunk, as much as the B tile.
//      Every product is wgmma; none needs mma.sync.  x, B and C are exact
//      in bf16.  The three fp32 operands (S, G and w x) each enter as bf16
//      hi + lo, two products into one fp32 accumulator: the CPU rehearsal
//      (tests/test_torch_scan_designs.py) at the main shape moves 0.107% of
//      the bf16 outputs off the plain version with all three split, 30.5%
//      with G in bf16 alone, 0.70% with S alone and 0.60% with w x alone.
// * float32, or a bf16 shape outside the above — the SIMT body
//   (ssd_scan_kernel): fp32 FMAs out of shared memory.  Tensor cores in
//   fp32 would mean TF32, about three decimal digits; the fp32 band
//   (5e-4 + 1e-3 |y|) does not allow it.  This is a choice by dtype and
//   shape, not a fallback: a bf16 call that fails to encode its tensor
//   maps or to launch returns the error, and the wrapper raises.
//
// What bounds it.  At Mamba-2-370M's prefill shape (B 2, S 4096, H 32,
// P 64, N 128, bf16) the function moves ~72.4 MB (x and y in bf16, dt fp32,
// B and C once) — ~21.6 us at 3.35 TB/s — and needs ~13 GFLOP in the SSD
// form, ~13 us at the bf16 tensor-core peak: bytes bound it.  The tensor-
// core pair reads B and C once per (head, column slice) from L2 (~310 MB
// of L2 traffic a call), and each CTA walks its 64 chunks in series; the
// consumer's chain of a barrier, the state's hi + lo split and two wgmma
// groups per chunk sets its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

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


// ---------------------------------------------------------------------------
// bfloat16: the tensor-core pair
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 288;          // warps 0-3: consumers; 4-7: the G warpgroup; 8: loads
constexpr int CH_THREADS = 1024;         // the chunk pass: a warp a head
constexpr int BOX_BYTES = QT * 128;      // 64 rows x 64 bf16, 128-byte swizzle
constexpr int XT_BYTES = QT * PT * 2;    // 64 rows x 32 bf16, 64-byte swizzle
// a chunk's per-head record (floats), see ssd_chunk_kernel: exp(cum), w,
// u, alpha [QT] each, beta [8][8], d [QT][8]; 3.25 KB
constexpr int REC_ECUM = 0, REC_W = QT, REC_U = 2 * QT, REC_ALPHA = 3 * QT,
              REC_BETA = 4 * QT, REC_D = 5 * QT;
constexpr int REC = 13 * QT;
constexpr int REC_BYTES = REC * 4;

// shared-memory plan of the scan for N up to 64 NT (NT 1 or 2); offsets
// from a 1024-byte-aligned base, every tile 1024-byte aligned
template <int NT>
struct Tc {
  static constexpr int STAGES = 3;
  static constexpr int X_OFF = 0;                        // x slice
  static constexpr int B_OFF = XT_BYTES;                 // NT boxes of B
  static constexpr int C_OFF = B_OFF + NT * BOX_BYTES;   // NT boxes of C
  static constexpr int REC_OFF = C_OFF + NT * BOX_BYTES; // the head's record
  static constexpr int STAGE_BYTES = (REC_OFF + REC_BYTES + 1023) / 1024 * 1024;
  static constexpr int SH_OFF = STAGES * STAGE_BYTES;    // state, bf16 hi: 64 NT rows x 32
  static constexpr int SL_OFF = SH_OFF + NT * XT_BYTES;  // state, bf16 lo
  static constexpr int W_OFF = SL_OFF + NT * XT_BYTES;   // w x hi, lo (64 x 32); two chunks' sets
  static constexpr int Y_OFF = W_OFF + 4 * XT_BYTES;     // y tiles (64 x 32) of two chunks
  static constexpr int G_OFF = Y_OFF + 2 * XT_BYTES;     // G hi, G lo; two chunks' sets
  static constexpr int BAR_OFF = G_OFF + 4 * BOX_BYTES;  // full, empty [STAGES]; gfull, gempty [2]
  static constexpr size_t bytes = BAR_OFF + 16 * STAGES + 32 + 1024;  // + slack to align
  static_assert(bytes <= 232448, "more shared memory than a block may have");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// byte offset of (row, byte column) in a tile of 64-byte rows, 64-byte
// swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_64B: 16-byte unit u of row r sits
// at u ^ ((r / 2) % 4))
__device__ __forceinline__ uint32_t swz64(int row, int col_bytes) {
  const uint32_t a = row * 64 + col_bytes;
  return a ^ (((a >> 7) & 3) << 4);
}

// the same for 128-byte rows, 128-byte swizzle (unit u of row r at
// u ^ (r % 8))
__device__ __forceinline__ uint32_t swz128(int row, int col_bytes) {
  const uint32_t a = row * 128 + col_bytes;
  return a ^ (((a >> 7) & 7) << 4);
}

__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const float xh = __bfloat162float(__float2bfloat16(x));
  const float yh = __bfloat162float(__float2bfloat16(y));
  hi = sm90::pack_bf16(xh, yh);
  lo = sm90::pack_bf16(x - xh, y - yh);
}

// the descriptor of the same layout `bytes` further on (the address field
// counts 16-byte units and every tile lies below 256 KB, so it never
// carries into the next field)
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// The chunk pass, for chunk blockIdx.x of batch row blockIdx.y: per head
// the record the scan reads.  With cum the inclusive cumsum of dt a over
// the chunk (one warp's shuffle scan; positions past S: dt 0; cum never
// increases, as dt >= 0 > a), the 8-blocks of positions and e(J) = 8 J + 7
// the last position of block J:
//   exp(cum_i)                        y's inter-chunk factor; [63] the decay
//   w_q = exp(cum_end - cum_q) dt_q   the weights of the state update
//   u_j = exp(cum_e(J) - cum_j) dt_j  j in block J
//   alpha_i = exp(cum_i - cum_e(I-1)) i in block I > 0 (0 in block 0)
//   beta_KJ = exp(cum_e(K) - cum_e(J)) J <= K, else 0
//   d_ik = dt_j prod_{j < t <= i} exp(dt_t a)
//                                      j = 8 I + k <= i in i's own block I,
//                                      else 0: the plain recurrence's own
//                                      product of per-step decays
// so that exp(cum_i - cum_j) dt_j is alpha_i beta_I-1,J u_j for j in an
// earlier block J and d_i,j%8 in i's own: each factor at most 1 (u and d
// at most dt), however large the decay, where one exp of the whole span
// could overflow, and the scan takes no exp.
__global__ void __launch_bounds__(CH_THREADS)
ssd_chunk_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                 float* __restrict__ rec, int S, int H, int nch) {
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  // warp w takes heads w, w + 32, ...; lane l positions 2l and 2l + 1
  const int lane = tid & 31, q = 2 * lane, s0 = c * QT;
  const float* dtb = dt + (size_t)b * S * H;
  for (int h = tid >> 5; h < H; h += CH_THREADS / 32) {
    const float ah = a[h];
    const float d0 = s0 + q < S ? dtb[(size_t)(s0 + q) * H + h] : 0.f;
    const float d1 = s0 + q + 1 < S ? dtb[(size_t)(s0 + q + 1) * H + h] : 0.f;
    const float e0 = d0 * ah, e1 = e0 + d1 * ah;
    float run = e1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, run, off);
      if (lane >= off) run += o;
    }
    const float c0 = run - e1 + e0, c1 = run;
    const float cend = __shfl_sync(0xffffffffu, run, 31);
    // cum at the last position of block J: lane 4 J + 3's c1
    const int blk = lane >> 2;
    const float own = __shfl_sync(0xffffffffu, c1, 4 * blk + 3);
    const float prev = __shfl_sync(0xffffffffu, c1, (4 * blk + 31) & 31);  // block blk - 1
    // beta entries 2 lane and 2 lane + 1 of the 8 x 8 table: row K = lane / 4
    const int jb = 2 * (lane & 3);
    const float lj0 = __shfl_sync(0xffffffffu, c1, 4 * jb + 3);
    const float lj1 = __shfl_sync(0xffffffffu, c1, 4 * jb + 7);
    float* r = rec + (((size_t)b * nch + c) * H + h) * REC;
    *reinterpret_cast<float2*>(r + REC_ECUM + q) = make_float2(expf(c0), expf(c1));
    *reinterpret_cast<float2*>(r + REC_W + q) =
        make_float2(expf(cend - c0) * d0, expf(cend - c1) * d1);
    *reinterpret_cast<float2*>(r + REC_U + q) =
        make_float2(expf(own - c0) * d0, expf(own - c1) * d1);
    *reinterpret_cast<float2*>(r + REC_ALPHA + q) =
        blk > 0 ? make_float2(expf(c0 - prev), expf(c1 - prev)) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(r + REC_BETA + q) =
        make_float2(jb <= blk ? expf(own - lj0) : 0.f, jb + 1 <= blk ? expf(own - lj1) : 0.f);
    // d: the block's per-step decays and dts from its four lanes, then per
    // row a running product from the row back to the block's start
    const float f0 = expf(e0), f1 = expf(d1 * ah);
    float fb[8], db[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int src = 4 * blk + j / 2;
      fb[j] = __shfl_sync(0xffffffffu, (j & 1) ? f1 : f0, src);
      db[j] = __shfl_sync(0xffffffffu, (j & 1) ? d1 : d0, src);
    }
    const int i0 = q & 7;   // row q's place in its block; row q + 1 is i0 + 1
    float g0[8], g1[8], p0 = 1.f, p1 = 1.f;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      g0[j] = j <= i0 ? p0 * db[j] : 0.f;
      g1[j] = j <= i0 + 1 ? p1 * db[j] : 0.f;
      if (j <= i0) p0 *= fb[j];
      if (j <= i0 + 1) p1 *= fb[j];
    }
    float4* dr = reinterpret_cast<float4*>(r + REC_D + 8 * q);
    dr[0] = make_float4(g0[0], g0[1], g0[2], g0[3]);
    dr[1] = make_float4(g0[4], g0[5], g0[6], g0[7]);
    dr[2] = make_float4(g1[0], g1[1], g1[2], g1[3]);
    dr[3] = make_float4(g1[4], g1[5], g1[6], g1[7]);
  }
}

// w x, w_q = exp(cum_end - cum_q) dt_q (the record's w), as bf16 hi + lo
// tiles in the x tile's own (swizzled) layout: the swizzle moves 16-byte
// units within a 64-byte row, so unit o of every tile is row o / 64
template <int NT>
__device__ __forceinline__ void build_wx(const uint8_t* stp, uint32_t wh, uint32_t wl,
                                         int t) {
  using L = Tc<NT>;
  const float* sw = reinterpret_cast<const float*>(stp + L::REC_OFF) + REC_W;
#pragma unroll
  for (int o = t * 16; o < XT_BYTES; o += 128 * 16) {
    const float w = sw[o >> 6];
    const uint4 xv = *reinterpret_cast<const uint4*>(stp + L::X_OFF + o);
    const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(&xw[e]);
      split_bf16(w * __low2float(pr), w * __high2float(pr), hi[e], lo[e]);
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(wh + o),
                 "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]) : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(wl + o),
                 "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]) : "memory");
  }
}

// The G warpgroup: C.B^T of the stage at `stg` / `stp` on
// wgmma (both tiles K-major; exact bf16 products, fp32 sums), then
// G[i][j] = CB[i][j] exp(cum_i - cum_j) dt_j for j <= i, else 0 — from
// the record's factors — from the accumulator's registers (rows r0, r1 in blocks
// b0, b0 + 1; columns 8 k + cq + {0, 1}: block k) into shared memory as
// bf16 hi and lo tiles (64 x 64, the K-major A operand of G . x, 128-byte
// swizzle)
template <int NT>
__device__ __forceinline__ void build_g(uint32_t stg, const uint8_t* stp, uint32_t gh,
                                        uint32_t gl, int r0, int r1, int cq) {
  using L = Tc<NT>;
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  sm90::fence_regs(d);
  sm90::wgmma_fence();
  const uint64_t dc = sm90::smem_desc(stg + L::C_OFF, 16, 1024, 1);
  const uint64_t db = sm90::smem_desc(stg + L::B_OFF, 16, 1024, 1);
#pragma unroll
  for (int kk = 0; kk < 4 * NT; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    sm90::wgmma_ss_m64n64k16(d, desc_at(dc, off), desc_at(db, off), 1);
  }
  sm90::wgmma_commit();
  const float* srec = reinterpret_cast<const float*>(stp + L::REC_OFF);
  const int b0 = r0 >> 3, b1 = b0 + 1;   // the rows' blocks
  // v[k] = alpha_row beta_(block - 1),k: the factor for block k before the row's
  float v0[8], v1[8];
  {
    const float a0 = srec[REC_ALPHA + r0], a1 = srec[REC_ALPHA + r1];
    const float* beta0 = srec + REC_BETA + 8 * (b0 > 0 ? b0 - 1 : 0);
    const float* beta1 = srec + REC_BETA + 8 * b0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v0[k] = a0 * beta0[k];
      v1[k] = a1 * beta1[k];
    }
  }
  // the rows' own blocks, columns 8 b + cq + {0, 1}: the d table
  const float2 dg0 = *reinterpret_cast<const float2*>(srec + REC_D + 8 * r0 + cq);
  const float2 dg1 = *reinterpret_cast<const float2*>(srec + REC_D + 8 * r1 + cq);
  sm90::wgmma_wait_all();
  sm90::fence_regs(d);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int col = 8 * k + cq;
    const float2 u = *reinterpret_cast<const float2*>(srec + REC_U + col);
    float g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rb = (e & 2) ? b1 : b0;
      const float v = (e & 2) ? v1[k] : v0[k];
      const float2 dg = (e & 2) ? dg1 : dg0;
      const float f = k < rb ? v * ((e & 1) ? u.y : u.x)
                             : (k == rb ? ((e & 1) ? dg.y : dg.x) : 0.f);
      g[e] = d[4 * k + e] * f;
    }
    uint32_t hi, lo;
    split_bf16(g[0], g[1], hi, lo);
    sts32(gh + swz128(r0, 2 * col), hi);
    sts32(gl + swz128(r0, 2 * col), lo);
    split_bf16(g[2], g[3], hi, lo);
    sts32(gh + swz128(r1, 2 * col), hi);
    sts32(gl + swz128(r1, 2 * col), lo);
  }
}

template <int NT>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_tc_kernel(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tc,
              const __grid_constant__ CUtensorMap ty,
              const float* __restrict__ rec, int S, int H, int nch) {
  using L = Tc<NT>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sbase = sm90::smem_u32(smem);
  const uint32_t bar_full = sbase + L::BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_gfull = bar_empty + 8 * STAGES;
  const uint32_t bar_gempty = bar_gfull + 16;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, 256);   // the consumer and G warpgroups
    }
    for (int g = 0; g < 2; ++g) {
      sm90::mbar_init(bar_gfull + 8 * g, 128);
      sm90::mbar_init(bar_gempty + 8 * g, 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // producer: one thread starts every copy of the CTA
    if (tid == 256) {
      const float* recb = rec + ((size_t)b * nch * H + h) * REC;
      for (int c = 0; c < nch; ++c) {
        const int s = c % STAGES;
        const uint32_t stg = sbase + s * L::STAGE_BYTES;
        const uint32_t full = bar_full + 8 * s;
        sm90::mbar_wait(bar_empty + 8 * s, ((c / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(full, XT_BYTES + 2 * NT * BOX_BYTES + REC_BYTES);
        sm90::tma_load_4d(stg + L::X_OFF, &tx, full, p0, h, c * QT, b);
        for (int k = 0; k < NT; ++k) {
          sm90::tma_load_4d(stg + L::B_OFF + k * BOX_BYTES, &tb, full, 64 * k, 0, c * QT, b);
          sm90::tma_load_4d(stg + L::C_OFF + k * BOX_BYTES, &tc, full, 64 * k, 0, c * QT, b);
        }
        sm90::bulk_load(stg + L::REC_OFF, recb + (size_t)c * H * REC, REC_BYTES, full);
      }
    }
    return;
  }

  // both warpgroups: thread t of a warpgroup holds rows r0 and r0 + 8 of
  // every accumulator (sm90.cuh), columns 8 j + cq + {0, 1}
  const int t = tid & 127;
  const int lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = 2 * (lane & 3);

  if (tid >= 128) {
    // the G warpgroup runs ahead of the consumers, one G set per chunk in a
    // ring of two
    for (int c = 0; c < nch; ++c) {
      const int s = c % STAGES, g = c & 1;
      const uint32_t gh = sbase + L::G_OFF + g * 2 * BOX_BYTES;
      sm90::mbar_wait(bar_full + 8 * s, (c / STAGES) & 1);
      sm90::mbar_wait(bar_gempty + 8 * g, ((c / 2) & 1) ^ 1);
      build_g<NT>(sbase + s * L::STAGE_BYTES, smem + s * L::STAGE_BYTES, gh,
                  gh + BOX_BYTES, r0, r1, cq);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar_gfull + 8 * g);
      sm90::mbar_arrive(bar_empty + 8 * s);
    }
    return;
  }

  // the consumers.  Per chunk one barrier, then both wgmma groups — y
  // (C . S and G . x) and the state update — and while they run the next
  // chunk's w x.  y leaves through shared memory and a TMA store one chunk
  // later, so that no global store stands in the chain.
  const uint32_t sh = sbase + L::SH_OFF, sl = sbase + L::SL_OFF;
  const uint64_t dsh = sm90::smem_desc(sh, XT_BYTES, 512, 2);   // SL follows SH

  float st[NT][16], yi[16], ya[16];
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) st[m][i] = 0.f;
  float e0 = 0.f, e1 = 0.f;   // exp(cum) of rows r0, r1 of the last chunk

  // y of chunk c into its shared-memory tile (64-byte swizzle, the y map's
  // box): ya + exp(cum_i) yi
  auto stage_y = [&](int c) {
    const uint32_t yt = sbase + L::Y_OFF + (c & 1) * XT_BYTES;
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const float e = (i & 2) ? e1 : e0;
      sts32(yt + swz64((i & 2) ? r1 : r0, 2 * (8 * (i >> 2) + cq)),
            sm90::pack_bf16(ya[i] + e * yi[i], ya[i + 1] + e * yi[i + 1]));
    }
  };

  sm90::mbar_wait(bar_full, 0);
  build_wx<NT>(smem, sbase + L::W_OFF, sbase + L::W_OFF + XT_BYTES, t);

  for (int c = 0; c < nch; ++c) {
    const int s = c % STAGES, g = c & 1;
    const uint32_t stg = sbase + s * L::STAGE_BYTES;
    const float* secum =
        reinterpret_cast<const float*>(smem + s * L::STAGE_BYTES + L::REC_OFF) + REC_ECUM;
    // this chunk's G set (hi, then lo) and w x set (hi, then lo)
    const uint32_t gh = sbase + L::G_OFF + g * 2 * BOX_BYTES;
    const uint32_t wh = sbase + L::W_OFF + g * 2 * XT_BYTES;

    // 1. the state into shared memory as bf16 hi + lo, the MN-major B
    //    operand of C . S (row n, 32 columns); the last chunk's y into its
    //    tile
#pragma unroll
    for (int m = 0; m < NT; ++m)
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int n = 64 * m + ((i & 2) ? r1 : r0);
        const uint32_t off = swz64(n, 2 * (8 * (i >> 2) + cq));
        uint32_t hi, lo;
        split_bf16(st[m][i], st[m][i + 1], hi, lo);
        sts32(sh + off, hi);
        sts32(sl + off, lo);
      }
    if (c > 0) stage_y(c - 1);
    sm90::fence_proxy_async();
    // the store of two chunks ago has read the tile stage_y writes next
    if (t == 0) sm90::bulk_wait_read();
    sm90::mbar_wait(bar_gfull + 8 * g, (c / 2) & 1);
    sm90::bar_sync(1, 128);
    if (t == 0 && c > 0) {
      sm90::tma_store_4d(&ty, sbase + L::Y_OFF + ((c - 1) & 1) * XT_BYTES, p0, h,
                         (c - 1) * QT, b);
      sm90::bulk_commit();
    }

    // 2. group 1: yi = C . S_hi + C . S_lo; ya = G_hi . x + G_lo . x (G the
    //    K-major A operand, x the MN-major B operand); group 2: S =
    //    exp(cum_end) S + B^T . (w x)_hi + B^T . (w x)_lo, B^T the B tile
    //    read as an MN-major A operand (m-tile m: the box of columns 64 m ..)
    {
      const float decay = secum[QT - 1];
#pragma unroll
      for (int m = 0; m < NT; ++m)
#pragma unroll
        for (int i = 0; i < 16; ++i) st[m][i] *= decay;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) yi[i] = ya[i] = 0.f;
    sm90::fence_regs(yi);
    sm90::fence_regs(ya);
#pragma unroll
    for (int m = 0; m < NT; ++m) sm90::fence_regs(st[m]);
    sm90::wgmma_fence();
    const uint64_t dc = sm90::smem_desc(stg + L::C_OFF, 16, 1024, 1);
    const uint64_t dx = sm90::smem_desc(stg + L::X_OFF, XT_BYTES, 512, 2);
    const uint64_t dbt = sm90::smem_desc(stg + L::B_OFF, BOX_BYTES, 1024, 1);
    const uint64_t dgh = sm90::smem_desc(gh, 16, 1024, 1);
    const uint64_t dwh = sm90::smem_desc(wh, XT_BYTES, 512, 2);
#pragma unroll
    for (int kk = 0; kk < 4 * NT; ++kk) {
      const uint64_t da = desc_at(dc, (kk / 4) * BOX_BYTES + (kk % 4) * 32);
      sm90::wgmma_ss_m64n32k16<0, 1>(yi, da, desc_at(dsh, kk * 1024), 1);
      sm90::wgmma_ss_m64n32k16<0, 1>(yi, da, desc_at(dsh, NT * XT_BYTES + kk * 1024), 1);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t db = desc_at(dx, k * 1024);
      sm90::wgmma_ss_m64n32k16<0, 1>(ya, desc_at(dgh, k * 32), db, 1);
      sm90::wgmma_ss_m64n32k16<0, 1>(ya, desc_at(dgh, BOX_BYTES + k * 32), db, 1);
    }
#pragma unroll
    for (int m = 0; m < NT; ++m)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t da = desc_at(dbt, m * BOX_BYTES + k * 2048);
        sm90::wgmma_ss_m64n32k16<1, 1>(st[m], da, desc_at(dwh, k * 1024), 1);
        sm90::wgmma_ss_m64n32k16<1, 1>(st[m], da, desc_at(dwh, XT_BYTES + k * 1024), 1);
      }
    sm90::wgmma_commit();

    // 3. while they run: the next chunk's w x into the other set (last
    //    read by the previous chunk's products, done)
    if (c + 1 < nch) {
      const int s1 = (c + 1) % STAGES;
      const uint32_t nw = sbase + L::W_OFF + ((c + 1) & 1) * 2 * XT_BYTES;
      sm90::mbar_wait(bar_full + 8 * s1, ((c + 1) / STAGES) & 1);
      build_wx<NT>(smem + s1 * L::STAGE_BYTES, nw, nw + XT_BYTES, t);
    }
    e0 = secum[r0];
    e1 = secum[r1];

    sm90::wgmma_wait_all();
    sm90::fence_regs(yi);
    sm90::fence_regs(ya);
#pragma unroll
    for (int m = 0; m < NT; ++m) sm90::fence_regs(st[m]);
    sm90::mbar_arrive(bar_gempty + 8 * g);   // this G set is free
    sm90::mbar_arrive(bar_empty + 8 * s);    // and this stage, for the consumers
  }

  // the last chunk's y
  stage_y(nch - 1);
  sm90::fence_proxy_async();
  sm90::bar_sync(1, 128);
  if (t == 0) {
    sm90::tma_store_4d(&ty, sbase + L::Y_OFF + ((nch - 1) & 1) * XT_BYTES, p0, h,
                       (nch - 1) * QT, b);
    sm90::bulk_commit();
    sm90::bulk_wait();
  }
}

// the tensor-core pair takes bf16 with whole 32-column slices of P and
// 16-byte rows of B and C (TMA), N <= 128 (two state tiles in registers)
bool tc_body(int P, int N, int dtype) {
  return dtype == 1 && P % PT == 0 && N % 8 == 0 && N <= 128;
}

// workspace floats: the records
size_t rec_floats(int B, int S, int H) { return (size_t)B * ((S + QT - 1) / QT) * H * REC; }

template <int NT>
int launch_tc(const void* x, const float* dt, const float* a, const void* bm,
              const void* cm, void* y, float* ws, int B, int S, int H, int P,
              int N, cudaStream_t stream) {
  using L = Tc<NT>;
  // TMA and the bulk copies read 16-byte-aligned global addresses
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
       reinterpret_cast<uintptr_t>(cm) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(ws)) & 15)
    return (int)cudaErrorMisalignedAddress;
  static size_t granted[sm90::MAX_DEVICES] = {};
  int err = sm90::ensure_smem(ssd_tc_kernel<NT>, L::bytes, granted);
  if (err) return err;
  CUtensorMap tx, tb, tc, ty;
  if ((err = sm90::encode_bshd(&tx, x, P, H, S, B, PT, 1, QT, CU_TENSOR_MAP_SWIZZLE_64B)))
    return err;
  if ((err = sm90::encode_bshd(&ty, y, P, H, S, B, PT, 1, QT, CU_TENSOR_MAP_SWIZZLE_64B)))
    return err;
  if ((err = sm90::encode_bshd(&tb, bm, N, 1, S, B, 64, 1, QT, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  if ((err = sm90::encode_bshd(&tc, cm, N, 1, S, B, 64, 1, QT, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  const int nch = (S + QT - 1) / QT;
  ssd_chunk_kernel<<<dim3(nch, B), CH_THREADS, 0, stream>>>(dt, a, ws, S, H, nch);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_tc_kernel<NT><<<dim3(P / PT, H, B), TC_THREADS, L::bytes, stream>>>(
      tx, tb, tc, ty, ws, S, H, nch);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of workspace a call needs: B x chunks x H x REC (the chunk
// pass's records) when the call takes the tensor-core pair, 0 when it takes
// the SIMT body.  The wrapper allocates it; it also says which body runs.
extern "C" long long ssd_scan_workspace_floats(int B, int S, int H, int P,
                                               int N, int dtype) {
  if (!tc_body(P, N, dtype)) return 0;
  return (long long)rec_floats(B, S, H);
}

// dtype (of x, b_, c_ and y): 0 = float32, 1 = bfloat16.  dt and a are
// float32; ws holds ssd_scan_workspace_floats fp32 values (may be null
// when that is 0).  Returns 0, the cudaError_t of an attribute call or a
// launch, or sm90::ENCODE_ERR + the CUresult of a failed tensor-map
// encoding.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, void* y, void* ws,
                            int B, int S, int H, int P, int N, int dtype,
                            void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  if (tc_body(P, N, dtype)) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    float* w = static_cast<float*>(ws);
    if (N <= 64) return launch_tc<1>(x, dtf, af, bm, cm, y, w, B, S, H, P, N, st);
    return launch_tc<2>(x, dtf, af, bm, cm, y, w, B, S, H, P, N, st);
  }
  if (dtype == 0)
    return launch<float>(x, dtf, af, bm, cm, y, B, S, H, P, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, af, bm, cm, y, B, S, H, P, N, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return sm90::error_string(err);
}
