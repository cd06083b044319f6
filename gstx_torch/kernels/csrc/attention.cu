// Fused attention for Hopper (sm_90a): out = softmax(q k^T * scale + mask) v
// with the scores kept on chip.
//
//   round_probs = 0: replaces gstx/kernels/attention.py::fused_attention
//     (pallas_call at line 118): f32 scores and probabilities, PV in f32, the
//     output rounded once to the input dtype.
//   round_probs = 1: replaces fused_attention_batch (pallas_call at line
//     200), the same function with the probabilities rounded to V's dtype
//     before PV.  The TPU kernel's all-heads-per-step grid is a VMEM/grid-step
//     choice; here it is one more instance of the same kernel.
// The additive mask is [B, 1|H, 1|Lq, Lk] f32; broadcast over heads or query
// rows is a zero stride.  There is no special case for a fully masked row:
// with the -10000 additive mask it is an ordinary row.
//
// What bounds it on an H100: bytes.  At the encoder's text shape (B=96, H=12,
// Lq=Lk=256, dh=64) Q/K/V/O are 151 MB: 45 us at 3.35 TB/s, against 19.3
// GFLOP (29 G with the split PV below), 19.5-29 us at the 989 TFLOP/s bf16
// peak.  Attention at these short lengths sits below the card's ~295
// FLOP/byte balance point.
//
// bf16 inputs (the engine's), mma_attention_kernel.  It replaces a design
// whose two products were f32 FMAs on the CUDA cores, fed from shared memory
// through K/V tiles widened to f32, with 32 score rows per CTA in shared
// memory (1.08 ms at the text shape on an H100 SXM at 700 W, 24x the bound).
// Now:
//   * one CTA of 4 warps owns one (batch, head, 64-row query tile), each warp
//     16 query rows; a warp whose rows all lie past Lq skips the math;
//   * Q is staged once and held in registers as mma A fragments (ldmatrix);
//   * K and V stay bf16 in a two-stage ring of 64-key tiles in shared memory,
//     filled by 16-byte cp.async.cg: tile j+1 (K, V and its bias, one commit
//     group, one barrier a tile) loads while tile j computes.  Rows past Lk
//     are zero-filled (source size 0), so no value from past the end, NaN
//     included, reaches a product.  Rows are padded by 16 bytes so that
//     ldmatrix reads 8 rows of one column block in distinct banks;
//   * the additive bias of each tile (the mask's row, or its 64 rows when it
//     varies over query rows; 0 without a mask; -inf at or past Lk) is staged
//     beside K with 4-byte cp.async and read as float2: no branch and no
//     global load in the score loop;
//   * S = Q K^T on the tensor cores (mma.sync m16n8k16 bf16 -> f32; products
//     of bf16 values are exact in f32, as in both TPU kernels), then
//     __fmul_rn(s, scale) + bias in that order;
//   * the softmax is online and stays in registers: a running row max and a
//     running sum of the unrounded f32 exponentials, the output accumulator
//     rescaled at each tile, one multiply by the reciprocal sum at the end;
//     the scores never touch shared memory, so Lk has no cap from shared
//     memory.  e^(s - m) is ex2.approx(s log2e - m log2e), one FFMA and one
//     MUFU where expf takes eight instructions: its relative error (~1e-6) is
//     far below the output's bf16 rounding; against expf it was faster at
//     every shape with every shape's error unchanged;
//   * PV on the tensor cores with the f32 C fragments of S reused as A
//     fragments (the m16n8k16 C and A layouts coincide), V read as B through
//     ldmatrix.trans.  round_probs = 1 rounds P to bf16: one mma per 16 keys.
//     It rounds exp(s - running max) where the reference rounds the
//     normalised probability; the two differ by at most about one bf16 ulp of
//     the output.  round_probs = 0 splits P = hi + lo, hi = bf16(P), lo =
//     bf16(P - hi), two mmas into one f32 accumulator: V is exact in bf16, so
//     PV carries about 16 bits of P, below the output's bf16 rounding.
//     Neither agrees bit for bit with the plain version any more; both hold
//     within 1e-2 + 1.6e-2 |plain|.
//   * Q, K and V are read through their strides (last dimension contiguous,
//     other strides multiples of 8 elements, 16-byte aligned base), so the
//     heads-split views of the projections need no copy; the output is
//     written through strides ([B, Lq, H, dh] storage: merging the heads is
//     a free view).
// mma.sync and not wgmma: at about two thirds of the tensor-core peak the
// products fit inside the byte bound.  What holds the kernel at 2.5-2.8x the
// bound (0.128 ms round_probs = 0, 0.114 ms round_probs = 1 at the text shape
// on an H100 SXM at 700 W) is not the tensor cores: every warp reads the
// whole K and V tile through ldmatrix for its 16 rows (about half the shared-
// memory pipe's rate), and at 138-154 registers (dh = 64) three CTAs share
// an SM, too few warps to hide the serial S -> softmax -> PV chain of each.
// Tried and not kept: 8 warps of 16 rows, a third ring stage, a persistent
// grid and S of tile j+1 beside tile j's softmax were slower at the text
// shape; 2 m-tiles per warp (250 registers) was faster there for
// round_probs = 1 only and slower at the other shapes.  wgmma (operands read from shared memory without
// ldmatrix, the accumulators out of the register file) is the next step.
//
// f32 inputs (dtype 0; the engine never runs them), fma_attention_kernel:
// the earlier design, unchanged: Q, K and V widened to f32 in shared memory,
// 32 f32 score rows per CTA in shared memory (Lk capped where they no longer
// fit), both products f32 FMAs, the softmax as jax.nn.softmax orders it.
//
// C interface (ctypes): the entry returns a cudaError_t as int, the launch's
// cudaGetLastError(); the caller raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "sm90_mma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int KT = 64;              // keys per K / V tile
constexpr int SMEM_LIMIT = 232448;  // opt-in dynamic shared memory per block

struct Strides {
  long long b, h, l;  // elements; the last dimension has stride 1
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // may be null
  void* out;
  Strides qs, ks, vs, ms, os;
  int batch, heads, lq, lk, ld_s;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores and asynchronous copies

constexpr int QM = 64;              // query rows per CTA, 16 per warp
constexpr int MMA_THREADS = 128;    // 4 warps
constexpr long long MMA_MAX_LK = (1ll << 31) - KT;  // key indices stay int

// 4 bytes global -> shared
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// e^(x - m) as 2^(x log2 e - m log2 e): one FFMA and one MUFU.EX2, where
// expf takes eight instructions.  Relative error about 1e-6 at the scores'
// range (|x|, |m| <= 30), against the output's bf16 rounding of 2^-9.
__device__ __forceinline__ float exp_shift(float x, float m) {
  constexpr float LOG2E = 1.4426950408889634f;
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaf(x, LOG2E, -m * LOG2E)));
  return y;
}

// This thread's share of copying 64 rows of DH bf16 into shared memory (row
// pitch DH + 8): 16-byte chunks in column c of rows r0 + i * RSTEP.  The
// offsets are computed once; each tile then costs one pointer step a chunk.
template <int DH>
struct TileLoader {
  static constexpr int CPR = DH / 8;  // 16-byte chunks per row
  static constexpr int RSTEP = MMA_THREADS / CPR;
  static constexpr int ITERS = KT / RSTEP;
  static_assert(KT % RSTEP == 0, "whole chunks per thread");
  int r0, soff;  // first row, shared-memory offset (elements)
  __device__ TileLoader() {
    r0 = threadIdx.x / CPR;
    soff = r0 * (DH + 8) + (threadIdx.x % CPR) * 8;
  }
  // rows [row0, row0 + 64) of a slice with row stride ld; rows at or past
  // `valid` are zero-filled (source size 0: nothing is read)
  __device__ __forceinline__ void operator()(bf16* dst, const bf16* src, long long ld, int row0,
                                             int valid) const {
    const bf16* g = src + (row0 + r0) * ld + (threadIdx.x % CPR) * 8;
    const uint32_t d = smem_addr(dst + soff);
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      cp_async16(d + i * RSTEP * (DH + 8) * sizeof(bf16), g, row0 + r0 + i * RSTEP < valid);
      g += RSTEP * ld;
    }
  }
};

// one bias entry: -inf at or past Lk, else the mask's value (cp.async), or 0
// without a mask or past Lq
__device__ __forceinline__ void bias_entry(float* dst, const Params& p, const float* mrow,
                                           bool row_ok, int key) {
  if (key >= p.lk)
    *dst = -INFINITY;
  else if (!mrow || !row_ok)
    *dst = 0.f;
  else
    cp_async4(smem_addr(dst), mrow + key);
}

// the additive bias of keys [j0, j0 + KT) for rows [q0, q0 + rows); rows is
// 1 when the mask broadcasts over query rows, else QM
__device__ __forceinline__ void load_bias(float* dst, const Params& p, const float* mb, int q0,
                                          int j0, int rows) {
  if (rows == 1) {
    if (threadIdx.x < KT) bias_entry(dst + threadIdx.x, p, mb, true, j0 + threadIdx.x);
    return;
  }
  for (int i = threadIdx.x; i < rows * KT; i += MMA_THREADS) {
    const int r = i / KT;
    bias_entry(dst + i, p, mb + (q0 + r) * p.ms.l, q0 + r < p.lq, j0 + i % KT);
  }
}

template <int DH, bool ROUND_P>
__global__ void __launch_bounds__(MMA_THREADS) mma_attention_kernel(Params p) {
  constexpr int LDS = DH + 8;     // row pitch: 8 rows of one 16-byte column block
  constexpr int TILE = KT * LDS;  //   start 16 bytes apart mod 128: no bank conflict
  constexpr int NS = KT / 8;      // 8-key score tiles
  constexpr int ND = DH / 8;      // 8-wide output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [QM][LDS]
  bf16* ks = qs + QM * LDS;                      // [2][KT][LDS]
  bf16* vs = ks + 2 * TILE;                      // [2][KT][LDS]
  float* bias = reinterpret_cast<float*>(vs + 2 * TILE);  // [2][brows][KT]

  const int q0 = blockIdx.x * QM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row and column pair
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs.b + h * p.vs.h;
  const int nt = (p.lk + KT - 1) / KT;
  const float* mb = p.mask ? p.mask + b * p.ms.b + h * p.ms.h : nullptr;
  const int brows = mb && p.ms.l ? QM : 1;
  const TileLoader<DH> load;

  // one cp.async group a tile: {Q, K 0, V 0, bias 0}, then {K j+1, V j+1,
  // bias j+1} issued at the top of tile j into the other stage
  load(qs, qg, p.qs.l, q0, p.lq);
  load(ks, kg, p.ks.l, 0, p.lk);
  load(vs, vg, p.vs.l, 0, p.lk);
  load_bias(bias, p, mb, q0, 0, brows);
  cp_async_commit();

  const int row = q0 + warp * 16 + g;  // this lane's rows: row and row + 8
  const bool active = q0 + warp * 16 < p.lq;
  // this lane's bias rows within a stage: row and row + 8, or the one row
  const int brow0 = brows == 1 ? 0 : (warp * 16 + g) * KT;
  const int brow1 = brows == 1 ? 0 : brow0 + 8 * KT;

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};

  uint32_t qf[DH / 16][4];
  for (int j = 0; j < nt; ++j) {
    // tile j landed, and every warp is done with tile j - 1, whose stage
    // tile j + 1 fills
    cp_async_wait<0>();
    __syncthreads();
    if (j == 0 && active) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 +
                                      (lane >> 4) * 8));
    }
    const int st = j & 1;
    const bf16* kt = ks + st * TILE;
    const bf16* vt = vs + st * TILE;
    const float* bt = bias + st * brows * KT;
    if (j + 1 < nt) {
      const int j1 = (j + 1) * KT;
      load(ks + (st ^ 1) * TILE, kg, p.ks.l, j1, p.lk);
      load(vs + (st ^ 1) * TILE, vg, p.vs.l, j1, p.lk);
      load_bias(bias + (st ^ 1) * brows * KT, p, mb, q0, j1, brows);
      cp_async_commit();
    }
    if (!active) continue;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        // keys np*16 + 0..7 and 8..15, dims kk*16 + 0..7 and 8..15
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_addr(kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }
    // (q.k) * scale, then + mask, each rounded, as the TPU kernel does
    // (+ 0 without a mask changes nothing; + -inf past Lk)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 b0 = *reinterpret_cast<const float2*>(bt + brow0 + n * 8 + 2 * t);
      const float2 b1 = *reinterpret_cast<const float2*>(bt + brow1 + n * 8 + 2 * t);
      s[n][0] = __fadd_rn(__fmul_rn(s[n][0], p.scale), b0.x);
      s[n][1] = __fadd_rn(__fmul_rn(s[n][1], p.scale), b0.y);
      s[n][2] = __fadd_rn(__fmul_rn(s[n][2], p.scale), b1.x);
      s[n][3] = __fadd_rn(__fmul_rn(s[n][3], p.scale), b1.y);
      tmax[0] = fmaxf(tmax[0], fmaxf(s[n][0], s[n][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[n][2], s[n][3]));
    }
    // the row's max over its quad, then the online rescale
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m = fmaxf(mx[i], tmax[i]);
      base[i] = m == -INFINITY ? 0.f : m;  // no -inf - -inf
      alpha[i] = exp_shift(mx[i], base[i]);
      mx[i] = m;
      sum[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp_shift(s[n][e], base[e >> 1]);
        sum[e >> 1] += s[n][e];  // this lane's part; the quad adds at the end
      }
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      // C fragments of score tiles 2kk, 2kk+1 -> the A fragment of keys
      // kk*16 + 0..15
      uint32_t a[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float c0 = s[2 * kk + (i >> 1)][2 * (i & 1)];
        const float c1 = s[2 * kk + (i >> 1)][2 * (i & 1) + 1];
        if (ROUND_P) {
          a[i] = pack_bf16(c0, c1);
        } else {
          const float h0 = round_bf16(c0), h1 = round_bf16(c1);
          a[i] = pack_bf16(h0, h1);  // exact
          lo[i] = pack_bf16(c0 - h0, c1 - h1);
        }
      }
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        // keys kk*16 + 0..7 and 8..15 of dims dp*16 + 0..7, then of 8..15
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_addr(vt + (kk * 16 + (lane & 15)) * LDS + dp * 16 +
                                        (lane >> 4) * 8));
        mma_bf16(o[2 * dp], a, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], a, vb[2], vb[3]);
        if (!ROUND_P) {
          mma_bf16(o[2 * dp], lo, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], lo, vb[2], vb[3]);
        }
      }
    }
  }

  if (!active) return;
  bf16* og = static_cast<bf16*>(p.out) + b * p.os.b + h * p.os.h;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    inv[i] = __frcp_rn(sum[i]);
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int c = d * 8 + 2 * t;
    if (row < p.lq)
      *reinterpret_cast<uint32_t*>(og + row * p.os.l + c) =
          pack_bf16(o[d][0] * inv[0], o[d][1] * inv[0]);
    if (row + 8 < p.lq)
      *reinterpret_cast<uint32_t*>(og + (row + 8) * p.os.l + c) =
          pack_bf16(o[d][2] * inv[1], o[d][3] * inv[1]);
  }
}

size_t mma_smem_bytes(int dh, int bias_rows) {
  return (size_t)(QM + 4 * KT) * (dh + 8) * sizeof(bf16) + 2 * bias_rows * KT * sizeof(float);
}

template <int DH, bool ROUND_P>
cudaError_t launch_mma(const Params& p, cudaStream_t s) {
  const auto kernel = mma_attention_kernel<DH, ROUND_P>;
  const size_t smem = mma_smem_bytes(DH, p.mask && p.ms.l ? QM : 1);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.lq + QM - 1) / QM, p.heads, p.batch);
  kernel<<<grid, MMA_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool ROUND_P>
cudaError_t dispatch_mma(const Params& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 16: return launch_mma<16, ROUND_P>(p, s);
    case 32: return launch_mma<32, ROUND_P>(p, s);
    case 64: return launch_mma<64, ROUND_P>(p, s);
    case 128: return launch_mma<128, ROUND_P>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, score rows in shared memory

constexpr int QT = 32;        // query rows per CTA
constexpr int THREADS = 256;  // 8 warps
constexpr int PAD = 4;        // f32 elements of padding per Q / K / V row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// rows [row0, row0 + nrows) of one (batch, head) slice -> f32 shared memory
// (row stride DH + PAD), zero-filled past `valid` rows
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long ld,
                                           int row0, int nrows, int valid) {
  constexpr int V4 = DH / 4;
  for (int i = threadIdx.x; i < nrows * V4; i += THREADS) {
    const int r = i / V4;
    const int c = (i - r * V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < valid) x = load4(src + (long long)(row0 + r) * ld + c);
    store4(dst + r * (DH + PAD) + c, x);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) fma_attention_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [QT][DH + PAD]
  float* kv = qs + QT * (DH + PAD);        // [KT][DH + PAD], K tiles then V tiles
  float* ss = kv + KT * (DH + PAD);        // [QT][ld_s] scores, then probabilities
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* kg = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* vg = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;

  stage_rows<DH>(qs, qg, p.qs.l, q0, QT, p.lq);

  // scores: thread -> key j of the tile and rows rg, rg + 4, ..., rg + 28; a
  // warp shares its rows, so the Q loads are broadcasts
  {
    const int j = tid % KT, rg = tid / KT;
    constexpr int RPT = QT / (THREADS / KT);
    const float* mrow = p.mask ? p.mask + b * p.ms.b + h * p.ms.h : nullptr;
    for (int j0 = 0; j0 < p.lk; j0 += KT) {
      __syncthreads();  // Q staged / the previous tile consumed
      stage_rows<DH>(kv, kg, p.ks.l, j0, KT, p.lk);
      __syncthreads();
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
      const float* kr = kv + j * (DH + PAD);
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        const float4 kf = load4(kr + d);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float4 qf = load4(qs + (rg + i * (THREADS / KT)) * (DH + PAD) + d);
          acc[i] = fmaf(qf.x, kf.x, acc[i]);
          acc[i] = fmaf(qf.y, kf.y, acc[i]);
          acc[i] = fmaf(qf.z, kf.z, acc[i]);
          acc[i] = fmaf(qf.w, kf.w, acc[i]);
        }
      }
      const int key = j0 + j;
      if (key < p.lk) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg + i * (THREADS / KT);
          // (q.k) * scale, then + mask, each rounded, as the TPU kernel does
          float s = __fmul_rn(acc[i], p.scale);
          if (mrow) s += mrow[min(q0 + r, p.lq - 1) * p.ms.l + key];
          ss[r * p.ld_s + key] = s;
        }
      }
    }
  }
  __syncthreads();

  // softmax: one warp per row, lanes striding over the keys; each lane reads
  // back only what it wrote, so the three passes need no barrier
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < QT; r += THREADS / 32) {
      if (q0 + r >= p.lq) break;  // rows ascend with r
      float* row = ss + r * p.ld_s;
      float m = -INFINITY;
      for (int j = lane; j < p.lk; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < p.lk; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < p.lk; j += 32) row[j] = row[j] / sum;
    }
  }

  // PV: thread -> 4 output columns (c4) of rows r0, r0 + RSTEP, ...
  constexpr int CG = DH / 4;
  constexpr int RSTEP = THREADS / CG;
  constexpr int RPT = (QT + RSTEP - 1) / RSTEP;
  const int c4 = (tid % CG) * 4, r0 = tid / CG;
  float4 acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < p.lk; j0 += KT) {
    __syncthreads();  // probabilities written / the previous tile consumed
    stage_rows<DH>(kv, vg, p.vs.l, j0, KT, p.lk);
    __syncthreads();
    const int nk = min(KT, p.lk - j0);
    for (int jj = 0; jj < nk; ++jj) {
      const float4 vf = load4(kv + jj * (DH + PAD) + c4);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i * RSTEP;
        if (RPT * RSTEP > QT && r >= QT) break;
        const float pr = ss[r * p.ld_s + j0 + jj];
        acc[i].x = fmaf(pr, vf.x, acc[i].x);
        acc[i].y = fmaf(pr, vf.y, acc[i].y);
        acc[i].z = fmaf(pr, vf.z, acc[i].z);
        acc[i].w = fmaf(pr, vf.w, acc[i].w);
      }
    }
  }
  float* og = static_cast<float*>(p.out) + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i * RSTEP;
    if (r < QT && q0 + r < p.lq) store4(og + (long long)(q0 + r) * p.os.l + c4, acc[i]);
  }
}

int ld_scores(int lk) { return (lk + 31) / 32 * 32 + PAD; }

size_t fma_smem_bytes(int dh, int lk) {
  return (size_t)((QT + KT) * (dh + PAD) + QT * ld_scores(lk)) * sizeof(float);
}

template <int DH>
cudaError_t launch_fma(const Params& p, int batch, int heads, cudaStream_t s) {
  const size_t smem = fma_smem_bytes(DH, p.lk);
  cudaError_t e = cudaFuncSetAttribute(fma_attention_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.lq + QT - 1) / QT, heads, batch);
  fma_attention_kernel<DH><<<grid, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_fma(const Params& p, int batch, int heads, int dh, cudaStream_t s) {
  switch (dh) {
    case 16: return launch_fma<16>(p, batch, heads, s);
    case 32: return launch_fma<32>(p, batch, heads, s);
    case 64: return launch_fma<64>(p, batch, heads, s);
    case 128: return launch_fma<128>(p, batch, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, Lq, dh], k and v [B, H, Lk, dh], out [B, H, Lq, dh], all read and
// written through strides[0..2] (q), [3..5] (k), [6..8] (v), [9..11] (mask),
// [12..14] (out): the batch, head and row strides in elements, the last
// dimension contiguous.  mask: additive f32 or null.  dtype: 0 f32, 1 bf16
// (q, k, v and out alike).  dh in {16, 32, 64, 128}.  round_probs: round the
// probabilities to the dtype before PV (fused_attention_batch).  bf16 also
// needs 16-byte aligned q, k, v and q/k/v strides divisible by 8; f32 needs
// Lk small enough for its score rows (fma_smem_bytes).
int gstx_attention(const void* q, const void* k, const void* v, const void* mask,
                   void* out, int batch, int heads, int lq, int lk, int dh,
                   const long long* strides, float scale, int dtype,
                   int round_probs, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const float*>(mask);
  p.out = out;
  Strides* st[5] = {&p.qs, &p.ks, &p.vs, &p.ms, &p.os};
  for (int i = 0; i < 5; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.batch = batch;
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.ld_s = ld_scores(lk);
  p.scale = scale;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    bool aligned = lk <= MMA_MAX_LK &&
                   (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16) == 0;
    for (int i = 0; i < 9; ++i) aligned = aligned && strides[i] % 8 == 0;
    if (!aligned) return (int)cudaErrorInvalidValue;
    return (int)(round_probs ? dispatch_mma<true>(p, dh, s) : dispatch_mma<false>(p, dh, s));
  }
  // f32 V: rounding the probabilities to V's dtype changes nothing
  if (dtype == 0 && fma_smem_bytes(dh, lk) <= (size_t)SMEM_LIMIT)
    return (int)dispatch_fma(p, batch, heads, dh, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
