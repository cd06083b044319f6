// Fused transformer epilogue kernels for Hopper (sm_90a), bf16 in / bf16 out.
//
//   gstx_dense_ln: out = LayerNorm(residual + x @ W^T + b)
//   gstx_ffn:      out = LayerNorm(x + gelu(x @ W1^T + b1) @ W2^T + b2)
//
// Replace the TPU kernels gstx/kernels/ffn.py::_dense_ln_pallas (line 254)
// and gstx/kernels/ffn.py::_ffn_pallas (line 198).  They compute what those
// kernels compute, not how: f32 accumulation, f32 bias / residual / GELU /
// LayerNorm (two-pass mean and variance, eps inside the rsqrt), the FFN
// hidden rounded to bf16 before the second product (ffn.py:224), output
// rounded to bf16 once.
//
// What bounds them on an H100: at the encoder's shapes (M = B*S up to
// 24,576 rows, D = 768 or 1024, F = 3,072) a text-FFN call is 232 GFLOP
// against ~0.1 GB of compulsory traffic, far above the card's ~295
// FLOP/byte balance point: operations.  dense_ln sits near that point
// (29 GFLOP against ~0.11 GB at 24,576 x 768 -> 768: bytes; operations at
// an inner width of 1,024).  Both keep the LayerNorm's whole row in one
// CTA, so every output element is written once, and the FFN keeps its
// [M, F] hidden on chip.
//
// Both kernels share one design: mma.sync m16n8k16 (bf16 in, f32
// accumulation) fed by one cp.async ring of tiles that all 16 warps of the
// CTA share.  The first designs (wmma fragments straight from global
// memory, nothing pipelined) took 4.31 ms (FFN) and 0.637 ms (dense_ln) at
// the text shape on an H100 SXM at 700 W, 18x their bounds: every CTA
// pulled every weight fragment from L2 on its own.  Now:
//   * a CTA owns BM = 64 rows (32 for D > 768, or where 64-row blocks would
//     not fill the card once: block_rows in ffn.py), 16 warps, one CTA per
//     SM.  Its [BM, D] f32 accumulator stays in registers across the whole
//     inner loop: warps 2 x 8, each (BM/2) rows x D/8 columns, 96
//     registers a thread at BM = 64, D = 768;
//   * tiles stream through a 4-stage ring in steps of two tiles (one step
//     in flight beside the one in use), one commit group and one barrier a
//     step.  Each weight byte crosses from L2 to the SM once per CTA;
//   * operands come through ldmatrix.  Rows of 32 bytes (two 16-byte
//     chunks) swap their chunks in rows 4-7 of every 8, and longer rows are
//     padded by 16 bytes, so the 8 rows of one ldmatrix matrix lie in
//     distinct banks;
//   * the LayerNorm runs from the registers: row sums over each warp's
//     columns by quad shuffles, the 8 column warps' partial sums through
//     shared memory (the free ring), mean, then the centred variance, and
//     bf16 stores straight from the registers.
//
// dense_ln_kernel: K is walked in 16-column tiles; a ring stage holds the
// W tile [D, 16] and the x tile [BM, 16] (zero-filled past M), so K has no
// limit.  The accumulator starts at bias + residual, read from global
// memory while the first tiles are in flight, and gamma and beta wait in
// shared memory, so the epilogue holds nothing beside the accumulator (no
// spills).  At the text shape each CTA streams the 1.18 MB W from L2 once:
// ~0.45 GB per call.
//
// ffn_kernel: the x block is staged once (cp.async, zero-filled past M) and
// is both the first product's A operand and the residual.  F is walked in
// chunks of FC = 128 hidden columns.  Every CTA walks one sequence of
// weight tiles of about equal size: per chunk, KS = 8 tiles of W1 ([FC
// rows, D/8 columns], rows padded) and then KS of W2 ([D rows, 16
// columns]): ~3.6 GB of L2 -> SM traffic per call at the text shape.
// GEMM1 makes the chunk's [BM, FC] hidden (warp tiles 16 x FC*BM/256) in
// registers; + b1, erf GELU in f32 and the rounding to bf16 put it in
// shared memory, where GEMM2 reads it as A fragments.  GEMM2 accumulates
// over F in chunk order.
// What holds it at about 6x its bound (1.36 ms at the text shape on an H100
// SXM at 700 W; PERF.md): the ring alone, with no math, takes 0.83 ms (the
// L2 -> SM stream at ~4.3 TB/s), the math alone 0.87 ms (266 TFLOP/s, a
// quarter of the bf16 peak: four warps per SM sub-partition, all in the same
// phase between barriers), and the two overlap only in part.  At D = 768
// kernels/ffn.py (takes_wgmma) sends every call to ffn_sm90.cu instead (TMA
// ring, wgmma, warp specialisation: 0.60 ms at the text shape); ffn_kernel
// keeps the other widths, D = 1,024 among them, whose [64, 1,024] f32
// accumulator does not fit two warpgroups' registers.
//
// C interface (ctypes): every entry returns a cudaError_t as int, the
// launch's cudaGetLastError(); the caller raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "sm90_mma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 512;        // 16 warps: 2 x 8 over the output block
constexpr int SMEM_LIMIT = 232448;  // opt-in dynamic shared memory per block

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// ffn_kernel: mma.sync fed by one cp.async weight ring

constexpr int F_ALIGN = 128;      // F % F_ALIGN == 0: whole chunks at every FC

template <int NT, int ROWS>
struct FfnShape {
  static constexpr int D = NT * 128;
  static constexpr int FC = 128;          // hidden columns per F chunk
  static constexpr int STAGES = 4;        // ring stages, in steps of GROUP tiles:
  static constexpr int GROUP = 2;         //   one commit group and one barrier a step
  static constexpr int KS = FC / 16;      // W1 tiles, and W2 tiles, per F chunk
  static constexpr int KC1 = D / KS;      // D columns of a W1 tile
  // row pitches in bf16, each 16 bytes past a multiple of 32: the 8 rows of
  // an ldmatrix matrix start in distinct 16-byte bank groups.  A W2 tile row
  // is two 16-byte chunks, unpadded: rows 4-7 of every 8 swap their chunks.
  static constexpr int LDX = D + 8;       // x block [ROWS][LDX]
  static constexpr int LDH = FC + 8;      // hidden chunk [ROWS][LDH]
  static constexpr int LD1 = KC1 + 8;     // W1 tile [FC][LD1]
  static constexpr int W2_TILE = D * 16;  // W2 tile [D][16]
  static constexpr int STAGE = FC * LD1 > W2_TILE ? FC * LD1 : W2_TILE;  // elements
  // GEMM2 (the output): warps 2 x 8, each (ROWS/2) x (D/8): MT2 m16 tiles
  // and 2 NT n8 tiles.  GEMM1 (the hidden chunk): warps (ROWS/16) x WC1,
  // each 16 x (FC/WC1): 2 NP1 n8 tiles.
  static constexpr int MT2 = ROWS / 32;
  static constexpr int WC1 = 256 / ROWS;
  static constexpr int NP1 = FC / WC1 / 16;
  static constexpr size_t SMEM =
      sizeof(bf16) * ((size_t)ROWS * LDX + (size_t)ROWS * LDH + (size_t)STAGES * STAGE);
  static_assert(STAGES % GROUP == 0 && STAGES / GROUP >= 2 && KS % GROUP == 0,
                "a step in flight beside the one in use; no step spans two products");
  static_assert(ROWS == 32 || ROWS == 64, "32 or 64 rows per CTA");
  static_assert(NP1 >= 1 && F_ALIGN % FC == 0, "whole ldmatrix_x4 tiles, whole chunks");
  static_assert(2 * ROWS * 8 * sizeof(float) <= STAGES * STAGE * sizeof(bf16),
                "the LayerNorm's partial sums fit the ring");
  static_assert(SMEM <= (size_t)SMEM_LIMIT, "shared memory");
};

// %tid.x, read where it is used.  Values derived from it are then recomputed
// in each tile (a few integer instructions) rather than held in registers
// across the loops beside the accumulators, where they spilled.
__device__ __forceinline__ int thread_x() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

// Where this thread's fragments lie in the FFN's warp tiles.
template <class S>
struct Place {
  int warp, lane;
  __device__ __forceinline__ Place() {
    const int tx = thread_x();
    warp = tx >> 5;
    lane = tx & 31;
  }
  __device__ __forceinline__ int g() const { return lane >> 2; }  // fragment row
  __device__ __forceinline__ int t() const { return lane & 3; }   //   and column pair
  // GEMM1 warp tile: rows 16 rt + [0, 16), chunk columns hc + [0, 16 NP1)
  __device__ __forceinline__ int rt() const { return warp / S::WC1; }
  __device__ __forceinline__ int hc() const { return warp % S::WC1 * S::NP1 * 16; }
  // GEMM2 warp tile: rows wm ROWS/2 + [0, ROWS/2), columns wn D/8 + [0, D/8)
  __device__ __forceinline__ int wm() const { return warp >> 3; }
  __device__ __forceinline__ int wn() const { return warp & 7; }
  // this lane's ldmatrix row and column: A from [m][k] rows, B from [n][k]
  // rows (W2's with the chunk swap of rows 4-7 of every 8)
  __device__ __forceinline__ int a_row() const { return lane & 15; }
  __device__ __forceinline__ int a_col() const { return (lane >> 4) * 8; }
  __device__ __forceinline__ int a2_col() const { return a_col() ^ ((lane >> 2) & 1) * 8; }
  __device__ __forceinline__ int b_row() const { return (lane & 7) + ((lane >> 4) << 3); }
  __device__ __forceinline__ int b_col() const { return ((lane >> 3) & 1) * 8; }
  __device__ __forceinline__ int b2_col() const { return b_col() ^ ((lane >> 2) & 1) * 8; }
};

// Weight tile `tile` of the sequence every CTA walks: in F chunk
// f0 = tile / (2 KS) * FC, tile s = tile % (2 KS) is W1 rows [f0, f0 + FC)
// x columns [s KC1, (s + 1) KC1) for s < KS, else W2's D rows x columns
// f0 + 16 (s - KS) + [0, 16).
template <class S>
__device__ __forceinline__ void load_weight_tile(bf16* dst, const bf16* __restrict__ w1,
                                                 const bf16* __restrict__ w2, int F, int tile) {
  const int f0 = tile / (2 * S::KS) * S::FC;
  const int s = tile % (2 * S::KS);
  if (s < S::KS) {
    constexpr int CPR = S::KC1 / 8;  // 16-byte chunks per row
    const bf16* src = w1 + (size_t)f0 * S::D + s * S::KC1;
    for (int i = thread_x(); i < S::FC * CPR; i += THREADS) {
      const int r = i / CPR, c = (i - r * CPR) * 8;
      cp_async16(smem_addr(dst + r * S::LD1 + c), src + (size_t)r * S::D + c, true);
    }
  } else {
    const bf16* src = w2 + f0 + (s - S::KS) * 16;
    for (int i = thread_x(); i < S::D * 2; i += THREADS) {
      const int r = i >> 1, c = i & 1;
      cp_async16(smem_addr(dst + r * 16 + (c ^ ((r >> 2) & 1)) * 8), src + (size_t)r * F + c * 8,
                 true);
    }
  }
}

// Tiles [first, first + GROUP) into their ring stages (those past the end
// are skipped), as one commit group.
template <class S>
__device__ __forceinline__ void load_step(bf16* ring, const bf16* __restrict__ w1,
                                          const bf16* __restrict__ w2, int F, int first,
                                          int ntiles) {
#pragma unroll
  for (int i = 0; i < S::GROUP; ++i)
    if (first + i < ntiles)
      load_weight_tile<S>(ring + (first + i) % S::STAGES * S::STAGE, w1, w2, F, first + i);
  cp_async_commit();
}

// The ring's step at tile `tile`, the first of a step: wait for its group
// (the STAGES / GROUP - 2 after it may still be in flight), let every warp
// see it and be done with the previous step, and refill that step's stages
// with the step STAGES / GROUP - 1 ahead.
template <class S>
__device__ __forceinline__ void ring_step(bf16* ring, const bf16* __restrict__ w1,
                                          const bf16* __restrict__ w2, int F, int tile,
                                          int ntiles) {
  cp_async_wait<S::STAGES / S::GROUP - 2>();
  __syncthreads();
  load_step<S>(ring, w1, w2, F, tile + S::STAGES - S::GROUP, ntiles);
}

// Replaces _ffn_pallas (gstx/kernels/ffn.py:198).  Bound on the card:
// operations (232 GFLOP at the text shape).  ROWS rows per CTA, D = NT * 128.
template <int NT, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ gamma,
           const float* __restrict__ beta, bf16* __restrict__ out, int M,
           int F, float eps) {
  using S = FfnShape<NT, ROWS>;
  constexpr int D = S::D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [ROWS][LDX]
  bf16* hs = xs + ROWS * S::LDX;             // [ROWS][LDH]
  bf16* ring = hs + ROWS * S::LDH;           // [STAGES][STAGE]
  const int row0 = blockIdx.x * ROWS;
  const int ntiles = F / S::FC * 2 * S::KS;

  // commit group 0: the x block (zero-filled past M) and the first step's
  // weight tiles; then the steps up to STAGES / GROUP - 2
  {
    constexpr int CPR = D / 8;
    for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
      const int r = i / CPR, c = (i - r * CPR) * 8;
      const bool valid = row0 + r < M;
      cp_async16(smem_addr(xs + r * S::LDX + c), x + (size_t)(valid ? row0 + r : 0) * D + c,
                 valid);
    }
  }
#pragma unroll
  for (int i = 0; i < S::STAGES - S::GROUP; i += S::GROUP) load_step<S>(ring, w1, w2, F, i, ntiles);

  float acc[S::MT2][2 * NT][4];
#pragma unroll
  for (int mt = 0; mt < S::MT2; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  int tile = 0;
  for (int f0 = 0; f0 < F; f0 += S::FC) {
    // GEMM1: the hidden chunk's warp tile, over D in KS weight tiles
    float h[2 * S::NP1][4];
#pragma unroll
    for (int j = 0; j < 2 * S::NP1; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
#pragma unroll 1
    for (int s = 0; s < S::KS; ++s, ++tile) {
      const Place<S> p;  // before the barrier, which hides its latency
      if (s % S::GROUP == 0) ring_step<S>(ring, w1, w2, F, tile, ntiles);
      const bf16* wt = ring + tile % S::STAGES * S::STAGE;
      const bf16* xa = xs + (p.rt() * 16 + p.a_row()) * S::LDX + s * S::KC1 + p.a_col();
      const bf16* wb = wt + (p.hc() + p.b_row()) * S::LD1 + p.b_col();
#pragma unroll
      for (int kk = 0; kk < S::KC1 / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(xa + kk * 16));
#pragma unroll
        for (int np = 0; np < S::NP1; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(wb + np * 16 * S::LD1 + kk * 16));
          mma_bf16(h[2 * np], a, b[0], b[1]);
          mma_bf16(h[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    // + b1, erf GELU in f32, bf16: the chunk's hidden into shared memory.
    // Every warp finished reading the previous chunk's before this chunk's
    // first ring step; the next ring step publishes this one.
#pragma unroll
    for (int j = 0; j < 2 * S::NP1; ++j) {
      const Place<S> p;
      const int c = p.hc() + j * 8 + 2 * p.t();
      const float bx = b1[f0 + c], by = b1[f0 + c + 1];
      bf16* hr = hs + (p.rt() * 16 + p.g()) * S::LDH + c;
      *reinterpret_cast<uint32_t*>(hr) =
          pack_bf16(gelu_erf(h[j][0] + bx), gelu_erf(h[j][1] + by));
      *reinterpret_cast<uint32_t*>(hr + 8 * S::LDH) =
          pack_bf16(gelu_erf(h[j][2] + bx), gelu_erf(h[j][3] + by));
    }
    // GEMM2: acc += hidden chunk @ W2[:, f0 + ...]^T, 16 hidden columns a tile
#pragma unroll 1
    for (int s = 0; s < S::KS; ++s, ++tile) {
      const Place<S> p;
      if (s % S::GROUP == 0) ring_step<S>(ring, w1, w2, F, tile, ntiles);
      const bf16* wt = ring + tile % S::STAGES * S::STAGE;
      uint32_t a[S::MT2][4];
#pragma unroll
      for (int mt = 0; mt < S::MT2; ++mt)
        ldmatrix_x4(a[mt], smem_addr(hs + (p.wm() * (ROWS / 2) + mt * 16 + p.a_row()) * S::LDH +
                                     s * 16 + p.a_col()));
      const bf16* wb = wt + (p.wn() * NT * 16 + p.b_row()) * 16 + p.b2_col();
#pragma unroll
      for (int np = 0; np < NT; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(wb + np * 16 * 16));
#pragma unroll
        for (int mt = 0; mt < S::MT2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the LayerNorm's partial sums go there

  // v = acc + b2 + x in place, and each row's sum over this warp's columns
  const Place<S> p;
  const int g = p.g(), t = p.t(), wm = p.wm(), wn = p.wn();
  float* part = reinterpret_cast<float*>(ring);  // [2][ROWS][8]
  float rs[S::MT2][2];
#pragma unroll
  for (int mt = 0; mt < S::MT2; ++mt) {
    const int r = wm * (ROWS / 2) + mt * 16 + g;
    rs[mt][0] = rs[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const int c = wn * NT * 16 + j * 8 + 2 * t;
      const float bx = b2[c], by = b2[c + 1];
      const __nv_bfloat162 x0 = *reinterpret_cast<const __nv_bfloat162*>(xs + r * S::LDX + c);
      const __nv_bfloat162 x1 =
          *reinterpret_cast<const __nv_bfloat162*>(xs + (r + 8) * S::LDX + c);
      acc[mt][j][0] = acc[mt][j][0] + bx + __low2float(x0);
      acc[mt][j][1] = acc[mt][j][1] + by + __high2float(x0);
      acc[mt][j][2] = acc[mt][j][2] + bx + __low2float(x1);
      acc[mt][j][3] = acc[mt][j][3] + by + __high2float(x1);
      rs[mt][0] += acc[mt][j][0] + acc[mt][j][1];
      rs[mt][1] += acc[mt][j][2] + acc[mt][j][3];
    }
  }
  // the quad's sum, then the 8 column warps' sums through shared memory:
  // first the mean, then the centred variance
  float mean[S::MT2][2], inv[S::MT2][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float* pp = part + pass * ROWS * 8;
#pragma unroll
    for (int mt = 0; mt < S::MT2; ++mt) {
      const int r = wm * (ROWS / 2) + mt * 16 + g;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v = rs[mt][i];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) pp[(r + 8 * i) * 8 + wn] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < S::MT2; ++mt) {
      const int r = wm * (ROWS / 2) + mt * 16 + g;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* row = pp + (r + 8 * i) * 8;
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) tot += row[w];
        if (pass == 0) {
          mean[mt][i] = tot * (1.0f / D);
        } else {
          inv[mt][i] = rsqrtf(tot * (1.0f / D) + eps);
        }
      }
      if (pass == 0) {
        rs[mt][0] = rs[mt][1] = 0.f;
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = acc[mt][j][e] - mean[mt][e >> 1];
            rs[mt][e >> 1] += d * d;
          }
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < S::MT2; ++mt) {
    const int r = row0 + wm * (ROWS / 2) + mt * 16 + g;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const int c = wn * NT * 16 + j * 8 + 2 * t;
      const float gx = gamma[c], gy = gamma[c + 1], bx = beta[c], by = beta[c + 1];
      if (r < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)r * D + c) =
            pack_bf16((acc[mt][j][0] - mean[mt][0]) * inv[mt][0] * gx + bx,
                      (acc[mt][j][1] - mean[mt][0]) * inv[mt][0] * gy + by);
      if (r + 8 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8) * D + c) =
            pack_bf16((acc[mt][j][2] - mean[mt][1]) * inv[mt][1] * gx + bx,
                      (acc[mt][j][3] - mean[mt][1]) * inv[mt][1] * gy + by);
    }
  }
}

// ---------------------------------------------------------------------------
// dense_ln_kernel: x and W tiles through one cp.async ring

template <int NT, int ROWS>
struct DenseLnShape {
  static constexpr int D = NT * 128;
  static constexpr int STAGES = 4;  // ring stages, in steps of GROUP tiles:
  static constexpr int GROUP = 2;   //   one commit group and one barrier a step
  // a stage: the W tile [D][16], then the x tile [ROWS][16]; 32-byte rows
  // whose two 16-byte chunks swap in rows 4-7 of every 8
  static constexpr int W_TILE = D * 16;
  static constexpr int STAGE = W_TILE + ROWS * 16;  // elements
  // warps 2 x 8, each (ROWS/2) x (D/8): MT m16 tiles and 2 NT n8 tiles
  static constexpr int MT = ROWS / 32;
  static constexpr size_t RING = sizeof(bf16) * STAGES * STAGE;  // bytes
  static constexpr size_t SMEM = RING + 2 * D * sizeof(float);     // + gamma, beta
  static_assert(STAGES % GROUP == 0 && STAGES / GROUP >= 2, "a step in flight beside the one in use");
  static_assert(ROWS == 32 || ROWS == 64, "32 or 64 rows per CTA");
  static_assert(2 * ROWS * 8 * sizeof(float) <= RING, "the LayerNorm's partial sums fit the ring");
  static_assert(SMEM <= (size_t)SMEM_LIMIT, "shared memory");
};

// Tile `tile` (K columns 16 tile + [0, 16)) of W's D rows and of x's rows
// row0 + [0, ROWS), zero-filled past M, into one ring stage.
template <class S, int ROWS>
__device__ __forceinline__ void load_dense_ln_tile(bf16* dst, const bf16* __restrict__ x,
                                                   const bf16* __restrict__ w, int row0, int M,
                                                   int K, int tile) {
  const int k0 = tile * 16;
  for (int i = thread_x(); i < S::D * 2; i += THREADS) {
    const int r = i >> 1, c = i & 1;
    cp_async16(smem_addr(dst + r * 16 + (c ^ ((r >> 2) & 1)) * 8), w + (size_t)r * K + k0 + c * 8,
               true);
  }
  const int i = thread_x();
  if (i < ROWS * 2) {
    const int r = i >> 1, c = i & 1;
    const bool valid = row0 + r < M;
    cp_async16(smem_addr(dst + S::W_TILE + r * 16 + (c ^ ((r >> 2) & 1)) * 8),
               x + (size_t)(valid ? row0 + r : 0) * K + k0 + c * 8, valid);
  }
}

// Tiles [first, first + GROUP) into their ring stages (those past the end
// are skipped), as one commit group.
template <class S, int ROWS>
__device__ __forceinline__ void dense_ln_step(bf16* ring, const bf16* __restrict__ x,
                                              const bf16* __restrict__ w, int row0, int M, int K,
                                              int first, int ntiles) {
#pragma unroll
  for (int i = 0; i < S::GROUP; ++i)
    if (first + i < ntiles)
      load_dense_ln_tile<S, ROWS>(ring + (first + i) % S::STAGES * S::STAGE, x, w, row0, M, K,
                                  first + i);
  cp_async_commit();
}

// Replaces _dense_ln_pallas (gstx/kernels/ffn.py:254).  Bound on the card:
// bytes at the text shape (24,576 x 768 -> 768), operations at an inner
// width of 1,024.  ROWS rows per CTA, D = NT * 128, K % 16 == 0.
template <int NT, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
dense_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, const bf16* __restrict__ res,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                bf16* __restrict__ out, int M, int K, float eps) {
  using S = DenseLnShape<NT, ROWS>;
  constexpr int D = S::D, MT = S::MT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);                  // [STAGES][STAGE]
  float* gb = reinterpret_cast<float*>(smem + S::RING);          // gamma [D], beta [D]
  const int row0 = blockIdx.x * ROWS;
  const int ntiles = K / 16;

  // commit groups: the steps up to STAGES / GROUP - 2
#pragma unroll
  for (int i = 0; i < S::STAGES - S::GROUP; i += S::GROUP)
    dense_ln_step<S, ROWS>(ring, x, w, row0, M, K, i, ntiles);

  // the accumulator starts at bias + residual (zero past M): read once,
  // while the first tiles are in flight, and not held beside it later
  float acc[MT][2 * NT][4];
  {
    const Place<S> p;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = row0 + p.wm() * (ROWS / 2) + mt * 16 + p.g();
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        const int c = p.wn() * NT * 16 + j * 8 + 2 * p.t();
        const float bx = bias[c], by = bias[c + 1];
        __nv_bfloat162 r0 = __floats2bfloat162_rn(0.f, 0.f), r1 = r0;
        if (r < M) r0 = *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)r * D + c);
        if (r + 8 < M) r1 = *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)(r + 8) * D + c);
        acc[mt][j][0] = bx + __low2float(r0);
        acc[mt][j][1] = by + __high2float(r0);
        acc[mt][j][2] = bx + __low2float(r1);
        acc[mt][j][3] = by + __high2float(r1);
      }
    }
  }

  // gamma and beta into shared memory, published by the first ring step's
  // barrier: read from global memory in the epilogue, their loads were
  // hoisted beside the accumulator and spilled
  for (int i = threadIdx.x; i < D; i += THREADS) {
    gb[i] = gamma[i];
    gb[D + i] = beta[i];
  }

#pragma unroll 1
  for (int tile = 0; tile < ntiles; ++tile) {
    const Place<S> p;  // before the barrier, which hides its latency
    if (tile % S::GROUP == 0) {
      // wait for this step's group, let every warp see it and be done with
      // the previous step, and refill that step's stages
      cp_async_wait<S::STAGES / S::GROUP - 2>();
      __syncthreads();
      dense_ln_step<S, ROWS>(ring, x, w, row0, M, K, tile + S::STAGES - S::GROUP, ntiles);
    }
    const bf16* wt = ring + tile % S::STAGES * S::STAGE;
    const bf16* xt = wt + S::W_TILE;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[mt], smem_addr(xt + (p.wm() * (ROWS / 2) + mt * 16 + p.a_row()) * 16 +
                                   p.a2_col()));
    const bf16* wb = wt + (p.wn() * NT * 16 + p.b_row()) * 16 + p.b2_col();
#pragma unroll
    for (int np = 0; np < NT; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_addr(wb + np * 16 * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the LayerNorm's partial sums go there

  // the LayerNorm from the registers: each row's sum over this warp's
  // columns, the quad's sum by shuffles, the 8 column warps' sums through
  // shared memory; first the mean, subtracted in place, then the centred
  // variance.  rs holds the partial sums of a row, then its statistic.
  const Place<S> p;
  const int g = p.g(), t = p.t(), wm = p.wm(), wn = p.wn();
  float* part = reinterpret_cast<float*>(ring);  // [2][ROWS][8]
  float rs[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    rs[mt][0] = rs[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      rs[mt][0] += acc[mt][j][0] + acc[mt][j][1];
      rs[mt][1] += acc[mt][j][2] + acc[mt][j][3];
    }
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float* pp = part + pass * ROWS * 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wm * (ROWS / 2) + mt * 16 + g;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v = rs[mt][i];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) pp[(r + 8 * i) * 8 + wn] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wm * (ROWS / 2) + mt * 16 + g;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // lane t adds partial sums 2t and 2t + 1 and the quad the rest: 8
        // loads a thread in flight beside the accumulator, not 32 (spills)
        const float* row = pp + (r + 8 * i) * 8 + 2 * t;
        float tot = row[0] + row[1];
        tot += __shfl_xor_sync(0xffffffffu, tot, 1);
        tot += __shfl_xor_sync(0xffffffffu, tot, 2);
        rs[mt][i] = pass == 0 ? tot * (1.0f / D) : rsqrtf(tot * (1.0f / D) + eps);
      }
      // pass 0: subtract the mean and sum the squares; pass 1: scale by
      // 1 / sqrt(variance + eps), so no statistic stays live in the stores
      const float s0 = rs[mt][0], s1 = rs[mt][1];
      rs[mt][0] = rs[mt][1] = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (pass == 0) {
            acc[mt][j][e] -= e < 2 ? s0 : s1;
            rs[mt][e >> 1] += acc[mt][j][e] * acc[mt][j][e];
          } else {
            acc[mt][j][e] *= e < 2 ? s0 : s1;
          }
        }
      }
    }
  }
  // * gamma + beta, bf16 stores of rows below M
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = row0 + wm * (ROWS / 2) + mt * 16 + g;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const int c = wn * NT * 16 + j * 8 + 2 * t;
      const float2 gm = *reinterpret_cast<const float2*>(gb + c);
      const float2 bt = *reinterpret_cast<const float2*>(gb + D + c);
      if (r < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)r * D + c) =
            pack_bf16(acc[mt][j][0] * gm.x + bt.x, acc[mt][j][1] * gm.y + bt.y);
      if (r + 8 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8) * D + c) =
            pack_bf16(acc[mt][j][2] * gm.x + bt.x, acc[mt][j][3] * gm.y + bt.y);
    }
  }
}

template <int NT, int ROWS>
cudaError_t launch_ffn(const bf16* x, const bf16* w1, const float* b1,
                       const bf16* w2, const float* b2, const float* g,
                       const float* be, bf16* out, int M, int F, float eps,
                       cudaStream_t s) {
  const size_t smem = FfnShape<NT, ROWS>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(ffn_kernel<NT, ROWS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  ffn_kernel<NT, ROWS><<<(M + ROWS - 1) / ROWS, THREADS, smem, s>>>(
      x, w1, b1, w2, b2, g, be, out, M, F, eps);
  return cudaGetLastError();
}

template <int NT, int ROWS>
cudaError_t launch_dense_ln(const bf16* x, const bf16* w, const float* b, const bf16* res,
                            const float* g, const float* be, bf16* out, int M, int K, float eps,
                            cudaStream_t s) {
  const size_t smem = DenseLnShape<NT, ROWS>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(dense_ln_kernel<NT, ROWS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dense_ln_kernel<NT, ROWS><<<(M + ROWS - 1) / ROWS, THREADS, smem, s>>>(x, w, b, res, g, be, out,
                                                                         M, K, eps);
  return cudaGetLastError();
}

}  // namespace

#define GSTX_NT_CASES_6(CALL) \
  case 1: return CALL(1);     \
  case 2: return CALL(2);     \
  case 3: return CALL(3);     \
  case 4: return CALL(4);     \
  case 5: return CALL(5);     \
  case 6: return CALL(6);

#define GSTX_NT_CASES(CALL) \
  GSTX_NT_CASES_6(CALL)     \
  case 7: return CALL(7);   \
  case 8: return CALL(8);

extern "C" {

// D = 128 * NT with NT in 1..8; K % 16 == 0; bm (rows per CTA) 32, or 64
// with D <= 768.  x, w, res 16-byte aligned.
int gstx_dense_ln(const void* x, const void* w, const void* b, const void* res,
                  const void* gamma, const void* beta, void* out, int M, int K,
                  int D, int bm, float eps, void* stream) {
  if (M <= 0 || K <= 0 || K % 16 != 0 || D % 128 != 0) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x | (uintptr_t)w | (uintptr_t)res) % 16) != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define GSTX_CALL(NT, ROWS)                                                              \
  (int)launch_dense_ln<NT, ROWS>((const bf16*)x, (const bf16*)w, (const float*)b,       \
                                 (const bf16*)res, (const float*)gamma,                  \
                                 (const float*)beta, (bf16*)out, M, K, eps, s)
#define GSTX_CALL32(NT) GSTX_CALL(NT, 32)
#define GSTX_CALL64(NT) GSTX_CALL(NT, 64)
  if (bm == 32) {
    switch (D / 128) { GSTX_NT_CASES(GSTX_CALL32) default: break; }
  } else if (bm == 64) {
    switch (D / 128) { GSTX_NT_CASES_6(GSTX_CALL64) default: break; }
  }
#undef GSTX_CALL64
#undef GSTX_CALL32
#undef GSTX_CALL
  return (int)cudaErrorInvalidValue;
}

// D = 128 * NT with NT in 1..8; F % 128 == 0; bm (rows per CTA) 32, or 64
// with D <= 768.  x, w1, w2 16-byte aligned.
int gstx_ffn(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, const void* gamma, const void* beta, void* out,
             int M, int D, int F, int bm, float eps, void* stream) {
  if (M <= 0 || F <= 0 || F % F_ALIGN != 0 || D % 128 != 0) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w2) % 16) != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define GSTX_CALL(NT, ROWS)                                                         \
  (int)launch_ffn<NT, ROWS>((const bf16*)x, (const bf16*)w1, (const float*)b1,     \
                            (const bf16*)w2, (const float*)b2, (const float*)gamma, \
                            (const float*)beta, (bf16*)out, M, F, eps, s)
#define GSTX_CALL32(NT) GSTX_CALL(NT, 32)
#define GSTX_CALL64(NT) GSTX_CALL(NT, 64)
  if (bm == 32) {
    switch (D / 128) { GSTX_NT_CASES(GSTX_CALL32) default: break; }
  } else if (bm == 64) {
    switch (D / 128) { GSTX_NT_CASES_6(GSTX_CALL64) default: break; }
  }
#undef GSTX_CALL64
#undef GSTX_CALL32
#undef GSTX_CALL
  return (int)cudaErrorInvalidValue;
}

const char* gstx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
