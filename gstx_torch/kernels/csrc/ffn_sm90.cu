// fused_ffn at an output width of 768 on Hopper (sm_90a), bf16 in / bf16 out:
//
//   gstx_ffn_sm90: out = LayerNorm(x + gelu(x @ W1^T + b1) @ W2^T + b2)
//
// The same function as ffn.cu's ffn_kernel, which replaces
// gstx/kernels/ffn.py::_ffn_pallas (line 198), and the same numerics: f32
// accumulation, f32 bias / residual / erf GELU / LayerNorm (two-pass mean
// and variance, eps inside the rsqrt), the hidden rounded to bf16 before
// the second product (ffn.py:224), the output rounded to bf16 once.  Only
// the order in which the products are summed differs.  kernels/ffn.py
// (takes_wgmma) sends it every D = 768 call: it was faster than ffn_kernel at
// each D = 768 shape timed, 64 to 128,000 rows.  D = 1,024 keeps ffn_kernel
// (a [64, 1,024] f32 accumulator does not fit two warpgroups' registers).
//
// What bounds it on an H100: operations (a text call is 4 M D F FLOPs, 232
// GFLOP at 24,576 rows, against ~0.1 GB of compulsory traffic).  What held
// ffn_kernel at about a sixth of that bound was the weights' stream: every
// 64-row CTA reads all 9.4 MB of W1 and W2 from L2 (0.83 ms of ring alone at
// 24,576 rows), and its mma.sync math (0.87 ms) overlapped that only in part,
// all 16 warps in one phase between barriers.  This design:
//   * a CTA owns BM = 64 output rows x all 768 columns, so the LayerNorm
//     closes inside it and every output element is written once.  The x
//     block [64, 768] is staged once by TMA (rows past M zero-filled): the
//     first product's A operand and the residual;
//   * warp specialisation, 384 threads: warpgroups 0 and 1 are the
//     consumers and run wgmma with both operands in shared memory (no
//     ldmatrix, no CTA-wide barrier in the main loop); warpgroup 2 is the
//     producer, one thread of which keeps TMA loads of weight tiles in flight
//     through a ring of STAGES stages guarded by full / empty mbarriers;
//   * the register budget decides the split: consumer warpgroup w holds the
//     output columns [384 w, 384 w + 384) as six m64n64 f32 accumulators
//     (192 registers a thread) and its half of the hidden chunk, m64n32 (16
//     more); setmaxnreg gives the consumers 240 registers and the producer
//     24.  With FC = 128 (an m64n64 half, 32 registers) ptxas spilled and
//     serialised the wgmma;
//   * F is walked in chunks of FC = 64 hidden columns.  Consumer w makes
//     hidden columns [32 w, 32 w + 32) of the chunk (GEMM1 over D), adds b1,
//     applies the erf GELU in f32, rounds to bf16 and writes them into one
//     of two hidden buffers in shared memory, in the 128-byte swizzle that
//     wgmma reads; a named barrier over the 256 consumer threads publishes
//     the chunk, and in the next step both consumers read it whole as A of
//     GEMM2 (over the chunk), accumulating over F in chunk order.  The step
//     for chunk c issues GEMM1(c) and then GEMM2(c - 1), so the two
//     products share one walk of the ring, and chunk c's GELU runs behind
//     the first three stages of GEMM2(c - 1) while they are in flight;
//   * a ring stage is two 64 x 64 TMA boxes (16 KB), both consumers of
//     which wait on its full barrier and release it.  Per chunk: 6 stages of
//     W1 (rows [64 c, +64), columns [128 k, +128): consumer w reads rows
//     [32 w, +32) of both boxes), then 6 of W2 (box w: rows
//     [384 w + 64 j, +64), columns [64 c, +64));
//   * not done: a 2-CTA cluster reading each weight tile once by TMA
//     multicast (half the L2 traffic) was no faster on the card (24,576 rows:
//     0.6126 ms against 0.6101; 128,000: 3.173 against 3.138), so every CTA
//     loads its own tiles: the shared-memory traffic of the operands' reads
//     and the ring's writes, not L2, holds it at about 40% of its bound.
//
// C interface (ctypes): the entry returns a cudaError_t as int; the caller
// raises on non-zero (gstx_error_string, in ffn.cu, names it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "sm90_mma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 768;                         // output width
constexpr int BM = 64;                         // rows per CTA: one wgmma row block
constexpr int FC = 64;                         // hidden columns per F chunk
constexpr int BOX = 64;                        // a TMA box: 64 rows x 64 bf16 (128 B rows)
constexpr int BOX_BYTES = BOX * BOX * 2;       // 8 KB
constexpr int KSLABS = D / BOX;                // 12 boxes of the x block
constexpr int NTILES = D / 2 / BOX;            // 6 m64n64 output tiles a consumer
constexpr int HCOLS = FC / 2;                  // hidden columns a consumer makes: m64n32
constexpr int STAGES = 7;                      // ring stages
constexpr int STAGE_BYTES = 2 * BOX_BYTES;     // two boxes
constexpr int W1_STAGES = KSLABS / 2;          // 6 a chunk, two 64-column slabs each
constexpr int THREADS = 384;                   // 2 consumer warpgroups, then the producer
constexpr int CONSUMER_THREADS = 256;
constexpr int X_BYTES = KSLABS * BOX_BYTES;    // the x block [64][768]
constexpr int H_BYTES = BOX_BYTES;             // a hidden buffer [64][64]
constexpr int H_OFF = X_BYTES;                 // two hidden buffers
constexpr int RING_OFF = H_OFF + 2 * H_BYTES;
constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;  // full[STAGES], empty[STAGES], x
constexpr int SMEM_BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment to 1 KB
static_assert(SMEM_BYTES <= 232448, "shared memory");
static_assert(2 * 2 * BM * sizeof(float) <= H_BYTES, "the LayerNorm's partial sums fit a hidden buffer");

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, wgmma

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// a 2-D box {c0 (column), c1 (row)} into this CTA's shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The low word of a shared-memory matrix descriptor for a K-major operand in
// the 128-byte swizzle that TMA writes: the start address / 16 and the
// leading offset, unused (1).  The high word (wgmma_64x64) holds the 8-row
// groups' stride, 1,024 bytes (64), and the swizzle (1 << 30).  A k16 step
// inside the 128-byte row advances the start address by 32 bytes (2).
__device__ __forceinline__ uint32_t sw128_desc(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (1u << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A B^T: A [64 x 16] and B [64 x 16], both K-major in shared memory
// (the low words of their sw128_desc descriptors; the high word is the same
// for all); d the m64n64 f32 fragment (row 16 warp + lane / 4 (+ 8),
// columns 8 i + 2 (lane % 4) (+ 1) at d[4 i ..]); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint32_t da, uint32_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 hi;\n"
      ".reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "mov.b32 hi, 0x40000040;\n"
      "mov.b64 da, {%32, hi};\n"
      "mov.b64 db, {%33, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(da), "r"(db), "r"(scale_d));
}

// the same with B [32 x 16]: d the m64n32 fragment
__device__ __forceinline__ void wgmma_64x32(float (&d)[16], uint32_t da, uint32_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 hi;\n"
      ".reg .b64 da, db;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "mov.b32 hi, 0x40000040;\n"
      "mov.b64 da, {%16, hi};\n"
      "mov.b64 db, {%17, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "da, db, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(da), "r"(db), "r"(scale_d));
}

// the 4 k16 steps over a 64-column box: A at `a` (64 rows), B at `b` (64
// rows for d[32], 32 for d[16]); scale 0 on the first if `overwrite`
__device__ __forceinline__ void wgmma_box(float (&d)[32], uint32_t a, uint32_t b, bool overwrite) {
#pragma unroll
  for (int kk = 0; kk < BOX / 16; ++kk)
    wgmma_64x64(d, sw128_desc(a) + 2 * kk, sw128_desc(b) + 2 * kk, overwrite && kk == 0 ? 0 : 1);
}

__device__ __forceinline__ void wgmma_box(float (&d)[16], uint32_t a, uint32_t b, bool overwrite) {
#pragma unroll
  for (int kk = 0; kk < BOX / 16; ++kk)
    wgmma_64x32(d, sw128_desc(a) + 2 * kk, sw128_desc(b) + 2 * kk, overwrite && kk == 0 ? 0 : 1);
}

// the registers are written here: no read of them moves above a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
}

// byte offset of element (r, 2 p) of a 64 x 64 bf16 box in the 128-byte
// swizzle: the 16-byte chunk p / 4 of row r lies at chunk (p / 4) ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int r, int chunk, int q) {
  return r * 128 + ((chunk ^ (r & 7)) << 4) + (q << 2);
}

// ---------------------------------------------------------------------------
// the kernel

// Consumer w's half of hidden chunk c (h, its GEMM1 fragment, complete): +
// b1, erf GELU in f32, bf16, into 16-byte chunks [4 w, 4 w + 4) of the rows
// of buffer c % 2, in the 128-byte swizzle.  That buffer was last read by
// GEMM2(c - 2), which both consumers finished before the barrier of chunk
// c - 1.  The generic-proxy stores are fenced for wgmma (the async proxy);
// the caller's barrier then publishes them to both consumers.
__device__ __forceinline__ void hidden_out(float (&h)[HCOLS / 2], uint32_t hs,
                                           const float* __restrict__ b1, int c, int w) {
  fence_regs(h);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + g;
  const uint32_t hb = hs + (c & 1) * H_BYTES;
  const float* bias = b1 + c * FC + w * HCOLS + 2 * q;
#pragma unroll
  for (int i = 0; i < HCOLS / 8; ++i) {
    const float bx = __ldg(bias + 8 * i), by = __ldg(bias + 8 * i + 1);
    st_shared(hb + swz(r, 4 * w + i, q),
              pack_bf16(gelu_erf(h[4 * i] + bx), gelu_erf(h[4 * i + 1] + by)));
    st_shared(hb + swz(r + 8, 4 * w + i, q),
              pack_bf16(gelu_erf(h[4 * i + 2] + bx), gelu_erf(h[4 * i + 3] + by)));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The ring's stage `t`: its slot, and the parity of its round
__device__ __forceinline__ uint32_t slot_of(int t) { return t % STAGES; }
__device__ __forceinline__ uint32_t round_parity(int t) { return (t / STAGES) & 1; }

// Producer: stage `t` of the walk, the boxes {c0, r0} and {c0 + cstep,
// r0 + rstep} of `map`, once the consumers have released the slot's
// previous round
__device__ __forceinline__ void produce(int t, uint32_t ring, uint32_t full, uint32_t empty,
                                        const CUtensorMap* map, int c0, int r0, int cstep,
                                        int rstep) {
  const uint32_t s = slot_of(t);
  if (t >= STAGES) mbar_wait(empty + 8 * s, round_parity(t - STAGES));
  mbar_expect_tx(full + 8 * s, STAGE_BYTES);
  const uint32_t dst = ring + s * STAGE_BYTES;
  tma_load(dst, map, full + 8 * s, c0, r0);
  tma_load(dst + BOX_BYTES, map, full + 8 * s, c0 + cstep, r0 + rstep);
}

// Consumer: release slot `s` (its products are done), once a warpgroup
__device__ __forceinline__ void release(uint32_t empty, uint32_t s) {
  if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * s);
}

// Replaces ffn_kernel at D = 768 (see the note above).
__global__ void __launch_bounds__(THREADS, 1)
ffn_kernel_sm90(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_w1,
                __grid_constant__ const CUtensorMap tm_w2, const float* __restrict__ b1,
                const float* __restrict__ b2, const float* __restrict__ gamma,
                const float* __restrict__ beta, bf16* __restrict__ out, int M, int F, float eps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1 KB
  const uint32_t xs = base, hs = base + H_OFF, ring = base + RING_OFF;
  const uint32_t full = base + BAR_OFF, empty = full + 8 * STAGES, xfull = empty + 8 * STAGES;
  const int nchunks = F / FC;
  const int row0 = blockIdx.x * BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // both consumers
    }
    mbar_init(xfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- the producer: one thread walks the stages in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMER_THREADS) {
      mbar_expect_tx(xfull, X_BYTES);
      for (int k = 0; k < KSLABS; ++k) tma_load(xs + k * BOX_BYTES, &tm_x, xfull, k * BOX, row0);
      int t = 0;
      for (int c = 0; c <= nchunks; ++c) {
        if (c < nchunks)
          for (int k = 0; k < W1_STAGES; ++k, ++t)
            produce(t, ring, full, empty, &tm_w1, 2 * k * BOX, c * FC, BOX, 0);
        if (c > 0)
          for (int j = 0; j < NTILES; ++j, ++t)
            produce(t, ring, full, empty, &tm_w2, (c - 1) * FC, j * BOX, 0, D / 2);
      }
    }
  } else {
    // ---- the consumers: warpgroup w owns output columns [384 w, 384 w + 384)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = threadIdx.x / 128;
    float acc[NTILES][32];
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    float h[HCOLS / 2];
    mbar_wait(xfull, 0);

    int t = 0;
    for (int c = 0; c <= nchunks; ++c) {
      int pending = -1;  // the GEMM1 slot whose products may still run
      if (c < nchunks) {
        // GEMM1(c): hidden columns [32 w, +32) of chunk c over D, two
        // 64-column slabs a stage
#pragma unroll 1
        for (int k = 0; k < W1_STAGES; ++k, ++t) {
          const uint32_t s = slot_of(t);
          const uint32_t b = ring + s * STAGE_BYTES + w * (HCOLS * 128);
          mbar_wait(full + 8 * s, round_parity(t));
          wgmma_fence();
          wgmma_box(h, xs + 2 * k * BOX_BYTES, b, k == 0);
          wgmma_box(h, xs + (2 * k + 1) * BOX_BYTES, b + BOX_BYTES, false);
          wgmma_commit();
          wgmma_wait<1>();
          if (pending >= 0) release(empty, pending);
          pending = s;
        }
      }
      if (c == 0) {
        wgmma_wait<0>();
        release(empty, pending);
        hidden_out(h, hs, b1, 0, w);
        consumer_sync();
        continue;
      }
      // GEMM2(c - 1): the whole hidden chunk c - 1 into this warpgroup's
      // output columns, up to three stages in flight.  Behind the first
      // three, GEMM1(c) is done: its hidden goes out while they run.
      const uint32_t hb = hs + ((c - 1) & 1) * H_BYTES;
      uint32_t held[3];  // the slots of the GEMM2 stages in flight
#pragma unroll
      for (int j = 0; j < NTILES; ++j, ++t) {
        const uint32_t s = slot_of(t);
        mbar_wait(full + 8 * s, round_parity(t));
        wgmma_fence();
        wgmma_box(acc[j], hb, ring + s * STAGE_BYTES + w * BOX_BYTES, false);
        wgmma_commit();
        if (j == 2) {
          wgmma_wait<3>();
          if (pending >= 0) release(empty, pending);
          if (c < nchunks) hidden_out(h, hs, b1, c, w);
        } else if (j > 2) {
          wgmma_wait<3>();
          release(empty, held[j - 3]);
        }
        held[j % 3] = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 3; ++i) release(empty, held[i]);
      if (c == nchunks) break;
      // both halves of hidden chunk c are out; GEMM2(c - 1), the last reader
      // of the other buffer, is done in both consumers
      consumer_sync();
    }

    // ---- epilogue: v = acc + b2 + x, LayerNorm over the row's 768 columns
#pragma unroll
    for (int j = 0; j < NTILES; ++j) fence_regs(acc[j]);
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int r = 16 * ((threadIdx.x >> 5) & 3) + g;  // and r + 8
    // [pass][consumer][row] partial sums, in the hidden buffer no product reads
    const uint32_t part = hs + (nchunks & 1) * H_BYTES;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      const uint32_t xb = xs + (6 * w + j) * BOX_BYTES;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 384 * w + 64 * j + 8 * i + 2 * q;
        const float bx = __ldg(b2 + col), by = __ldg(b2 + col + 1);
        const uint32_t x0 = ld_shared_u32(xb + swz(r, i, q));
        const uint32_t x1 = ld_shared_u32(xb + swz(r + 8, i, q));
        const __nv_bfloat162 v0 = *reinterpret_cast<const __nv_bfloat162*>(&x0);
        const __nv_bfloat162 v1 = *reinterpret_cast<const __nv_bfloat162*>(&x1);
        acc[j][4 * i] += bx + __low2float(v0);
        acc[j][4 * i + 1] += by + __high2float(v0);
        acc[j][4 * i + 2] += bx + __low2float(v1);
        acc[j][4 * i + 3] += by + __high2float(v1);
        s0 += acc[j][4 * i] + acc[j][4 * i + 1];
        s1 += acc[j][4 * i + 2] + acc[j][4 * i + 3];
      }
    }
    float mean0 = 0.f, mean1 = 0.f, inv0 = 0.f, inv1 = 0.f;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      // the quad's sum, then the two consumers' through shared memory
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      const uint32_t pp = part + pass * 2 * BM * 4;
      if (q == 0) {
        st_shared(pp + (w * BM + r) * 4, __float_as_uint(s0));
        st_shared(pp + (w * BM + r + 8) * 4, __float_as_uint(s1));
      }
      consumer_sync();
      const float t0 = ld_shared_f32(pp + r * 4) + ld_shared_f32(pp + (BM + r) * 4);
      const float t1 = ld_shared_f32(pp + (r + 8) * 4) + ld_shared_f32(pp + (BM + r + 8) * 4);
      if (pass == 0) {
        mean0 = t0 * (1.0f / D);
        mean1 = t1 * (1.0f / D);
        s0 = s1 = 0.f;
#pragma unroll
        for (int j = 0; j < NTILES; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float d0 = acc[j][4 * i] - mean0, d1 = acc[j][4 * i + 1] - mean0;
            const float d2 = acc[j][4 * i + 2] - mean1, d3 = acc[j][4 * i + 3] - mean1;
            s0 += d0 * d0 + d1 * d1;
            s1 += d2 * d2 + d3 * d3;
          }
      } else {
        inv0 = rsqrtf(t0 * (1.0f / D) + eps);
        inv1 = rsqrtf(t1 * (1.0f / D) + eps);
      }
    }
    // * gamma + beta, bf16 stores of rows below M
    const bool in0 = row0 + r < M, in1 = row0 + r + 8 < M;
    bf16* o0 = out + (size_t)(row0 + r) * D;
    bf16* o1 = o0 + 8 * D;
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 384 * w + 64 * j + 8 * i + 2 * q;
        const float gx = __ldg(gamma + col), gy = __ldg(gamma + col + 1);
        const float bx = __ldg(beta + col), by = __ldg(beta + col + 1);
        if (in0)
          *reinterpret_cast<uint32_t*>(o0 + col) =
              pack_bf16((acc[j][4 * i] - mean0) * inv0 * gx + bx,
                        (acc[j][4 * i + 1] - mean0) * inv0 * gy + by);
        if (in1)
          *reinterpret_cast<uint32_t*>(o1 + col) =
              pack_bf16((acc[j][4 * i + 2] - mean1) * inv1 * gx + bx,
                        (acc[j][4 * i + 3] - mean1) * inv1 * gy + by);
      }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps through the driver's entry point (no -lcuda)

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major bf16 [rows][cols] tensor read in 64 x 64 boxes, 128-byte
// swizzled; boxes past its edge are zero-filled
bool box_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {BOX, BOX};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_ffn_sm90(const CUtensorMap& tx, const CUtensorMap& t1, const CUtensorMap& t2,
                            const float* b1, const float* b2, const float* g, const float* be,
                            bf16* out, int M, int F, float eps, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      ffn_kernel_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  ffn_kernel_sm90<<<(M + BM - 1) / BM, THREADS, SMEM_BYTES, s>>>(tx, t1, t2, b1, b2, g, be, out,
                                                                 M, F, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// D = 768 only; F % 64 == 0.  x, w1, w2 16-byte aligned.
int gstx_ffn_sm90(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                  const void* gamma, const void* beta, void* out, int M, int d, int F, float eps,
                  void* stream) {
  if (M <= 0 || d != D || F <= 0 || F % FC != 0) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w2) % 16) != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, t1, t2;
  if (!box_map(&tx, x, M, D) || !box_map(&t1, w1, F, D) || !box_map(&t2, w2, D, F))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)launch_ffn_sm90(tx, t1, t2, (const float*)b1, (const float*)b2, (const float*)gamma,
                              (const float*)beta, (bf16*)out, M, F, eps, s);
}

}  // extern "C"
