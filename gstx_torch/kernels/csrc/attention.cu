// Fused attention for Hopper (sm_90a): out = softmax(q k^T * scale + mask) v
// with each CTA's score rows kept in shared memory.
//
//   round_probs = 0: replaces gstx/kernels/attention.py::fused_attention
//     (pallas_call at line 118).  Q, K and V are widened to f32, the scores
//     and probabilities stay f32, the PV product runs in f32, the output is
//     rounded once to the input dtype.
//   round_probs = 1: replaces fused_attention_batch (pallas_call at line
//     200), the same function with the probabilities rounded to V's dtype
//     before PV.  Its Q.K^T in the input dtype with f32 accumulation is the
//     same number as the f32 product here: products of bf16 values are exact
//     in f32.  The TPU kernel's all-heads-per-step grid is a VMEM/grid-step
//     choice; here it is one more instance of the same kernel.
// The softmax is jax.nn.softmax's: subtract the row max, expf, divide by the
// row sum.  The additive mask is [B, 1|H, 1|Lq, Lk] f32; broadcast over heads
// or query rows is a zero stride.  There is no special case for a fully
// masked row: with the -10000 additive mask it is an ordinary row.
//
// What bounds it on an H100: bytes.  At the encoder's shapes (B=96, text self
// [96,12,256,256,64]: 151 MB of Q/K/V/O against 19 GFLOP, 45 us vs 19.5 us)
// attention at these short lengths sits below the card's ~295 FLOP/byte
// balance point.  What the design does about it:
//   * one CTA owns one (batch, head, 32-row query tile); every Q, K, V and
//     output element crosses device memory once per CTA, and the [Lq, Lk]
//     scores and probabilities never leave shared memory (32 x 580 f32 at the
//     model's largest Lk of 549);
//   * K, then V, stream through one shared-memory tile of 64 rows, widened to
//     f32 on the way in, read as 16-byte vectors (rows padded by 4 floats so
//     a quarter-warp's vector loads hit distinct banks);
//   * Q, K and V are read through their strides (the last dimension
//     contiguous), so the heads-split views of the projections need no copy,
//     and the output is written through strides too.
// In this simple form the f32 FMA pipe fed from shared memory bounds it, not
// the bytes: both products are CUDA-core FMAs (8 score rows or 2-4 output rows
// per thread, 16-byte broadcast loads of Q and P).  bf16 mma for Q.K^T would
// be exact in its products, but the f32 probabilities of round_probs = 0 rule
// out a bf16 mma for PV; wgmma + TMA wait for a later change.
//
// C interface (ctypes): the entry returns a cudaError_t as int, the launch's
// cudaGetLastError(); the caller raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int QT = 32;        // query rows per CTA
constexpr int KT = 64;        // keys per streamed K / V tile
constexpr int THREADS = 256;  // 8 warps
constexpr int PAD = 4;        // f32 elements of padding per Q / K / V row
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
  int lq, lk, ld_s;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  // bf16 -> f32 is the 16 high bits; element 0 is the low half (little endian)
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

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

// rows [row0, row0 + nrows) of one (batch, head) slice -> f32 shared memory
// (row stride DH + PAD), zero-filled past `valid` rows
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long ld,
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

template <typename T, int DH, bool ROUND_P>
__global__ void __launch_bounds__(THREADS) attention_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [QT][DH + PAD]
  float* kv = qs + QT * (DH + PAD);        // [KT][DH + PAD], K tiles then V tiles
  float* ss = kv + KT * (DH + PAD);        // [QT][ld_s] scores, then probabilities
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks.b + h * p.ks.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.vs.b + h * p.vs.h;

  stage_rows<T, DH>(qs, qg, p.qs.l, q0, QT, p.lq);

  // scores: thread -> key j of the tile and rows rg, rg + 4, ..., rg + 28; a
  // warp shares its rows, so the Q loads are broadcasts
  {
    const int j = tid % KT, rg = tid / KT;
    constexpr int RPT = QT / (THREADS / KT);
    const float* mrow = p.mask ? p.mask + b * p.ms.b + h * p.ms.h : nullptr;
    for (int j0 = 0; j0 < p.lk; j0 += KT) {
      __syncthreads();  // Q staged / the previous tile consumed
      stage_rows<T, DH>(kv, kg, p.ks.l, j0, KT, p.lk);
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
      for (int j = lane; j < p.lk; j += 32) {
        float pr = row[j] / sum;
        if (ROUND_P) pr = __bfloat162float(__float2bfloat16(pr));
        row[j] = pr;
      }
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
    stage_rows<T, DH>(kv, vg, p.vs.l, j0, KT, p.lk);
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
  T* og = static_cast<T*>(p.out) + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i * RSTEP;
    if (r < QT && q0 + r < p.lq) store4(og + (long long)(q0 + r) * p.os.l + c4, acc[i]);
  }
}

int ld_scores(int lk) { return (lk + 31) / 32 * 32 + PAD; }

size_t smem_bytes(int dh, int lk) {
  return (size_t)((QT + KT) * (dh + PAD) + QT * ld_scores(lk)) * sizeof(float);
}

template <typename T, int DH, bool ROUND_P>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t s) {
  const size_t smem = smem_bytes(DH, p.lk);
  cudaError_t e = cudaFuncSetAttribute(attention_kernel<T, DH, ROUND_P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.lq + QT - 1) / QT, heads, batch);
  attention_kernel<T, DH, ROUND_P><<<grid, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, bool ROUND_P>
cudaError_t dispatch_dh(const Params& p, int batch, int heads, int dh, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16, ROUND_P>(p, batch, heads, s);
    case 32: return launch<T, 32, ROUND_P>(p, batch, heads, s);
    case 64: return launch<T, 64, ROUND_P>(p, batch, heads, s);
    case 128: return launch<T, 128, ROUND_P>(p, batch, heads, s);
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
// probabilities to the dtype before PV (fused_attention_batch).
int gstx_attention(const void* q, const void* k, const void* v, const void* mask,
                   void* out, int batch, int heads, int lq, int lk, int dh,
                   const long long* strides, float scale, int dtype,
                   int round_probs, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || heads > 65535 ||
      batch > 65535 || smem_bytes(dh, lk) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const float*>(mask);
  p.out = out;
  Strides* st[5] = {&p.qs, &p.ks, &p.vs, &p.ms, &p.os};
  for (int i = 0; i < 5; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.lq = lq;
  p.lk = lk;
  p.ld_s = ld_scores(lk);
  p.scale = scale;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)(round_probs ? dispatch_dh<bf16, true>(p, batch, heads, dh, s)
                             : dispatch_dh<bf16, false>(p, batch, heads, dh, s));
  // f32 V: rounding the probabilities to V's dtype changes nothing
  if (dtype == 0) return (int)dispatch_dh<float, false>(p, batch, heads, dh, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
