// One-token decode cross-attention over int8 memory for Hopper (sm_90a):
//   out[b, h, 0, :] = softmax(q[b, h, 0, :] . K_i8[b, h]^T + mask[b]) . V_i8[b, h]
// with f32 scores, softmax and output.  The K scale and 1/sqrt(dh) are folded
// into q beforehand and the caller applies the V scale, so the kernel sees
// plain int8 operands.
//
// Replaces gstx/kernels/decode_attn.py::quant_decode_attention (pallas_call
// at line 79).  It computes what that kernel computes: widen to f32, the
// scores as a multiply-reduce over dh, + mask, max-subtract, expf, divide by
// the sum, then the probability-weighted sum of the V rows.
//
// What bounds it on an H100: bytes.  Each call reads the whole int8 memory of
// one decoder layer, 2 x B x H x M x dh bytes (43.2 MB at B=96, H=12, M=293,
// dh=64: 12.9 us at 3.35 TB/s), for 4 FLOPs per int8 element.  The TPU kernel
// exists to make K/V cross device memory at int8 width every step, and so
// does this one:
//   * one CTA (4 warps) per (batch row, head); q (dh values) in registers;
//   * K and V rows stream from device memory as 16-byte vectors of int8, dh/16
//     lanes per row, so a warp reads 512 contiguous bytes per load; they are
//     widened to f32 in registers only, and no bf16 copy of the memory ever
//     exists;
//   * the M scores live in shared memory (f32, M <= 549 at the model's widths);
//     the softmax uses warp shuffles and a 4-way block reduction;
//   * the PV sums go per lane over its 16 channels, then across the lanes and
//     warps that share those channels.
// Ragged B and M need nothing special: the grid is B x H and every loop over
// M runs whole warp-uniform iterations with the tail lanes idle.
//
// C interface (ctypes): the entry returns a cudaError_t as int, the launch's
// cudaGetLastError(); the caller raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 232448;  // opt-in dynamic shared memory per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// 16 int8 -> f32, element 0 from the lowest byte (little endian)
__device__ __forceinline__ void widen16(const int8_t* src, float* dst) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      // byte j to the top, then an arithmetic shift sign-extends it
      dst[4 * i + j] = (float)((int)((unsigned)w[i] << (24 - 8 * j)) >> 24);
}

template <typename QT, typename MT, int DH>
__global__ void __launch_bounds__(THREADS)
quant_decode_kernel(const QT* __restrict__ q, const int8_t* __restrict__ k,
                    const int8_t* __restrict__ v, const MT* __restrict__ mask,
                    long long mask_sb, float* __restrict__ out, int heads, int m) {
  constexpr int LPK = DH / 16;   // lanes per K / V row, 16 int8 each
  constexpr int KPW = 32 / LPK;  // rows per warp and iteration
  extern __shared__ float s[];   // [m] scores, then probabilities
  __shared__ float red[WARPS];
  __shared__ float part[WARPS][DH];
  const int bh = blockIdx.x, b = bh / heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row_off = lane / LPK, chunk = lane % LPK;
  const size_t base = (size_t)bh * m * DH + chunk * 16;
  const MT* mrow = mask ? mask + b * mask_sb : nullptr;

  float qv[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) qv[c] = to_f32(q[(size_t)bh * DH + chunk * 16 + c]);

  // scores; `r0` is warp-uniform, so the shuffles see every lane
  for (int r0 = warp * KPW; r0 < m; r0 += WARPS * KPW) {
    const int j = r0 + row_off;
    float dot = 0.f;
    if (j < m) {
      float kf[16];
      widen16(k + base + (size_t)j * DH, kf);
#pragma unroll
      for (int c = 0; c < 16; ++c) dot = fmaf(qv[c], kf[c], dot);
    }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (chunk == 0 && j < m) s[j] = mrow ? dot + to_f32(mrow[j]) : dot;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int j = tid; j < m; j += THREADS) mx = fmaxf(mx, s[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();  // red is reused below
  float sum = 0.f;
  for (int j = tid; j < m; j += THREADS) {
    const float e = expf(s[j] - mx);
    s[j] = e;
    sum += e;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) sum += red[w];
  for (int j = tid; j < m; j += THREADS) s[j] = s[j] / sum;
  __syncthreads();

  float acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0.f;
  for (int r0 = warp * KPW; r0 < m; r0 += WARPS * KPW) {
    const int j = r0 + row_off;
    if (j < m) {
      float vf[16];
      widen16(v + base + (size_t)j * DH, vf);
      const float pr = s[j];
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] = fmaf(pr, vf[c], acc[c]);
    }
  }
  // lanes l and l ^ (LPK << i) hold the same 16 channels
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int o = 16; o >= LPK; o >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
  if (row_off == 0) {
#pragma unroll
    for (int c = 0; c < 16; ++c) part[warp][chunk * 16 + c] = acc[c];
  }
  __syncthreads();
  for (int d = tid; d < DH; d += THREADS) {
    float o = part[0][d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) o += part[w][d];
    out[(size_t)bh * DH + d] = o;
  }
}

template <typename QT, typename MT, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   long long mask_sb, void* out, int batch, int heads, int m,
                   cudaStream_t s) {
  const size_t smem = (size_t)m * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(quant_decode_kernel<QT, MT, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  quant_decode_kernel<QT, MT, DH><<<batch * heads, THREADS, smem, s>>>(
      static_cast<const QT*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const MT*>(mask), mask_sb,
      static_cast<float*>(out), heads, m);
  return cudaGetLastError();
}

template <typename QT, typename MT>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* mask,
                        long long mask_sb, void* out, int batch, int heads, int m,
                        int dh, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<QT, MT, 16>(q, k, v, mask, mask_sb, out, batch, heads, m, s);
    case 32: return launch<QT, MT, 32>(q, k, v, mask, mask_sb, out, batch, heads, m, s);
    case 64: return launch<QT, MT, 64>(q, k, v, mask, mask_sb, out, batch, heads, m, s);
    case 128: return launch<QT, MT, 128>(q, k, v, mask, mask_sb, out, batch, heads, m, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, 1, dh] contiguous (q_dtype 0 f32, 1 bf16); k and v [B, H, M, dh]
// int8 contiguous, 16-byte aligned; mask [B or 1, 1, 1, M] contiguous
// (mask_dtype 0 f32, 1 bf16; mask_sb its batch stride, 0 to broadcast) or
// null; out [B, H, 1, dh] f32.  dh in {16, 32, 64, 128}.
int gstx_quant_decode_attention(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int batch, int heads,
                                int m, int dh, long long mask_sb, int q_dtype,
                                int mask_dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || m <= 0 ||
      (long long)batch * heads > 0x7fffffffLL ||
      (size_t)m * sizeof(float) > (size_t)SMEM_LIMIT - 4096)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define GSTX_CALL(QT, MT) \
  dispatch_dh<QT, MT>(q, k, v, mask, mask_sb, out, batch, heads, m, dh, s)
  if (q_dtype == 0 && mask_dtype == 0) return (int)GSTX_CALL(float, float);
  if (q_dtype == 0 && mask_dtype == 1) return (int)GSTX_CALL(float, bf16);
  if (q_dtype == 1 && mask_dtype == 0) return (int)GSTX_CALL(bf16, float);
  if (q_dtype == 1 && mask_dtype == 1) return (int)GSTX_CALL(bf16, bf16);
#undef GSTX_CALL
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
