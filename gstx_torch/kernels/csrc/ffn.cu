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
// What bounds them on an H100: tensor-core operations.  At the encoder's
// shapes (M = B*S up to 24,576 rows, D = 768 or 1024, F = 3,072) a text-FFN
// call is 232 GFLOP against ~0.1 GB of compulsory traffic, far above the
// card's ~295 FLOP/byte balance point; dense_ln sits near it.  What the design
// does about it:
//   * bf16 WMMA 16x16x16 fragments with f32 accumulators, so every product
//     runs on the tensor cores;
//   * one CTA owns BM whole rows (the LayerNorm needs the full row), keeps
//     its [BM, D] accumulator in registers across the K (and F) loop, and
//     writes each output element once;
//   * the FFN loops over F in chunks of FC columns: the [BM, FC] hidden tile
//     goes registers -> shared memory (bias + erf GELU in f32, bf16 round)
//     -> the second product, so the [M, F] hidden never reaches device
//     memory;
//   * the x row block is staged once in shared memory (zero-filled past M,
//     rows padded by 8 elements against bank conflicts) and doubles as the
//     FFN residual.
// Weights are read as tensor-core fragments straight from global memory
// (L2-resident: at most 9.4 MB per call), once per CTA.  That L2 traffic
// (weights x M/BM), not the tensor cores, is the first limit of this simple
// form; wgmma + TMA + multicast of weight tiles across a cluster is the
// later fix.
//
// C interface (ctypes): every entry returns a cudaError_t as int, the
// launch's cudaGetLastError(); the caller raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32;      // rows per CTA: two 16-row tiles
constexpr int THREADS = BM / 16 * 256;  // 8 warps per row tile
constexpr int FC = 128;     // FFN hidden columns per chunk: one 16-col tile per warp column group
constexpr int XPAD = 8;     // bf16 elements of padding per staged x / h row
constexpr int YPAD = 4;     // f32 elements of padding per accumulator row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

// Copy rows [row0, row0 + BM) of a [M, K] bf16 matrix into shared memory
// (row stride K + XPAD), zero-filling rows at or past M.  16 bytes a thread.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           int row0, int M, int K) {
  const int vec_per_row = K / 8;
  for (int i = threadIdx.x; i < BM * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row;
    const int c = (i - r * vec_per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < M)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * K + c);
    *reinterpret_cast<uint4*>(dst + r * (K + XPAD) + c) = v;
  }
}

// LayerNorm epilogue over the f32 rows ys[BM][D + YPAD] (the product
// without bias): v = y + bias + residual, then two-pass mean / variance with
// warp reductions, one warp per row.  The residual is bf16, either in
// shared memory (stride res_ld) or in global memory.
template <int D>
__device__ __forceinline__ void layer_norm_rows(
    float* ys, const float* __restrict__ bias, const bf16* res, int res_ld,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    bf16* __restrict__ out, int row0, int M, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < BM; r += nwarps) {
    const int gr = row0 + r;
    if (gr >= M) break;  // rows ascend with r: the ragged tail is masked
    float* y = ys + r * (D + YPAD);
    const bf16* rr = res + (size_t)r * res_ld;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = y[c] + bias[c] + __bfloat162float(rr[c]);
      y[c] = v;
      s += v;
    }
    const float mean = warp_sum(s) * (1.0f / D);
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = y[c] - mean;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) * (1.0f / D) + eps);
    bf16* o = out + (size_t)gr * D;
    for (int c = lane; c < D; c += 32)
      o[c] = __float2bfloat16((y[c] - mean) * inv * gamma[c] + beta[c]);
  }
}

// Replaces _dense_ln_pallas (gstx/kernels/ffn.py:254).  Bound on the card:
// bytes at the text shape (24,576 x 768 -> 768), operations at the others;
// in this form the per-CTA weight reads from L2 bound it instead.
// BM rows per CTA, 8 warps per 16-row tile; warp w owns row tile w / 8 and
// the NT consecutive 16-column tiles starting at column (w % 8) * NT * 16,
// so D = NT * 128.
template <int NT>
__global__ void __launch_bounds__(THREADS)
dense_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ b, const bf16* __restrict__ res,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                bf16* __restrict__ out, int M, int K, float eps) {
  constexpr int D = NT * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                                 // [BM][K + XPAD]
  float* ys = reinterpret_cast<float*>(smem + (size_t)BM * (K + XPAD) * 2);  // [BM][D + YPAD]
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int rt = warp / 8;
  const int col0 = (warp % 8) * NT * 16;

  stage_rows(xs, x, row0, M, K);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[j], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
  const bf16* xa = xs + rt * 16 * (K + XPAD);
  for (int k = 0; k < K; k += 16) {
    wmma::load_matrix_sync(a, xa + k, K + XPAD);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // W is [D, K] row-major, i.e. W^T column-major with leading dim K
      wmma::load_matrix_sync(bw, w + (size_t)(col0 + j * 16) * K + k, K);
      wmma::mma_sync(acc[j], a, bw, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
    wmma::store_matrix_sync(ys + rt * 16 * (D + YPAD) + col0 + j * 16, acc[j],
                            D + YPAD, wmma::mem_row_major);
  __syncthreads();
  layer_norm_rows<D>(ys, b, res + (size_t)row0 * D, D, gamma, beta, out,
                     row0, M, eps);
}

// Replaces _ffn_pallas (gstx/kernels/ffn.py:198).  Bound on the card:
// operations (232 GFLOP at the text shape); in this form the per-CTA weight
// reads from L2 bound it instead.  Same warp layout as dense_ln_kernel; in
// each F chunk warp w also makes the hidden tile (row tile w / 8, columns
// f0 + (w % 8) * 16).
template <int NT>
__global__ void __launch_bounds__(THREADS)
ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ gamma,
           const float* __restrict__ beta, bf16* __restrict__ out, int M,
           int F, float eps) {
  constexpr int D = NT * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [BM][D + XPAD]
  unsigned char* tail = smem + (size_t)BM * (D + XPAD) * 2;
  // the loop's buffers and the epilogue's rows share one region
  bf16* hs = reinterpret_cast<bf16*>(tail);                                  // [BM][FC + XPAD]
  float* hscr = reinterpret_cast<float*>(tail + (size_t)BM * (FC + XPAD) * 2);  // [warps][256]
  float* ys = reinterpret_cast<float*>(tail);                                // [BM][D + YPAD]
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rt = warp / 8;
  const int cg = warp % 8;
  const int col0 = cg * NT * 16;

  stage_rows(xs, x, row0, M, D);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[j], 0.0f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> hc;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
  const bf16* xa = xs + rt * 16 * (D + XPAD);
  float* my_scr = hscr + warp * 256;

  for (int f0 = 0; f0 < F; f0 += FC) {
    // h tile (rows rt*16.., hidden cols f0 + cg*16..) = x @ W1^T, W1 is [F, D]
    const int fcol = f0 + cg * 16;
    wmma::fill_fragment(hc, 0.0f);
    for (int k = 0; k < D; k += 16) {
      wmma::load_matrix_sync(a, xa + k, D + XPAD);
      wmma::load_matrix_sync(bw, w1 + (size_t)fcol * D + k, D);
      wmma::mma_sync(hc, a, bw, hc);
    }
    wmma::store_matrix_sync(my_scr, hc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i / 16, c = i % 16;
      const float v = gelu_erf(my_scr[i] + b1[fcol + c]);
      hs[(rt * 16 + r) * (FC + XPAD) + cg * 16 + c] = __float2bfloat16(v);
    }
    __syncthreads();
    // acc += h[rows, 0..FC) @ W2^T[f0..f0+FC, cols], W2 is [D, F]
    const bf16* ha = hs + rt * 16 * (FC + XPAD);
#pragma unroll
    for (int kk = 0; kk < FC; kk += 16) {
      wmma::load_matrix_sync(a, ha + kk, FC + XPAD);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        wmma::load_matrix_sync(bw, w2 + (size_t)(col0 + j * 16) * F + f0 + kk, F);
        wmma::mma_sync(acc[j], a, bw, acc[j]);
      }
    }
    __syncthreads();  // hs is rewritten by the next chunk
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
    wmma::store_matrix_sync(ys + rt * 16 * (D + YPAD) + col0 + j * 16, acc[j],
                            D + YPAD, wmma::mem_row_major);
  __syncthreads();
  layer_norm_rows<D>(ys, b2, xs, D + XPAD, gamma, beta, out, row0, M, eps);
}

template <int NT>
cudaError_t launch_dense_ln(const bf16* x, const bf16* w, const float* b,
                            const bf16* res, const float* g, const float* be,
                            bf16* out, int M, int K, float eps, cudaStream_t s) {
  constexpr int D = NT * 128;
  const size_t smem = (size_t)BM * (K + XPAD) * 2 + (size_t)BM * (D + YPAD) * 4;
  cudaError_t e = cudaFuncSetAttribute(dense_ln_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dense_ln_kernel<NT><<<(M + BM - 1) / BM, THREADS, smem, s>>>(
      x, w, b, res, g, be, out, M, K, eps);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_ffn(const bf16* x, const bf16* w1, const float* b1,
                       const bf16* w2, const float* b2, const float* g,
                       const float* be, bf16* out, int M, int F, float eps,
                       cudaStream_t s) {
  constexpr int D = NT * 128;
  const size_t loop_bytes = (size_t)BM * (FC + XPAD) * 2 + (size_t)(THREADS / 32) * 256 * 4;
  const size_t epi_bytes = (size_t)BM * (D + YPAD) * 4;
  const size_t smem = (size_t)BM * (D + XPAD) * 2 +
                      (loop_bytes > epi_bytes ? loop_bytes : epi_bytes);
  cudaError_t e = cudaFuncSetAttribute(ffn_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  ffn_kernel<NT><<<(M + BM - 1) / BM, THREADS, smem, s>>>(
      x, w1, b1, w2, b2, g, be, out, M, F, eps);
  return cudaGetLastError();
}

}  // namespace

#define GSTX_NT_CASES(CALL) \
  case 1: return CALL(1);   \
  case 2: return CALL(2);   \
  case 3: return CALL(3);   \
  case 4: return CALL(4);   \
  case 5: return CALL(5);   \
  case 6: return CALL(6);   \
  case 7: return CALL(7);   \
  case 8: return CALL(8);

extern "C" {

// D = 128 * NT with NT in 1..8; K % 16 == 0.
int gstx_dense_ln(const void* x, const void* w, const void* b, const void* res,
                  const void* gamma, const void* beta, void* out, int M, int K,
                  int D, float eps, void* stream) {
  if (M <= 0 || K <= 0 || K % 16 != 0 || D % 128 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define GSTX_CALL(NT)                                                            \
  (int)launch_dense_ln<NT>((const bf16*)x, (const bf16*)w, (const float*)b,     \
                           (const bf16*)res, (const float*)gamma,                \
                           (const float*)beta, (bf16*)out, M, K, eps, s)
  switch (D / 128) { GSTX_NT_CASES(GSTX_CALL) default: break; }
#undef GSTX_CALL
  return (int)cudaErrorInvalidValue;
}

// D = 128 * NT with NT in 1..8; F % 128 == 0.
int gstx_ffn(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, const void* gamma, const void* beta, void* out,
             int M, int D, int F, float eps, void* stream) {
  if (M <= 0 || F <= 0 || F % FC != 0 || D % 128 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define GSTX_CALL(NT)                                                               \
  (int)launch_ffn<NT>((const bf16*)x, (const bf16*)w1, (const float*)b1,           \
                      (const bf16*)w2, (const float*)b2, (const float*)gamma,      \
                      (const float*)beta, (bf16*)out, M, F, eps, s)
  switch (D / 128) { GSTX_NT_CASES(GSTX_CALL) default: break; }
#undef GSTX_CALL
  return (int)cudaErrorInvalidValue;
}

const char* gstx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
