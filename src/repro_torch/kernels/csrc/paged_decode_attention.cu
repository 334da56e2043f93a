// Paged GQA decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `paged_gqa_decode_attention` in
// src/repro/kernels/paged_decode_attention.py (Pallas body `_paged_kernel`):
// one query token per request attends over the request's KV, which lives in
// physical pool blocks named by a block table, with an f32 online softmax and
// scale hd**-0.5. The G = H/K query heads of one KV head share each K/V tile.
// Blocks at or past a row's length are skipped; a length-0 row gives zeros.
//
// What bounds it on this card: the KV bytes. Every valid token's K and V rows
// are read once (2 * K * hd * itemsize bytes per token per layer) and each is
// used for G multiply-adds per element, so the arithmetic intensity is about
// G/itemsize FLOP per byte, far below the H100's ~295 FLOP/byte ridge. The
// least time is (KV bytes read) / 3.35 TB/s.
//
// What this simple design does about it: it reads only the blocks the row
// needs (the loop stops at min(ceil(length/BS), nb), where the TPU grid walks
// all nb), reads each K/V element exactly once per (request, KV head), and
// shares it across the G query heads from shared memory. It does not yet
// split long contexts across blocks (split-K), vectorise its loads, or
// overlap loads with compute (cp.async/TMA); those are later work.
//
// Layouts (all contiguous): q/out [B, H, hd]; k_pool/v_pool [NB, BS, K, hd];
// table [B, nb] int32; lengths [B] int32. Grid (B, K), 128 threads a block.
// The caller guarantees every table entry a row reads (the first
// min(ceil(length/BS), nb)) is a valid physical block id.

#include <cfloat>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;       // tokens per shared-memory tile (one warp)
constexpr int kMaxAcc = 16;     // accumulator registers a thread: G*hd <= 2048
// The reference's finite mask value: exp(s - m) on a fully masked score row
// stays finite (exp(0) = 1), where -INFINITY would give exp(-inf + inf) = NaN.
constexpr float kNegInf = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int K, int G, int hd, int BS, int nb, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ks_stride = hd + 1;        // padded: conflict-free score reads
  float* q_s = smem;                   // [G][hd]
  float* k_s = q_s + G * hd;           // [kTile][hd + 1]
  float* v_s = k_s + kTile * ks_stride;  // [kTile][hd]
  float* p_s = v_s + kTile * hd;       // [G][kTile] scores, then weights
  float* m_s = p_s + G * kTile;        // [G] running max
  float* l_s = m_s + G;                // [G] running denominator
  float* a_s = l_s + G;                // [G] this tile's rescale factor

  const size_t head0 = ((size_t)b * K * G + (size_t)kh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = to_f32(q[head0 + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;

  const int length = max(lengths[b], 0);
  // bounded by the table width as well as the length: a row never reads a
  // table entry past nb, whatever its length says
  const int n_blocks = min((length + BS - 1) / BS, nb);
  const size_t tok_stride = (size_t)K * hd;
  const int* tbl = table + (size_t)b * nb;
  __syncthreads();

  for (int blk = 0; blk < n_blocks; ++blk) {
    const size_t base = (size_t)tbl[blk] * BS * tok_stride + (size_t)kh * hd;
    for (int t0 = 0; t0 < BS; t0 += kTile) {
      const int tok0 = blk * BS + t0;
      if (tok0 >= length) break;       // every tile below holds a valid token
      const int nt = min(kTile, BS - t0);
      for (int i = tid; i < nt * hd; i += kThreads) {
        const int t = i / hd, d = i - t * hd;
        const size_t off = base + (size_t)(t0 + t) * tok_stride + d;
        k_s[t * ks_stride + d] = to_f32(k_pool[off]);
        v_s[t * hd + d] = to_f32(v_pool[off]);
      }
      __syncthreads();
      for (int i = tid; i < G * nt; i += kThreads) {
        const int g = i / nt, t = i - g * nt;
        const float* qr = q_s + g * hd;
        const float* kr = k_s + t * ks_stride;
        float s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
        p_s[g * kTile + t] = (tok0 + t < length) ? s * scale : kNegInf;
      }
      __syncthreads();
      // online softmax, one warp a query row, one lane a token
      for (int g = warp; g < G; g += kThreads / 32) {
        const float s = lane < nt ? p_s[g * kTile + lane] : kNegInf;
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        const float p = lane < nt ? expf(s - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane < nt) p_s[g * kTile + lane] = p;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[g] = alpha;
          l_s[g] = alpha * l_s[g] + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMaxAcc; ++j) {
        const int i = tid + j * kThreads;
        if (i < G * hd) {
          const int g = i / hd, d = i - g * hd;
          const float* pr = p_s + g * kTile;
          float a = acc[j] * a_s[g];
          for (int t = 0; t < nt; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
          acc[j] = a;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * hd)
      out[head0 + i] = from_f32<T>(acc[j] / fmaxf(l_s[i / hd], 1e-30f));
  }
}

size_t smem_bytes(int G, int hd) {
  return sizeof(float) * ((size_t)G * hd + (size_t)kTile * (hd + 1) +
                          (size_t)kTile * hd + (size_t)G * kTile + 3 * G);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* lengths, void* out, int B,
                   int K, int G, int hd, int BS, int nb, cudaStream_t stream) {
  const dim3 grid(B, K);
  const size_t smem = smem_bytes(G, hd);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), K, G, hd, BS,
      nb, static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd))));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* lengths, void* out, int B, int K,
                           int G, int hd, int BS, int nb, int dtype,
                           void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (G <= 0 || hd <= 0 || hd > 128 || G * hd > kMaxAcc * kThreads ||
      BS <= 0 || nb <= 0 || smem_bytes(G, hd) > 48 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, table, lengths, out, B, K, G,
                           hd, BS, nb, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, B,
                                   K, G, hd, BS, nb, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
