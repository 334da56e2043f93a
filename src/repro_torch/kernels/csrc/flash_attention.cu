// Tiled causal prefill attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (Pallas body `_flash_kernel`): each
// query row attends over the keys with an f32 online softmax, scale
// hd**-0.5, masked by kv_id < Skv, by top-left-aligned causality
// (q_id >= kv_id, both counted from 0) and optionally by a sliding window
// (q_id - kv_id < window). Query head h reads KV head h / G; K/V are never
// repeated. Whole KV tiles that the TPU kernel's skip test marks irrelevant
// are not visited. Masked scores take the reference's finite -0.7*FLT_MAX,
// and masked entries go through exactly the TPU kernel's arithmetic
// (p = exp(s - m), which is 1 while a row has seen only masked scores and is
// wiped by alpha = 0 at its first valid score), so every row with a valid
// key gets the reference's result whatever the tiling.
//
// What bounds it on this card: operations. A causal prefill of S tokens does
// about 2 * 2 * hd * H * S^2 / 2 FLOP on 4 * S * H * hd * itemsize bytes, so
// past a few hundred tokens the least time is FLOP / 989 TFLOP/s (bf16 tensor
// cores); below that, bytes / 3.35 TB/s.
//
// What this simple design does about it: it keeps one 64-row query tile and
// one 64-row K/V tile in shared memory, so each K/V element is read from
// device memory once per query tile rather than once per query, and the
// score matrix never leaves the SM. Its products run on the CUDA cores in
// f32 (two threads a query row, one half of the keys and of the head dims
// each), not on the tensor cores: it is far from the FLOP bound. wgmma, TMA
// and a producer/consumer pipeline are later work.
//
// Layouts (all contiguous): q/out [B, Sq, H, hd]; k/v [B, Skv, K, hd].
// Grid (ceil(Sq/64), H, B), 128 threads a block, dynamic shared memory above
// 48 KB (the kernel's attribute is raised before every launch).

#include <cfloat>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;     // query rows a block (two threads a row)
constexpr int kBKV = 64;    // keys a tile
constexpr int kHalf = kBKV / 2;
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
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_floats() {
  // q tile and k tile padded to HD + 1 (conflict-free row reads), v tile,
  // and the probability tile padded to kBKV + 1
  return (size_t)kBQ * (HD + 1) + (size_t)kBKV * (HD + 1) +
         (size_t)kBKV * HD + (size_t)kBQ * (kBKV + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int K, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kBQ][HD + 1]
  float* k_s = q_s + kBQ * (HD + 1);        // [kBKV][HD + 1]
  float* v_s = k_s + kBKV * (HD + 1);       // [kBKV][HD]
  float* p_s = v_s + kBKV * HD;             // [kBQ][kBKV + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;   // this thread's row and half
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / K);
  const int q0 = blockIdx.x * kBQ, qi = q0 + r;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int rr = i / HD, d = i - rr * HD, qq = q0 + rr;
    q_s[rr * (HD + 1) + d] =
        qq < Sq ? to_f32(q[(((size_t)b * Sq + qq) * H + h) * HD + d]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[HD / 2];   // head dims 2*j + half
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;

  const int n_tiles = (Skv + kBKV - 1) / kBKV;
  for (int st = 0; st < n_tiles; ++st) {
    const int kv0 = st * kBKV;
    // the TPU kernel's whole-tile skip test, on this kernel's tiles
    // (uniform across the block, so no thread skips a barrier alone)
    if (causal && kv0 > q0 + kBQ - 1) continue;
    if (window > 0 && kv0 + kBKV - 1 <= q0 - window) continue;
    __syncthreads();            // the previous tile's readers are done
    for (int i = tid; i < kBKV * HD; i += kThreads) {
      const int c = i / HD, d = i - c * HD, kk = kv0 + c;
      const size_t off = (((size_t)b * Skv + kk) * K + kvh) * HD + d;
      const bool in = kk < Skv;   // the TPU pads K/V with zeros
      k_s[c * (HD + 1) + d] = in ? to_f32(k[off]) : 0.f;
      v_s[c * HD + d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // scores of this row against keys c = 2*j + half, kept in p_s
    float mx = kNegInf;
    const float* qr = q_s + r * (HD + 1);
    float* pr = p_s + r * (kBKV + 1);
#pragma unroll 2
    for (int j = 0; j < kHalf; ++j) {
      const int c = 2 * j + half, kk = kv0 + c;
      const float* kr = k_s + c * (HD + 1);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      bool valid = kk < Skv;
      if (causal) valid = valid && qi >= kk;
      if (window > 0) valid = valid && qi - kk < window;
      const float sc = valid ? dot * scale : kNegInf;
      pr[c] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll 4
    for (int j = 0; j < kHalf; ++j) {
      const int c = 2 * j + half;
      const float p = expf(pr[c] - m_new);
      pr[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m - m_new);
    l = alpha * l + sum;
    m = m_new;
    __syncwarp();               // the row's two halves of p are visible
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] *= alpha;
#pragma unroll 2
    for (int c = 0; c < kBKV; ++c) {
      const float p = pr[c];
      const float* vr = v_s + c * HD + half;
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = fmaf(p, vr[2 * j], acc[j]);
    }
  }

  if (qi < Sq) {
    T* o = out + (((size_t)b * Sq + qi) * H + h) * HD;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 2; ++j)
      o[2 * j + half] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int K, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, K, causal,
      window, static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Skv, int H, int K,
                        int hd, int causal, int window, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, K, causal, window, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, K, causal, window, s);
    case 80:
      return launch<T, 80>(q, k, v, out, B, Sq, Skv, H, K, causal, window, s);
    case 96:
      return launch<T, 96>(q, k, v, out, B, Sq, Skv, H, K, causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, K, causal, window,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means no window.
// Returns a cudaError_t (0 = success).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Skv, int H, int K, int hd, int causal,
                    int window, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaSuccess;
  if (Skv <= 0 || K <= 0 || H % K) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_hd<float>(q, k, v, out, B, Sq, Skv, H, K, hd, causal,
                                window, s);
    case 1:
      return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, K, hd,
                                        causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
