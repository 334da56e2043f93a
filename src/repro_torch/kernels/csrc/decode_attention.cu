// Contiguous-cache GQA decode attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel `gqa_decode_attention` in
// src/repro/kernels/decode_attention.py (Pallas body `_decode_kernel`): one
// query token per request attends over the first `length` rows of its dense
// K/V cache with an f32 online softmax, scale hd**-0.5, mask kv_id < length.
// The G = H/K query heads of one KV head share each K/V tile.
//
// Length-0 rows follow the TPU kernel exactly. That kernel never skips a
// tile, so a row whose every score is masked takes p = exp(NEG_INF - NEG_INF)
// = 1 on all Sp = ceil(S/bs)*bs padded slots and returns sum_{j<S} V[j] / Sp
// (the zero padding adds nothing to the sum). The caller passes Sp, so the
// result does not depend on this kernel's own tiling. Lengths past S are
// taken as S.
//
// What bounds it on this card: the KV bytes. Each valid token's K and V rows
// are read once (2 * K * hd * itemsize bytes per token) and each element
// feeds G multiply-adds, about G/itemsize FLOP per byte, far below the
// H100's ~295 FLOP/byte ridge. The least time is
// 2 * sum(length) * K * hd * itemsize / 3.35 TB/s.
//
// What this simple design does about it: it reads nothing past a row's
// length (the loop stops at ceil(length/64) tiles, where the TPU grid walks
// all of Sp), reads every K/V element once per (request, KV head) and shares
// it across the G query heads, and keeps bytes in flight: each tile of 64
// rows is copied with 16-byte cp.async (neighbouring threads on neighbouring
// addresses, straight from the strided [B, S, K, hd] cache, no padding
// copy), two tiles ahead of the one being used, in a three-stage ring in
// shared memory. Split-K over the sequence for small batches, TMA and wgmma
// are later work.
//
// Layouts: q/out [B, H, hd] contiguous; k/v [B, S, K, hd] with the last
// dimension contiguous and equal element strides (sb, ss, sk) for both, every
// row 16-byte aligned; lengths [B] int32. Grid (B, K), 128 threads a block,
// dynamic shared memory (the attribute is raised before every launch).

#include <cfloat>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // cache rows a tile (two a lane in the softmax)
constexpr int kStages = 3;      // tiles in the shared-memory ring
constexpr int kMaxG = 8;        // query heads a KV head
constexpr int kMaxHd = 128;
constexpr int kQRegs = kMaxHd / 32;                  // q values a lane a head
constexpr int kMaxAcc = kMaxG * kMaxHd / kThreads;   // accumulators a thread
// The reference's finite mask value: exp(s - m) on a fully masked score row
// stays finite (exp(0) = 1), where -INFINITY would give NaN.
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, int S, int K, int G, int hd, long long sb,
              long long ss, long long sk, int Sp, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row_bytes = hd * static_cast<int>(sizeof(T));
  const int tile_bytes = kTile * row_bytes;
  const int vec_row = row_bytes / 16;                 // 16-byte copies a row
  constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));
  unsigned char* k_s = smem;                          // [kStages][kTile][hd]
  unsigned char* v_s = k_s + kStages * tile_bytes;    // [kStages][kTile][hd]
  float* p_s = reinterpret_cast<float*>(v_s + kStages * tile_bytes);
  float* m_s = p_s + G * kTile;                       // [G] running max
  float* l_s = m_s + G;                               // [G] running denominator
  float* a_s = l_s + G;                               // [G] this tile's rescale

  const int length = lengths[b];
  const bool empty = length <= 0;                     // the TPU kernel's quirk
  const int n_tok = empty ? S : min(length, S);
  const int n_tiles = (n_tok + kTile - 1) / kTile;
  const T* kb = k + b * sb + kh * sk;
  const T* vb = v + b * sb + kh * sk;

  auto load_tile = [&](int tile) {
    const int tok0 = tile * kTile;
    const int nt = min(kTile, n_tok - tok0);
    unsigned char* kd = k_s + (tile % kStages) * tile_bytes;
    unsigned char* vd = v_s + (tile % kStages) * tile_bytes;
    for (int i = tid; i < nt * vec_row; i += kThreads) {
      const int t = i / vec_row, c = i - t * vec_row;
      const long long off = (tok0 + t) * ss + c * kVecElems;
      if (!empty) cp_async16(kd + t * row_bytes + c * 16, kb + off);
      cp_async16(vd + t * row_bytes + c * 16, vb + off);
    }
  };

  // this lane's slice of the G query rows: elements lane, lane + 32, ...
  float qr[kMaxG][kQRegs];
  const T* qb = q + (static_cast<size_t>(b) * K + kh) * G * hd;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int j = 0; j < kQRegs; ++j) {
      const int d = lane + 32 * j;
      qr[g][j] = (g < G && d < hd) ? to_f32(qb[g * hd + d]) : 0.f;
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();   // this thread's copies of `tile` landed
    // everyone's copies landed, and everyone is done with tile - 1, whose
    // stage the next prefetch overwrites
    __syncthreads();
    if (tile + kStages - 1 < n_tiles) load_tile(tile + kStages - 1);
    cp_async_commit();
    const int tok0 = tile * kTile;
    const int nt = min(kTile, n_tok - tok0);
    const T* kt = reinterpret_cast<const T*>(k_s + (tile % kStages) * tile_bytes);
    const T* vt = reinterpret_cast<const T*>(v_s + (tile % kStages) * tile_bytes);

    if (!empty) {
      // scores: one warp a cache row, lanes across the head dim
      for (int t = warp; t < nt; t += kWarps) {
        const T* kr = kt + t * hd;
        float kv[kQRegs];
#pragma unroll
        for (int j = 0; j < kQRegs; ++j) {
          const int d = lane + 32 * j;
          kv[j] = d < hd ? to_f32(kr[d]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < kQRegs; ++j) s = fmaf(qr[g][j], kv[j], s);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              s += __shfl_xor_sync(0xffffffffu, s, o);
            if (lane == 0) p_s[g * kTile + t] = s * scale;
          }
        }
      }
      __syncthreads();
    }
    // online softmax: one warp a query head, two rows a lane
    for (int g = warp; g < G; g += kWarps) {
      float* pr = p_s + g * kTile;
      const int t0 = lane, t1 = lane + 32;
      if (empty) {             // every score masked: p = 1 on each slot
        pr[t0] = t0 < nt ? 1.f : 0.f;
        pr[t1] = t1 < nt ? 1.f : 0.f;
        if (lane == 0) a_s[g] = 1.f;
        continue;
      }
      const float s0 = t0 < nt ? pr[t0] : kNegInf;
      const float s1 = t1 < nt ? pr[t1] : kNegInf;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = t0 < nt ? expf(s0 - m_new) : 0.f;
      const float p1 = t1 < nt ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      pr[t0] = p0;
      pr[t1] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // weighted values: one thread a (head, dim) pair of the G x hd output
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < G * hd) {
        const int g = i / hd, d = i - g * hd;
        const float* pr = p_s + g * kTile;
        float a = acc[j] * a_s[g];
        for (int t = 0; t < nt; ++t) a = fmaf(pr[t], to_f32(vt[t * hd + d]), a);
        acc[j] = a;
      }
    }
  }
  cp_async_wait<0>();   // only empty groups remain; leave none behind

  T* ob = out + (static_cast<size_t>(b) * K + kh) * G * hd;
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * hd) {
      const float denom = empty ? static_cast<float>(Sp)
                                : fmaxf(l_s[i / hd], 1e-30f);
      ob[i] = from_f32<T>(acc[j] / denom);
    }
  }
}

size_t smem_bytes(int G, int hd, size_t itemsize) {
  return 2 * kStages * kTile * hd * itemsize +
         sizeof(float) * (static_cast<size_t>(G) * kTile + 3 * G);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int S, int K, int G,
                   int hd, long long sb, long long ss, long long sk, int Sp,
                   cudaStream_t stream) {
  if ((hd * sizeof(T)) % 16) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, hd, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_kernel<T><<<dim3(B, K), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), S, K, G, hd, sb, ss, sk, Sp,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd))));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. sb/ss/sk are K's and V's element
// strides over batch, sequence and KV head. Sp is the TPU kernel's padded
// length, used only by length-0 rows. Returns a cudaError_t (0 = success).
int decode_attention(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, int B, int S, int K,
                     int G, int hd, long long sb, long long ss, long long sk,
                     int Sp, int dtype, void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (S <= 0 || Sp < S || G < 1 || G > kMaxG || hd <= 0 || hd > kMaxHd)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, lengths, out, B, S, K, G, hd, sb, ss, sk,
                           Sp, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, K, G, hd, sb,
                                   ss, sk, Sp, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
