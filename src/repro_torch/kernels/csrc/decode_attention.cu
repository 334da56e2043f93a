// Contiguous-cache GQA decode attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel `gqa_decode_attention` in
// src/repro/kernels/decode_attention.py (Pallas body `_decode_kernel`): one
// query token per request attends over the first `length` rows of its dense
// K/V cache with an f32 online softmax, scale hd**-0.5, mask kv_id < length.
// The G = H/K query heads of one KV head share each K/V row.
//
// Length-0 rows follow the TPU kernel exactly. That kernel never skips a
// tile, so a row whose every score is masked takes p = exp(NEG_INF - NEG_INF)
// = 1 on all Sp = ceil(S/bs)*bs padded slots and returns sum_{j<S} V[j] / Sp
// (the zero padding adds nothing to the sum). The caller passes Sp, so the
// result does not depend on this kernel's own tiling. Lengths past S are
// taken as S. Both are settled where the partials merge.
//
// What bounds it on this card: the KV bytes. Each valid token's K and V rows
// are read once (2 * K * hd * itemsize bytes per token) and each element
// feeds G multiply-adds, about G/itemsize FLOP per byte, far below the
// H100's ~295 FLOP/byte ridge. The least time is
// 2 * sum(length) * K * hd * itemsize / 3.35 TB/s.
//
// What the design does about it (flash-decoding):
//
// * Split of the sequence. Grid (B, K, n_split): block (b, kh, s) covers
//   rows [s * rows_per_split, ...) of request b up to its length, so a long
//   row is read by many SMs at once. The host picks n_split from S and B*K
//   alone (no read of the lengths); a split wholly past a row's length
//   exits at once. Each split writes its unnormalised (acc, m, l) per head
//   to an f32 scratch [B, K, n_split, G, hd + 2]; a second small kernel
//   merges the live splits and writes [B, H, hd] in q's dtype.
// * Lane groups over 16-byte chunks. A cache row is hd * itemsize bytes;
//   a group of lanes (that size over 16, rounded up to a power of two: 8
//   lanes at bf16 hd 64) holds one row, one 16-byte chunk of K and of V a
//   lane, loaded straight into registers from the strided cache. Each warp
//   streams its own contiguous share of the block's rows, 32/group rows a
//   load and kUnroll loads in flight, the next batch issued before the
//   current one is used. A score is reduced over its group in log2(group)
//   shuffles, and all G query heads reuse the K chunk in registers.
// * State in registers. Each group keeps its own running (m, l, acc) per
//   head, rescaled once per batch of rows; no barrier in the loop. Groups
//   merge by shuffles, warps through shared memory, at the end.
//
// Head dim and dtype are template parameters (no loop tests d < hd); the
// head group G runs in a register array sized for G rounded up to 1, 2, 4
// or 8. The lane groups, the fold of a batch of rows and the merge of
// groups and warps are common.cuh's, shared with the paged kernel; the
// merge of splits is written out here (common.cuh says why).
//
// Layouts: q/out [B, H, hd] contiguous; k/v [B, S, K, hd] with the last
// dimension contiguous and equal element strides (sb, ss, sk) for both, every
// row 16-byte aligned; lengths [B] int32; scratch [B, K, n_split, G, hd + 2]
// f32, allocated by the caller. 128 threads a block, both kernels.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;        // query heads a KV head
constexpr int kMaxHd = 128;

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part, int S, int K, int G,
                    long long sb, long long ss, long long sk, int n_split,
                    int rows_per_split, float scale) {
  using L = Lanes<T, HD, GM>;
  constexpr int E = L::kElems;

  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int length = lengths[b];
  const bool empty = length <= 0;            // the TPU kernel's quirk
  const int n_tok = empty ? S : min(length, S);
  const int r0 = split * rows_per_split;
  if (r0 >= n_tok) return;                   // wholly past the row's length
  const int r1 = min(r0 + rows_per_split, n_tok);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / L::kGroup, ch = lane % L::kGroup;
  const bool has_chunk = ch < L::kChunks;
  // this warp's contiguous share of the split, a multiple of kRows
  const int per_warp =
      ((r1 - r0 + kWarps - 1) / kWarps + L::kRows - 1) / L::kRows * L::kRows;
  const int w0 = r0 + warp * per_warp, w1 = min(w0 + per_warp, r1);

  // this lane's chunk of each query head, in f32
  float qf[GM][E];
  const T* qb = q + ((size_t)b * K + kh) * G * HD + ch * E;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G && has_chunk) {
      unpack<T, E>(ldg16(qb + g * HD), qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[g][e] = 0.f;
    }
  }
  // empty rows weigh every row 1: scores 0 and a running max of 0
  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = empty ? 0.f : kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const T* kb = k + b * sb + kh * sk + ch * E;
  const T* vb = v + b * sb + kh * sk + ch * E;
  // slot u of the batch at `row` is cache row row + u * kRows + grp
  auto load = [&](uint4 (&kc)[L::kUnroll], uint4 (&vc)[L::kUnroll],
                  int row) {
#pragma unroll
    for (int u = 0; u < L::kUnroll; ++u) {
      const int t = row + u * L::kRows + grp;
      const bool in = has_chunk && t < w1;
      kc[u] = (in && !empty) ? ldg16(kb + t * ss) : make_uint4(0, 0, 0, 0);
      vc[u] = in ? ldg16(vb + t * ss) : make_uint4(0, 0, 0, 0);
    }
  };
  uint4 kc[L::kUnroll], vc[L::kUnroll];
  load(kc, vc, w0);
  for (int row = w0; row < w1; row += L::kStep) {
    uint4 kn[L::kUnroll], vn[L::kUnroll];
    if (row + L::kStep < w1) load(kn, vn, row + L::kStep);
    fold_rows<T, HD, GM>(kc, vc, row, w1, grp, qf, G, scale, empty, m, l,
                         acc);
#pragma unroll
    for (int u = 0; u < L::kUnroll; ++u) {
      kc[u] = kn[u];
      vc[u] = vn[u];
    }
  }

  store_split<T, HD, GM, kWarps>(
      m, l, acc, G,
      part + (((size_t)b * K + kh) * n_split + split) * G * (HD + 2));
}

// Merge the live splits of each (request, KV head): out = sum_s acc_s
// e^{m_s - M} / max(sum_s l_s e^{m_s - M}, 1e-30), M = max_s m_s; a
// length-0 row (every split's m = 0) gives sum_s acc_s / Sp instead.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int S, int K, int G, int hd, int n_split,
                    int rows_per_split, int Sp) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int length = lengths[b];
  const bool empty = length <= 0;
  const int n_tok = empty ? S : min(length, S);
  const int n_live = (n_tok + rows_per_split - 1) / rows_per_split;
  const float* pb = part + ((size_t)b * K + kh) * n_split * G * (hd + 2);
  T* ob = out + ((size_t)b * K + kh) * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    const float* p = pb + g * (hd + 2);
    const size_t split_stride = (size_t)G * (hd + 2);
    float r;
    if (empty) {
      float a = 0.f;
      for (int s = 0; s < n_live; ++s) a += p[s * split_stride + d];
      r = a / static_cast<float>(Sp);
    } else {
      float mx = kNegInf;
      for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, p[s * split_stride + hd]);
      float a = 0.f, lsum = 0.f;
      for (int s = 0; s < n_live; ++s) {
        const float* ps = p + s * split_stride;
        const float wt = expf(ps[hd] - mx);
        a = fmaf(wt, ps[d], a);
        lsum = fmaf(wt, ps[hd + 1], lsum);
      }
      r = a / fmaxf(lsum, 1e-30f);
    }
    ob[i] = from_f32<T>(r);
  }
}

template <typename T, int HD, int GM>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* lengths, float* part, int B, int S,
                         int K, int G, long long sb, long long ss,
                         long long sk, int n_split, int rows_per_split,
                         cudaStream_t stream) {
  decode_split_kernel<T, HD, GM><<<dim3(B, K, n_split), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths), part, S, K,
      G, sb, ss, sk, n_split, rows_per_split,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(const void* q, const void* k, const void* v,
                       const void* lengths, float* part, int B, int S, int K,
                       int G, long long sb, long long ss, long long sk,
                       int n_split, int rows_per_split, cudaStream_t s) {
  if (G <= 1)
    return launch_split<T, HD, 1>(q, k, v, lengths, part, B, S, K, G, sb, ss,
                                  sk, n_split, rows_per_split, s);
  if (G <= 2)
    return launch_split<T, HD, 2>(q, k, v, lengths, part, B, S, K, G, sb, ss,
                                  sk, n_split, rows_per_split, s);
  if (G <= 4)
    return launch_split<T, HD, 4>(q, k, v, lengths, part, B, S, K, G, sb, ss,
                                  sk, n_split, rows_per_split, s);
  return launch_split<T, HD, 8>(q, k, v, lengths, part, B, S, K, G, sb, ss,
                                sk, n_split, rows_per_split, s);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, float* part, int B, int S,
                   int K, int G, int hd, long long sb, long long ss,
                   long long sk, int Sp, int n_split, int rows_per_split,
                   cudaStream_t s) {
  cudaError_t err;
  switch (hd) {
    case 64:
      err = dispatch_g<T, 64>(q, k, v, lengths, part, B, S, K, G, sb, ss, sk,
                              n_split, rows_per_split, s);
      break;
    case 80:
      err = dispatch_g<T, 80>(q, k, v, lengths, part, B, S, K, G, sb, ss, sk,
                              n_split, rows_per_split, s);
      break;
    case 96:
      err = dispatch_g<T, 96>(q, k, v, lengths, part, B, S, K, G, sb, ss, sk,
                              n_split, rows_per_split, s);
      break;
    case 112:
      err = dispatch_g<T, 112>(q, k, v, lengths, part, B, S, K, G, sb, ss, sk,
                               n_split, rows_per_split, s);
      break;
    case 128:
      err = dispatch_g<T, 128>(q, k, v, lengths, part, B, S, K, G, sb, ss, sk,
                               n_split, rows_per_split, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<dim3(B, K), kThreads, 0, s>>>(
      part, static_cast<const int*>(lengths), static_cast<T*>(out), S, K, G,
      hd, n_split, rows_per_split, Sp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. sb/ss/sk are K's and V's element
// strides over batch, sequence and KV head. Sp is the TPU kernel's padded
// length, used only by length-0 rows. part is the f32 scratch
// [B, K, n_split, G, hd + 2]; n_split * rows_per_split must cover S.
// Returns a cudaError_t (0 = success).
int decode_attention(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* part, int B, int S,
                     int K, int G, int hd, long long sb, long long ss,
                     long long sk, int Sp, int n_split, int rows_per_split,
                     int dtype, void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (S <= 0 || Sp < S || G < 1 || G > kMaxG || hd <= 0 || hd > kMaxHd ||
      n_split < 1 || n_split > 65535 || rows_per_split < 1 ||
      (long long)n_split * rows_per_split < S)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, lengths, out, p, B, S, K, G, hd, sb, ss,
                           sk, Sp, n_split, rows_per_split, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, lengths, out, p, B, S, K, G, hd,
                                   sb, ss, sk, Sp, n_split, rows_per_split,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
