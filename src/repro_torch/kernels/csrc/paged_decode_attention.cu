// Paged GQA decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `paged_gqa_decode_attention` in
// src/repro/kernels/paged_decode_attention.py (Pallas body `_paged_kernel`):
// one query token per request attends over the request's KV, which lives in
// physical pool blocks named by a block table, with an f32 online softmax and
// scale hd**-0.5. The G = H/K query heads of one KV head share each K/V row.
// Rows at or past a row's length are masked; a length-0 row gives exact
// zeros. A row reads only its first min(ceil(length/BS), nb) table entries,
// so no length sends it past the table.
//
// What bounds it on this card: the KV bytes. Every valid token's K and V rows
// are read once (2 * K * hd * itemsize bytes per token per layer) and each
// element feeds G multiply-adds, about G/itemsize FLOP per byte, far below
// the H100's ~295 FLOP/byte ridge. The least time is
// 2 * sum(length) * K * hd * itemsize / 3.35 TB/s.
//
// What the design does about it (the contiguous kernel's flash-decoding,
// csrc/decode_attention.cu, with the table in front of every block):
//
// * Split of the sequence. Grid (B, K, n_split) over the table's capacity
//   nb * BS: block (b, kh, s) covers rows [s * rows_per_split, ...) of
//   request b up to min(length, nb * BS); rows_per_split is a multiple of
//   BS, so a split covers whole logical blocks. The host picks the plan
//   from the shapes alone (no read of the lengths); a split wholly past a
//   row's bound, and every split of a length-0 row, exits at once. Each
//   live split writes its unnormalised (acc, m, l) per head to an f32
//   scratch [B, K, n_split, G, hd + 2]; a second small kernel merges the
//   live splits, or writes zeros where there are none.
// * Lane groups over 16-byte chunks (common.cuh `Lanes`). One row of one
//   KV head is hd * itemsize contiguous bytes in its physical block, and
//   consecutive tokens of a block lie K * hd elements apart. A group of
//   lanes holds one row, a 16-byte chunk of K and of V a lane, loaded
//   straight into registers; each warp streams its own share of the split
//   with several rows in flight and issues the next batch before it folds
//   the current one. State in registers, no barrier in the loop; groups
//   and warps merge at the end.
// * The block table off the critical path. A warp loads a window of 32
//   table entries (one a lane, one coalesced load) at the start of its
//   share; a lane takes its row's physical id from the window with a
//   shuffle, so a K/V load waits on no table load. The window moves only
//   when a share spans more than 32 blocks. Entries past the row's bound
//   are never read.
//
// Two more entries carry a decode whose KV sequence is sharded over several
// cards (each card holds some rows of every block): `paged_decode_partials`
// runs the same split kernel, and its merge writes each (request, head)'s
// unnormalised (acc, m, l) over the card's rows, f32 [B, H, hd + 2] (m =
// -inf, l = 0 and acc = 0 where the card holds no live row), instead of the
// normalised output; `paged_decode_combine` takes M such partials
// [M, B, H, hd + 2] to the output [B, H, hd]: acc e^{m - M*} and l e^{m - M*}
// summed over the pieces that hold rows (M* their largest m), the one over
// the other; exact zeros where no piece holds a row. Both are a few KB a
// head, read once: the KV read stays the split kernel's.
//
// Layouts (all contiguous): q/out [B, H, hd]; k_pool/v_pool [NB, BS, K, hd]
// (one layer of the pool), 16-byte aligned; table [B, nb] int32; lengths [B]
// int32; scratch [B, K, n_split, G, hd + 2] f32, allocated by the caller.
// 128 threads a block, both kernels. The caller guarantees every table entry
// a row reads is a valid physical block id.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;        // query heads a KV head
constexpr int kMaxHd = 128;

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ table,
                          const int* __restrict__ lengths,
                          float* __restrict__ part, int K, int G, int BS,
                          int nb, int n_split, int rows_per_split,
                          float scale) {
  using L = Lanes<T, HD, GM>;
  constexpr int E = L::kElems;

  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  // bounded by the table width as well as the length
  const int n_tok = min(max(lengths[b], 0), nb * BS);
  const int r0 = split * rows_per_split;
  if (r0 >= n_tok) return;        // length 0, or wholly past the row's bound
  const int r1 = min(r0 + rows_per_split, n_tok);
  const int n_blk = (n_tok + BS - 1) / BS;   // table entries the row reads

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
  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // the window: lane i holds the entry of logical block base + i
  const int* tb = table + (size_t)b * nb;
  int base = w0 / BS;
  int entry = base + lane < n_blk ? __ldg(tb + base + lane) : 0;

  const size_t tok_stride = (size_t)K * HD;
  const T* kb = k_pool + kh * HD + ch * E;
  const T* vb = v_pool + kh * HD + ch * E;
  const unsigned bs = BS;
  // slot u of the batch at `row` is row row + u * kRows + grp, read from
  // its physical block; the whole warp calls this (the shuffles)
  auto load = [&](uint4 (&kc)[L::kUnroll], uint4 (&vc)[L::kUnroll],
                  int row) {
    const int last = min(row + L::kStep, w1) - 1;
    if (last / BS - base >= 32) {  // past the window: move it to this batch
      base = row / BS;
      entry = base + lane < n_blk ? __ldg(tb + base + lane) : 0;
    }
#pragma unroll
    for (int u = 0; u < L::kUnroll; ++u) {
      const unsigned t = row + u * L::kRows + grp;
      const unsigned blk = t / bs;
      const int phys =
          __shfl_sync(0xffffffffu, entry, (blk - base) & 31u);
      const bool in = has_chunk && t < (unsigned)w1;
      const size_t off = ((size_t)phys * BS + (t - blk * bs)) * tok_stride;
      kc[u] = in ? ldg16(kb + off) : make_uint4(0, 0, 0, 0);
      vc[u] = in ? ldg16(vb + off) : make_uint4(0, 0, 0, 0);
    }
  };
  uint4 kc[L::kUnroll], vc[L::kUnroll];
  load(kc, vc, w0);
  for (int row = w0; row < w1; row += L::kStep) {
    uint4 kn[L::kUnroll], vn[L::kUnroll];
    if (row + L::kStep < w1) load(kn, vn, row + L::kStep);
    fold_rows<T, HD, GM>(kc, vc, row, w1, grp, qf, G, scale, false, m, l,
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

// Merge the live splits of each (request, KV head),
// ceil(min(length, nb * BS) / rows_per_split) of them: out = sum_s acc_s
// e^{m_s - M} / max(sum_s l_s e^{m_s - M}, 1e-30), M = max_s m_s. A
// length-0 row has none and gets exact zeros; the scratch is then not
// read.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const float* __restrict__ part,
                          const int* __restrict__ lengths,
                          T* __restrict__ out, int K, int G, int hd, int BS,
                          int nb, int n_split, int rows_per_split) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int n_tok = min(max(lengths[b], 0), nb * BS);
  const int n_live = (n_tok + rows_per_split - 1) / rows_per_split;
  const float* pb = part + ((size_t)b * K + kh) * n_split * G * (hd + 2);
  const size_t split_stride = (size_t)G * (hd + 2);
  T* ob = out + ((size_t)b * K + kh) * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    const float* p = pb + g * (hd + 2);
    float mx = kNegInf;
    for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, p[s * split_stride + hd]);
    float a = 0.f, lsum = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float* ps = p + s * split_stride;
      const float wt = expf(ps[hd] - mx);
      a = fmaf(wt, ps[d], a);
      lsum = fmaf(wt, ps[hd + 1], lsum);
    }
    ob[i] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

// The rank's partials: each (request, head)'s live splits merged but not
// normalised, [B, K, G, hd + 2] = [B, H, hd + 2] f32 (acc, then m, then l);
// no live split gives acc = 0, m = -inf, l = 0.
__global__ void __launch_bounds__(kThreads)
paged_decode_partials_kernel(const float* __restrict__ part,
                             const int* __restrict__ lengths,
                             float* __restrict__ out, int K, int G, int hd,
                             int BS, int nb, int n_split,
                             int rows_per_split) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int n_tok = min(max(lengths[b], 0), nb * BS);
  const int n_live = (n_tok + rows_per_split - 1) / rows_per_split;
  const int w = hd + 2;
  const float* pb = part + ((size_t)b * K + kh) * n_split * G * w;
  const size_t split_stride = (size_t)G * w;
  float* ob = out + ((size_t)b * K + kh) * G * w;
  for (int i = threadIdx.x; i < G * w; i += kThreads) {
    const int g = i / w, d = i - g * w;
    if (n_live == 0) {
      ob[i] = d == hd ? -INFINITY : 0.f;
      continue;
    }
    const float* p = pb + g * w;
    float mx = kNegInf;
    for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, p[s * split_stride + hd]);
    if (d == hd) {
      ob[i] = mx;
      continue;
    }
    float a = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float* ps = p + s * split_stride;
      a = fmaf(expf(ps[hd] - mx), ps[d], a);
    }
    ob[i] = a;
  }
}

// M pieces' partials [M, BH, hd + 2] -> out [BH, hd]: one block a
// (request, head), a thread an element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ parts,
                            T* __restrict__ out, int M, int BH, int hd) {
  const int bh = blockIdx.x;
  const int w = hd + 2;
  const size_t piece = (size_t)BH * w;
  const float* pb = parts + (size_t)bh * w;
  float mx = -INFINITY;
  for (int i = 0; i < M; ++i) {
    const float* p = pb + i * piece;
    if (p[hd + 1] > 0.f) mx = fmaxf(mx, p[hd]);
  }
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.f, lsum = 0.f;
    for (int i = 0; i < M; ++i) {
      const float* p = pb + i * piece;
      const float l = p[hd + 1];
      if (l > 0.f) {
        const float wt = expf(p[hd] - mx);
        a = fmaf(wt, p[d], a);
        lsum = fmaf(wt, l, lsum);
      }
    }
    out[(size_t)bh * hd + d] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD, int GM>
cudaError_t launch_split(const void* q, const void* k_pool,
                         const void* v_pool, const void* table,
                         const void* lengths, float* part, int B, int K,
                         int G, int BS, int nb, int n_split,
                         int rows_per_split, cudaStream_t stream) {
  paged_decode_split_kernel<T, HD, GM>
      <<<dim3(B, K, n_split), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool), static_cast<const int*>(table),
          static_cast<const int*>(lengths), part, K, G, BS, nb, n_split,
          rows_per_split,
          static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(const void* q, const void* k_pool, const void* v_pool,
                       const void* table, const void* lengths, float* part,
                       int B, int K, int G, int BS, int nb, int n_split,
                       int rows_per_split, cudaStream_t s) {
  if (G <= 1)
    return launch_split<T, HD, 1>(q, k_pool, v_pool, table, lengths, part, B,
                                  K, G, BS, nb, n_split, rows_per_split, s);
  if (G <= 2)
    return launch_split<T, HD, 2>(q, k_pool, v_pool, table, lengths, part, B,
                                  K, G, BS, nb, n_split, rows_per_split, s);
  if (G <= 4)
    return launch_split<T, HD, 4>(q, k_pool, v_pool, table, lengths, part, B,
                                  K, G, BS, nb, n_split, rows_per_split, s);
  return launch_split<T, HD, 8>(q, k_pool, v_pool, table, lengths, part, B,
                                K, G, BS, nb, n_split, rows_per_split, s);
}

// partials: write the f32 partials [B, H, hd + 2] to out, not the output
template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* lengths, void* out,
                   float* part, int B, int K, int G, int hd, int BS, int nb,
                   int n_split, int rows_per_split, bool partials,
                   cudaStream_t s) {
  cudaError_t err;
  switch (hd) {
    case 64:
      err = dispatch_g<T, 64>(q, k_pool, v_pool, table, lengths, part, B, K,
                              G, BS, nb, n_split, rows_per_split, s);
      break;
    case 80:
      err = dispatch_g<T, 80>(q, k_pool, v_pool, table, lengths, part, B, K,
                              G, BS, nb, n_split, rows_per_split, s);
      break;
    case 96:
      err = dispatch_g<T, 96>(q, k_pool, v_pool, table, lengths, part, B, K,
                              G, BS, nb, n_split, rows_per_split, s);
      break;
    case 112:
      err = dispatch_g<T, 112>(q, k_pool, v_pool, table, lengths, part, B, K,
                               G, BS, nb, n_split, rows_per_split, s);
      break;
    case 128:
      err = dispatch_g<T, 128>(q, k_pool, v_pool, table, lengths, part, B, K,
                               G, BS, nb, n_split, rows_per_split, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  if (partials) {
    paged_decode_partials_kernel<<<dim3(B, K), kThreads, 0, s>>>(
        part, static_cast<const int*>(lengths), static_cast<float*>(out), K,
        G, hd, BS, nb, n_split, rows_per_split);
    return cudaGetLastError();
  }
  paged_decode_merge_kernel<T><<<dim3(B, K), kThreads, 0, s>>>(
      part, static_cast<const int*>(lengths), static_cast<T*>(out), K, G, hd,
      BS, nb, n_split, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

static int run(const void* q, const void* k_pool, const void* v_pool,
               const void* table, const void* lengths, void* out, void* part,
               int B, int K, int G, int hd, int BS, int nb, int n_split,
               int rows_per_split, int dtype, bool partials, void* stream) {
  if (B <= 0 || K <= 0) return cudaSuccess;
  if (G < 1 || G > kMaxG || hd <= 0 || hd > kMaxHd || BS <= 0 || nb <= 0 ||
      n_split < 1 || n_split > 65535 || rows_per_split < BS ||
      rows_per_split % BS || (long long)nb * BS > (1LL << 30) ||
      (long long)n_split * rows_per_split < (long long)nb * BS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, table, lengths, out, p, B, K, G,
                           hd, BS, nb, n_split, rows_per_split, partials, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, p,
                                   B, K, G, hd, BS, nb, n_split,
                                   rows_per_split, partials, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16. part is the f32 scratch
// [B, K, n_split, G, hd + 2]; rows_per_split must be a multiple of BS and
// n_split * rows_per_split must cover nb * BS. Returns a cudaError_t
// (0 = success).
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* lengths, void* out, void* part, int B,
                           int K, int G, int hd, int BS, int nb, int n_split,
                           int rows_per_split, int dtype, void* stream) {
  return run(q, k_pool, v_pool, table, lengths, out, part, B, K, G, hd, BS,
             nb, n_split, rows_per_split, dtype, false, stream);
}

// As paged_decode_attention, but out is the f32 partials [B, H, hd + 2].
int paged_decode_partials(const void* q, const void* k_pool,
                          const void* v_pool, const void* table,
                          const void* lengths, void* out, void* part, int B,
                          int K, int G, int hd, int BS, int nb, int n_split,
                          int rows_per_split, int dtype, void* stream) {
  return run(q, k_pool, v_pool, table, lengths, out, part, B, K, G, hd, BS,
             nb, n_split, rows_per_split, dtype, true, stream);
}

// parts: f32 [M, BH, hd + 2]; out: [BH, hd] of dtype (0 = float32,
// 1 = bfloat16).
int paged_decode_combine(const void* parts, void* out, int M, int BH, int hd,
                         int dtype, void* stream) {
  if (BH <= 0) return cudaSuccess;
  if (M < 1 || hd <= 0 || hd > kMaxHd || BH > (1 << 30))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(parts);
  switch (dtype) {
    case 0:
      paged_decode_combine_kernel<float><<<BH, kThreads, 0, s>>>(
          p, static_cast<float*>(out), M, BH, hd);
      break;
    case 1:
      paged_decode_combine_kernel<__nv_bfloat16><<<BH, kThreads, 0, s>>>(
          p, static_cast<__nv_bfloat16*>(out), M, BH, hd);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
