// Tiled causal prefill attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (Pallas body `_flash_kernel`): each
// query row attends over the keys with an f32 online softmax, scale
// hd**-0.5, masked by kv_id < Skv, by top-left-aligned causality
// (q_id >= kv_id, both counted from 0) and optionally by a sliding window
// (q_id - kv_id < window). Query head h reads KV head h / G; K/V are never
// repeated. Whole KV tiles that the TPU kernel's skip test marks irrelevant
// are not visited: the test is the loop's bounds. Masked scores take the
// reference's finite -0.7*FLT_MAX, and masked entries go through exactly
// the TPU kernel's arithmetic (p = exp(s - m), which is 1 while a row has
// seen only masked scores and is wiped by alpha = 0 at its first valid
// score), so every row with a valid key gets the reference's result
// whatever the tiling.
//
// What bounds it on this card: operations. A causal prefill of S tokens does
// about 2 * 2 * hd * H * S^2 / 2 FLOP on 4 * S * H * hd * itemsize bytes, so
// past a few hundred tokens the least time is FLOP / 989 TFLOP/s (bf16 tensor
// cores); below that, bytes / 3.35 TB/s.
//
// Two bodies, chosen by dtype (the wrapper names which; neither falls back
// to the other):
//
// * bfloat16: tensor cores. One block is one warpgroup (128 threads) for 64
//   query rows of one (batch, head). Q is loaded once; K/V tiles of 64 keys
//   go through a four-stage ring in shared memory (three at hd 128),
//   filled with 16-byte cp.async.cg (neighbouring threads on neighbouring
//   addresses) into the 128-byte-swizzled layout that wgmma descriptors
//   read, three tiles ahead of the one being multiplied (two at hd 128).
//   cp.async rather than TMA: TMA needs cuTensorMapEncodeTiled from
//   libcuda, which the ctypes build does not link. S = Q K^T is wgmma
//   m64n64k16 with both operands from shared memory (K-major). The online
//   softmax runs on the f32 accumulator fragments in registers, in the
//   log2 domain (one ex2.approx of scores scaled by hd**-0.5 * log2 e); a
//   row's max and sum need shuffles among the 4 threads that share it, and
//   only tiles on a mask's edge test each element. P is rounded to bf16 in
//   registers and is the register A operand of O += P V (wgmma
//   m64n{64,128}k16, V read transposed from shared memory), so P never goes
//   through shared memory. S for tile t+1 and P V for tile t are issued
//   together, and the softmax of tile t+1 runs while P V is still in
//   flight. The softmax's instructions, not the tensor cores, bound the
//   loop. Head dims are padded in shared memory only: 32 to 64, 80 and 96
//   to 128 (zero K columns add nothing to a score; padded V columns are
//   not stored). Numerics: P V takes P in bf16 where the reference keeps P
//   in f32, and exp is an approximate exp2 of prescaled scores; within the
//   bf16 tolerance (3e-2).
//
// * float32: CUDA cores, the design of the first port: one 64-row query
//   tile and one 64-row K/V tile in shared memory as f32, two threads a
//   query row, scalar f32 products. Tensor cores would take f32 as TF32 and
//   break the reference's 1e-4 float32 tolerance.
//
// Two entry points share the bodies, each with a build of its own
// (kPrefix). `flash_attention` is the TPU kernel's API (top-left causal,
// optional window), with an optional length a request (keys at or past it
// masked): the model's prefill without a prefix. `flash_prefix_attention`
// is the prefill of the model's `self_attn_seq` over a prefix
// (src/repro/models/attention.py, the masks of its `_mask_builder`): K/V
// are [prefix (P_pad slots) || suffix], prefix slots at or past the valid
// prefix length pl take id -1, suffix slot j takes id pl + j - P_pad,
// query row i id pl + i, and each request's keys are cut at its length (in
// ids, from a device array). pl too is read from the device when a block
// starts, so a CUDA graph that captured the launch replays it at whatever
// prefix length the engine staged for that replay (a scalar argument would
// be frozen at its captured value). The plain entry is the case P_pad =
// pl = 0, so both give the same bits there. Its build folds P_pad and pl
// away, keeps the TPU kernel's whole-tile skip test as its loop bounds and
// tests a slot against two bounds a row (RowKeys): on the card it runs as fast
// as the TPU kernel's mask alone, where one build of both entries read 8%
// slower and the prefix build at P_pad = 0 15% slower (tools/decode_ab.py).
// Key tiles with no valid slot for a query tile are not visited: the
// valid prefix's tiles, then the suffix's up to the length and the causal
// diagonal (a tile may straddle the prefix's masked tail and the suffix;
// it is visited once). Tiles not wholly valid for every row take the
// per-element mask.
//
// Layouts (all contiguous): q/out [B, Sq, H, hd]; k/v [B, Skv, K, hd].
// Grid (ceil(Sq/64), H, B), 128 threads a block, dynamic shared memory above
// 48 KB (the kernel's attribute is raised before every launch).

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;     // query rows a block (two threads a row)
constexpr int kBKV = 64;    // keys a tile
constexpr int kHalf = kBKV / 2;

// The keys one query row sees. Without a prefix they are the slots
// [lo, hi): the length, causality and the window folded into two bounds
// once a row, so that an edge tile tests a slot with two comparisons, as
// the TPU kernel's mask does (testing the mask's terms a slot made that
// build 7% slower). With a prefix each slot's id comes first, then the
// terms of the reference's `_mask_builder` (bounds there read 6-8%
// slower). Both measured on the card with tools/decode_ab.py.
template <bool kPrefix>
struct RowKeys;

template <>
struct RowKeys<false> {
  int lo, hi;

  __device__ __forceinline__ bool valid(int j) const {
    return j >= lo && j < hi;
  }
};

template <>
struct RowKeys<true> {
  int qi, Skv, P_pad, pl, len, causal, window;

  // prefix slot j < P_pad has id j, valid below pl; suffix slot j has id
  // pl + j - P_pad; the row's id is pl + qi
  __device__ __forceinline__ bool valid(int j) const {
    const int id = j < P_pad ? (j < pl ? j : -1) : pl + j - P_pad;
    bool ok = j < Skv && id >= 0 && id < len;
    if (causal) ok = ok && pl + qi >= id;
    if (window > 0) ok = ok && pl + qi - id < window;
    return ok;
  }
};

// Which keys a query row sees (see the header): `len` is the request's
// length in ids. Without a prefix (kPrefix false) P_pad and pl are 0.
template <bool kPrefix>
struct Mask {
  int Skv, P_pad, pl, len, causal, window;

  __device__ __forceinline__ RowKeys<kPrefix> row(int qi) const {
    if constexpr (kPrefix) {
      return RowKeys<true>{qi, Skv, P_pad, pl, len, causal, window};
    } else {
      int hi = min(Skv, len);
      if (causal) hi = min(hi, qi + 1);
      return RowKeys<false>{window > 0 ? qi - window + 1 : 0, hi};
    }
  }
  // valid prefix slots [0, prefix_end())
  __device__ __forceinline__ int prefix_end() const {
    return max(0, min(min(pl, P_pad), len));
  }
  // the key tiles query tile [q0, q0 + kBQ) visits: [0, n_pre), then
  // [s_beg, s_end); without a prefix the TPU kernel's whole-tile skip test
  // with the keys cut at len
  __device__ __forceinline__ void tiles(int q0, int& n_pre, int& s_beg,
                                        int& s_end) const {
    if constexpr (kPrefix) {
      n_pre = (prefix_end() + kBKV - 1) / kBKV;
      int hi = min(Skv, P_pad + max(len - pl, 0));
      if (causal) hi = min(hi, P_pad + q0 + kBQ);
      s_end = (hi + kBKV - 1) / kBKV;
      s_beg = max(n_pre, P_pad / kBKV);
    } else {
      n_pre = 0;
      s_end = (min(Skv, len) + kBKV - 1) / kBKV;
      if (causal) s_end = min(s_end, (q0 + kBQ - 1) / kBKV + 1);
      s_beg = 0;
    }
    if (window > 0 && q0 - window - (kBKV - 1) >= 0)
      s_beg = max(s_beg, (q0 - window - (kBKV - 1)) / kBKV + 1);
    s_end = max(s_end, s_beg);
  }
  // the key tile of visited tile n
  __device__ __forceinline__ int tile(int n, int n_pre, int s_beg) const {
    if constexpr (kPrefix) return n < n_pre ? n : s_beg + n - n_pre;
    return s_beg + n;
  }
  // is every slot of tile t valid for every row of query tile q0? (the
  // others take the per-element mask)
  __device__ __forceinline__ bool full(int q0, int t) const {
    const int kv0 = t * kBKV;
    if constexpr (kPrefix) {
      if (kv0 + kBKV <= prefix_end()) return true;
      if (kv0 < P_pad || kv0 + kBKV > P_pad + len - pl) return false;
    } else if (kv0 + kBKV > len) {
      return false;
    }
    return kv0 + kBKV <= Skv && (!causal || kv0 + kBKV - 1 - P_pad <= q0) &&
           (window <= 0 || q0 + kBQ - 1 - (kv0 - P_pad) < window);
  }
};

// the mask of request b: the prefix entry's, with the valid prefix length
// *plen read from the device, or without a prefix P_pad and pl folded to 0
// and the length Skv where no lengths are given
template <bool kPrefix>
__device__ __forceinline__ Mask<kPrefix> make_mask(const int* lens,
                                                   const int* plen, int b,
                                                   int Skv, int causal,
                                                   int window, int P_pad) {
  if constexpr (kPrefix)
    return Mask<kPrefix>{Skv, P_pad, *plen, lens[b], causal, window};
  return Mask<kPrefix>{Skv, 0, 0, lens ? lens[b] : Skv, causal, window};
}

template <int HD>
constexpr size_t smem_floats() {
  // q tile and k tile padded to HD + 1 (conflict-free row reads), v tile,
  // and the probability tile padded to kBKV + 1
  return (size_t)kBQ * (HD + 1) + (size_t)kBKV * (HD + 1) +
         (size_t)kBKV * HD + (size_t)kBQ * (kBKV + 1);
}

template <typename T, int HD, bool kPrefix>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             const int* __restrict__ lens, const int* __restrict__ plen,
             int Sq, int Skv, int H, int K, int causal, int window,
             int P_pad, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kBQ][HD + 1]
  float* k_s = q_s + kBQ * (HD + 1);        // [kBKV][HD + 1]
  float* v_s = k_s + kBKV * (HD + 1);       // [kBKV][HD]
  float* p_s = v_s + kBKV * HD;             // [kBQ][kBKV + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;   // this thread's row and half
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / K);
  const int q0 = blockIdx.x * kBQ, qi = q0 + r;
  const auto mk =
      make_mask<kPrefix>(lens, plen, b, Skv, causal, window, P_pad);
  const auto keys = mk.row(qi);

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int rr = i / HD, d = i - rr * HD, qq = q0 + rr;
    q_s[rr * (HD + 1) + d] =
        qq < Sq ? to_f32(q[(((size_t)b * Sq + qq) * H + h) * HD + d]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[HD / 2];   // head dims 2*j + half
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;

  // the visited tiles (uniform across the block, so no thread skips a
  // barrier alone)
  int n_pre, s_beg, s_end;
  mk.tiles(q0, n_pre, s_beg, s_end);
  for (int n = 0; n < n_pre + s_end - s_beg; ++n) {
    const int kv0 = mk.tile(n, n_pre, s_beg) * kBKV;
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
      const float sc = keys.valid(kk) ? dot * scale : kNegInf;
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

// ------------------------------------------------- bfloat16: tensor cores --
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct WgTile {
  static constexpr int kPad = HD <= 64 ? 64 : 128;   // head dim in smem
  static constexpr int kChunks = HD / 8;             // 16-byte chunks of data
  static constexpr int kPadChunks = kPad / 8 - kChunks;
  static constexpr int kBytes = 64 * kPad * 2;       // one 64-row tile
  // K/V tiles in the shared-memory ring, each copied kStages - 1 tiles
  // ahead of its products: 4 at hd 64 (73 KB, three blocks an SM), 3 at
  // hd 128 (113 KB)
  static constexpr int kStages = kPad == 64 ? 4 : 3;
  // Q, then kStages K tiles, then kStages V tiles; 1 KB of slack to align
  // the base to 1024 bytes (the swizzle's period)
  static constexpr size_t kSmem = 1024 + (size_t)kBytes * (1 + 2 * kStages);
};

// Copy rows [row0, row0 + 64) of a [n_rows, HD] bf16 matrix with row stride
// `stride` (elements) into a swizzled tile; rows past n_rows read as zeros.
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int n_rows, int tid) {
  using L = WgTile<HD>;
  static_assert(64 * L::kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int j = 0; j < 64 * L::kChunks / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / L::kChunks, c = i - r * L::kChunks;
    const bool in = row0 + r < n_rows;
    const __nv_bfloat16* g =
        src + (in ? (long long)(row0 + r) * stride + c * 8 : 0);
    cp_async16(dst + swizzle128(r, c), g, in);
  }
}

// The online softmax of one 64 x 64 score tile, in place on the wgmma
// accumulator fragments. s[i] is row r_lo + 8 * ((i >> 1) & 1) of the
// tile, key 8 * (i >> 2) + 2 * (lane & 3) + (i & 1). Scores are scaled into
// the log2 domain (c = scale * log2 e) and masked to kNegInf where invalid;
// the running max m is kept in that domain; l is this thread's share of
// each row's sum (the 4 threads of a row add theirs at the end). Leaves
// p = exp2(s - m) in s and returns each row's rescale factor alpha for O.
struct RowState {
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
};

template <bool kPrefix>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], RowState& st, float& a_lo, float& a_hi, bool edge,
    const RowKeys<kPrefix>& k_lo, const RowKeys<kPrefix>& k_hi, int kv0,
    int lane, float c) {
  if (edge) {   // a tile some of whose slots are masked for some row
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kk = kv0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool ok = ((i >> 1) & 1) ? k_hi.valid(kk) : k_lo.valid(kk);
      s[i] = ok ? s[i] * c : kNegInf;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= c;
  }
  float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if ((i >> 1) & 1) mx_hi = fmaxf(mx_hi, s[i]);
    else mx_lo = fmaxf(mx_lo, s[i]);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
  }
  const float mn_lo = fmaxf(st.m_lo, mx_lo), mn_hi = fmaxf(st.m_hi, mx_hi);
  a_lo = fast_exp2(st.m_lo - mn_lo);
  a_hi = fast_exp2(st.m_hi - mn_hi);
  st.m_lo = mn_lo;
  st.m_hi = mn_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if ((i >> 1) & 1) {
      s[i] = fast_exp2(s[i] - mn_hi);
      sum_hi += s[i];
    } else {
      s[i] = fast_exp2(s[i] - mn_lo);
      sum_lo += s[i];
    }
  }
  st.l_lo = a_lo * st.l_lo + sum_lo;
  st.l_hi = a_hi * st.l_hi + sum_hi;
}

// P in bf16 as the A fragments of O += P V: k-step kk (keys 16kk ..
// 16kk+15) takes s[8kk .. 8kk+7] as four pairs, the accumulator's layout
// being the A operand's.
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

template <int HD, bool kPrefix>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out,
                   const int* __restrict__ lens,
                   const int* __restrict__ plen, int Sq, int Skv, int H,
                   int K, int causal, int window, int P_pad, float scale) {
  using L = WgTile<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int kStages = L::kStages;
  unsigned char* k_s = q_s + L::kBytes;               // [kStages] tiles
  unsigned char* v_s = k_s + kStages * L::kBytes;     // [kStages] tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / K);
  // the longest causal rows first: they have the most tiles to visit
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  // this thread's two rows of the tile, as the wgmma fragments lay them
  // out: q_row and q_row + 8
  const int q_row = q0 + 16 * warp + (lane >> 2);

  const auto mk =
      make_mask<kPrefix>(lens, plen, b, Skv, causal, window, P_pad);
  const auto k_lo = mk.row(q_row), k_hi = mk.row(q_row + 8);
  // the visited key tiles, numbered n = 0 .. n_vis - 1 in the order they
  // go through the ring
  int n_pre, s_beg, s_end;
  mk.tiles(q0, n_pre, s_beg, s_end);
  const int n_vis = n_pre + s_end - s_beg;
  auto tile = [&](int n) { return mk.tile(n, n_pre, s_beg); };
  // tiles that need the per-element mask
  auto edge = [&](int n) { return !mk.full(q0, tile(n)); };

  // padded head-dim columns: zero in every tile, once (no copy writes them)
  if constexpr (L::kPadChunks > 0) {
    for (int i = tid; i < (1 + 2 * kStages) * 64 * L::kPadChunks;
         i += kThreads) {
      const int tile = i / (64 * L::kPadChunks);
      const int rem = i - tile * 64 * L::kPadChunks;
      const int r = rem / L::kPadChunks;
      const int c = L::kChunks + rem - r * L::kPadChunks;
      *reinterpret_cast<uint4*>(q_s + tile * L::kBytes + swizzle128(r, c)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const __nv_bfloat16* qg = q + ((size_t)b * Sq * H + h) * HD;
  const __nv_bfloat16* kg = k + ((size_t)b * Skv * K + kvh) * HD;
  const __nv_bfloat16* vg = v + ((size_t)b * Skv * K + kvh) * HD;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)K * HD;
  auto load_kv = [&](int n) {   // visited tile n into stage n % kStages
    if (n < n_vis) {
      const int off = (n % kStages) * L::kBytes;
      load_tile<HD>(k_s + off, kg, kv_stride, tile(n) * kBKV, Skv, tid);
      load_tile<HD>(v_s + off, vg, kv_stride, tile(n) * kBKV, Skv, tid);
    }
    cp_async_commit();
  };
  load_tile<HD>(q_s, qg, q_stride, q0, Sq, tid);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);   // Q in #0

  // descriptors: K-major (Q, K) with 8-row groups 1024 B apart; MN-major
  // (V) with 8-key groups 1024 B apart and 64-column panels 8 KB apart
  const uint64_t q_desc = smem_desc(smem_addr(q_s), 16, 1024);
  const uint64_t k_desc0 = smem_desc(smem_addr(k_s), 16, 1024);
  const uint64_t v_desc0 = smem_desc(smem_addr(v_s), 64 * 128, 1024);
  // S = Q K^T into s: HD_PAD/16 k-steps of 32 bytes along the swizzled
  // rows, a new 8 KB panel every 4 steps
  auto issue_s = [&](float (&s)[32], int n) {
    const uint64_t kd = k_desc0 + (((n % kStages) * L::kBytes) >> 4);
#pragma unroll
    for (int kk = 0; kk < L::kPad / 16; ++kk) {
      const uint64_t off = ((kk >> 2) * 8192 + (kk & 3) * 32) >> 4;
      wgmma_m64n64k16_ss(s, q_desc + off, kd + off, kk > 0);
    }
    wgmma_commit();
  };

  float o[L::kPad / 2];
#pragma unroll
  for (int i = 0; i < L::kPad / 2; ++i) o[i] = 0.f;
  RowState row;
  const float c = scale * kLog2e;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  uint32_t p[4][4];

  if (n_vis > 0) {
    cp_async_wait<kStages - 2>();   // Q and the first tile landed ...
    fence_proxy_async();   // ... are visible to wgmma ...
    __syncthreads();       // ... from every thread
    wgmma_fence();
    issue_s(s, 0);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);
    float a_lo, a_hi;
    softmax_tile(s, row, a_lo, a_hi, edge(0), k_lo, k_hi, tile(0) * kBKV,
                 lane, c);
    pack_p(s, p);
  }
  // P V for visited tile n (its P in registers, its V in its stage)
  auto issue_pv = [&](int n) {
    const uint64_t vd = v_desc0 + (((n % kStages) * L::kBytes) >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // 16 keys = two 1 KB groups a step
      if constexpr (L::kPad == 64)
        wgmma_m64n64k16_rs(o, p[kk], vd + ((kk * 2048) >> 4), 1);
      else
        wgmma_m64n128k16_rs(o, p[kk], vd + ((kk * 2048) >> 4), 1);
    }
    wgmma_commit();
  };
  // Each iteration: P_n is ready in registers and O holds tiles < n.
  // Issue S_{n+1} = Q K_{n+1}^T and O += P_n V_n on the tensor cores; the
  // softmax of tile n+1 runs in place on S while P_n V_n is in flight, and
  // P_{n+1} is packed once both are done. Every iteration issues both
  // products (the last tile's P V is peeled off below), so ptxas can tell
  // which one each wait retires and keeps them asynchronous. One barrier an
  // iteration publishes tile n+1 and frees the stage of tile n-1, whose
  // products every warp has waited for; the copy of tile n+kStages-1 then
  // goes there.
  for (int n = 0; n + 1 < n_vis; ++n) {
    cp_async_wait<kStages - 3>();   // tile n + 1 landed
    fence_proxy_async();
    __syncthreads();
    load_kv(n + kStages - 1);
#pragma unroll
    for (int i = 0; i < L::kPad / 2; ++i) fence_operand(o[i]);
    wgmma_fence();
    issue_s(s, n + 1);
    issue_pv(n);
    wgmma_wait<1>();       // S_{n+1} is done; P_n V_n may still run
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);
    float a_lo, a_hi;
    softmax_tile(s, row, a_lo, a_hi, edge(n + 1), k_lo, k_hi,
                 tile(n + 1) * kBKV, lane, c);
    wgmma_wait<0>();       // P_n V_n is done: O and P_n are free
#pragma unroll
    for (int i = 0; i < L::kPad / 2; ++i) {
      fence_operand(o[i]);
      o[i] *= ((i >> 1) & 1) ? a_hi : a_lo;
    }
    pack_p(s, p);
  }
  if (n_vis > 0) {         // the last tile's P V (landed in the last wait)
#pragma unroll
    for (int i = 0; i < L::kPad / 2; ++i) fence_operand(o[i]);
    wgmma_fence();
    issue_pv(n_vis - 1);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < L::kPad / 2; ++i) fence_operand(o[i]);
  }
  cp_async_wait<0>();      // only empty groups remain; leave none behind

  float l_lo = row.l_lo, l_hi = row.l_hi;
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o_);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o_);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  // o[4j + 2*hi + e] is row q_row + 8*hi, column 8j + 2*(lane & 3) + e
#pragma unroll
  for (int j = 0; j < L::kPad / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (col < HD) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int qi = q_row + 8 * hi;
        if (qi < Sq) {
          const float inv = hi ? inv_hi : inv_lo;
          *reinterpret_cast<uint32_t*>(
              out + ((size_t)b * Sq + qi) * H * HD + (size_t)h * HD + col) =
              pack_bf16(o[4 * j + 2 * hi] * inv, o[4 * j + 2 * hi + 1] * inv);
        }
      }
    }
  }
}

// One call's arguments, for both entry points.
struct Args {
  const void *q, *k, *v;
  void* out;
  const int* lens;   // [B] lengths in ids (null: every length Skv)
  const int* plen;   // the valid prefix length (the prefix entry only)
  int B, Sq, Skv, H, K, causal, window, P_pad;
  cudaStream_t stream;
};

template <int HD, bool kPrefix>
cudaError_t launch_f32(const Args& a) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<float, HD, kPrefix>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_kernel<float, HD, kPrefix><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lens,
      a.plen, a.Sq, a.Skv, a.H, a.K, a.causal, a.window, a.P_pad,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return cudaGetLastError();
}

template <int HD, bool kPrefix>
cudaError_t launch_bf16(const Args& a) {
  constexpr size_t smem = WgTile<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, kPrefix>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_wgmma_kernel<HD, kPrefix><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), a.lens, a.plen, a.Sq, a.Skv, a.H,
      a.K, a.causal, a.window, a.P_pad,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return cudaGetLastError();
}

template <int HD, bool kPrefix>
cudaError_t launch(int body, const Args& a) {
  switch (body) {
    case 0:
      return launch_f32<HD, kPrefix>(a);
    case 1:
      return launch_bf16<HD, kPrefix>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// each entry point takes its own build (kPrefix)
template <bool kPrefix>
cudaError_t dispatch(int hd, int body, const Args& a) {
  if (a.B <= 0 || a.Sq <= 0 || a.H <= 0) return cudaSuccess;
  if (a.Skv <= 0 || a.K <= 0 || a.H % a.K) return cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch<32, kPrefix>(body, a);
    case 64:
      return launch<64, kPrefix>(body, a);
    case 80:
      return launch<80, kPrefix>(body, a);
    case 96:
      return launch<96, kPrefix>(body, a);
    case 128:
      return launch<128, kPrefix>(body, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// body: 0 = float32 on the CUDA cores, 1 = bfloat16 on the tensor cores
// (the wrapper picks it by dtype); window <= 0 means no window; lens [B]
// (int32, on the device) each request's length, keys at or past it
// masked, or null for none. Returns a cudaError_t (0 = success).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    const int* lens, int B, int Sq, int Skv, int H, int K,
                    int hd, int causal, int window, int body, void* stream) {
  return dispatch<false>(hd, body,
                         Args{q, k, v, out, lens, nullptr, B, Sq, Skv, H, K,
                              causal, window, 0,
                              static_cast<cudaStream_t>(stream)});
}

// The prefix-masked causal prefill: k/v hold prefix_pad prefix slots, the
// first *prefix_len of them valid, then the suffix; lens [B] (int32, on the
// device) are each request's lengths in ids, and prefix_len (one int32, on
// the device, read by the kernel) must lie in [0, prefix_pad]: the wrapper
// checks it where it is known on the host, the engine where it stages it.
// A window with a prefix is refused, as in the reference.
int flash_prefix_attention(const void* q, const void* k, const void* v,
                           void* out, const int* lens,
                           const int* prefix_len, int B, int Sq, int Skv,
                           int H, int K, int hd, int prefix_pad, int window,
                           int body, void* stream) {
  if (prefix_pad < 0 || prefix_pad > Skv || (window > 0 && prefix_pad > 0) ||
      lens == nullptr || prefix_len == nullptr)
    return cudaErrorInvalidValue;
  return dispatch<true>(hd, body,
                        Args{q, k, v, out, lens, prefix_len, B, Sq, Skv, H, K,
                             1, window, prefix_pad,
                             static_cast<cudaStream_t>(stream)});
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
