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

__device__ __forceinline__ void softmax_tile(
    float (&s)[32], RowState& st, float& a_lo, float& a_hi, bool edge,
    int q_row, int kv0, int lane, int Skv, int causal, int window,
    float c) {
  if (edge) {   // a tile on the causal diagonal, the window's edge or Skv
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qi = q_row + 8 * ((i >> 1) & 1);
      const int kk = kv0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      bool valid = kk < Skv;
      if (causal) valid = valid && qi >= kk;
      if (window > 0) valid = valid && qi - kk < window;
      s[i] = valid ? s[i] * c : kNegInf;
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                   int K, int causal, int window, float scale) {
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

  // the TPU kernel's whole-tile skip test, on this kernel's 64-key tiles,
  // as loop bounds: causal skips kv0 > q0 + 63, a window kv0 + 63 <=
  // q0 - window
  int t_end = (Skv + kBKV - 1) / kBKV;
  if (causal) t_end = min(t_end, (q0 + kBQ - 1) / kBKV + 1);
  int t_beg = 0;
  if (window > 0 && q0 - window - (kBKV - 1) >= 0)
    t_beg = (q0 - window - (kBKV - 1)) / kBKV + 1;
  // tiles that need the per-element mask: past Skv, across the causal
  // diagonal or across the window's far edge
  auto edge = [&](int t) {
    const int kv0 = t * kBKV;
    return kv0 + kBKV > Skv || (causal && kv0 + kBKV - 1 > q0) ||
           (window > 0 && q0 + kBQ - 1 - kv0 >= window);
  };

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
  auto load_kv = [&](int t) {   // tile t into stage (t - t_beg) % kStages
    if (t < t_end) {
      const int off = ((t - t_beg) % kStages) * L::kBytes;
      load_tile<HD>(k_s + off, kg, kv_stride, t * kBKV, Skv, tid);
      load_tile<HD>(v_s + off, vg, kv_stride, t * kBKV, Skv, tid);
    }
    cp_async_commit();
  };
  load_tile<HD>(q_s, qg, q_stride, q0, Sq, tid);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(t_beg + j);   // Q in #0

  // descriptors: K-major (Q, K) with 8-row groups 1024 B apart; MN-major
  // (V) with 8-key groups 1024 B apart and 64-column panels 8 KB apart
  const uint64_t q_desc = smem_desc(smem_addr(q_s), 16, 1024);
  const uint64_t k_desc0 = smem_desc(smem_addr(k_s), 16, 1024);
  const uint64_t v_desc0 = smem_desc(smem_addr(v_s), 64 * 128, 1024);
  // S = Q K^T into s: HD_PAD/16 k-steps of 32 bytes along the swizzled
  // rows, a new 8 KB panel every 4 steps
  auto issue_s = [&](float (&s)[32], int t) {
    const uint64_t kd =
        k_desc0 + ((((t - t_beg) % kStages) * L::kBytes) >> 4);
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

  if (t_beg < t_end) {
    cp_async_wait<kStages - 2>();   // Q and the first tile landed ...
    fence_proxy_async();   // ... are visible to wgmma ...
    __syncthreads();       // ... from every thread
    wgmma_fence();
    issue_s(s, t_beg);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);
    float a_lo, a_hi;
    softmax_tile(s, row, a_lo, a_hi, edge(t_beg), q_row, t_beg * kBKV, lane,
                 Skv, causal, window, c);
    pack_p(s, p);
  }
  // P V for tile t (its P in registers, its V in its stage)
  auto issue_pv = [&](int t) {
    const uint64_t vd =
        v_desc0 + ((((t - t_beg) % kStages) * L::kBytes) >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // 16 keys = two 1 KB groups a step
      if constexpr (L::kPad == 64)
        wgmma_m64n64k16_rs(o, p[kk], vd + ((kk * 2048) >> 4), 1);
      else
        wgmma_m64n128k16_rs(o, p[kk], vd + ((kk * 2048) >> 4), 1);
    }
    wgmma_commit();
  };
  // Each iteration: P_t is ready in registers and O holds tiles < t.
  // Issue S_{t+1} = Q K_{t+1}^T and O += P_t V_t on the tensor cores; the
  // softmax of tile t+1 runs in place on S while P_t V_t is in flight, and
  // P_{t+1} is packed once both are done. Every iteration issues both
  // products (the last tile's P V is peeled off below), so ptxas can tell
  // which one each wait retires and keeps them asynchronous. One barrier an
  // iteration publishes tile t+1 and frees the stage of tile t-1, whose
  // products every warp has waited for; the copy of tile t+kStages-1 then
  // goes there.
  for (int t = t_beg; t + 1 < t_end; ++t) {
    cp_async_wait<kStages - 3>();   // tile t + 1 landed
    fence_proxy_async();
    __syncthreads();
    load_kv(t + kStages - 1);
#pragma unroll
    for (int i = 0; i < L::kPad / 2; ++i) fence_operand(o[i]);
    wgmma_fence();
    issue_s(s, t + 1);
    issue_pv(t);
    wgmma_wait<1>();       // S_{t+1} is done; P_t V_t may still run
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);
    float a_lo, a_hi;
    softmax_tile(s, row, a_lo, a_hi, edge(t + 1), q_row, (t + 1) * kBKV,
                 lane, Skv, causal, window, c);
    wgmma_wait<0>();       // P_t V_t is done: O and P_t are free
#pragma unroll
    for (int i = 0; i < L::kPad / 2; ++i) {
      fence_operand(o[i]);
      o[i] *= ((i >> 1) & 1) ? a_hi : a_lo;
    }
    pack_p(s, p);
  }
  if (t_beg < t_end) {     // the last tile's P V (landed in the last wait)
#pragma unroll
    for (int i = 0; i < L::kPad / 2; ++i) fence_operand(o[i]);
    wgmma_fence();
    issue_pv(t_end - 1);
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

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Skv, int H, int K, int causal,
                       int window, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<float, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<float, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, K,
      causal, window,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Skv, int H, int K,
                        int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = WgTile<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_wgmma_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, H, K, causal, window,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int body, const void* q, const void* k, const void* v,
                   void* out, int B, int Sq, int Skv, int H, int K,
                   int causal, int window, cudaStream_t s) {
  switch (body) {
    case 0:
      return launch_f32<HD>(q, k, v, out, B, Sq, Skv, H, K, causal, window, s);
    case 1:
      return launch_bf16<HD>(q, k, v, out, B, Sq, Skv, H, K, causal, window,
                             s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// body: 0 = float32 on the CUDA cores, 1 = bfloat16 on the tensor cores
// (the wrapper picks it by dtype); window <= 0 means no window.
// Returns a cudaError_t (0 = success).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Skv, int H, int K, int hd, int causal,
                    int window, int body, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaSuccess;
  if (Skv <= 0 || K <= 0 || H % K) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(body, q, k, v, out, B, Sq, Skv, H, K, causal, window,
                        s);
    case 64:
      return launch<64>(body, q, k, v, out, B, Sq, Skv, H, K, causal, window,
                        s);
    case 80:
      return launch<80>(body, q, k, v, out, B, Sq, Skv, H, K, causal, window,
                        s);
    case 96:
      return launch<96>(body, q, k, v, out, B, Sq, Skv, H, K, causal, window,
                        s);
    case 128:
      return launch<128>(body, q, k, v, out, B, Sq, Skv, H, K, causal, window,
                         s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
