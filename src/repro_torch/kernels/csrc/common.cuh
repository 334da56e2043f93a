// Device helpers shared by the flash-prefill, contiguous-decode and
// paged-decode kernels (sm_90a): conversions, a one-instruction exp2, the
// reference's finite mask value, 16-byte asynchronous and read-only
// copies, the two decode kernels' lane groups (16-byte chunks of a row in
// registers, the online softmax over a batch of rows, the merge of groups
// and warps), the 128-byte shared-memory swizzle that wgmma
// descriptors read, and the wgmma instructions with their fences.
//
// A change here changes every kernel: kernels/_build.py hashes every
// csrc/*.cuh with each source, so an edited header rebuilds them all.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// The reference's finite mask value: exp(s - m) on a fully masked score
// row stays finite (exp(0) = 1), where -INFINITY would give NaN.
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

// 2^x on the special-function unit (one instruction; denormal results
// flush to 0, relative error about 2^-22).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---------------------------------------------------------------- copies --
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, bypassing L1; 16 zero bytes
// instead where `in` is false (src is then not read, but must be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 read-only bytes from device memory into registers.
__device__ __forceinline__ uint4 ldg16(const void* src) {
  return __ldg(reinterpret_cast<const uint4*>(src));
}

// ---------------------------------------------------- decode lane groups --
// Both decode kernels stream a request's K/V rows for one KV head: a row
// is hd * itemsize contiguous bytes. A group of lanes (that size over 16,
// rounded up to a power of two: 8 lanes at bf16 hd 64) holds one row, one
// 16-byte chunk of K and of V a lane, in registers. A warp loads kRows
// rows at once and keeps kUnroll such loads in flight. Each group keeps
// its own running (m, l, acc) per query head; groups merge by shuffles
// and warps through shared memory at the end, and each split of the
// sequence writes its unnormalised (acc[hd], m, l) per head to an f32
// scratch that a second kernel merges.

constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T, int HD, int GM>
struct Lanes {
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int kChunks = HD / kElems;        // chunks a row
  static constexpr int kGroup = pow2_at_least(kChunks);   // lanes a row
  static constexpr int kRows = 32 / kGroup;          // rows a warp a load
  // rows a lane keeps in flight a batch (the K and V chunks of each, and
  // as many again for the next batch, in registers)
  static constexpr int kUnroll = GM >= 8 ? 2 : 4;
  static constexpr int kStep = kUnroll * kRows;      // rows a warp a batch
  static_assert(HD % kElems == 0 && kGroup <= 32, "unsupported head dim");
};

template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4& c, float (&f)[N]);
template <>
__device__ __forceinline__ void unpack<float, 4>(const uint4& c,
                                                 float (&f)[4]) {
  f[0] = __uint_as_float(c.x);
  f[1] = __uint_as_float(c.y);
  f[2] = __uint_as_float(c.z);
  f[3] = __uint_as_float(c.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16, 8>(const uint4& c,
                                                         float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(p[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

// Fold one batch of rows into a group's running state: slot u of the batch
// at `row` is row row + u * kRows + grp, valid below w1 (kc/vc hold zeros
// past it). A score is reduced over the group in log2(kGroup) shuffles;
// all G query heads reuse the K chunk. `empty` scores every row 0 (the
// contiguous kernel's length-0 quirk).
template <typename T, int HD, int GM>
__device__ __forceinline__ void fold_rows(
    const uint4 (&kc)[Lanes<T, HD, GM>::kUnroll],
    const uint4 (&vc)[Lanes<T, HD, GM>::kUnroll], int row, int w1, int grp,
    const float (&qf)[GM][Lanes<T, HD, GM>::kElems], int G, float scale,
    bool empty, float (&m)[GM], float (&l)[GM],
    float (&acc)[GM][Lanes<T, HD, GM>::kElems]) {
  using L = Lanes<T, HD, GM>;
  constexpr int E = L::kElems;
  float kf[L::kUnroll][E], vf[L::kUnroll][E];
  bool valid[L::kUnroll];
#pragma unroll
  for (int u = 0; u < L::kUnroll; ++u) {
    unpack<T, E>(kc[u], kf[u]);
    unpack<T, E>(vc[u], vf[u]);
    valid[u] = row + u * L::kRows + grp < w1;
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      float s[L::kUnroll];
#pragma unroll
      for (int u = 0; u < L::kUnroll; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kf[u][e], d);
#pragma unroll
        for (int o = 1; o < L::kGroup; o <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        s[u] = empty ? 0.f : d * scale;
      }
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < L::kUnroll; ++u)
        if (valid[u]) mx = fmaxf(mx, s[u]);
      const float alpha = expf(m[g] - mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < L::kUnroll; ++u) {
        const float p = valid[u] ? expf(s[u] - mx) : 0.f;
        sum += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
      }
      l[g] = alpha * l[g] + sum;
      m[g] = mx;
    }
  }
}

// Merge the running states of a block's groups (lanes with the same chunk)
// by shuffles, then of its kWarps warps through shared memory, and write
// the split's unnormalised (acc[HD], m, l) of each of the G heads to
// pb[G][HD + 2]. Every thread of the block calls it (one barrier).
template <typename T, int HD, int GM, int kWarps>
__device__ __forceinline__ void store_split(
    float (&m)[GM], float (&l)[GM],
    float (&acc)[GM][Lanes<T, HD, GM>::kElems], int G, float* pb) {
  using L = Lanes<T, HD, GM>;
  constexpr int E = L::kElems;
  __shared__ float red_m[kWarps][GM], red_l[kWarps][GM];
  __shared__ float red_acc[kWarps][GM][HD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / L::kGroup, ch = lane % L::kGroup;
#pragma unroll
  for (int o = L::kGroup; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], m_o);
      const float a = expf(m[g] - mx), a_o = expf(m_o - mx);
      l[g] = a * l[g] + a_o * l_o;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = a * acc[g][e] + a_o * acc_o;
      }
      m[g] = mx;
    }
  }
  if (grp == 0 && ch < L::kChunks) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) red_acc[warp][g][ch * E + e] = acc[g][e];
      if (ch == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += kWarps * 32) {
    const int g = i / HD, d = i - g * HD;
    float mx = red_m[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][g]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(red_m[w][g] - mx);
      a = fmaf(wt, red_acc[w][g][d], a);
      lsum = fmaf(wt, red_l[w][g], lsum);
    }
    float* row = pb + g * (HD + 2);
    row[d] = a;
    if (d == 0) {
      row[HD] = mx;
      row[HD + 1] = lsum;
    }
  }
}

// ------------------------------------------------------ 128-byte swizzle --
// A tile of bf16 rows is kept as panels of 64 columns (128 bytes a row,
// 8 KB for 64 rows). Inside a panel the 16-byte chunk c of row r sits at
// chunk c ^ (r % 8): the layout that TMA's SWIZZLE_128B writes and that a
// wgmma descriptor of layout type B128 reads. The panel base must be
// 1024-byte aligned. Returns the byte offset of (row r, chunk c) in a tile
// of 64-row panels; c counts 16-byte chunks over the whole padded row.
__device__ __forceinline__ int swizzle128(int r, int c) {
  return (c >> 3) * (64 * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// ----------------------------------------------------------------- wgmma --
// Shared-memory matrix descriptor, layout type B128 (128-byte swizzle):
// start address, leading and stride byte offsets, each in 16-byte units.
// K-major operand (rows of the contraction dim contiguous): SBO is the
// stride between 8-row groups (1024 B); LBO is unused. MN-major operand:
// SBO is the stride between groups of 8 contraction rows (1024 B) and LBO
// that between 64-column panels.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// Before a wgmma that reads registers or shared memory that plain
// instructions wrote.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins a register after wgmma_wait so that no read of it moves above.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
// Shared memory written by plain stores or cp.async, then read by wgmma
// (the async proxy): each writer fences before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B from shared memory through
// descriptors, both K-major; bf16 in, f32 accumulate; D is kept (scale_d
// = 1) or overwritten (scale_d = 0).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A from registers (four bf16
// pairs a thread, in the accumulator's fragment layout), B from shared
// memory through a descriptor, MN-major (transposed); f32 accumulate.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]; A from registers (four bf16
// pairs a thread, in the accumulator's fragment layout), B from shared
// memory through a descriptor, MN-major (transposed); f32 accumulate.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

}  // namespace
