// Single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_decode.py::flash_decode (the Pallas
// `_kernel`). Computes, for each batch row b and query head h,
// softmax(s over positions < cache_len[b]) . V with s = q . K^T * hd^-0.5,
// or cap * tanh(s / cap) under a logit softcap (Gemma-2), in the order of
// the reference's `_sdpa`; an fp32 online softmax (running max m,
// denominator l, accumulator acc). Masked positions score -1e30, so a row
// with cache_len <= 0 takes a uniform softmax over all S positions, as the
// reference does. hd is 64, 128 or 256. In bf16, P is
// rounded to V's dtype before P.V, as the Pallas kernel does (its
// `p.astype(v.dtype)`); l sums the fp32 P.
//
// What bounds it on this card: reading the KV cache. Each K/V element
// feeds 2 * rep flops (rep = H / Hkv query heads share a KV head), far below
// the ~295 flop/B at which the H100's bf16 tensor cores become the limit,
// so the least time is the valid K/V prefix's bytes over the H100 SXM's
// 3.35 TB/s. At the served decode shape (B=4, Hkv=4, S=64) that is ~0.1 us:
// what a launch costs there is latency (dependent loads and arithmetic
// inside few blocks), and at long caches it is how many SMs stream K/V at
// once and how many bytes each keeps in flight.
//
// What the design does about it:
//  - Tensor cores for both products in bf16 (mma.sync m16n8k16, fp32
//    accumulation): the rep heads of one KV group are the M side (16 a
//    block; fewer are padded, more take further blocks), 16 positions the
//    N side of the scores and the K side of P.V; the score accumulators are
//    reused in registers as P's fragments. fp32 keeps CUDA-core FMAs (TF32
//    would break the fp32 tolerance): lanes split hd and shuffle-reduce.
//  - hd 256 keeps q in shared memory (one tile per block, read by ldmatrix
//    each chunk in bf16) instead of registers: the warp's output
//    accumulators alone take 128 registers there, and q's fragments would
//    take 64 more. Its per-warp rings take 192 KB, so one block runs per SM,
//    with 4 warps x 2 chunks of 16 KB in flight. The softcap is a template
//    flag: without it each instantiation is the kernel it was before.
//  - A block's M side is 16 query heads; a KV group of rep < 16 heads
//    (Gemma-2's 2, Whisper's 1) leaves 1 - rep/16 of each tensor-core
//    product on padded rows. The cache read, which bounds the kernel, is
//    the same.
//  - Each warp owns its own 16-position chunks, brought into a private
//    three-stage shared-memory ring with 16-byte cp.async (zero-filled past
//    the valid prefix, swizzled for conflict-free ldmatrix), and keeps its
//    own (m, l, acc). The block merges its four warps once at the end: no
//    block-wide barrier per tile.
//  - S is split across blocks (flash-decoding) when B * Hkv blocks would
//    leave SMs idle: grid (Hkv * M tiles, B, splits), each split a fixed
//    run of positions (the wrapper picks it from S and the grid, since the
//    lengths live on the device); splits past a row's prefix exit at once.
//    Each split writes fp32 (m, l, acc) partials and a second small kernel
//    combines them. One split runs straight to the output.
//  - Optionally (a non-null `lse`) each row's fp32 log-sum-exp of its
//    scaled, softcapped scores, m + log(l), from the state the output is
//    normalised by: the one-split merge and the combine both hold it. A
//    caller that splits a cache across devices (context-parallel decode)
//    merges the blocks' outputs by it. In that mode a row with no valid
//    position has no positions at all (lse = -inf, out = 0), not the
//    uniform softmax above. It is a template flag, as the softcap is:
//    without `lse` each instantiation is the kernel it was before.
#include "sm90.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 16;               // query heads per block (mma's M)
constexpr int kChunk = 16;               // positions a warp takes at a time
constexpr int kStages = 3;               // per-warp K/V ring depth
constexpr float kMasked = -1e30f;

struct Args {
  const void* q;        // (B, H, hd)
  const void* k;        // (B, S, Hkv, hd)
  const void* v;
  const int* lens;      // (B,)
  void* out;            // (B, H, hd)
  float* part;          // (B, H, splits, hd + 2): acc, m, l; null if splits == 1
  float* lse;           // (B, H) log-sum-exp of each row's scores, or null
  int S, Hkv, rep, splits, split_len;
  float scale;
  float cap;            // logit softcap (> 0 only in the kCap instantiations)
};

// q stays in shared memory rather than registers from this hd on (256 in
// the served build; scripts/kernel_ab.py --b3-q builds 64 and 512 beside
// it, each into its own library, to time the choice)
#ifndef FLASH_Q_SMEM_HD
#define FLASH_Q_SMEM_HD 256
#endif

template <int HD>
__host__ __device__ constexpr bool q_in_smem() { return HD >= FLASH_Q_SMEM_HD; }

// bytes of the block's q tile in shared memory (0 when q is in registers)
template <typename T, int HD>
__host__ __device__ constexpr size_t q_bytes() {
  return q_in_smem<HD>() ? (size_t)kHeads * HD * sizeof(T) : 0;
}

// [per-warp K/V rings (bf16), reused as the merge buffer][q tile][(m, l)]
template <typename T, int HD>
__host__ __device__ constexpr size_t region_bytes() {
  const size_t ring = sizeof(T) == 2 ? (size_t)kWarps * kStages * 2 * kChunk * HD * 2 : 0;
  const size_t obuf = (size_t)kWarps * kHeads * HD * sizeof(float);
  return ring > obuf ? ring : obuf;
}

template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return region_bytes<T, HD>() + q_bytes<T, HD>() + (size_t)kWarps * kHeads * 2 * sizeof(float);
}

// the scaled score, softcapped as the reference's `softcap` does
template <bool kCap>
__device__ __forceinline__ float score(float s, float scale, float cap) {
  const float x = s * scale;
  if constexpr (kCap) return cap * tanhf(x / cap);
  return x;
}

// One warp's running softmax over its chunks, tensor-core version: the
// thread holds rows g = lane/4 and g + 8, and o's columns nt*8 + 2t, +1.
// q's A fragments live in registers, or (hd 256) in the block's shared q
// tile (16 x HD, swizzled), read with ldmatrix for each 16-column step.
template <int HD, bool kCap>
struct WarpBf16 {
  static constexpr bool kQs = q_in_smem<HD>();
  uint32_t qa[kQs ? 1 : HD / 16][4];
  const __nv_bfloat16* qs;
  float m[2], l[2];
  float o[HD / 8][4];

  __device__ void init(const __nv_bfloat16* qb, const __nv_bfloat16* q_tile, int rows,
                       int lane) {
    const int g = lane >> 2, t = lane & 3;
    qs = q_tile;
    if constexpr (!kQs) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = g + (i & 1) * 8;
          const int col = kk * 16 + (i >> 1) * 8 + 2 * t;
          qa[kk][i] = r < rows
              ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r * HD + col) : 0u;
        }
      }
    }
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }

  // positions c0 .. c0+15 from the ring stage (ks, vs: 16 x HD, swizzled)
  __device__ void step(const __nv_bfloat16* ks, const __nv_bfloat16* vs, int c0,
                       int p_end, int len, float scale, float cap, int lane) {
    const int t = lane & 3, q4 = lane >> 3, r8 = lane & 7;
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // matrices: (pos 0-7, k lo), (pos 0-7, k hi), (pos 8-15, k lo), (pos 8-15, k hi)
      const int row = r8 + (q4 >> 1) * 8;
      uint32_t b[4];
      ldsm_x4(b, ks + swizzle<__nv_bfloat16>(row, 2 * kk + (q4 & 1), HD / 8));
      if constexpr (kQs) {
        // matrices: (rows 0-7, k lo), (rows 8-15, k lo), (rows 0-7, k hi), (rows 8-15, k hi)
        uint32_t a[4];
        ldsm_x4(a, qs + swizzle<__nv_bfloat16>(r8 + (q4 & 1) * 8, 2 * kk + (q4 >> 1), HD / 8));
        mma_bf16(s[0], a, b[0], b[1]);
        mma_bf16(s[1], a, b[2], b[3]);
      } else {
        mma_bf16(s[0], qa[kk], b[0], b[1]);
        mma_bf16(s[1], qa[kk], b[2], b[3]);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = c0 + j * 8 + 2 * t + (e & 1);
        const float x = pos >= p_end ? -INFINITY
                                     : (pos >= len ? kMasked : score<kCap>(s[j][e], scale, cap));
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);    // finite: c0 < p_end
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    // the score accumulators are P's A fragment (k = the 16 positions)
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      // matrices: (pos 0-7, cols 16np..), (pos 8-15, same), (pos 0-7, +8), (pos 8-15, +8)
      const int row = r8 + (q4 & 1) * 8;
      uint32_t b[4];
      ldsm_x4_trans(b, vs + swizzle<__nv_bfloat16>(row, 2 * np + (q4 >> 1), HD / 8));
      mma_bf16(o[2 * np], pa, b[0], b[1]);
      mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
    }
  }

  // unnormalised acc, m and l of this warp into the merge buffers
  __device__ void store(float* ob, float* ml, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[(g + (e >> 1) * 8) * HD + nt * 8 + 2 * t + (e & 1)] = o[nt][e];
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ml[(g + i * 8) * 2] = m[i];
        ml[(g + i * 8) * 2 + 1] = l[i];
      }
    }
  }
};

// The fp32 version: lanes split hd (HD / 32 elements each), every lane
// holds all 16 rows' (m, l) after a butterfly reduction of each score. At
// hd 256, q is read from the block's shared q tile, laid out [row][j][lane]
// so that a warp's reads of one (row, j) hit 32 banks.
template <int HD, bool kCap>
struct WarpF32 {
  static constexpr int kV = HD / 32;
  static constexpr bool kQs = q_in_smem<HD>();
  float q[kQs ? 1 : kHeads][kV];
  const float* qs;
  float m[kHeads], l[kHeads];
  float acc[kHeads][kV];

  __device__ float qv(int r, int j, int lane) const {
    if constexpr (kQs) return qs[(r * kV + j) * 32 + lane];
    return q[r][j];
  }

  __device__ void init(const float* qb, const float* q_tile, int rows, int lane) {
    qs = q_tile;
#pragma unroll
    for (int r = 0; r < kHeads; ++r) {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        if constexpr (!kQs) q[r][j] = r < rows ? qb[(size_t)r * HD + lane * kV + j] : 0.f;
        acc[r][j] = 0.f;
      }
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
  }

  // positions c0 .. c0+15 read straight from global memory, the next
  // position's K/V row loaded while this one is scored; all 16 rows are
  // scored (padded rows have q = 0) so their shuffle chains interleave
  __device__ void step(const float* k, const float* v, size_t row_stride, int c0,
                       int p_end, int len, float scale, float cap, int lane) {
    const int end = min(c0 + kChunk, p_end);
    float kn[kV], vn[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      kn[j] = k[(size_t)c0 * row_stride + lane * kV + j];
      vn[j] = v[(size_t)c0 * row_stride + lane * kV + j];
    }
    for (int pos = c0; pos < end; ++pos) {
      float kv[kV], vv[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        kv[j] = kn[j];
        vv[j] = vn[j];
      }
      if (pos + 1 < end) {
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          kn[j] = k[(size_t)(pos + 1) * row_stride + lane * kV + j];
          vn[j] = v[(size_t)(pos + 1) * row_stride + lane * kV + j];
        }
      }
      float dot[kHeads];
#pragma unroll
      for (int r = 0; r < kHeads; ++r) {
        dot[r] = 0.f;
#pragma unroll
        for (int j = 0; j < kV; ++j) dot[r] = fmaf(qv(r, j, lane), kv[j], dot[r]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < kHeads; ++r) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
#pragma unroll
      for (int r = 0; r < kHeads; ++r) {
        const float x = pos >= len ? kMasked : score<kCap>(dot[r], scale, cap);
        const float m_new = fmaxf(m[r], x);
        const float alpha = expf(m[r] - m_new);
        const float p = expf(x - m_new);
        m[r] = m_new;
        l[r] = fmaf(l[r], alpha, p);
#pragma unroll
        for (int j = 0; j < kV; ++j) acc[r][j] = fmaf(acc[r][j], alpha, p * vv[j]);
      }
    }
  }

  __device__ void store(float* ob, float* ml, int lane) {
#pragma unroll
    for (int r = 0; r < kHeads; ++r) {
#pragma unroll
      for (int j = 0; j < kV; ++j) ob[r * HD + lane * kV + j] = acc[r][j];
      if (lane == 0) {
        ml[r * 2] = m[r];
        ml[r * 2 + 1] = l[r];
      }
    }
  }
};

template <typename T, int HD, bool kCap, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kTensor = sizeof(T) == 2;
  const int mtiles = (a.rep + kHeads - 1) / kHeads;
  const int g = blockIdx.x / mtiles, mt = blockIdx.x - g * mtiles;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int H = a.Hkv * a.rep;
  const int h0 = g * a.rep + mt * kHeads;        // first query head of the block
  const int rows = min(kHeads, a.rep - mt * kHeads);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = a.lens[b];
  // positions that can contribute: the valid prefix; with no valid position
  // every score is masked and (as in the reference) the softmax is uniform,
  // unless the caller asks for the log-sum-exp: then there is none
  const int n = len >= 1 ? min(len, a.S) : (kLse ? 0 : a.S);
  const int p_begin = sp * a.split_len;
  const int p_end = min(n, p_begin + a.split_len);
  if (p_begin >= p_end) {              // a split past this row's prefix
    if (kLse && a.splits == 1) {       // lse mode, no valid position: out 0
      for (int i = threadIdx.x; i < rows * HD; i += kThreads)
        static_cast<T*>(a.out)[((size_t)b * H + h0) * HD + i] = from_f32<T>(0.f);
      if (threadIdx.x < rows) a.lse[(size_t)b * H + h0 + threadIdx.x] = -INFINITY;
    } else if (threadIdx.x < rows) {
      float* pr = a.part + (((size_t)b * H + h0 + threadIdx.x) * a.splits + sp) * (HD + 2);
      pr[HD] = -INFINITY;
      pr[HD + 1] = 0.f;
    }
    return;
  }

  const size_t row_stride = (size_t)a.Hkv * HD;   // between positions
  const T* kb = static_cast<const T*>(a.k) + ((size_t)b * a.S * a.Hkv + g) * HD;
  const T* vb = static_cast<const T*>(a.v) + ((size_t)b * a.S * a.Hkv + g) * HD;
  const T* qb = static_cast<const T*>(a.q) + ((size_t)b * H + h0) * HD;
  const int first = p_begin + warp * kChunk, stride = kWarps * kChunk;

  using Warp = typename std::conditional<kTensor, WarpBf16<HD, kCap>, WarpF32<HD, kCap>>::type;
  T* q_tile = reinterpret_cast<T*>(smem + region_bytes<T, HD>());
  if constexpr (q_in_smem<HD>()) {
    // the block's 16 q rows (zero past `rows`) into the shared q tile
    constexpr int kCpr = HD * sizeof(T) / 16;          // 16-byte chunks per row
    for (int i = threadIdx.x; i < kHeads * kCpr; i += kThreads) {
      const int r = i / kCpr, ch = i - r * kCpr;
      const uint4 val = r < rows ? reinterpret_cast<const uint4*>(qb + (size_t)r * HD)[ch]
                                 : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (kTensor) {
        *reinterpret_cast<uint4*>(q_tile + swizzle<T>(r, ch, kCpr)) = val;
      } else {
        // element c = 4ch + e of row r is lane c / kV's j = c % kV
        const float f[4] = {__uint_as_float(val.x), __uint_as_float(val.y),
                            __uint_as_float(val.z), __uint_as_float(val.w)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * ch + e, kV = HD / 32;
          reinterpret_cast<float*>(q_tile)[(r * kV + c % kV) * 32 + c / kV] = f[e];
        }
      }
    }
    __syncthreads();
  }
  Warp w;
  w.init(qb, q_tile, rows, lane);
  if constexpr (kTensor) {
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) +
                          (size_t)warp * kStages * 2 * kChunk * HD;
    constexpr int kCpr = HD / 8;            // 16-byte chunks per K/V row
    auto issue = [&](int stage, int c0) {
      __nv_bfloat16* ks = ring + (size_t)stage * 2 * kChunk * HD;
      __nv_bfloat16* vs = ks + kChunk * HD;
#pragma unroll
      for (int i = lane; i < kChunk * kCpr; i += 32) {
        const int r = i / kCpr, ch = i - r * kCpr;
        const int pos = c0 + r;
        const bool ok = pos < p_end;
        const size_t off = (size_t)(ok ? pos : 0) * row_stride + ch * 8;
        const int dst = swizzle<__nv_bfloat16>(r, ch, kCpr);
        cp_async16(ks + dst, kb + off, ok);
        cp_async16(vs + dst, vb + off, ok);
      }
    };
    // kStages - 1 chunks in flight ahead of the one being scored; every
    // iteration commits one group (empty past the end) so the wait count holds
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (first + i * stride < p_end) issue(i, first + i * stride);
      cp_async_commit();
    }
    int it = 0;
    for (int c0 = first; c0 < p_end; c0 += stride, ++it) {
      const int ahead = c0 + (kStages - 1) * stride;
      if (ahead < p_end) issue((it + kStages - 1) % kStages, ahead);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const __nv_bfloat16* ks = ring + (size_t)(it % kStages) * 2 * kChunk * HD;
      w.step(ks, ks + kChunk * HD, c0, p_end, len, a.scale, a.cap, lane);
      __syncwarp();                         // the stage is refilled next
    }
    cp_async_wait<0>();
  } else {
    for (int c0 = first; c0 < p_end; c0 += stride)
      w.step(reinterpret_cast<const float*>(kb), reinterpret_cast<const float*>(vb),
             row_stride, c0, p_end, len, a.scale, a.cap, lane);
  }
  __syncthreads();                          // the rings become the merge buffer
  float* obuf = reinterpret_cast<float*>(smem);
  float* ml = reinterpret_cast<float*>(smem + smem_bytes<T, HD>()) - kWarps * kHeads * 2;
  w.store(obuf + (size_t)warp * kHeads * HD, ml + warp * kHeads * 2, lane);
  __syncthreads();

  // merge the warps: warps that saw no position hold m = -inf, l = 0
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, c = i - r * HD;
    float M = -INFINITY;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) M = fmaxf(M, ml[(x * kHeads + r) * 2]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) {
      const float mx = ml[(x * kHeads + r) * 2];
      if (mx == -INFINITY) continue;
      const float wgt = expf(mx - M);
      L = fmaf(ml[(x * kHeads + r) * 2 + 1], wgt, L);
      O = fmaf(obuf[((size_t)x * kHeads + r) * HD + c], wgt, O);
    }
    const size_t row = (size_t)b * H + h0 + r;
    if (a.splits == 1) {
      static_cast<T*>(a.out)[row * HD + c] = from_f32<T>(O / L);
      if (kLse && c == 0) a.lse[row] = M + logf(L);
    } else {
      float* pr = a.part + (row * a.splits + sp) * (HD + 2);
      pr[c] = O;
      if (c == 0) {
        pr[HD] = M;
        pr[HD + 1] = L;
      }
    }
  }
}

// out[row] = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M) over the splits
// of each (b, h) row; one block of HD threads per row. The split weights
// are found by all threads at once (reductions over the splits), then each
// thread sums its column over the splits with independent loads. With
// `lse`, also lse[row] = M + log(L), and a row whose every split is empty
// (possible only then) gets out 0 and lse -inf.
template <int N>
__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  __syncthreads();                          // red is reused between calls
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int x = 1; x < N / 32; ++x) v = is_max ? fmaxf(v, red[x]) : v + red[x];
  return v;
}

template <typename T, int HD, bool kLse>
__global__ void __launch_bounds__(HD)
combine_kernel(const float* __restrict__ part, T* __restrict__ out, float* __restrict__ lse,
               int splits) {
  extern __shared__ float wgt[];            // (splits,) weights e^(m_s - M)
  __shared__ float red[HD / 32];
  const size_t row = blockIdx.x;
  const float* pr = part + row * splits * (HD + 2);
  float M = -INFINITY;
  for (int s = threadIdx.x; s < splits; s += HD) M = fmaxf(M, pr[(size_t)s * (HD + 2) + HD]);
  M = block_reduce<HD>(M, true, red);       // finite unless lse mode found no position
  if (kLse && M == -INFINITY) {
    out[row * HD + threadIdx.x] = from_f32<T>(0.f);
    if (threadIdx.x == 0) lse[row] = -INFINITY;
    return;
  }
  float L = 0.f;
  for (int s = threadIdx.x; s < splits; s += HD) {
    const float* ps = pr + (size_t)s * (HD + 2);
    const float w = ps[HD] == -INFINITY ? 0.f : expf(ps[HD] - M);   // empty split
    wgt[s] = w;
    L = fmaf(ps[HD + 1], w, L);
  }
  L = block_reduce<HD>(L, false, red);      // its barriers publish wgt too
  float O = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const float w = wgt[s];
    const float v = pr[(size_t)s * (HD + 2) + threadIdx.x];   // unwritten if w == 0
    O = w != 0.f ? fmaf(v, w, O) : O;
  }
  out[row * HD + threadIdx.x] = from_f32<T>(O / L);
  if (kLse && threadIdx.x == 0) lse[row] = M + logf(L);
}

template <typename T, int HD, bool kCap, bool kLse>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, HD>();
  static_assert(smem <= 232448, "over the H100's shared memory per block");
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_kernel<T, HD, kCap, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const int mtiles = (a.rep + kHeads - 1) / kHeads;
  const dim3 grid(a.Hkv * mtiles, B, a.splits);
  flash_decode_kernel<T, HD, kCap, kLse><<<grid, kThreads, smem, s>>>(a);
  if (a.splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    combine_kernel<T, HD, kLse><<<B * a.Hkv * a.rep, HD, a.splits * sizeof(float), s>>>(
        a.part, static_cast<T*>(a.out), a.lse, a.splits);
  }
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_cap(const Args& a, int B, cudaStream_t s) {
  if (a.lse != nullptr)
    return a.cap > 0.f ? launch<T, HD, true, true>(a, B, s) : launch<T, HD, false, true>(a, B, s);
  return a.cap > 0.f ? launch<T, HD, true, false>(a, B, s) : launch<T, HD, false, false>(a, B, s);
}

template <typename T>
cudaError_t launch_hd(const Args& a, int B, int hd, cudaStream_t s) {
  if (hd == 64) return launch_cap<T, 64>(a, B, s);
  if (hd == 128) return launch_cap<T, 128>(a, B, s);
  if (hd == 256) return launch_cap<T, 256>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, hd); k, v (B, S, Hkv, hd); lens (B,) int32; out (B, H, hd); all
// contiguous, q/k/v/out one dtype, hd 64, 128 or 256. softcap: the logit
// cap (0 for none; cap * tanh(s / cap) of the scaled score s otherwise).
// part: fp32 scratch of
// B * H * splits * (hd + 2) floats, or null when splits == 1. lse: (B, H)
// fp32 for each row's log-sum-exp (then a row with no valid position gives
// out 0 and lse -inf), or null. Split sp takes
// positions [sp * split_len, (sp + 1) * split_len) of each row's prefix;
// splits * split_len must cover S. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lens, void* out, void* part, void* lse, int B,
                                   int S, int Hkv, int rep, int hd, int splits,
                                   int split_len, float scale, float softcap,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hkv <= 0 || rep <= 0 || S <= 0 || splits <= 0 || split_len <= 0 ||
      (long long)splits * split_len < S || (splits > 1 && part == nullptr) ||
      !(softcap >= 0.f))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(lens), out, static_cast<float*>(part),
               static_cast<float*>(lse), S, Hkv, rep, splits, split_len, scale, softcap};
  if (dtype == kFloat32) return launch_hd<float>(a, B, hd, s);
  if (dtype == kBFloat16) return launch_hd<__nv_bfloat16>(a, B, hd, s);
  return cudaErrorInvalidValue;
}
