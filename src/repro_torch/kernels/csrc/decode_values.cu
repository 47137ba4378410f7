// The softmax and p . V of decode over a head_dim slice for Hopper
// (sm_90a): B3-pv, the second of B3's two halves over a head_dim-sharded
// cache.
//
// Replaces: no Pallas kernel of its own. It is the masked softmax and
// p . V of repro/kernels/flash_decode.py::flash_decode (the Pallas
// `_kernel`), run on one rank's V slice after decode_scores.cu (B3-qk)
// wrote each rank's partial scores and an all-reduce over the model axis
// summed them: the partitioning GSPMD gives the reference's decode over a
// cache sharded on head_dim. Every rank holds the same summed scores and
// writes its own head_dim slice of the output.
//
// Computes, for each batch row b and query head h, over the positions
// t < lens[b]: c = cap * tanh(s / cap) of the summed score s under a logit
// softcap (Gemma-2; s itself without one), as B3 applies it; the softmax of
// c; out = softmax . V[:, h / rep, :] over the slice's hd_l columns, in V's
// dtype; and, with a non-null `lse`, each row's fp32 log-sum-exp of c, as
// B3 returns it for merging blocks of a sequence-sharded cache. A row with
// no valid position gives out 0 and lse -inf, as B3 gives them in its lse
// mode. Scores past the length are never used. An fp32 online softmax; in
// bf16, P is rounded to V's dtype before P . V, as B3 and the Pallas kernel
// (`p.astype(v.dtype)`) do, and l sums the fp32 P.
//
// What bounds it on this card: bytes, as B3: the valid scores (fp32) and
// the valid V prefix are each read once and the output written once; each
// V element feeds 2 * rep flops (kernels/bounds.py::decode_values).
//
// What the design does about it (B3's machinery, csrc/flash_decode.cu, on
// the summed scores instead of q . K^T):
//  - grid (Hkv * M tiles, B, splits): a block takes one KV group's query
//    heads (16 a tile: mma's M; fewer are padded, more take further blocks)
//    over one split of the positions (flash-decoding: the wrapper picks the
//    split from S and the grid alone, since the lengths live on the device,
//    aiming at ~8 blocks an SM over a full cache: decode_split.splits).
//  - Each of the block's four warps owns its own 32-position steps (two
//    16-position tensor-core tiles), brought into a private shared-memory
//    ring by 16-byte cp.async: V in bf16, swizzled for ldmatrix, zero-filled
//    past the valid prefix; beside it the 16 x 32 fp32 scores of the tile's
//    heads (rows XOR-swizzled so that the quads' 8-byte reads hit distinct
//    banks), read into registers in the mma accumulator layout. The ring
//    takes as many stages (2 to 4) as fit 48 KB a block, so that four
//    blocks share an SM up to hd_l 64 (hd_l 128 takes 2 stages, 80 KB).
//  - Each warp keeps its own (m, l, acc) in registers: the online softmax
//    reduces over the quad by shuffles and rescales once a step, the
//    softcap is a template flag as in B3, P = exp(c - m) by the SFU's
//    exp2 (__expf), and P (rounded to bf16) is the A fragment of m16n8k16
//    tensor-core products against V (K = the positions, N = hd_l). The four
//    warps merge once at the end: no block-wide barrier per step.
//  - One split writes the output (and lse) itself; more write fp32
//    (acc, m, l) partials and a second small kernel combines them: each
//    split's (m, l) read once, the accumulators of the splits that weigh
//    anything read eight splits at a time, summed in a fixed order.
//  - fp32 (and bf16 at hd_l 4, below the tensor cores' N of 8, or T not a
//    multiple of 4) keeps CUDA-core FMAs, as B3's fp32 path does: a warp
//    takes 32 positions at a time, a lane a position's score per head, so
//    the chunk's max and rescale are warp reductions and each lane's weight
//    one exp; then lanes split hd_l (4 columns each) and positions, take
//    each position's weight by a shuffle, and the partial sums over
//    positions are shuffle-reduced at the end. No TF32.
//
// Measured (chip_smoke.py phase 18a, H100 SXM 80 GB at 700 W, the
// 32768-position cache: B 4, H 64, Hkv 4, hd 128, lengths 32768 / 16384 /
// 8192 / 1, bf16, one of 2 / 4 / 16 slices, L2-warm): 0.0270 / 0.0161 /
// 0.0132 ms (L2-cold 0.0310 / 0.0240 / 0.0201), 49 / 54 / 41 % of the
// bound; the first design (fp32 staging, accumulators in shared memory,
// three barriers a chunk) took 0.2310 / 0.1365 / 0.0698. What holds it: the
// loads. At 2 slices a timing-only scratch build that skipped the math
// after each warp's first step took about the whole time, near the rate
// unsplit B3 reaches over the whole cache through the same 16-byte
// cp.async (phase 18a's reference line); 16-position warp steps measured
// slower at every slice and were not kept.
//
// The split rule sits in kernels/decode_split.py: its TILE must equal
// kWarps * kStep (the positions a block takes a step) and its HEADS kHeads;
// decode_values_launch refuses a split_len that is not a multiple of
// kWarps * kStep when it splits.
#include "sm90.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 16;               // query heads of a block (mma's M)
constexpr int kChunk = 16;               // positions of a tensor-core tile (mma's K)
constexpr int kFmaChunk = 32;            // positions a CUDA-core warp takes at a time
constexpr int kMaxSplits = 4096;         // the combine keeps 8 bytes a split in shared memory
constexpr int kMaxSmem = 232448;         // the H100's shared memory a block

struct Args {
  const float* scores;  // (B, H, T) summed over the slices
  const void* v;        // (B, T, Hkv, hd_l)
  const int* lens;      // (B,)
  void* out;            // (B, H, hd_l)
  float* part;          // (B, H, splits, hd_l + 2): acc, m, l; null if splits == 1
  float* lse;           // (B, H) or null
  int T, Hkv, rep, splits, split_len;
  float cap;            // logit softcap, 0 for none
};

__device__ __forceinline__ float capped(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// the softcap as B3 applies it, decided when the kernel is compiled
template <bool kCap>
__device__ __forceinline__ float capped_if(float s, float cap) {
  if constexpr (kCap) return cap * tanhf(s / cap);
  return s;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's place: KV group g, M tile mt (rows query heads from h0), batch
// row b, split sp over positions [p_begin, p_end) of the valid prefix.
struct Tile {
  int g, mt, b, sp, h0, rows, p_begin, p_end;
  __device__ Tile(const Args& a) {
    const int mtiles = (a.rep + kHeads - 1) / kHeads;
    g = blockIdx.x / mtiles;
    mt = blockIdx.x - g * mtiles;
    b = blockIdx.y;
    sp = blockIdx.z;
    h0 = g * a.rep + mt * kHeads;
    rows = min(kHeads, a.rep - mt * kHeads);
    const int len = min(a.lens[b], a.T);
    p_begin = sp * a.split_len;
    p_end = min(p_begin + a.split_len, len);
  }
};

// a split with no valid position: out 0 and lse -inf when it is the only
// split, else partials that weigh 0 in the combine
template <typename T, int HD>
__device__ void write_empty(const Args& a, const Tile& tl) {
  const size_t row0 = (size_t)tl.b * a.Hkv * a.rep + tl.h0;
  if (a.splits == 1) {
    for (int i = threadIdx.x; i < tl.rows * HD; i += kThreads)
      static_cast<T*>(a.out)[row0 * HD + i] = from_f32<T>(0.f);
    if (a.lse != nullptr && threadIdx.x < tl.rows) a.lse[row0 + threadIdx.x] = -INFINITY;
  } else if (threadIdx.x < tl.rows) {
    float* pr = a.part + ((row0 + threadIdx.x) * a.splits + tl.sp) * (HD + 2);
    pr[HD] = -INFINITY;
    pr[HD + 1] = 0.f;
  }
}

// merge the warps' (acc, m, l) (obuf: kWarps x kHeads x HD; ml: kWarps x
// kHeads x (m, l); a warp that saw no position holds m -inf, l 0) into the
// output and lse (one split) or the split's partials
template <typename T, int HD>
__device__ void merge(const Args& a, const Tile& tl, const float* obuf, const float* ml) {
  const size_t row0 = (size_t)tl.b * a.Hkv * a.rep + tl.h0;
  for (int i = threadIdx.x; i < tl.rows * HD; i += kThreads) {
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
    const size_t row = row0 + r;
    if (a.splits == 1) {                   // L > 0: the split has a valid position
      static_cast<T*>(a.out)[row * HD + c] = from_f32<T>(O / L);
      if (a.lse != nullptr && c == 0) a.lse[row] = M + logf(L);
    } else {
      float* pr = a.part + (row * a.splits + tl.sp) * (HD + 2);
      pr[c] = O;
      if (c == 0) {
        pr[HD] = M;
        pr[HD + 1] = L;
      }
    }
  }
}

// ---------------------------------------------------------------- tensor cores

constexpr int kSub = 2;                  // 16-position tiles a warp step takes
constexpr int kStep = kSub * kChunk;     // positions a warp step takes
constexpr int kRingBytes = 49152;        // a block's rings: 4 blocks an SM

// bytes of one warp's ring stage: V (kStep x HD bf16), then the scores
// (16 rows x kStep fp32)
template <int HD>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)kStep * HD * 2 + (size_t)kHeads * kStep * 4;
}

// ring stages a warp: as many as fit kRingBytes a block, 2 to 4
template <int HD>
__host__ __device__ constexpr int tc_stages() {
  const int n = (int)(kRingBytes / (kWarps * stage_bytes<HD>()));
  return n < 2 ? 2 : (n > 4 ? 4 : n);
}

// [per-warp rings, reused as the merge buffer][(m, l) of each warp's rows]
template <int HD>
__host__ __device__ constexpr size_t tc_smem() {
  const size_t ring = (size_t)kWarps * tc_stages<HD>() * stage_bytes<HD>();
  const size_t obuf = (size_t)kWarps * kHeads * HD * 4;
  return (ring > obuf ? ring : obuf) + (size_t)kWarps * kHeads * 2 * 4;
}

// 16-byte chunk ch of score row r in the stage: a quad reads 2 chunks of a
// row at a time and a half-warp 4 rows, whose starts share banks; the XOR
// spreads them over the 32 banks
__device__ __forceinline__ int score_chunk(int r, int ch) {
  return r * (kStep / 4) + (ch ^ ((r & 3) << 1));
}

// One warp's running softmax over its steps: the thread holds rows g =
// lane/4 and g + 8, and o's columns nt*8 + 2t, +1 (mma's accumulator layout).
template <int HD, bool kCap>
struct WarpTC {
  float m[2], l[2];
  float o[HD / 8][4];

  __device__ void init() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }

  // positions c0 .. c0 + kStep - 1 from the ring stage: vs (kStep x HD,
  // swizzled), ss (16 rows x kStep fp32, score_chunk's layout; rows past the
  // tile's heads hold 0)
  __device__ void step(const __nv_bfloat16* vs, const float* ss, int c0, int p_end,
                       float cap, int lane) {
    const int g = lane >> 2, t = lane & 3, q4 = lane >> 3, r8 = lane & 7;
    constexpr int kN = 2 * kSub;           // 8-position tiles of the step
    float s[kN][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        // positions j*8 + 2t, +1: chunk 2j + t/2 of the row, floats 2(t%2), +1
        const float2 x = *reinterpret_cast<const float2*>(
            ss + score_chunk(r, 2 * j + (t >> 1)) * 4 + 2 * (t & 1));
        s[j][2 * i] = x.x;
        s[j][2 * i + 1] = x.y;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = c0 + j * 8 + 2 * t + (e & 1);
        const float x = pos >= p_end ? -INFINITY : capped_if<kCap>(s[j][e], cap);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);    // finite: c0 < p_end
      alpha[i] = __expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
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
    constexpr int kCpr = HD / 8;
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      // P's A fragment for positions 16u .. 16u + 15 (the k side), rounded to bf16
      const uint32_t pa[4] = {pack_bf16(s[2 * u][0], s[2 * u][1]),
                              pack_bf16(s[2 * u][2], s[2 * u][3]),
                              pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]),
                              pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3])};
      if constexpr (HD >= 16) {
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          // matrices: (pos 0-7, cols 16np..), (pos 8-15, same), (pos 0-7, +8), (pos 8-15, +8)
          uint32_t b[4];
          ldsm_x4_trans(b, vs + swizzle_chunk<kCpr>(16 * u + r8 + (q4 & 1) * 8,
                                                    2 * np + (q4 >> 1)) * 8);
          mma_bf16(o[2 * np], pa, b[0], b[1]);
          mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
        }
      } else {
        // hd_l 8: matrices (pos 0-7, cols 0-7), (pos 8-15, cols 0-7)
        uint32_t b[2];
        ldsm_x2_trans(b, vs + swizzle_chunk<kCpr>(16 * u + (lane & 15), 0) * 8);
        mma_bf16(o[0], pa, b[0], b[1]);
      }
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

template <int HD, bool kCap>
__global__ void __launch_bounds__(kThreads) values_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using bf16 = __nv_bfloat16;
  const Tile tl(a);
  if (tl.p_begin >= tl.p_end) {
    write_empty<bf16, HD>(a, tl);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int T = a.T, H = a.Hkv * a.rep;
  const int p_end = tl.p_end;
  const size_t row_stride = (size_t)a.Hkv * HD;            // V elements between positions
  const bf16* vb = static_cast<const bf16*>(a.v) + ((size_t)tl.b * T * a.Hkv + tl.g) * HD;
  const float* sb = a.scores + ((size_t)tl.b * H + tl.h0) * T;
  constexpr int kStages = tc_stages<HD>();
  unsigned char* ring = smem + (size_t)warp * kStages * stage_bytes<HD>();
  constexpr int kCpr = HD / 8;                             // 16-byte chunks a V row
  auto issue = [&](int stage, int c0) {
    bf16* vs = reinterpret_cast<bf16*>(ring + (size_t)stage * stage_bytes<HD>());
    float* ss = reinterpret_cast<float*>(vs + kStep * HD);
#pragma unroll
    for (int i = lane; i < kStep * kCpr; i += 32) {
      const int r = i / kCpr, ch = i - r * kCpr;
      const int pos = c0 + r;
      const bool ok = pos < p_end;
      cp_async16(vs + swizzle_chunk<kCpr>(r, ch) * 8,
                 vb + (size_t)(ok ? pos : 0) * row_stride + ch * 8, ok);
    }
#pragma unroll
    for (int i = lane; i < kHeads * kStep / 4; i += 32) {
      const int r = i / (kStep / 4), ch = i - r * (kStep / 4);
      const int pos = c0 + ch * 4;                         // pos + 3 < T: T % 4 == 0
      const bool ok = r < tl.rows && pos < p_end;
      cp_async16(ss + score_chunk(r, ch) * 4, ok ? sb + (size_t)r * T + pos : sb, ok);
    }
  };
  const int first = tl.p_begin + warp * kStep, stride = kWarps * kStep;
  WarpTC<HD, kCap> w;
  w.init();
  // kStages - 1 steps in flight ahead of the one being used; every
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
    const bf16* vs =
        reinterpret_cast<const bf16*>(ring + (size_t)(it % kStages) * stage_bytes<HD>());
    const float* ss = reinterpret_cast<const float*>(vs + kStep * HD);
    w.step(vs, ss, c0, p_end, a.cap, lane);
    __syncwarp();                                          // the stage is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();                                         // the rings become the merge buffer
  float* obuf = reinterpret_cast<float*>(smem);
  float* ml = reinterpret_cast<float*>(smem + tc_smem<HD>()) - kWarps * kHeads * 2;
  w.store(obuf + (size_t)warp * kHeads * HD, ml + warp * kHeads * 2, lane);
  __syncthreads();
  merge<bf16, HD>(a, tl, obuf, ml);
}

// ------------------------------------------------------------------ CUDA cores

template <int HD>
__host__ __device__ constexpr size_t fma_smem() {
  return (size_t)kWarps * kHeads * HD * 4 + (size_t)kWarps * kHeads * 2 * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) values_fma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLpp = HD / 4;             // lanes a position (4 columns a lane)
  constexpr int kNp = 32 / kLpp;           // positions a warp step takes
  const Tile tl(a);
  if (tl.p_begin >= tl.p_end) {
    write_empty<T, HD>(a, tl);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pp = lane / kLpp, cl = lane - pp * kLpp;
  const int S = a.T, H = a.Hkv * a.rep, rows = tl.rows, p_end = tl.p_end;
  const size_t row_stride = (size_t)a.Hkv * HD;
  const T* vb = static_cast<const T*>(a.v) + ((size_t)tl.b * S * a.Hkv + tl.g) * HD + cl * 4;
  const float* sb = a.scores + ((size_t)tl.b * H + tl.h0) * S;
  float m[kHeads], l[kHeads], acc[kHeads][4];
#pragma unroll
  for (int r = 0; r < kHeads; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  for (int c0 = tl.p_begin + warp * kFmaChunk; c0 < p_end; c0 += kWarps * kFmaChunk) {
    const int pos = c0 + lane;                             // this lane's score
    const bool ok = pos < p_end;
    float p[kHeads];
#pragma unroll
    for (int r = 0; r < kHeads; ++r) {
      if (r >= rows) continue;
      const float x = ok ? capped(sb[(size_t)r * S + pos], a.cap) : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));       // finite: c0 < p_end
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      p[r] = expf(x - m_new);
      l[r] = fmaf(l[r], alpha, p[r]);                      // this lane's share of l
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= alpha;
    }
#pragma unroll 4
    for (int j0 = 0; j0 < kFmaChunk; j0 += kNp) {
      const int j = j0 + pp;                               // the position this lane adds
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (c0 + j < p_end) load4(vb + (size_t)(c0 + j) * row_stride, v);
#pragma unroll
      for (int r = 0; r < kHeads; ++r) {
        if (r >= rows) continue;
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(pj, v[e], acc[r][e]);
      }
    }
  }
  // sums over the positions a warp step spread over lanes, and over l's lanes
#pragma unroll
  for (int r = 0; r < kHeads; ++r) {
    l[r] = warp_sum(l[r]);
#pragma unroll
    for (int o = kLpp; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  }
  float* obuf = reinterpret_cast<float*>(smem);
  float* ml = obuf + kWarps * kHeads * HD;
  float* ob = obuf + (size_t)warp * kHeads * HD;
  if (pp == 0) {
#pragma unroll
    for (int r = 0; r < kHeads; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) ob[r * HD + cl * 4 + e] = acc[r][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kHeads; ++r) {
      ml[(warp * kHeads + r) * 2] = m[r];
      ml[(warp * kHeads + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  merge<T, HD>(a, tl, obuf, ml);
}

// ---------------------------------------------------------------- the combine

// out[row] = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M) over the splits
// of each (b, h) row (an empty split has m -inf and weighs 0); lse = M +
// log(L); a row whose every split is empty gets out 0 and lse -inf. One
// block a row: the splits' (m, l) read once into shared memory, then warp w
// sums the splits w, w + 4, ... that weigh anything (a lane a column; the
// loads of 8 splits in flight, predicated on the weight), and the four
// warps' sums add in a fixed order.
__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();                                    // red is reused between calls
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int x = 1; x < kWarps; ++x) v = is_max ? fmaxf(v, red[x]) : v + red[x];
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part, T* __restrict__ out, float* __restrict__ lse,
               int splits) {
  constexpr int kCols = (HD + 31) / 32;              // columns a lane
  extern __shared__ float2 ml_s[];                   // (splits,): (m, l), then (weight, l)
  __shared__ float red[kWarps];
  __shared__ float osum[kWarps][HD];
  const size_t row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* pr = part + row * splits * (HD + 2);
  float M = -INFINITY, L = 0.f;
  for (int s = threadIdx.x; s < splits; s += kThreads) {
    const float2 x = *reinterpret_cast<const float2*>(pr + (size_t)s * (HD + 2) + HD);
    ml_s[s] = x;
    M = fmaxf(M, x.x);
  }
  M = block_reduce(M, true, red);                     // its barriers publish ml_s too
  if (M == -INFINITY) {
    for (int c = threadIdx.x; c < HD; c += kThreads) out[row * HD + c] = from_f32<T>(0.f);
    if (lse != nullptr && threadIdx.x == 0) lse[row] = -INFINITY;
    return;
  }
  for (int s = threadIdx.x; s < splits; s += kThreads) {
    const float2 x = ml_s[s];
    const float w = x.x == -INFINITY ? 0.f : expf(x.x - M);
    ml_s[s].x = w;
    L = fmaf(x.y, w, L);
  }
  L = block_reduce(L, false, red);                    // and the weights
  float o[kCols] = {};
#pragma unroll 8
  for (int s = warp; s < splits; s += kWarps) {
    const float w = ml_s[s].x;                        // warp-uniform; 0: never written
    const float* ps = pr + (size_t)s * (HD + 2);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      const float v = w != 0.f && c < HD ? ps[c] : 0.f;
      o[j] = fmaf(v, w, o[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    if (c < HD) osum[warp][c] = o[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < HD; c += kThreads) {
    float v = osum[0][c];
#pragma unroll
    for (int x = 1; x < kWarps; ++x) v += osum[x][c];
    out[row * HD + c] = from_f32<T>(v / L);
  }
  if (lse != nullptr && threadIdx.x == 0) lse[row] = M + logf(L);
}

// ---------------------------------------------------------------------- launch

template <typename T, int HD, bool kTC, bool kCap = false>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  constexpr size_t smem = kTC ? tc_smem<HD>() : fma_smem<HD>();
  static_assert(smem <= (size_t)kMaxSmem, "over the H100's shared memory per block");
  const void* kernel;
  if constexpr (kTC)
    kernel = reinterpret_cast<const void*>(values_tc_kernel<HD, kCap>);
  else
    kernel = reinterpret_cast<const void*>(values_fma_kernel<T, HD>);
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.Hkv * ((a.rep + kHeads - 1) / kHeads), B, a.splits);
  if constexpr (kTC)
    values_tc_kernel<HD, kCap><<<grid, kThreads, smem, s>>>(a);
  else
    values_fma_kernel<T, HD><<<grid, kThreads, smem, s>>>(a);
  if (a.splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    combine_kernel<T, HD><<<B * a.Hkv * a.rep, kThreads, a.splits * sizeof(float2), s>>>(
        a.part, static_cast<T*>(a.out), a.lse, a.splits);
  }
  return cudaGetLastError();
}

template <typename T, bool kTC>
cudaError_t launch_hd(const Args& a, int B, int hd, cudaStream_t s) {
  if constexpr (!kTC) {
    if (hd == 4) return launch<T, 4, false>(a, B, s);
  }
  if constexpr (kTC) {
    if (a.cap > 0.f) {
      if (hd == 8) return launch<T, 8, true, true>(a, B, s);
      if (hd == 16) return launch<T, 16, true, true>(a, B, s);
      if (hd == 32) return launch<T, 32, true, true>(a, B, s);
      if (hd == 64) return launch<T, 64, true, true>(a, B, s);
      if (hd == 128) return launch<T, 128, true, true>(a, B, s);
      return cudaErrorInvalidValue;
    }
  }
  if (hd == 8) return launch<T, 8, kTC>(a, B, s);
  if (hd == 16) return launch<T, 16, kTC>(a, B, s);
  if (hd == 32) return launch<T, 32, kTC>(a, B, s);
  if (hd == 64) return launch<T, 64, kTC>(a, B, s);
  if (hd == 128) return launch<T, 128, kTC>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// scores (B, H, T) fp32 with H = Hkv * rep; v (B, T, Hkv, hd); lens (B,)
// int32; out (B, H, hd) in v's dtype; all contiguous and 16-byte aligned;
// hd, the slice's head_dim, is 4, 8, 16, 32, 64 or 128. part: fp32 scratch
// of B * H * splits * (hd + 2) floats, or null when splits == 1. lse: (B, H)
// fp32, or null. softcap: 0 for none. Split sp takes positions
// [sp * split_len, (sp + 1) * split_len) of each row's valid prefix;
// splits * split_len must cover T, and with more than one split split_len
// is a multiple of kWarps * kStep = 128 (decode_split.TILE). Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int decode_values_launch(const void* scores, const void* v, const void* lens,
                                    void* out, void* part, void* lse, int B, int T, int Hkv,
                                    int rep, int hd, int splits, int split_len,
                                    float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || Hkv <= 0 || rep <= 0 || splits <= 0 || split_len <= 0 ||
      (long long)splits * split_len < T || B > 65535 || splits > 65535 ||
      (splits > 1 && (part == nullptr || split_len % (kWarps * kStep) != 0)) ||
      !(softcap >= 0.f) || splits > kMaxSplits)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(scores), v, static_cast<const int*>(lens), out,
               static_cast<float*>(part), static_cast<float*>(lse), T, Hkv, rep,
               splits, split_len, softcap};
  if (dtype == kFloat32) return launch_hd<float, false>(a, B, hd, s);
  if (dtype == kBFloat16) {
    // the tensor cores need hd_l >= 8 (mma's N) and T % 4 == 0 (16-byte score rows)
    if (hd >= 8 && T % 4 == 0) return launch_hd<__nv_bfloat16, true>(a, B, hd, s);
    return launch_hd<__nv_bfloat16, false>(a, B, hd, s);
  }
  return cudaErrorInvalidValue;
}
