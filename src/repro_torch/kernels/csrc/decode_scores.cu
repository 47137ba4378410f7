// Partial decode scores over a head_dim slice for Hopper (sm_90a): B3-qk,
// the first of B3's two halves over a head_dim-sharded cache.
//
// Replaces: no Pallas kernel of its own. It is q . K^T of
// repro/kernels/flash_decode.py::flash_decode (the Pallas `_kernel`), split
// off for a decode cache whose KV heads do not divide the model axis:
// cache_shardings shards K/V on head_dim there, and GSPMD partitions the
// reference's decode attention as q . K^T over each rank's head_dim slice,
// an all-reduce of the partial scores over the model axis, then the softmax
// and p . V over each rank's V slice. This kernel is one rank's partial
// scores; decode_values.cu (B3-pv) is the rest. Neither half gathers the
// cache.
//
// Computes, for each batch row b, query head h and position t,
//   scores[b, h, t] = (q[b, h, :] . k[b, t, h / rep, :]) * scale
// over the slice's hd_l columns, with `scale` = 1/sqrt(hd) of the WHOLE
// head_dim (the slices' partial scores then sum to B3's scaled score).
// Positions t >= lens[b] are written as exactly 0 and never read from K:
// B3-pv masks them by the same lengths, and zeros keep the all-reduce's sum
// finite and the output deterministic. fp32 sums of exact products.
//
// What bounds it on this card: bytes. Each K element feeds rep = H / Hkv
// products, far below the ~295 flop/B at which the H100's bf16 tensor cores
// become the limit, so the function's least time is q, the valid K prefix
// and the valid scores over 3.35 TB/s (kernels/bounds.py::decode_scores).
// Its contract also writes the zeros past each length: the all-reduce sums
// the whole (B, H, T) buffer. So this kernel's own least bytes are q, the
// valid K prefix and every score (bounds.py::decode_scores_own). At the
// 32768-position cache of chip_smoke.py phase 18a (B 4, H 64, Hkv 4, hd
// 128, lengths 32768 / 16384 / 8192 / 1, bf16) the zeros add 18,874,112 B
// (~5.63 us at 3.35 TB/s) to the bound's 44,073,728 B at one of 2 slices,
// and the same to 18,354,496 B at one of 16: the kernel can reach at most
// ~70 % of the function's bound at 2 slices and ~49 % at 16.
//
// What the design does about it:
//  - bf16 with hd_l >= 8 and T % 4 == 0 runs on the tensor cores (mma.sync
//    m16n8k16, fp32 accumulation): a KV group's query heads are the M side
//    (16 a tile; fewer are padded, more take further tiles), 16 positions
//    the N side, hd_l the K side (hd_l 8 zero-pads the fragment's upper
//    half). q's A fragments are built once a block into shared memory, in
//    fragment order (one 16-byte load a lane and k step).
//  - Each warp owns its own 16-position chunks of K, brought in bf16 into a
//    private four-stage shared-memory ring by 16-byte cp.async (no fp32
//    staging, zero-filled past the length, swizzled for conflict-free
//    ldmatrix at any row width): no block-wide barrier after the q tile.
//  - A block takes G KV heads of its positions, G the largest power of two
//    dividing Hkv whose rows fit 256 B (G hd_l <= 128): at hd_l <= 16 that
//    is every KV head of a 4-head cache, so each position's K row is one
//    contiguous run, and at hd_l 64 two heads' 256 bytes.
//  - The scores go out as 8-byte stores straight from the accumulators (a
//    warp's store covers 8 rows x 32 B, whole sectors); chunks past the
//    length write their zeros as 16-byte stores. A block takes 256
//    positions (4 chunks a warp).
//  - fp32 (and bf16 at hd_l 4, or T not a multiple of 4) keeps CUDA-core
//    FMAs, register-tiled: a thread a position, its K row read 16 bytes at
//    a time, the group's q rows in shared memory as fp32 read as float4
//    (one broadcast load feeds 4 FMAs), up to 16 heads' sums in registers.
//    No TF32.
//
// Measured (chip_smoke.py phase 18a, H100 SXM 80 GB at 700 W, the cache
// above, one of 2 / 4 / 16 slices, L2-warm): 0.0267 / 0.0198 / 0.0145 ms
// (L2-cold 0.0247 / 0.0196 / 0.0156), 49 / 44 / 38 % of the function's
// bound and 70 / 73 / 76 % of this kernel's own bytes; the first design
// (fp32 staging, a dot a thread) took 0.0864 / 0.0519 / 0.0288.
#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 16;               // query heads of a tensor-core tile (mma's M)
constexpr int kChunk = 16;               // positions a warp takes at a time (mma's N)
constexpr int kStages = 4;               // per-warp K ring depth
constexpr int kSpan = 256;               // positions a block takes
constexpr int kMaxRun = 128;             // elements of a block's K run a position (256 B)
constexpr int kMaxSmem = 232448;         // the H100's shared memory a block

struct Args {
  const void* q;        // (B, H, hd_l)
  const void* k;        // (B, T, Hkv, hd_l)
  const int* lens;      // (B,)
  float* scores;        // (B, H, T)
  int T, Hkv, rep;
  float scale;
};

// ---------------------------------------------------------------- tensor cores

template <int HD>
__host__ __device__ constexpr int ksteps() { return (HD + 15) / 16; }

template <int HD, int G>
size_t tc_smem(int rep) {
  const size_t mtiles = (rep + kHeads - 1) / kHeads;
  return (size_t)G * mtiles * ksteps<HD>() * 32 * 16 +              // q's A fragments
         (size_t)kWarps * kStages * kChunk * G * HD * 2;            // the K rings
}

template <int HD, int G>
__global__ void __launch_bounds__(kThreads) scores_tc_kernel(const Args a) {
  constexpr int KK = ksteps<HD>();
  constexpr int kRun = G * HD;             // elements of a position's K run
  constexpr int kCpr = kRun / 8;           // its 16-byte chunks
  extern __shared__ __align__(16) unsigned char smem[];
  const int gc = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * kSpan;
  const int rep = a.rep, mtiles = (rep + kHeads - 1) / kHeads;
  const int H = a.Hkv * rep, T = a.T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int len = max(0, min(a.lens[b], T));
  const int end = min(t0 + kSpan, T);
  const int vend = min(end, len);          // positions of the block scored from K
  const int g0 = gc * G;
  float* out = a.scores + ((size_t)b * H + (size_t)g0 * rep) * T;   // the block's G rep rows
  const int first = t0 + warp * kChunk, stride = kWarps * kChunk;
  int c0 = first;

  if (t0 < vend) {                         // block-uniform
    uint4* qf = reinterpret_cast<uint4*>(smem);
    const int nfrag = G * mtiles * KK;
    const __nv_bfloat16* qb =
        static_cast<const __nv_bfloat16*>(a.q) + ((size_t)b * H + (size_t)g0 * rep) * HD;
    // q's A fragments: entry (gi, mt, kk) holds lane l's {(row g, col 2t),
    // (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)} pairs; zero past rep / HD
    for (int i = threadIdx.x; i < nfrag * 32; i += kThreads) {
      const int l = i & 31, f = i >> 5;
      const int kk = f % KK, mt = (f / KK) % mtiles, gi = f / (KK * mtiles);
      const int lg = l >> 2, lt = l & 3;
      uint32_t r4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * kHeads + lg + (e & 1) * 8;
        const int col = kk * 16 + (e >> 1) * 8 + 2 * lt;
        r4[e] = row < rep && col < HD
                    ? *reinterpret_cast<const uint32_t*>(qb + ((size_t)gi * rep + row) * HD + col)
                    : 0u;
      }
      qf[i] = make_uint4(r4[0], r4[1], r4[2], r4[3]);
    }
    __syncthreads();

    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)nfrag * 32 * 16) +
                          (size_t)warp * kStages * kChunk * kRun;
    const size_t row_stride = (size_t)a.Hkv * HD;          // elements between positions
    const __nv_bfloat16* kb =
        static_cast<const __nv_bfloat16*>(a.k) + ((size_t)b * T * a.Hkv + g0) * HD;
    auto issue = [&](int stage, int c) {
      __nv_bfloat16* ks = ring + (size_t)stage * kChunk * kRun;
#pragma unroll
      for (int i = lane; i < kChunk * kCpr; i += 32) {
        const int r = i / kCpr, ch = i - r * kCpr;
        const int pos = c + r;
        const bool ok = pos < len;
        cp_async16(ks + swizzle_chunk<kCpr>(r, ch) * 8,
                   kb + (size_t)(ok ? pos : 0) * row_stride + ch * 8, ok);
      }
    };
    // kStages - 1 chunks in flight ahead of the one being scored; every
    // iteration commits one group (empty past the end) so the wait count holds
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (first + i * stride < vend) issue(i, first + i * stride);
      cp_async_commit();
    }
    const int r8 = lane & 7, q4 = lane >> 3;
    for (int it = 0; c0 < vend; c0 += stride, ++it) {
      const int ahead = c0 + (kStages - 1) * stride;
      if (ahead < vend) issue((it + kStages - 1) % kStages, ahead);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const __nv_bfloat16* ks = ring + (size_t)(it % kStages) * kChunk * kRun;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        for (int mt = 0; mt < mtiles; ++mt) {
          float s[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < KK; ++kk) {
            uint32_t bk[4];
            if constexpr (HD >= 16) {
              // matrices: (pos 0-7, k lo), (pos 0-7, k hi), (pos 8-15, k lo), (pos 8-15, k hi)
              ldsm_x4(bk, ks + swizzle_chunk<kCpr>(r8 + (q4 >> 1) * 8,
                                                   gi * (HD / 8) + 2 * kk + (q4 & 1)) * 8);
            } else {
              // hd_l 8: matrices (pos 0-7, k lo), (pos 8-15, k lo); k hi is padding
              uint32_t b2[2];
              ldsm_x2(b2, ks + swizzle_chunk<kCpr>(lane & 15, gi) * 8);
              bk[0] = b2[0];
              bk[1] = 0u;
              bk[2] = b2[1];
              bk[3] = 0u;
            }
            const uint4 af = qf[((gi * mtiles + mt) * KK + kk) * 32 + lane];
            const uint32_t av[4] = {af.x, af.y, af.z, af.w};
            mma_bf16(s[0], av, bk[0], bk[1]);
            mma_bf16(s[1], av, bk[2], bk[3]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int hr = mt * kHeads + g + i * 8;          // head within the group
            if (hr >= rep) continue;
            float* o = out + ((size_t)gi * rep + hr) * T;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int pos = c0 + j * 8 + 2 * t;             // even, and T % 4 == 0
              if (pos < T)
                *reinterpret_cast<float2*>(o + pos) =
                    make_float2(pos < len ? s[j][2 * i] * a.scale : 0.f,
                                pos + 1 < len ? s[j][2 * i + 1] * a.scale : 0.f);
            }
          }
        }
      }
      __syncwarp();                                          // the stage is refilled next
    }
    cp_async_wait<0>();
  }
  // the warp's chunks past the length: zeros, 16 bytes a store
  const int nrows = G * rep;
  for (; c0 < end; c0 += stride) {
    for (int i = lane; i < nrows * 4; i += 32) {
      const int r = i >> 2, pos = c0 + (i & 3) * 4;
      if (pos < T)
        *reinterpret_cast<float4*>(out + (size_t)r * T + pos) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ------------------------------------------------------------------ CUDA cores

size_t fma_smem(int rep, int hd) { return (size_t)rep * hd * sizeof(float); }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) scores_fma_kernel(const Args a) {
  extern __shared__ __align__(16) float qs[];            // (rep, HD) fp32
  const int g = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * kSpan;
  const int rep = a.rep, H = a.Hkv * rep, S = a.T;
  const int len = max(0, min(a.lens[b], S));
  const int end = min(t0 + kSpan, S);
  float* out = a.scores + ((size_t)b * H + (size_t)g * rep) * S;
  if (t0 < len) {                                        // block-uniform
    const T* qb = static_cast<const T*>(a.q) + ((size_t)b * H + (size_t)g * rep) * HD;
    for (int i = threadIdx.x; i < rep * HD; i += kThreads) qs[i] = to_f32<T>(qb[i]);
    __syncthreads();
  }
  const T* kb = static_cast<const T*>(a.k) + ((size_t)b * S * a.Hkv + g) * HD;
  for (int p = t0 + threadIdx.x; p < end; p += kThreads) {
    if (p >= len) {
      for (int r = 0; r < rep; ++r) out[(size_t)r * S + p] = 0.f;
      continue;
    }
    const T* kp = kb + (size_t)p * a.Hkv * HD;
    for (int h0 = 0; h0 < rep; h0 += kHeads) {
      const int rows = min(kHeads, rep - h0);
      float acc[kHeads] = {};
#pragma unroll 4
      for (int c = 0; c < HD; c += 4) {
        float kv[4];
        load4(kp + c, kv);
#pragma unroll
        for (int r = 0; r < kHeads; ++r) {
          if (r < rows) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + (h0 + r) * HD + c);
            acc[r] = fmaf(qv.x, kv[0],
                          fmaf(qv.y, kv[1], fmaf(qv.z, kv[2], fmaf(qv.w, kv[3], acc[r]))));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kHeads; ++r)
        if (r < rows) out[(size_t)(h0 + r) * S + p] = acc[r] * a.scale;
    }
  }
}

// ---------------------------------------------------------------------- launch

cudaError_t allow_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <int HD, int G>
cudaError_t launch_tc(const Args& a, int B, cudaStream_t s) {
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr =
      allow_smem(reinterpret_cast<const void*>(scores_tc_kernel<HD, G>));
  if (attr != cudaSuccess) return attr;
  const size_t smem = tc_smem<HD, G>(a.rep);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((a.T + kSpan - 1) / kSpan, a.Hkv / G, B);
  scores_tc_kernel<HD, G><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// G: the largest power of two dividing Hkv with G * HD <= kMaxRun (or 1)
template <int HD, int G = (kMaxRun / HD > 1 ? kMaxRun / HD : 1)>
cudaError_t launch_groups(const Args& a, int B, cudaStream_t s) {
  if constexpr (G > 1) {
    if (a.Hkv % G != 0) return launch_groups<HD, G / 2>(a, B, s);
  }
  return launch_tc<HD, G>(a, B, s);
}

template <typename T, int HD>
cudaError_t launch_fma(const Args& a, int B, cudaStream_t s) {
  static const cudaError_t attr =
      allow_smem(reinterpret_cast<const void*>(scores_fma_kernel<T, HD>));
  if (attr != cudaSuccess) return attr;
  const size_t smem = fma_smem(a.rep, HD);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((a.T + kSpan - 1) / kSpan, a.Hkv, B);
  scores_fma_kernel<T, HD><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& a, int B, int hd, cudaStream_t s) {
  if (hd == 4) return launch_fma<T, 4>(a, B, s);
  if (hd == 8) return launch_fma<T, 8>(a, B, s);
  if (hd == 16) return launch_fma<T, 16>(a, B, s);
  if (hd == 32) return launch_fma<T, 32>(a, B, s);
  if (hd == 64) return launch_fma<T, 64>(a, B, s);
  if (hd == 128) return launch_fma<T, 128>(a, B, s);
  return cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const Args& a, int B, int hd, cudaStream_t s) {
  if (a.T % 4 != 0) return launch_hd<__nv_bfloat16>(a, B, hd, s);   // 8-/16-byte score stores
  if (hd == 8) return launch_groups<8>(a, B, s);
  if (hd == 16) return launch_groups<16>(a, B, s);
  if (hd == 32) return launch_groups<32>(a, B, s);
  if (hd == 64) return launch_groups<64>(a, B, s);
  if (hd == 128) return launch_groups<128>(a, B, s);
  return launch_hd<__nv_bfloat16>(a, B, hd, s);                     // hd_l 4
}

}  // namespace

// q (B, H, hd) with H = Hkv * rep; k (B, T, Hkv, hd); lens (B,) int32;
// scores (B, H, T) fp32; all contiguous and 16-byte aligned, q/k one dtype;
// hd, the slice's head_dim, is 4, 8, 16, 32, 64 or 128; scale 1/sqrt of the
// whole one. Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int decode_scores_launch(const void* q, const void* k, const void* lens,
                                    void* scores, int B, int T, int Hkv, int rep,
                                    int hd, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || Hkv <= 0 || rep <= 0 || B > 65535 || Hkv > 65535)
    return cudaErrorInvalidValue;
  const Args a{q, k, static_cast<const int*>(lens), static_cast<float*>(scores), T, Hkv, rep,
               scale};
  if (dtype == kFloat32) return launch_hd<float>(a, B, hd, s);
  if (dtype == kBFloat16) return launch_bf16(a, B, hd, s);
  return cudaErrorInvalidValue;
}
