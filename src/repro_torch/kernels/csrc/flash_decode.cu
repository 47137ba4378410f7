// Single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_decode.py::flash_decode (the Pallas
// `_kernel`). Computes, for each batch row b and query head h,
// softmax(q . K^T * hd^-0.5 over positions < cache_len[b]) . V with an
// fp32 online softmax (running max m, denominator l, accumulator acc).
//
// What bounds it on this card: reading the KV cache. Each cached K/V
// element is used by the rep = H / Hkv query heads that share its KV head,
// i.e. 2*rep flops per element, far below the H100's ~295 flop/B; the least
// time is the valid K/V prefix's bytes over 3.35 TB/s. At the served decode
// shapes (B=4, Hkv=4, S=64) the whole cache is a few hundred KB, so a
// launch is dominated by its fixed cost rather than by either bound.
//
// What the design does about it: one block per (kv head, batch row), so
// the rep query heads of a group share every K/V tile a block loads (the
// GQA repetition is never materialised). A loop over S in tiles of 32
// positions inside the block replaces the TPU's sequential grid axis; only
// the tiles below cache_len[b] are read at all. K/V rows are loaded with
// consecutive threads on consecutive head-dim elements (coalesced), staged
// in fp32 in shared memory (K padded by one column so the per-position dot
// products are bank-conflict free). Splitting S across blocks
// (flash-decoding) for long caches is left to a later change.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;        // positions per tile (one per lane in softmax)
constexpr float kMasked = -1e30f;

struct Smem {
  // layout offsets (in floats) of the dynamic shared-memory carve-up
  int qs, ks, vs, ps, acc, m, l, alpha, total;
  __host__ __device__ Smem(int rep, int hd) {
    const int ld = hd + 1;
    qs = 0;
    ks = qs + rep * ld;
    vs = ks + kTile * ld;
    ps = vs + kTile * hd;
    acc = ps + rep * kTile;
    m = acc + rep * hd;
    l = m + rep;
    alpha = l + rep;
    total = alpha + rep;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    T* __restrict__ out, int S, int Hkv, int rep, int hd,
                    float scale) {
  extern __shared__ float smem[];
  const Smem L(rep, hd);
  const int ld = hd + 1;
  float* qs = smem + L.qs;
  float* ks = smem + L.ks;
  float* vs = smem + L.vs;
  float* ps = smem + L.ps;
  float* acc = smem + L.acc;
  float* m = smem + L.m;
  float* l = smem + L.l;
  float* alpha = smem + L.alpha;

  const int g = blockIdx.x;            // kv head
  const int b = blockIdx.y;            // batch row
  const int H = Hkv * rep;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int len = lens[b];
  // positions that can contribute: the valid prefix; with no valid position
  // every score is masked and (as in the reference) the softmax is uniform
  const int n = len >= 1 ? min(len, S) : S;

  const T* qb = q + ((size_t)b * H + (size_t)g * rep) * hd;
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd, dd = i - r * hd;
    qs[r * ld + dd] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m[r] = kMasked;
    l[r] = 0.f;
  }

  for (int s0 = 0; s0 < n; s0 += kTile) {
    __syncthreads();
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int t = i / hd, dd = i - t * hd;
      const int s = s0 + t;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * Hkv + g) * hd + dd;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[t * ld + dd] = kv;
      vs[t * hd + dd] = vv;
    }
    __syncthreads();
    // scores: one (head, position) pair per thread-iteration
    for (int i = tid; i < rep * kTile; i += kThreads) {
      const int r = i / kTile, t = i - r * kTile;
      const int s = s0 + t;
      float sc;
      if (s >= S) {
        sc = -INFINITY;                // no such position
      } else {
        const float* qr = qs + r * ld;
        const float* kt = ks + t * ld;
        float dot = 0.f;
        for (int dd = 0; dd < hd; ++dd) dot = fmaf(qr[dd], kt[dd], dot);
        sc = s < len ? dot * scale : kMasked;
      }
      ps[i] = sc;
    }
    __syncthreads();
    // online softmax update, one warp per head row, one lane per position
    for (int r = warp; r < rep; r += kThreads / 32) {
      const float sc = ps[r * kTile + lane];
      float mx = sc;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(sc - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l[r] = a * l[r] + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < rep * hd; i += kThreads) {
      const int r = i / hd, dd = i - r * hd;
      const float* pr = ps + r * kTile;
      float a = acc[i] * alpha[r];
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) a = fmaf(pr[t], vs[t * hd + dd], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)g * rep) * hd;
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd;
    ob[i] = from_f32<T>(acc[i] / l[r]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lens,
                   void* out, int B, int S, int Hkv, int rep, int hd, float scale,
                   cudaStream_t s) {
  const size_t smem = (size_t)Smem(rep, hd).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B);
  flash_decode_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lens, static_cast<T*>(out), S, Hkv, rep, hd, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, hd); k, v (B, S, Hkv, hd); lens (B,) int32; out (B, H, hd). All
// contiguous, q/k/v/out one dtype. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lens, void* out, int B, int S,
                                   int Hkv, int rep, int hd, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hkv <= 0 || rep <= 0 || hd <= 0 || S <= 0) return cudaErrorInvalidValue;
  const int* lp = static_cast<const int*>(lens);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, lp, out, B, S, Hkv, rep, hd, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, lp, out, B, S, Hkv, rep, hd, scale, s);
  return cudaErrorInvalidValue;
}
