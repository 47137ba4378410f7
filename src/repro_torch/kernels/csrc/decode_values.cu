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
// mode. Scores past the length are never read. fp32 throughout.
//
// What bounds it on this card: bytes, as B3: the valid scores (fp32) and
// the valid V prefix are each read once and the output written once; each
// V element feeds 2 * rep flops (kernels/bounds.py::decode_values).
//
// What the design does about it (simple first; its speed is later work):
//  - grid (splits, Hkv, B): a block takes one KV head's rep query heads over
//    one split of the positions (flash-decoding: the wrapper cuts T into
//    splits when B * Hkv blocks would leave SMs idle, as B3's `splits`
//    does); each V row is read once, by consecutive threads on consecutive
//    columns;
//  - per chunk of kPos positions the block stages V (fp32) and the rep rows
//    of capped scores in shared memory, one warp a head updates the running
//    max, denominator and rescale factor (an online softmax), and each
//    thread updates whole (head, column) accumulators in shared memory;
//  - one split writes the output (and lse) itself; more write fp32
//    (acc, m, l) partials and a second small kernel combines them, as B3's
//    combine does.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPos = 64;                 // positions a chunk stages
constexpr int kMaxSmem = 232448;         // the H100's shared memory a block

struct Args {
  const float* scores;  // (B, H, T) summed over the slices
  const void* v;        // (B, T, Hkv, hd_l)
  const int* lens;      // (B,)
  void* out;            // (B, H, hd_l)
  float* part;          // (B, H, splits, hd_l + 2): acc, m, l; null if splits == 1
  float* lse;           // (B, H) or null
  int T, Hkv, rep, hd, splits, split_len;
  float cap;            // logit softcap, 0 for none
};

__host__ __device__ inline size_t smem_bytes(int rep, int hd) {
  // V chunk, capped scores of the chunk, accumulators, (m, l, alpha) a head
  return ((size_t)kPos * hd + (size_t)rep * kPos + (size_t)rep * hd + 3 * (size_t)rep) *
         sizeof(float);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_values_kernel(const Args a) {
  extern __shared__ float smem[];
  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = a.rep, hd = a.hd, H = a.Hkv * rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* vt = smem;                                   // (kPos, hd)
  float* st = vt + (size_t)kPos * hd;                 // (rep, kPos)
  float* acc = st + (size_t)rep * kPos;               // (rep, hd)
  float* m = acc + (size_t)rep * hd;                  // (rep,)
  float* l = m + rep;
  float* alpha = l + rep;
  for (int i = threadIdx.x; i < rep * hd; i += kThreads) acc[i] = 0.f;
  for (int r = threadIdx.x; r < rep; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  const int len = min(a.lens[b], a.T);
  const int lo = sp * a.split_len;
  const int hi = min(lo + a.split_len, len);          // this split's valid positions
  const size_t row = (size_t)a.Hkv * hd;              // V elements between positions
  const T* vb = static_cast<const T*>(a.v) + ((size_t)b * a.T * a.Hkv + g) * hd;
  const float* sb = a.scores + ((size_t)b * H + (size_t)g * rep) * a.T;
  __syncthreads();
  for (int c0 = lo; c0 < hi; c0 += kPos) {
    const int n = min(kPos, hi - c0);                 // >= 1 valid position
    for (int i = threadIdx.x; i < n * hd; i += kThreads) {
      const int p = i / hd, c = i - p * hd;
      vt[i] = to_f32<T>(vb[(size_t)(c0 + p) * row + c]);
    }
    for (int i = threadIdx.x; i < rep * kPos; i += kThreads) {
      const int r = i / kPos, p = i - r * kPos;
      float s = -INFINITY;
      if (p < n) {
        s = sb[(size_t)r * a.T + c0 + p];
        if (a.cap > 0.f) s = a.cap * tanhf(s / a.cap);
      }
      st[i] = s;
    }
    __syncthreads();
    // one warp a head: the chunk's max, its weights exp(c - m_new), their
    // sum, and the factor that rescales what came before
    for (int r = warp; r < rep; r += kWarps) {
      float* sr = st + (size_t)r * kPos;
      float cm = -INFINITY;
      for (int p = lane; p < kPos; p += 32) cm = fmaxf(cm, sr[p]);
      cm = warp_max(cm);
      const float mo = m[r];
      const float mn = fmaxf(mo, cm);                 // finite: the chunk has a position
      float cs = 0.f;
      for (int p = lane; p < kPos; p += 32) {
        const float w = p < n ? expf(sr[p] - mn) : 0.f;
        sr[p] = w;
        cs += w;
      }
      cs = warp_sum(cs);
      if (lane == 0) {
        const float al = mo == -INFINITY ? 0.f : expf(mo - mn);
        alpha[r] = al;
        l[r] = fmaf(l[r], al, cs);
        m[r] = mn;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rep * hd; i += kThreads) {
      const int r = i / hd, c = i - r * hd;
      const float* wr = st + (size_t)r * kPos;
      float s = acc[i] * alpha[r];
      for (int p = 0; p < n; ++p) s = fmaf(wr[p], vt[p * hd + c], s);
      acc[i] = s;
    }
    __syncthreads();
  }
  if (a.splits == 1) {
    T* out = static_cast<T*>(a.out) + ((size_t)b * H + (size_t)g * rep) * hd;
    for (int i = threadIdx.x; i < rep * hd; i += kThreads) {
      const float li = l[i / hd];
      out[i] = from_f32<T>(li > 0.f ? acc[i] / li : 0.f);
    }
    if (a.lse != nullptr)
      for (int r = threadIdx.x; r < rep; r += kThreads)
        a.lse[(size_t)b * H + (size_t)g * rep + r] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    return;
  }
  for (int i = threadIdx.x; i < rep * (hd + 2); i += kThreads) {
    const int r = i / (hd + 2), c = i - r * (hd + 2);
    float* pr = a.part + (((size_t)b * H + (size_t)g * rep + r) * a.splits + sp) * (hd + 2);
    pr[c] = c < hd ? acc[r * hd + c] : c == hd ? m[r] : l[r];
  }
}

// out[row] = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M) over the splits
// of each (b, h) row (an empty split has m -inf and weighs 0); lse = M +
// log(L); a row whose every split is empty gets out 0 and lse -inf. One
// block a row; the split weights in shared memory.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part, T* __restrict__ out, float* __restrict__ lse,
               int splits, int hd) {
  extern __shared__ float wgt[];                      // (splits,)
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  const float* pr = part + row * splits * (hd + 2);
  float M = -INFINITY;
  for (int s = threadIdx.x; s < splits; s += kThreads)
    M = fmaxf(M, pr[(size_t)s * (hd + 2) + hd]);
  M = block_reduce(M, true, red);
  if (M == -INFINITY) {
    for (int c = threadIdx.x; c < hd; c += kThreads) out[row * hd + c] = from_f32<T>(0.f);
    if (lse != nullptr && threadIdx.x == 0) lse[row] = -INFINITY;
    return;
  }
  float L = 0.f;
  for (int s = threadIdx.x; s < splits; s += kThreads) {
    const float* ps = pr + (size_t)s * (hd + 2);
    const float w = ps[hd] == -INFINITY ? 0.f : expf(ps[hd] - M);
    wgt[s] = w;
    L = fmaf(ps[hd + 1], w, L);
  }
  L = block_reduce(L, false, red);                    // its barriers publish wgt too
  for (int c = threadIdx.x; c < hd; c += kThreads) {
    float o = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = wgt[s];
      o = w != 0.f ? fmaf(pr[(size_t)s * (hd + 2) + c], w, o) : o;
    }
    out[row * hd + c] = from_f32<T>(o / L);
  }
  if (lse != nullptr && threadIdx.x == 0) lse[row] = M + logf(L);
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  // once per instantiation (thread-safe static initialisation): allow the
  // largest dynamic shared memory, for groups of many heads
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_values_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.splits, a.Hkv, B);
  decode_values_kernel<T><<<grid, kThreads, smem_bytes(a.rep, a.hd), s>>>(a);
  if (a.splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    combine_kernel<T><<<B * a.Hkv * a.rep, kThreads, a.splits * sizeof(float), s>>>(
        a.part, static_cast<T*>(a.out), a.lse, a.splits, a.hd);
  }
  return cudaGetLastError();
}

}  // namespace

// scores (B, H, T) fp32 with H = Hkv * rep; v (B, T, Hkv, hd); lens (B,)
// int32; out (B, H, hd) in v's dtype; all contiguous; hd is the slice's
// head_dim. part: fp32 scratch of B * H * splits * (hd + 2) floats, or null
// when splits == 1. lse: (B, H) fp32, or null. softcap: 0 for none. Split
// sp takes positions [sp * split_len, (sp + 1) * split_len) of each row's
// valid prefix; splits * split_len must cover T. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take).
extern "C" int decode_values_launch(const void* scores, const void* v, const void* lens,
                                    void* out, void* part, void* lse, int B, int T, int Hkv,
                                    int rep, int hd, int splits, int split_len,
                                    float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || Hkv <= 0 || rep <= 0 || hd <= 0 || splits <= 0 ||
      split_len <= 0 || (long long)splits * split_len < T || B > 65535 || Hkv > 65535 ||
      (splits > 1 && part == nullptr) || !(softcap >= 0.f) ||
      smem_bytes(rep, hd) > (size_t)kMaxSmem || (size_t)splits * sizeof(float) > 48 * 1024)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(scores), v, static_cast<const int*>(lens), out,
               static_cast<float*>(part), static_cast<float*>(lse), T, Hkv, rep, hd,
               splits, split_len, softcap};
  if (dtype == kFloat32) return launch<float>(a, B, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, B, s);
  return cudaErrorInvalidValue;
}
