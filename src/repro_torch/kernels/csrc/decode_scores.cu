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
// Positions t >= lens[b] are written as 0 and never read from K: B3-pv
// masks them by the same lengths, and zeros keep the all-reduce's sum
// finite and the output deterministic. fp32 products and sums.
//
// What bounds it on this card: bytes. Each K element feeds rep = H / Hkv
// products, far below the ~295 flop/B at which the H100's bf16 tensor cores
// become the limit, so the least time is q, the valid K prefix and the
// valid scores over 3.35 TB/s (kernels/bounds.py::decode_scores).
//
// What the design does about it (simple first; its speed is later work):
//  - grid (ceil(T / kPos), Hkv, B): a block takes one KV head's kPos
//    positions, so every valid K row is read from device memory once, by
//    consecutive threads on consecutive columns;
//  - the block stages those keys in shared memory as fp32 (rows padded by
//    one float, so threads on consecutive positions hit distinct banks) and
//    the group's rep query rows beside them, then each thread computes whole
//    (head, position) dots; consecutive threads take consecutive positions,
//    so the stores of the scores are coalesced;
//  - a block past a row's length only writes its zeros.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPos = 64;                 // positions a block takes
constexpr int kMaxSmem = 232448;         // the H100's shared memory a block

struct Args {
  const void* q;        // (B, H, hd_l)
  const void* k;        // (B, T, Hkv, hd_l)
  const int* lens;      // (B,)
  float* scores;        // (B, H, T)
  int T, Hkv, rep, hd;  // hd: the slice's head_dim hd_l
  float scale;
};

__host__ __device__ inline size_t smem_bytes(int rep, int hd) {
  return ((size_t)kPos * (hd + 1) + (size_t)rep * hd) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_scores_kernel(const Args a) {
  extern __shared__ float smem[];
  const int g = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * kPos;
  const int H = a.Hkv * a.rep, hd = a.hd, ks = hd + 1;
  const int len = min(a.lens[b], a.T);
  const int n = min(kPos, a.T - t0);                  // positions of this block
  const int valid = max(0, min(n, len - t0));         // of them below the length
  float* out = a.scores + ((size_t)b * H + (size_t)g * a.rep) * a.T + t0;
  if (valid == 0) {
    for (int i = threadIdx.x; i < a.rep * n; i += kThreads)
      out[(size_t)(i / n) * a.T + i % n] = 0.f;
    return;
  }
  float* kt = smem;                                   // (kPos, hd + 1)
  float* qt = smem + (size_t)kPos * ks;               // (rep, hd)
  const T* kb = static_cast<const T*>(a.k) + (((size_t)b * a.T + t0) * a.Hkv + g) * hd;
  const size_t row = (size_t)a.Hkv * hd;              // elements between positions
  for (int i = threadIdx.x; i < valid * hd; i += kThreads) {
    const int p = i / hd, c = i - p * hd;
    kt[p * ks + c] = to_f32<T>(kb[p * row + c]);
  }
  const T* qb = static_cast<const T*>(a.q) + ((size_t)b * H + (size_t)g * a.rep) * hd;
  for (int i = threadIdx.x; i < a.rep * hd; i += kThreads) qt[i] = to_f32<T>(qb[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < a.rep * n; i += kThreads) {
    const int r = i / n, p = i - r * n;
    float s = 0.f;
    if (p < valid) {
      const float* kp = kt + p * ks;
      const float* qr = qt + r * hd;
#pragma unroll 8
      for (int c = 0; c < hd; ++c) s = fmaf(qr[c], kp[c], s);
      s *= a.scale;
    }
    out[(size_t)r * a.T + p] = s;
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  // once per instantiation (thread-safe static initialisation): allow the
  // largest dynamic shared memory, for groups of many heads
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.T + kPos - 1) / kPos, a.Hkv, B);
  decode_scores_kernel<T><<<grid, kThreads, smem_bytes(a.rep, a.hd), s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, hd) with H = Hkv * rep; k (B, T, Hkv, hd); lens (B,) int32;
// scores (B, H, T) fp32; all contiguous, q/k one dtype; hd is the slice's
// head_dim, scale 1/sqrt of the whole one. Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
extern "C" int decode_scores_launch(const void* q, const void* k, const void* lens,
                                    void* scores, int B, int T, int Hkv, int rep,
                                    int hd, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || Hkv <= 0 || rep <= 0 || hd <= 0 || B > 65535 ||
      Hkv > 65535 || smem_bytes(rep, hd) > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  const Args a{q, k, static_cast<const int*>(lens), static_cast<float*>(scores),
               T, Hkv, rep, hd, scale};
  if (dtype == kFloat32) return launch<float>(a, B, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, B, s);
  return cudaErrorInvalidValue;
}
