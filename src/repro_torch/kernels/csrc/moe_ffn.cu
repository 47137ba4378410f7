// Grouped expert FFN for Hopper (sm_90a), CUDA-core FMA.
//
// Replaces: repro/kernels/moe_ffn.py::moe_ffn (the Pallas `_kernel`).
// Computes, per expert e:  h = act(x @ W_gate, x @ W_up) rounded to x's
// dtype, then y = h @ W_down, accumulated in fp32 over all of f and
// rounded once (the reference `moe_ffn_ref`, not the Pallas kernel's
// per-f-block rounding).
//
// What bounds it on this card: reading the expert weights. At decode the
// dispatch capacity C is a handful of rows per expert (C = 8 at the served
// shapes), so every weight byte feeds 2*C flops: ~16 flop/B in bf16 against
// the ~295 flop/B the H100 needs before compute is the limit. The bound is
// 3*E*d*f weight elements over 3.35 TB/s (4.83 GB, 1.44 ms per launch for
// E=128, d=4096, f=1536 in bf16).
//
// What the design does about it: every weight element is read from device
// memory exactly once per block row of C, by threads that walk the
// contiguous axis (consecutive threads, consecutive columns: each warp load
// is one fully used 64 B (bf16) or 128 B (fp32) segment). The C rows of x
// are staged in shared memory in fp32 and broadcast, so each loaded weight
// is reused C times from a register. Each thread keeps 4 columns x 8 rows
// (x2 for the gate) of fp32 accumulators and the k loop is unrolled so that
// several loads per thread are in flight. Two launches: up+activation into
// a scratch h (E, C, f) in x's dtype, then down-projection into y. Ragged C
// and f are masked; nothing needs to divide a tile. Experts with no routed
// rows are still computed (their x rows are zero, so their y rows are zero):
// skipping them is left to a later change.
#include "common.cuh"

namespace {

enum Act : int { kNone = 0, kSwiglu = 1, kGeglu = 2, kRelu2 = 3, kGelu = 4 };

constexpr int kThreads = 128;
constexpr int kCols = 4;                    // output columns per thread
constexpr int kBlockN = kThreads * kCols;   // 512 columns per block
constexpr int kBlockC = 8;                  // rows of x per block
constexpr int kChunkK = 128;                // reduction chunk staged in smem

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;      // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// out[e, c, n] = act(sum_k x[e,c,k] * w2[e,k,n], sum_k x[e,c,k] * w1[e,k,n])
// x (E, C, K); w1, w2 (E, K, N) row-major; out (E, C, N). w2 is the gate
// weight and is read only for gated activations.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_act(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ w2, T* __restrict__ out,
                 int C, int K, int N) {
  constexpr bool kGated = (ACT == kSwiglu || ACT == kGeglu);
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kBlockC;
  const int n0 = blockIdx.x * kBlockN + threadIdx.x;

  __shared__ float xs[kBlockC][kChunkK];
  float acc1[kBlockC][kCols];
  float acc2[kBlockC][kCols];
#pragma unroll
  for (int r = 0; r < kBlockC; ++r)
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc1[r][t] = acc2[r][t] = 0.f;

  bool col_ok[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) col_ok[t] = n0 + t * kThreads < N;

  const T* xe = x + (size_t)e * C * K;
  const T* w1e = w1 + (size_t)e * K * N;
  const T* w2e = kGated ? w2 + (size_t)e * K * N : w1e;

  for (int k0 = 0; k0 < K; k0 += kChunkK) {
    const int kn = min(kChunkK, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockC * kChunkK; i += kThreads) {
      const int r = i / kChunkK, kk = i - r * kChunkK;
      const int c = c0 + r;
      xs[r][kk] = (c < C && kk < kn) ? to_f32(xe[(size_t)c * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const size_t row = (size_t)(k0 + kk) * N;
      float a[kCols], b[kCols];
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const size_t off = row + n0 + t * kThreads;
        a[t] = col_ok[t] ? to_f32(w1e[off]) : 0.f;
        b[t] = (kGated && col_ok[t]) ? to_f32(w2e[off]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBlockC; ++r) {
        const float xv = xs[r][kk];
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          acc1[r][t] = fmaf(xv, a[t], acc1[r][t]);
          if (kGated) acc2[r][t] = fmaf(xv, b[t], acc2[r][t]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kBlockC; ++r) {
    const int c = c0 + r;
    if (c >= C) continue;
    T* o = out + ((size_t)e * C + c) * N + n0;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      if (!col_ok[t]) continue;
      const float u = acc1[r][t];
      float h;
      if (ACT == kSwiglu) {
        const float g = acc2[r][t];
        h = g / (1.f + expf(-g)) * u;
      } else if (ACT == kGeglu) {
        h = gelu_tanh(acc2[r][t]) * u;
      } else if (ACT == kRelu2) {
        const float p = fmaxf(u, 0.f);
        h = p * p;
      } else if (ACT == kGelu) {
        h = gelu_tanh(u);
      } else {
        h = u;
      }
      o[t * kThreads] = from_f32<T>(h);
    }
  }
}

template <typename T>
cudaError_t launch_gemm(int act, const void* x, const void* w1, const void* w2,
                        void* out, int E, int C, int K, int N, cudaStream_t s) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (C + kBlockC - 1) / kBlockC, E);
  const T* xp = static_cast<const T*>(x);
  const T* w1p = static_cast<const T*>(w1);
  const T* w2p = static_cast<const T*>(w2);
  T* op = static_cast<T*>(out);
  switch (act) {
    case kNone: grouped_gemm_act<T, kNone><<<grid, kThreads, 0, s>>>(xp, w1p, w2p, op, C, K, N); break;
    case kSwiglu: grouped_gemm_act<T, kSwiglu><<<grid, kThreads, 0, s>>>(xp, w1p, w2p, op, C, K, N); break;
    case kGeglu: grouped_gemm_act<T, kGeglu><<<grid, kThreads, 0, s>>>(xp, w1p, w2p, op, C, K, N); break;
    case kRelu2: grouped_gemm_act<T, kRelu2><<<grid, kThreads, 0, s>>>(xp, w1p, w2p, op, C, K, N); break;
    case kGelu: grouped_gemm_act<T, kGelu><<<grid, kThreads, 0, s>>>(xp, w1p, w2p, op, C, K, N); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t moe_ffn_typed(const void* xg, const void* w_gate, const void* w_up,
                          const void* w_down, void* h, void* y, int E, int C,
                          int d, int f, int act, cudaStream_t s) {
  cudaError_t err = launch_gemm<T>(act, xg, w_up, w_gate, h, E, C, d, f, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(kNone, h, w_down, nullptr, y, E, C, f, d, s);
}

}  // namespace

// xg (E, C, d); w_gate, w_up (E, d, f) (w_gate may be null for ungated
// activations); w_down (E, f, d); h (E, C, f) scratch; y (E, C, d). All
// contiguous, one dtype. Launches on `stream`; returns cudaGetLastError().
extern "C" int moe_ffn_launch(const void* xg, const void* w_gate, const void* w_up,
                              const void* w_down, void* h, void* y, int E, int C,
                              int d, int f, int act, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0) return cudaSuccess;
  if (dtype == kFloat32)
    return moe_ffn_typed<float>(xg, w_gate, w_up, w_down, h, y, E, C, d, f, act, s);
  if (dtype == kBFloat16)
    return moe_ffn_typed<__nv_bfloat16>(xg, w_gate, w_up, w_down, h, y, E, C, d, f, act, s);
  return cudaErrorInvalidValue;
}
