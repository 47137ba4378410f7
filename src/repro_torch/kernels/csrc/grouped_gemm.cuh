// Grouped GEMM + activation over per-expert weights, CUDA-core FMA in fp32:
// the one building block of moe_ffn.cu (B1) and moe_ffn_quant.cu (B2).
//
//   out[e, c, n] = act(sum_k x[e,c,k] * W2[s,k,n], sum_k x[e,c,k] * W1[s,k,n])
//
// with s = slot_ids[e] (or e when slot_ids is null): the expert -> slot
// indirection of the device slot cache is folded into the weight pointers,
// so no gathered copy of the weights is ever made. W2 is the gate weight and
// is read only for gated activations. Weights may be stored narrower than
// the math (fp16, or int8 with one fp32 scale per output column n, SCALED):
// each weight element is widened (and scaled) to fp32 in a register right
// before its FMA, as the reference's `q.astype(f32) * scale` does.
//
// Layout: every block owns 8 rows of x (kBlockC) and 512 output columns
// (128 threads x 4 columns, kCols, strided by 128 so a warp's loads are
// consecutive addresses). x rows are staged in shared memory in fp32 in
// chunks of 128 along k and broadcast; each loaded weight is reused for all
// 8 rows from a register. Ragged C, K and N are masked.
#pragma once

#include "common.cuh"

namespace grouped {

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

// x (E, C, K); w1, w2 (n_slots, K, N) row-major; s1, s2 (n_slots, N) fp32
// scales (read only when SCALED); slot_ids (E,) or null; out (E, C, N).
template <typename TX, typename TW, typename TO, int ACT, bool SCALED>
__global__ void __launch_bounds__(kThreads)
gemm_act(const TX* __restrict__ x, const TW* __restrict__ w1,
         const TW* __restrict__ w2, const float* __restrict__ s1,
         const float* __restrict__ s2, const int* __restrict__ slot_ids,
         TO* __restrict__ out, int C, int K, int N) {
  constexpr bool kGated = (ACT == kSwiglu || ACT == kGeglu);
  const int e = blockIdx.z;
  const size_t slot = slot_ids ? (size_t)slot_ids[e] : (size_t)e;
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
  float sc1[kCols], sc2[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const int n = n0 + t * kThreads;
    col_ok[t] = n < N;
    sc1[t] = (SCALED && col_ok[t]) ? s1[slot * N + n] : 1.f;
    sc2[t] = (SCALED && kGated && col_ok[t]) ? s2[slot * N + n] : 1.f;
  }

  const TX* xe = x + (size_t)e * C * K;
  const TW* w1e = w1 + slot * K * N;
  const TW* w2e = kGated ? w2 + slot * K * N : w1e;

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
        if (SCALED) {
          a[t] *= sc1[t];
          b[t] *= sc2[t];
        }
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
    TO* o = out + ((size_t)e * C + c) * N + n0;
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
      o[t * kThreads] = from_f32<TO>(h);
    }
  }
}

// One launch of gemm_act with a compile-time activation.
template <typename TX, typename TW, typename TO, int ACT, bool SCALED>
cudaError_t launch(const void* x, const void* w1, const void* w2,
                   const float* s1, const float* s2, const int* slot_ids,
                   void* out, int E, int C, int K, int N, cudaStream_t s) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (C + kBlockC - 1) / kBlockC, E);
  gemm_act<TX, TW, TO, ACT, SCALED><<<grid, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w1),
      static_cast<const TW*>(w2), s1, s2, slot_ids, static_cast<TO*>(out),
      C, K, N);
  return cudaGetLastError();
}

// The same with the activation chosen at run time (the up-projection).
template <typename TX, typename TW, typename TO, bool SCALED>
cudaError_t launch_act(int act, const void* x, const void* w1, const void* w2,
                       const float* s1, const float* s2, const int* slot_ids,
                       void* out, int E, int C, int K, int N, cudaStream_t s) {
  switch (act) {
    case kNone: return launch<TX, TW, TO, kNone, SCALED>(x, w1, w2, s1, s2, slot_ids, out, E, C, K, N, s);
    case kSwiglu: return launch<TX, TW, TO, kSwiglu, SCALED>(x, w1, w2, s1, s2, slot_ids, out, E, C, K, N, s);
    case kGeglu: return launch<TX, TW, TO, kGeglu, SCALED>(x, w1, w2, s1, s2, slot_ids, out, E, C, K, N, s);
    case kRelu2: return launch<TX, TW, TO, kRelu2, SCALED>(x, w1, w2, s1, s2, slot_ids, out, E, C, K, N, s);
    case kGelu: return launch<TX, TW, TO, kGelu, SCALED>(x, w1, w2, s1, s2, slot_ids, out, E, C, K, N, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace grouped
