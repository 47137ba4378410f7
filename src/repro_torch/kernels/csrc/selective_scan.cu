// Mamba-1 selective scan (Jamba's recurrent layer), for Hopper (sm_90a).
//
// Replaces: the reference's lax.scan of repro/models/mamba.py (`_ssm_params`
// + `_scan_chunk` inside `mamba_forward`, and the single step of
// `mamba_decode`); the reference has no Pallas kernel for it. For each batch
// row b, channel c (of d_in) and state n (of N), over t = 0..T-1:
//   dA    = exp(dt_t[c] * A[c][n])
//   dBx   = (dt_t[c] * x_t[c]) * B_t[n]
//   h[n]  = dA * h[n] + dBx
//   y_t[c] = sum_n h[n] * C_t[n]
// in fp32, with the products in the reference's order (dt * x first); x, B
// and C are widened from the model dtype, dt, A, h and y are fp32. y is the
// scan's output before the D skip and the silu(z) gate (both stay torch ops
// in the model dtype, as in the reference); h_T is written for the cache.
//
// What bounds it on this card: bytes. At decode (T = 1) every state element
// is read and written once (2 * B * d_in * N * 4 B; 8.4 MB at Jamba's
// B = 4, d_in = 16384, N = 16) against 7 fp32 operations each. Over a
// prefill the per-step rows of x, dt and y add 10 B a channel and step
// against 7 * N operations, still bytes at N = 16; but the steps are a
// chain, so a short prompt at B = 1 is bounded by T steps of latency.
//
// Design (simple, correct first): one thread per (b, channel) keeps its N
// fp32 states and its row of A in registers for the whole launch, so the
// state is read once and written once and the (B, T, d_in, N) tensors dA
// and dBx the reference materialises are never formed: they are computed
// on the fly. A block takes kThreads channels of one batch row; it stages a
// tile of kTile steps at a time in shared memory: the steps' B_t and C_t
// rows (which every channel shares) and the block's columns of x and dt
// (coalesced loads). Each thread's N state chains are independent, so one
// step has N-way instruction-level parallelism. One launch carries the
// state over any T >= 1 (the reference's 256-step chunks become the loop).
#include "common.cuh"

namespace {

constexpr int kThreads = 64;    // channels a block takes
constexpr int kTile = 32;       // steps staged at a time

template <typename X, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const X* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const X* __restrict__ Bm,
                      const X* __restrict__ Cm, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ hT, int T, int D) {
  __shared__ float xs[kTile][kThreads];
  __shared__ float ds[kTile][kThreads];
  __shared__ float bs[kTile][N];
  __shared__ float cs[kTile][N];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kThreads;
  const int tid = threadIdx.x;
  const int c = c0 + tid;
  const bool live = c < D;
  const size_t seq = (size_t)b * T;          // row of (b, t = 0) in (B, T, .)

  float h[N], a[N];
  if (live) {
    const float* h0c = h0 + ((size_t)b * D + c) * N;
    const float* ac = A + (size_t)c * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = h0c[n];
      a[n] = ac[n];
    }
  }

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int steps = min(kTile, T - t0);
    __syncthreads();                          // the previous tile is consumed
    for (int i = tid; i < steps * kThreads; i += kThreads) {
      const int t = i / kThreads, j = i - t * kThreads;
      if (c0 + j < D) {
        const size_t off = (seq + t0 + t) * D + c0 + j;
        xs[t][j] = to_f32<X>(x[off]);
        ds[t][j] = dt[off];
      }
    }
    for (int i = tid; i < steps * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const size_t off = (seq + t0 + t) * N + n;
      bs[t][n] = to_f32<X>(Bm[off]);
      cs[t][n] = to_f32<X>(Cm[off]);
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t) {
      const float d = ds[t][tid];
      const float dx = d * xs[t][tid];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(d * a[n]) * h[n] + dx * bs[t][n];
        acc += h[n] * cs[t][n];
      }
      y[(seq + t0 + t) * D + c] = acc;
    }
  }

  if (live) {
    float* hc = hT + ((size_t)b * D + c) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hc[n] = h[n];
  }
}

template <typename X>
cudaError_t launch_n(const void* x, const float* dt, const float* A, const void* Bm,
                     const void* Cm, const float* h0, float* y, float* hT, int B, int T,
                     int D, int N, cudaStream_t s) {
  const X* xp = static_cast<const X*>(x);
  const X* bp = static_cast<const X*>(Bm);
  const X* cp = static_cast<const X*>(Cm);
  const dim3 grid((D + kThreads - 1) / kThreads, B);
#define SCAN_CASE(NS)                                                              \
  if (N == NS) {                                                                   \
    selective_scan_kernel<X, NS><<<grid, kThreads, 0, s>>>(xp, dt, A, bp, cp, h0, y, \
                                                           hT, T, D);              \
    return cudaGetLastError();                                                     \
  }
  SCAN_CASE(8)
  SCAN_CASE(16)
#undef SCAN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, T, D) in `dtype`; dt (B, T, D) fp32; A (D, N) fp32; Bm, Cm (B, T, N)
// in `dtype`; h0 (B, D, N) fp32; y (B, T, D) fp32; hT (B, D, N) fp32. All
// contiguous; N in {8, 16}; T >= 1. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int selective_scan_launch(const void* x, const void* dt, const void* A,
                                     const void* Bm, const void* Cm, const void* h0,
                                     void* y, void* hT, int B, int T, int D, int N,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || D <= 0) return cudaErrorInvalidValue;
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float* yp = static_cast<float*>(y);
  float* hTp = static_cast<float*>(hT);
  if (dtype == kFloat32)
    return launch_n<float>(x, dtp, ap, Bm, Cm, h0p, yp, hTp, B, T, D, N, s);
  if (dtype == kBFloat16)
    return launch_n<__nv_bfloat16>(x, dtp, ap, Bm, Cm, h0p, yp, hTp, B, T, D, N, s);
  return cudaErrorInvalidValue;
}
