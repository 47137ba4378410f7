// Gradient of the Mamba-1 selective scan (B5's backward), for Hopper (sm_90a).
//
// Replaces: XLA's differentiation of the reference's lax.scan of
// `_scan_chunk` over `_ssm_params` (repro/models/mamba.py:52-75); the
// reference has no Pallas kernel for either direction. Per batch row b,
// channel c and state n, with h_t the state after step t (h_{-1} = h0),
// dA_t = exp(dt_t A), the forward
//   h_t = dA_t h_{t-1} + (dt_t x_t) B_t,   y_t = sum_n h_t C_t,
// and g the gradient of h_t, each step t = T-1 .. 0 takes
//   g        = dA_{t+1} g_{t+1} + dy_t C_t        (g_{T-1} also takes dhT)
//   dx_t     = dt_t sum_n g B_t
//   ddt_t    = sum_n g (A dA_t h_{t-1} + x_t B_t)
//   dB_t[n] += sum_c g dt_t x_t,   dC_t[n] += sum_c dy_t h_t
//   dA[c][n] += g dt_t dA_t h_{t-1}               (over b and t)
// and dh0 = dA_0 g_0, in fp32; dx, dB, dC are rounded once to x's dtype.
//
// h_{t-1} is never reconstructed backwards ((h_t - dBx_t) / dA_t is inf/NaN
// once exp(dt * A) underflows, with A < 0 and a large dt): the forward wrote
// the state before every kChunk-th step (selective_scan.cu's `ck`), and each
// chunk, last first, recomputes its states from its checkpoint with the
// forward's own arithmetic (ex2 of dt * A log2 e, dt * x first, one fma),
// so the same fp32 bits, into shared memory, then walks them in reverse.
//
// What bounds it on this card: the function's least work is bytes at
// Jamba's training shape (the rows of x, dt, dy, dx, ddt and the states:
// ~0.04 ms at B 4, T 128, d_in 16384, N 16), but the kernel issues ~35
// instructions a state element and step (the walk's ~14 fp32 operations
// and an exp, the recompute's 4 and an exp, and moving the dB/dC partial
// sums between lanes), so instruction issue and the latency of each
// chunk's steps bound it; the checkpoints (B * d_in * N * 4 B every kChunk
// steps) and the block partials below add ~0.1 GB of bytes.
//
// Design: the forward's decomposition: a block takes 32 channels of one
// batch row, two lanes a channel, each lane 8 of its 16 states (4 of 8).
// dx and ddt sum over a channel's states: one shuffle between its lanes.
// dB and dC sum over all d_in channels, spread over d_in / 32 blocks: a
// reduce-scatter over the warp's 16 channels (15 shuffles for a lane's 16
// partials) and a fixed-order sum of the block's two warps give one
// partial a block, (blocks, B, T, 2N) fp32; dA sums over b in the same way,
// (B, d_in, N) partials. A chunk's dx and ddt are staged in shared memory
// and written as coalesced rows once per chunk.
//  - The next chunk's rows of dt, x, dy, B, C and its checkpoint slice are
//    loaded into registers while this chunk walks, and stored to shared
//    memory at its start, so a chunk does not wait for device memory.
//  - The second kernel sums the partials in a fixed order with 8 threads an
//    output of dB/dC (each over every 8th block, then added in thread
//    order) and one thread an output of dA (the batch rows in order): ~1500
//    blocks at the training shape; one thread an output would fill 64.
// Both measured faster on an H100 than without them (PERF.md).
// Nothing uses atomics: two launches give the same bits. Measured slower
// and not kept: one exp a state element and step (the exps kept beside the
// states, in shared memory or registers, cost more occupancy than the exp
// they save) and summing dB/dC over a cluster of CTAs in distributed
// shared memory before writing partials (each cluster barrier waits for
// its slowest CTA); PERF.md has their times.
#include "common.cuh"
#include "reduce.cuh"

namespace {

constexpr int kChannels = kScanBwdChannels;   // channels a block: its partials' row
constexpr int kLanes = 2;                     // lanes a channel's states are split over
constexpr int kChunk = kCkptSteps;            // steps between the forward's checkpoints
constexpr int kThreads = kChannels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

template <typename X, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const X* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const X* __restrict__ Bm,
                          const X* __restrict__ Cm, const float* __restrict__ ck,
                          const float* __restrict__ dy, const float* __restrict__ dhT,
                          X* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ dh0, float* __restrict__ part,
                          float* __restrict__ dA_part, int T, int D) {
  constexpr int S = N / kLanes;               // states a lane keeps
  static_assert(2 * S <= 16, "a lane's dB and dC partials fit one reduce-scatter");
  // the chunk's states: before each step and after the last, per thread
  __shared__ float ring[kChunk + 1][S][kThreads];
  __shared__ float sdt[kChunk][kChannels], sx[kChunk][kChannels], sdy[kChunk][kChannels];
  __shared__ float sB[kChunk][N], sC[kChunk][N];
  __shared__ float sdx[kChunk][kChannels], sddt[kChunk][kChannels];
  __shared__ float wpart[kChunk][kWarps][2 * N];

  const int B = gridDim.y, b = blockIdx.y, blk = blockIdx.x;
  const int c0 = blk * kChannels;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / kLanes, g = tid % kLanes;
  const int c = c0 + cl;
  const bool live = c < D;
  const int nck = (T + kChunk - 1) / kChunk;
  const size_t state = ((size_t)b * D + c) * N + g * S;   // the lane's S states

  // a lane past d_in keeps zeros over zero-filled rows and writes nothing;
  // it still takes part in every shuffle and barrier
  float Ar[S], a[S], gn[S], dA_acc[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    Ar[q] = live ? A[(size_t)c * N + g * S + q] : 0.f;
    a[q] = Ar[q] * kLog2e;                    // as the forward prescales it
    gn[q] = live ? dhT[state + q] : 0.f;
    dA_acc[q] = 0.f;
  }

  // the next chunk's rows and checkpoint, loaded into registers while this
  // chunk walks and stored to shared memory at its start
  constexpr int kRowPer = kChunk * kChannels / kThreads;
  constexpr int kBCPer = (kChunk * N + kThreads - 1) / kThreads;
  float pdt[kRowPer], pdy[kRowPer], px[kRowPer], pb[kBCPer], pc[kBCPer], ph[S];
  auto fetch = [&](int ci) {
    const int t0 = ci * kChunk, n = min(kChunk, T - t0);
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) {
      const int e = tid + i * kThreads, s = e / kChannels, cc = c0 + e - s * kChannels;
      const bool ok = s < n && cc < D;
      const size_t off = ((size_t)b * T + t0 + s) * D + cc;
      pdt[i] = ok ? dt[off] : 0.f;
      px[i] = ok ? to_f32<X>(x[off]) : 0.f;
      pdy[i] = ok ? dy[off] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBCPer; ++i) {
      const int e = tid + i * kThreads, s = e / N;
      const bool ok = e < kChunk * N && s < n;
      const size_t off = ((size_t)b * T + t0) * N + e;
      pb[i] = ok ? to_f32<X>(Bm[off]) : 0.f;
      pc[i] = ok ? to_f32<X>(Cm[off]) : 0.f;
    }
    const float* cp = ck + (size_t)ci * B * D * N;
#pragma unroll
    for (int q = 0; q < S; ++q) ph[q] = live ? cp[state + q] : 0.f;
  };
  fetch(nck - 1);
  for (int ci = nck - 1; ci >= 0; --ci) {
    const int n = min(kChunk, T - ci * kChunk);
    __syncthreads();          // the previous chunk's shared rows are written out
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) {
      const int e = tid + i * kThreads, s = e / kChannels, j = e - s * kChannels;
      sdt[s][j] = pdt[i];
      sx[s][j] = px[i];
      sdy[s][j] = pdy[i];
    }
#pragma unroll
    for (int i = 0; i < kBCPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < kChunk * N) {
        sB[e / N][e % N] = pb[i];
        sC[e / N][e % N] = pc[i];
      }
    }
    float h[S];
#pragma unroll
    for (int q = 0; q < S; ++q) h[q] = ph[q];
    if (ci > 0) fetch(ci - 1);
    const int t0 = ci * kChunk;
    __syncthreads();

    // recompute the chunk's states, the forward's way
    for (int s = 0; s < n; ++s) {
      const float d = sdt[s][cl], dxv = d * sx[s][cl];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        ring[s][q][tid] = h[q];
        h[q] = fmaf(ex2(d * a[q]), h[q], dxv * sB[s][g * S + q]);
      }
    }
#pragma unroll
    for (int q = 0; q < S; ++q) ring[n][q][tid] = h[q];

    // the chunk's steps in reverse
    for (int s = n - 1; s >= 0; --s) {
      const float d = sdt[s][cl], xv = sx[s][cl], dyv = sdy[s][cl];
      const float dxv = d * xv;
      float pv[16];                           // [0, S): dB, [S, 2S): dC, then pad
      float sum_x = 0.f, sum_dt = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const float hp = ring[s][q][tid], ht = ring[s + 1][q][tid];
        const float bq = sB[s][g * S + q], cq = sC[s][g * S + q];
        const float dA = ex2(d * a[q]);
        const float gq = fmaf(dyv, cq, gn[q]);
        pv[q] = gq * dxv;
        pv[S + q] = dyv * ht;
        sum_x = fmaf(gq, bq, sum_x);
        sum_dt = fmaf(gq, fmaf(Ar[q] * dA, hp, xv * bq), sum_dt);
        dA_acc[q] = fmaf(gq * d, dA * hp, dA_acc[q]);
        gn[q] = dA * gq;
      }
#pragma unroll
      for (int q = 2 * S; q < 16; ++q) pv[q] = 0.f;
      // over the channel's lanes (lane bit 0): the same sum on both
#pragma unroll
      for (int m = 1; m < kLanes; m <<= 1) {
        sum_x += __shfl_xor_sync(0xffffffffu, sum_x, m);
        sum_dt += __shfl_xor_sync(0xffffffffu, sum_dt, m);
      }
      if (g == 0) {
        sdx[s][cl] = d * sum_x;
        sddt[s][cl] = sum_dt;
      }
      // over the warp's 16 channels (lane bits 1-4): lane holds index p
      const int p = lane >> 1;
      reduce_scatter<1, 8, 16>(pv, p);
      if (p < 2 * S) {
        const int kind = p / S, q = p - kind * S;
        wpart[s][warp][kind * N + g * S + q] = pv[0];
      }
    }
    __syncthreads();

    for (int e = tid; e < n * kChannels; e += kThreads) {
      const int s = e / kChannels, j = e - s * kChannels, cc = c0 + j;
      if (cc < D) {
        const size_t off = ((size_t)b * T + t0 + s) * D + cc;
        dx[off] = from_f32<X>(sdx[s][j]);
        ddt[off] = sddt[s][j];
      }
    }
    for (int e = tid; e < n * 2 * N; e += kThreads) {
      const int s = e / (2 * N), m = e - s * 2 * N;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += wpart[s][w][m];
      part[(((size_t)blk * B + b) * T + t0 + s) * 2 * N + m] = v;
    }
  }

  if (live) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      dh0[state + q] = gn[q];
      dA_part[state + q] = dA_acc[q];
    }
  }
}

constexpr int kSumSplit = 8;    // threads an output of dB/dC sums over

// dB, dC (B, T, N): the blocks' partials, kSumSplit threads an output each
// summing every kSumSplit-th block, then added in thread order; dA (D, N):
// the batch rows' partials summed in row order
template <typename X>
__global__ void __launch_bounds__(256)
selective_scan_bwd_sum(const float* __restrict__ part, const float* __restrict__ dA_part,
                       X* __restrict__ dB, X* __restrict__ dC, float* __restrict__ dA,
                       int blocks, int B, int T, int D, int N, int row_blocks) {
  constexpr int kOuts = 256 / kSumSplit;
  __shared__ float sp[kSumSplit][kOuts];
  if (int(blockIdx.x) < row_blocks) {
    const size_t rows = (size_t)B * T * 2 * N;
    const int k = threadIdx.x / kOuts, j = threadIdx.x % kOuts;
    const size_t o = (size_t)blockIdx.x * kOuts + j;
    float v = 0.f;
    if (o < rows)
      for (int ci = k; ci < blocks; ci += kSumSplit) v += part[(size_t)ci * rows + o];
    sp[k][j] = v;
    __syncthreads();
    if (k == 0 && o < rows) {
#pragma unroll
      for (int kk = 1; kk < kSumSplit; ++kk) v += sp[kk][j];
      const size_t bt = o / (2 * N);
      const int m = int(o - bt * 2 * N);
      if (m < N)
        dB[bt * N + m] = from_f32<X>(v);
      else
        dC[bt * N + m - N] = from_f32<X>(v);
    }
  } else {
    const size_t cols = (size_t)D * N;
    const size_t j = (size_t)(blockIdx.x - row_blocks) * blockDim.x + threadIdx.x;
    if (j < cols) {
      float v = 0.f;
      for (int k = 0; k < B; ++k) v += dA_part[(size_t)k * cols + j];
      dA[j] = v;
    }
  }
}

template <typename X, int N>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* ck, const float* dy, const float* dhT,
                   void* dx, float* ddt, void* dB, void* dC, float* dA, float* dh0,
                   float* part, float* dA_part, int B, int T, int D, cudaStream_t s) {
  const int blocks = (D + kChannels - 1) / kChannels;
  selective_scan_bwd_kernel<X, N><<<dim3(blocks, B), kThreads, 0, s>>>(
      static_cast<const X*>(x), dt, A, static_cast<const X*>(Bm), static_cast<const X*>(Cm),
      ck, dy, dhT, static_cast<X*>(dx), ddt, dh0, part, dA_part, T, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t rows = (size_t)B * T * 2 * N, cols = (size_t)D * N;
  constexpr int kOuts = 256 / kSumSplit;
  const int row_blocks = int((rows + kOuts - 1) / kOuts);
  selective_scan_bwd_sum<X><<<row_blocks + int((cols + 255) / 256), 256, 0, s>>>(
      part, dA_part, static_cast<X*>(dB), static_cast<X*>(dC), dA, blocks, B, T, D, N,
      row_blocks);
  return cudaGetLastError();
}

template <typename X>
cudaError_t launch_n(const void* x, const float* dt, const float* A, const void* Bm,
                     const void* Cm, const float* ck, const float* dy, const float* dhT,
                     void* dx, float* ddt, void* dB, void* dC, float* dA, float* dh0,
                     float* part, float* dA_part, int B, int T, int D, int N,
                     cudaStream_t s) {
  if (N == 8)
    return launch<X, 8>(x, dt, A, Bm, Cm, ck, dy, dhT, dx, ddt, dB, dC, dA, dh0, part,
                        dA_part, B, T, D, s);
  if (N == 16)
    return launch<X, 16>(x, dt, A, Bm, Cm, ck, dy, dhT, dx, ddt, dB, dC, dA, dh0, part,
                         dA_part, B, T, D, s);
  return cudaErrorInvalidValue;
}

template <typename X, int N>
cudaError_t occupancy(int* out) {
  auto kernel = selective_scan_bwd_kernel<X, N>;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  out[1] = kThreads;
  out[2] = int(fa.sharedSizeBytes);
  out[3] = fa.numRegs;
  return cudaSuccess;
}

}  // namespace

// x (B, T, D) in `dtype`; dt (B, T, D) fp32; A (D, N) fp32; Bm, Cm (B, T, N)
// in `dtype`; ck (ceil(T / 8), B, D, N) fp32, the forward's checkpoints; dy
// (B, T, D) and dhT (B, D, N) fp32. Writes dx (B, T, D) in `dtype`, ddt
// (B, T, D) fp32, dB, dC (B, T, N) in `dtype`, dA (D, N) and dh0 (B, D, N)
// fp32, through the scratch `part` (ceil(D / 32), B, T, 2N) and `dA_part`
// (B, D, N) fp32. All contiguous; N in {8, 16}; T >= 1. Two launches on
// `stream`; returns cudaGetLastError().
extern "C" int selective_scan_bwd_launch(const void* x, const void* dt, const void* A,
                                         const void* Bm, const void* Cm, const void* ck,
                                         const void* dy, const void* dhT, void* dx,
                                         void* ddt, void* dB, void* dC, void* dA,
                                         void* dh0, void* part, void* dA_part, int B,
                                         int T, int D, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || D <= 0) return cudaErrorInvalidValue;
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  const float* ckp = static_cast<const float*>(ck);
  const float* dyp = static_cast<const float*>(dy);
  const float* dhp = static_cast<const float*>(dhT);
  float* ddtp = static_cast<float*>(ddt);
  float* dAp = static_cast<float*>(dA);
  float* dh0p = static_cast<float*>(dh0);
  float* pp = static_cast<float*>(part);
  float* dApp = static_cast<float*>(dA_part);
  if (dtype == kFloat32)
    return launch_n<float>(x, dtp, ap, Bm, Cm, ckp, dyp, dhp, dx, ddtp, dB, dC, dAp, dh0p,
                           pp, dApp, B, T, D, N, s);
  if (dtype == kBFloat16)
    return launch_n<__nv_bfloat16>(x, dtp, ap, Bm, Cm, ckp, dyp, dhp, dx, ddtp, dB, dC, dAp,
                                   dh0p, pp, dApp, B, T, D, N, s);
  return cudaErrorInvalidValue;
}

// The main kernel's layout for (N, dtype) into out[4]: CTAs an SM, threads
// a CTA, shared bytes a CTA, registers a thread; returns a CUDA error code.
extern "C" int selective_scan_bwd_occupancy(int N, int dtype, void* out) {
  int* o = static_cast<int*>(out);
  if (dtype == kFloat32 && N == 8) return occupancy<float, 8>(o);
  if (dtype == kFloat32 && N == 16) return occupancy<float, 16>(o);
  if (dtype == kBFloat16 && N == 8) return occupancy<__nv_bfloat16, 8>(o);
  if (dtype == kBFloat16 && N == 16) return occupancy<__nv_bfloat16, 16>(o);
  return cudaErrorInvalidValue;
}
