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
// What bounds it on this card. At decode (T = 1): bytes. Every state element
// is read and written once (2 * B * d_in * N * 4 B; 8.4 MB of the ~10 MB at
// Jamba's B = 4, d_in = 16384, N = 16) against 7 fp32 operations each. Over
// a prefill the rows of x, dt and y add 10 B a channel and step (bf16 x)
// against N exps: at B = 1 and N = 16 the exps alone, at 16 a clock on an
// SM's special-function units (SFUs), take about as long as the bytes at
// T = 36 and longer at long T (2048 steps: 0.128 ms of exps at 1980 MHz
// against 0.101 ms of bytes). The steps are a chain, and a B = 1 prefill
// has only d_in * N state chains, so its warps must each keep several
// steps in flight to feed the SFUs.
//
// Design. What a simple kernel (one thread per (b, channel), 64
// channels a block, 12-16 % of its bound) lacks, and what this one does:
//  1. Too few threads: a group of G lanes takes one (b, channel), each lane
//     keeping S = N / G states and the matching slice of A's row in
//     registers; y_t is the lanes' partial sums plus a fixed-order
//     __shfl_xor_sync butterfly (log2 G steps), so two launches on the same
//     inputs give bit-equal outputs. G = 2 (kLanes): measured against 1, 4,
//     8 and 16 by scripts/kernel_ab.py --lanes, it was fastest at decode
//     and at every B = 1 prefill length: more lanes add per-lane loads and
//     shuffles faster than they hide latency.
//  2. Uncoalesced state: h0, A and h_T move as 16-byte vectors, a lane's
//     S = 8 states as chunks g and g + 2 of its channel's row, so a
//     channel's two lanes cover 32 contiguous bytes per access and every
//     sector a warp touches is whole (one thread a channel touches 32
//     sectors with 4 bytes each per access).
//  3. Accurate expf on every element: exp(dt*A) is ex2.approx of
//     dt * (A * log2 e), A prescaled once per lane: one SFU instruction
//     (max relative error ~2^-22; results below 2^-126 flush to zero,
//     which a state of O(1) cannot see).
//  4. Synchronous staging: a block's step tiles (the shared B_t / C_t rows
//     and its 32 columns of x and dt) go through a two-stage cp.async ring
//     in dynamic shared memory, kTile = 64 steps a stage (no slower than 32
//     at any length, faster from T = 36), so the scan of one tile overlaps
//     the load of the next.
//     Once a tile lands, the block widens it to fp32 (dt, dt * x, B, C) in
//     one pass, so a lane's step is vector loads from shared memory, 2 fp32
//     multiplies, an ex2 and 2 FMAs a state; a lane takes kUnroll = 8 steps
//     at a time (the last T % 8 in blocks of 4, 2 and 1) with every load
//     before the first y store, so those steps' loads and exps overlap and
//     only the FMA chain through h is serial.
//     A stage holds min(T, kTile) steps, so a decode block takes < 1 KB of
//     shared memory, and the decode build caps registers at 64 so a pool of
//     4 at d_in 16384 (2048 blocks) is resident in one wave. When a pointer
//     or a row is not 16-byte aligned (d_in not a multiple of 8 for bf16 x)
//     the ring is filled by plain loads and the state moves by scalars.
// y is stored by the group's first lane. One launch carries the state over
// any T >= 1 (the reference's 256-step chunks become the loop).
//
// Under a gradient the wrapper passes `ck`, and the launch also writes the
// fp32 state before every kCkpt-th step, (ceil(T / kCkpt), B, d_in, N), at
// the start of a lane's block of steps: selective_scan_bwd.cu recomputes
// each chunk of kCkpt steps from its checkpoint instead of running the
// recurrence backwards (h_{t-1} = (h_t - dBx_t) / dA_t is inf/NaN once
// exp(dt * A) underflows). With ck null the launch takes the build without
// the stores (CKPT = false): the serving kernel's code and bits. A branch on
// ck inside one build instead gave the same bits but cost the serving
// launch time (0.2916 against 0.2619 ms at B 1, T 2048; H100,
// scripts/kernel_ab.py --parent), so each instantiation is built twice.
#include <atomic>

#include "sm90.cuh"

namespace {

// SCAN_LANES / SCAN_TILE override the two measured choices for a sweep
// build (scripts/kernel_ab.py --lanes); the served library takes these.
#ifndef SCAN_LANES
#define SCAN_LANES 2
#endif
#ifndef SCAN_TILE
#define SCAN_TILE 64
#endif

constexpr int kChannels = 32;          // channels a block takes
constexpr int kLanes = SCAN_LANES;     // lanes a channel's states are split over
constexpr int kTile = SCAN_TILE;       // steps a ring stage holds
constexpr int kUnroll = 8;             // steps a lane has in flight over a prefill
constexpr int kCkpt = kCkptSteps;      // steps between state checkpoints (selective_scan_bwd.cu's kChunk)
static_assert(kCkpt % kUnroll == 0 && kTile % kCkpt == 0,
              "a checkpoint falls on the start of a lane's block of steps");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// Lane g of a group of G keeps S = N / G of a channel's N states. With
// S >= 4 it holds every G-th 16-byte chunk of the channel's row (chunks g,
// g + G, ...), so the G lanes of a channel read or write 16 * G contiguous
// bytes in each vector access and every sector a warp touches is whole;
// with S < 4 it holds S consecutive states.
template <int N, int G>
__device__ __forceinline__ int lane_state0(int g) {
  return N / G >= 4 ? 4 * g : (N / G) * g;
}

// a lane's S states of the row at p (p + lane_state0), as 16- or 8-byte
// vectors when vec
template <int S, int G>
__device__ __forceinline__ void load_f32(float (&v)[S], const float* p, bool vec) {
  if constexpr (S % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < S / 4; ++k) {
        const float4 q = reinterpret_cast<const float4*>(p)[k * G];
        v[4 * k] = q.x, v[4 * k + 1] = q.y, v[4 * k + 2] = q.z, v[4 * k + 3] = q.w;
      }
      return;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = p[(s / 4) * 4 * G + s % 4];
  } else {
    if constexpr (S == 2) {
      if (vec) {
        const float2 q = *reinterpret_cast<const float2*>(p);
        v[0] = q.x, v[1] = q.y;
        return;
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = p[s];
  }
}

template <int S, int G>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[S], bool vec) {
  if constexpr (S % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < S / 4; ++k)
        reinterpret_cast<float4*>(p)[k * G] =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      return;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) p[(s / 4) * 4 * G + s % 4] = v[s];
  } else {
    if constexpr (S == 2) {
      if (vec) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
        return;
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) p[s] = v[s];
  }
}

// bytes of one ring stage of `tile` steps: x, dt (the block's columns), B, C
template <typename X, int N>
__host__ __device__ constexpr int stage_bytes(int tile) {
  return tile * (kChannels * int(sizeof(X)) + kChannels * 4 + 2 * N * int(sizeof(X)));
}

// bytes of the fp32 tile the scan reads: dt, dt * x (the block's columns),
// B and C, widened once a tile for every lane of the block
template <int N>
__host__ __device__ constexpr int wide_bytes(int tile) {
  return tile * (2 * kChannels + 2 * N) * 4;
}

// U consecutive steps t..t+U-1 of a lane's S = N / G states, read from the
// fp32 tile. Every load comes before the first y store and the exps do not
// depend on h, so the U steps' loads and exps overlap and only the FMA chain
// through h is sequential.
template <int N, int G, int U>
__device__ __forceinline__ void scan_steps(float (&h)[N / G], const float (&a)[N / G],
                                           const float* wd, const float* wdx,
                                           const float* wb, const float* wc, int t,
                                           int cl, int g, float* yc, int D, bool store) {
  constexpr int S = N / G;
  float d[U], dx[U], bv[U][S], cv[U][S], p[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    d[u] = wd[(t + u) * kChannels + cl];
    dx[u] = wdx[(t + u) * kChannels + cl];
    load_f32<S, G>(bv[u], wb + (t + u) * N + lane_state0<N, G>(g), true);
    load_f32<S, G>(cv[u], wc + (t + u) * N + lane_state0<N, G>(g), true);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    p[u] = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      h[s] = fmaf(ex2(d[u] * a[s]), h[s], dx[u] * bv[u][s]);
      p[u] = fmaf(h[s], cv[u][s], p[u]);
    }
  }
  // y_t: the group's partial sums, the same butterfly order for every step
#pragma unroll
  for (int m = 1; m < G; m <<= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) p[u] += __shfl_xor_sync(0xffffffffu, p[u], m);
  }
  if (store) {
#pragma unroll
    for (int u = 0; u < U; ++u) yc[(size_t)(t + u) * D] = p[u];
  }
}

template <typename X, int N, int G, int U, bool CKPT>
__global__ void __launch_bounds__(kChannels * G, U == 1 ? 1024 / (kChannels * G) : 1)
selective_scan_kernel(const X* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const X* __restrict__ Bm,
                      const X* __restrict__ Cm, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ hT,
                      float* __restrict__ ck, int T, int D, int tile, bool vec) {
  static_assert(U == 1 || U == 2 || U == 4 || U == 8, "the remainder cascade");
  constexpr int S = N / G;                  // states a lane keeps
  constexpr int kThreads = kChannels * G;
  constexpr int kX = 16 / int(sizeof(X));   // X elements in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int cl = tid / G, g = tid % G;      // channel in the block, lane in group
  const int c = c0 + cl;
  const bool live = c < D;
  const size_t seq = (size_t)b * T;         // row of (b, t = 0) in (B, T, .)
  const int n0 = lane_state0<N, G>(g);
  const size_t state = ((size_t)b * D + c) * N + n0;

  // a lane past d_in keeps zero states over zero-filled columns (ex2(0) = 1)
  // and stores nothing; it still takes part in every shuffle and barrier
  float h[S] = {}, a[S] = {};
  if (live) {
    load_f32<S, G>(h, h0 + state, vec);
    load_f32<S, G>(a, A + (size_t)c * N + n0, vec);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] *= kLog2e;
  }

  // ring stage `buf`: x[tile][kChannels] X, dt[tile][kChannels] fp32,
  // B[tile][N] X, C[tile][N] X; then the fp32 tile: dt, dt * x, B, C
  auto ring = [&](int buf) { return smem + buf * stage_bytes<X, N>(tile); };
  float* const wd = reinterpret_cast<float*>(ring(2));
  float* const wdx = wd + tile * kChannels;
  float* const wb = wdx + tile * kChannels;
  float* const wc = wb + tile * N;

  // stage the steps of tile i into ring stage i % 2
  auto stage = [&](int i) {
    const int t0 = i * tile, steps = min(tile, T - t0);
    X* xs = reinterpret_cast<X*>(ring(i & 1));
    float* ds = reinterpret_cast<float*>(xs + tile * kChannels);
    X* bs = reinterpret_cast<X*>(ds + tile * kChannels);
    X* cs = bs + tile * N;
    const size_t row0 = seq + t0;
    if (vec) {
      constexpr int kXC = kChannels / kX, kDC = kChannels / 4;   // chunks a row
      for (int k = tid; k < steps * kXC; k += kThreads) {
        const int t = k / kXC, ch = k - t * kXC, cc = c0 + ch * kX;
        const bool ok = cc < D;             // D % kX == 0: whole chunks
        cp_async16(xs + t * kChannels + ch * kX, ok ? x + (row0 + t) * D + cc : x, ok);
      }
      for (int k = tid; k < steps * kDC; k += kThreads) {
        const int t = k / kDC, ch = k - t * kDC, cc = c0 + ch * 4;
        const bool ok = cc < D;
        cp_async16(ds + t * kChannels + ch * 4, ok ? dt + (row0 + t) * D + cc : dt, ok);
      }
      // the steps' B and C rows are contiguous: steps * N elements each
      for (int k = tid; k < steps * N / kX; k += kThreads) {
        cp_async16(bs + k * kX, Bm + row0 * N + k * kX, true);
        cp_async16(cs + k * kX, Cm + row0 * N + k * kX, true);
      }
    } else {
      for (int k = tid; k < steps * kChannels; k += kThreads) {
        const int t = k / kChannels, j = k - t * kChannels, cc = c0 + j;
        const bool ok = cc < D;
        const size_t off = (row0 + t) * D + cc;
        xs[k] = ok ? x[off] : from_f32<X>(0.f);
        ds[k] = ok ? dt[off] : 0.f;
      }
      for (int k = tid; k < steps * N; k += kThreads) {
        bs[k] = Bm[row0 * N + k];
        cs[k] = Cm[row0 * N + k];
      }
    }
    cp_async_commit();
  };

  // the lane's states before step t, into checkpoint t / kCkpt
  auto save = [&](int t) {
    if constexpr (CKPT) {
      if (live && t % kCkpt == 0)
        store_f32<S, G>(ck + (size_t)(t / kCkpt) * gridDim.y * D * N + state, h, vec);
    }
  };

  const int tiles = (T + tile - 1) / tile;
  stage(0);
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      stage(i + 1);                         // overlaps the scan of tile i
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // tile i is in every thread's view
    const int t0 = i * tile, steps = min(tile, T - t0);
    {
      // widen tile i once for the block (the scan reads only the fp32 tile,
      // so stage i + 2 may refill this ring stage after the next barrier)
      const X* xs = reinterpret_cast<const X*>(ring(i & 1));
      const float* ds = reinterpret_cast<const float*>(xs + tile * kChannels);
      const X* bs = reinterpret_cast<const X*>(ds + tile * kChannels);
      for (int k = tid; k < steps * kChannels; k += kThreads) {
        const float d = ds[k];
        wd[k] = d;
        wdx[k] = d * to_f32<X>(xs[k]);      // dt * x first, as the reference
      }
      for (int k = tid; k < steps * N; k += kThreads) {
        wb[k] = to_f32<X>(bs[k]);
        wc[k] = to_f32<X>(bs[tile * N + k]);
      }
    }
    __syncthreads();
    float* yc = y + (seq + t0) * D + c;
    const bool store = live && g == 0;      // y_t from the group's first lane
    int t = 0;
    for (; t + U <= steps; t += U) {
      save(t0 + t);
      scan_steps<N, G, U>(h, a, wd, wdx, wb, wc, t, cl, g, yc, D, store);
    }
    if (t < steps) save(t0 + t);            // the remainder's first step
    // the last steps % U in blocks of 4, 2 and 1 (U = 8), not one by one
    if constexpr (U >= 8) {
      if (t + 4 <= steps) {
        scan_steps<N, G, 4>(h, a, wd, wdx, wb, wc, t, cl, g, yc, D, store);
        t += 4;
      }
    }
    if constexpr (U >= 4) {
      if (t + 2 <= steps) {
        scan_steps<N, G, 2>(h, a, wd, wdx, wb, wc, t, cl, g, yc, D, store);
        t += 2;
      }
    }
    if constexpr (U >= 2) {
      if (t < steps) scan_steps<N, G, 1>(h, a, wd, wdx, wb, wc, t, cl, g, yc, D, store);
    }
  }

  if (live) store_f32<S, G>(hT + state, h, vec);
}

template <typename X, int N, int G, int U, bool CKPT>
cudaError_t launch_g(const X* x, const float* dt, const float* A, const X* Bm,
                     const X* Cm, const float* h0, float* y, float* hT, float* ck,
                     int B, int T, int D, bool vec, cudaStream_t s) {
  const int tile = T < kTile ? T : kTile;
  const int bytes = 2 * stage_bytes<X, N>(tile) + wide_bytes<N>(tile);
  // Above 48 KB a launch needs the instantiation's opt-in, which is set once
  // per device to what a full kTile-step ring takes (the most any T asks).
  constexpr int kMost = 2 * stage_bytes<X, N>(kTile) + wide_bytes<N>(kTile);
  if (bytes > 48 * 1024) {
    static std::atomic<unsigned> opted{0};  // bit d: device d has the opt-in
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (!(opted.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(selective_scan_kernel<X, N, G, U, CKPT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMost);
      if (err != cudaSuccess) return err;
      opted.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  selective_scan_kernel<X, N, G, U, CKPT><<<grid, kChannels * G, bytes, s>>>(
      x, dt, A, Bm, Cm, h0, y, hT, ck, T, D, tile, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename X, int N>
cudaError_t launch_n(const void* x, const float* dt, const float* A, const void* Bm,
                     const void* Cm, const float* h0, float* y, float* hT, float* ck,
                     int B, int T, int D, cudaStream_t s) {
  constexpr int G = kLanes < N ? kLanes : N;  // at least one state a lane
  const X* xp = static_cast<const X*>(x);
  const X* bp = static_cast<const X*>(Bm);
  const X* cp = static_cast<const X*>(Cm);
  // 16-byte staging and vector state accesses need aligned bases and rows
  const bool vec = aligned16(x) && aligned16(dt) && aligned16(A) && aligned16(Bm) &&
                   aligned16(Cm) && aligned16(h0) && aligned16(hT) && aligned16(ck) &&
                   D % (16 / int(sizeof(X))) == 0;
  // decode (T = 1): no steps to overlap, registers for occupancy; ck: the
  // build that writes checkpoints
  if (T == 1 && ck != nullptr)
    return launch_g<X, N, G, 1, true>(xp, dt, A, bp, cp, h0, y, hT, ck, B, T, D, vec, s);
  if (T == 1)
    return launch_g<X, N, G, 1, false>(xp, dt, A, bp, cp, h0, y, hT, ck, B, T, D, vec, s);
  if (ck != nullptr)
    return launch_g<X, N, G, kUnroll, true>(xp, dt, A, bp, cp, h0, y, hT, ck, B, T, D, vec,
                                            s);
  return launch_g<X, N, G, kUnroll, false>(xp, dt, A, bp, cp, h0, y, hT, ck, B, T, D, vec,
                                           s);
}

template <typename X>
cudaError_t launch_x(const void* x, const float* dt, const float* A, const void* Bm,
                     const void* Cm, const float* h0, float* y, float* hT, float* ck,
                     int B, int T, int D, int N, cudaStream_t s) {
  if (N == 8) return launch_n<X, 8>(x, dt, A, Bm, Cm, h0, y, hT, ck, B, T, D, s);
  if (N == 16) return launch_n<X, 16>(x, dt, A, Bm, Cm, h0, y, hT, ck, B, T, D, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, T, D) in `dtype`; dt (B, T, D) fp32; A (D, N) fp32; Bm, Cm (B, T, N)
// in `dtype`; h0 (B, D, N) fp32; y (B, T, D) fp32; hT (B, D, N) fp32; ck
// null, or (ceil(T / 8), B, D, N) fp32 for the state before every 8th step.
// All contiguous; N in {8, 16}; T >= 1. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int selective_scan_launch(const void* x, const void* dt, const void* A,
                                     const void* Bm, const void* Cm, const void* h0,
                                     void* y, void* hT, void* ck, int B, int T, int D,
                                     int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || D <= 0) return cudaErrorInvalidValue;
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float* yp = static_cast<float*>(y);
  float* hTp = static_cast<float*>(hT);
  float* ckp = static_cast<float*>(ck);
  if (dtype == kFloat32)
    return launch_x<float>(x, dtp, ap, Bm, Cm, h0p, yp, hTp, ckp, B, T, D, N, s);
  if (dtype == kBFloat16)
    return launch_x<__nv_bfloat16>(x, dtp, ap, Bm, Cm, h0p, yp, hTp, ckp, B, T, D, N, s);
  return cudaErrorInvalidValue;
}
