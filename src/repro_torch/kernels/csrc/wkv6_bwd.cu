// Gradient of the RWKV6 recurrence (B4's backward), for Hopper (sm_90a).
//
// Replaces: XLA's differentiation of the reference's lax.scan over
// `_wkv_chunk` (repro/models/rwkv6.py:78-89); the reference has no backward
// Pallas kernel. Per (batch, head) row, with the (K, V) = (hd, hd) state
// S_t before step t (S_0 = s0), a_t = k_t v_t^T, the forward
//   o_t = r_t^T (S_t + diag(u) a_t),   S_{t+1} = diag(w_t) S_t + a_t,
// and G the gradient of the state after step t (G = dsN after the last
// step), each step t = T-1 .. 0 takes
//   dr_t[i] = sum_j S_t[i][j] do_t[j] + u[i] k_t[i] (do_t . v_t)
//   dk_t[i] = sum_j G[i][j] v_t[j]    + u[i] r_t[i] (do_t . v_t)
//   dv_t[j] = sum_i G[i][j] k_t[i]    + do_t[j] sum_i u[i] r_t[i] k_t[i]
//   dw_t[i] = sum_j G[i][j] S_t[i][j]
//   du[i]  += r_t[i] k_t[i] (do_t . v_t)
//   G       = diag(w_t) G + r_t do_t^T
// and ds0 = G at the end; all in fp32, gradients rounded once to each
// input's dtype.
//
// S_t is never reconstructed backwards ((S_{t+1} - a_t) / w_t is inf/NaN
// once a data-dependent decay underflows): the forward wrote the state
// before every kChunk-th step (wkv6.cu's `ck`), and each chunk, last first,
// recomputes its kChunk states from its checkpoint with the forward's own
// expression (w * S + k * v, so the same fp32 bits) into shared memory,
// then walks them in reverse.
//
// What bounds it on this card: fp32 operations. Per state element and step
// the reverse walk takes 4 products (S.do, G.v, G.S and G^T k: 8 flops)
// and the update of G (3), and the recompute 3 more; the rows of r/k/v/w/do
// and of the gradients are O(hd) a step against O(hd^2) of work, and the
// checkpoints add hd^2 * 4 B every kChunk steps. At the training shape (B*H
// = 256 rows of hd 64, T = 128) that is ~0.02 ms of fp32 flops.
//
// Design: one block a row, so that every reduction stays in the block and
// nothing crosses blocks (no atomics: two launches give the same bits).
// Thread (ti, tj) of (hd/4) x (hd/4) keeps a 4 x 4 tile of G, rows 4ti..,
// columns 4tj... The three sums over columns (S.do, G.v, G.S: 12 values
// a thread) are one reduce-scatter over the tj lanes of a warp (15
// shuffles at hd 64, not 48 of a butterfly each), after which each lane
// holds whole sums for one (quantity, row); the sum over rows (G^T k) is a
// reduce-scatter over the warp's ti lanes and a fixed-order sum over the
// warps' partials in shared memory. A chunk's gradients are staged in
// shared memory and written as coalesced rows once per chunk, with the O(hd)
// u terms added there. du sums over T inside the block, in reverse step
// order. The recomputed states take kChunk * hd^2 * 4 B of shared memory
// (128 KB at hd 64: one block an SM; 2 waves at B*H = 256), each thread's
// own elements as float4 columns, so no access conflicts.
#include "common.cuh"
#include "reduce.cuh"

namespace {

constexpr int kChunk = kCkptSteps;   // steps between the forward's checkpoints

template <int HD>
struct Layout {
  static constexpr int TC = HD / 4;          // column threads, 4 columns each
  static constexpr int NT = TC * TC;         // threads: a 4 x 4 tile each
  static constexpr int NW = NT / 32;         // warps
  static constexpr int LR = 32 / TC;         // row threads in a warp
  // shared memory, in floats: the recomputed states, then r/k/w/v/do of the
  // chunk, the three column sums, the warps' row sums, and per step
  // do.v and sum u r k, then u
  static constexpr int kRing = kChunk * 16 * NT;
  static constexpr int kRows = 5 * kChunk * HD;
  static constexpr int kSums = 3 * kChunk * HD;
  static constexpr int kWarpSums = kChunk * NW * HD;
  static constexpr int kFloats = kRing + kRows + kSums + kWarpSums + 2 * kChunk + HD;
  static constexpr int kBytes = kFloats * 4;
};

template <typename R, typename W, int HD>
__global__ void __launch_bounds__(Layout<HD>::NT)
wkv6_bwd_kernel(const R* __restrict__ r, const R* __restrict__ k,
                const R* __restrict__ v, const W* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ ck,
                const R* __restrict__ dout, const float* __restrict__ dsN,
                R* __restrict__ dr, R* __restrict__ dk, R* __restrict__ dv,
                W* __restrict__ dw, float* __restrict__ du, float* __restrict__ ds0,
                int T) {
  using L = Layout<HD>;
  constexpr int TC = L::TC, NT = L::NT, NW = L::NW, LR = L::LR;
  extern __shared__ __align__(16) float sm[];
  float4* const ring = reinterpret_cast<float4*>(sm);    // [kChunk][4][NT]
  float* const rs = sm + L::kRing;                       // [kChunk][HD] each
  float* const ks = rs + kChunk * HD;
  float* const ws = ks + kChunk * HD;
  float* const vs = ws + kChunk * HD;
  float* const ds = vs + kChunk * HD;
  float* const sums = ds + kChunk * HD;                  // [3][kChunk][HD]
  float* const wsum = sums + L::kSums;                   // [kChunk][NW][HD]
  float* const es = wsum + L::kWarpSums;                 // [kChunk]: do . v
  float* const cs = es + kChunk;                         // [kChunk]: sum u r k
  float* const us = cs + kChunk;                         // [HD]

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ti = tid / TC, tj = tid % TC;
  const int i0 = 4 * ti, j0 = 4 * tj;
  const size_t seq = (size_t)bh * T * HD;
  const size_t row = (size_t)bh * HD * HD;
  const int nck = (T + kChunk - 1) / kChunk;
  for (int i = tid; i < HD; i += NT) us[i] = u[(size_t)bh * HD + i];

  float G[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) G[a][b] = dsN[row + (size_t)(i0 + a) * HD + j0 + b];
  float du_acc = 0.f;       // row tid's du (tid < HD)

  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
    __syncthreads();        // the previous chunk's shared rows are written out
    for (int e = tid; e < n * HD; e += NT) {
      const size_t off = seq + (size_t)t0 * HD + e;
      rs[e] = to_f32<R>(r[off]);
      ks[e] = to_f32<R>(k[off]);
      ws[e] = to_f32<W>(w[off]);
      vs[e] = to_f32<R>(v[off]);
      ds[e] = to_f32<R>(dout[off]);
    }
    float S[4][4];
    const float* cp = ck + ((size_t)bh * nck + c) * HD * HD;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) S[a][b] = cp[(size_t)(i0 + a) * HD + j0 + b];
    __syncthreads();

    // per step: do_t . v_t and sum_i u r_t k_t, a warp a step, fixed order
    for (int s = warp; s < n; s += NW) {
      float e = 0.f, cc = 0.f;
      for (int i = lane; i < HD; i += 32) {
        e += ds[s * HD + i] * vs[s * HD + i];
        cc += us[i] * rs[s * HD + i] * ks[s * HD + i];
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        e += __shfl_xor_sync(0xffffffffu, e, m);
        cc += __shfl_xor_sync(0xffffffffu, cc, m);
      }
      if (lane == 0) es[s] = e, cs[s] = cc;
    }

    // recompute the chunk's states S_t0 .. S_{t0+n-1}, the forward's way
    for (int s = 0; s < n; ++s) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        ring[(s * 4 + a) * NT + tid] = make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
      if (s + 1 < n) {
        const float4 k4 = *reinterpret_cast<const float4*>(ks + s * HD + i0);
        const float4 w4 = *reinterpret_cast<const float4*>(ws + s * HD + i0);
        const float4 v4 = *reinterpret_cast<const float4*>(vs + s * HD + j0);
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w}, wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float av = kk[a] * vv[b];
            S[a][b] = wv[a] * S[a][b] + av;
          }
      }
    }

    // the chunk's steps in reverse
    for (int s = n - 1; s >= 0; --s) {
      float St[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 q = ring[(s * 4 + a) * NT + tid];
        St[a][0] = q.x, St[a][1] = q.y, St[a][2] = q.z, St[a][3] = q.w;
      }
      const float4 r4 = *reinterpret_cast<const float4*>(rs + s * HD + i0);
      const float4 k4 = *reinterpret_cast<const float4*>(ks + s * HD + i0);
      const float4 w4 = *reinterpret_cast<const float4*>(ws + s * HD + i0);
      const float4 v4 = *reinterpret_cast<const float4*>(vs + s * HD + j0);
      const float4 d4 = *reinterpret_cast<const float4*>(ds + s * HD + j0);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w}, dd[4] = {d4.x, d4.y, d4.z, d4.w};
      // x[a]: S.do, x[4 + a]: G.v, x[8 + a]: G.S of row i0 + a; x[12..15] pad
      float x[16], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float p0 = 0.f, p1 = 0.f, p2 = 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          p0 = fmaf(St[a][b], dd[b], p0);
          p1 = fmaf(G[a][b], vv[b], p1);
          p2 = fmaf(G[a][b], St[a][b], p2);
        }
        x[a] = p0, x[4 + a] = p1, x[8 + a] = p2, x[12 + a] = 0.f;
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float q = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) q = fmaf(G[a][b], kk[a], q);
        y[b] = q;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) G[a][b] = fmaf(wv[a], G[a][b], rr[a] * dd[b]);

      // over the row's columns: the tj lanes (low bits of the lane)
      reduce_scatter<0, TC / 2, 16>(x, tj);
      constexpr int PX = 16 / TC;             // sums a lane holds
#pragma unroll
      for (int q = 0; q < PX; ++q) {
        const int idx = tj * PX + q, kind = idx / 4;
        if (kind < 3) sums[(kind * kChunk + s) * HD + i0 + idx % 4] = x[q];
      }
      // over the column's rows: the warp's ti lanes, then the warps
      const int pr = lane / TC;
      reduce_scatter<log2i(TC), LR / 2, 4>(y, pr);
      constexpr int PY = 4 / LR;
#pragma unroll
      for (int q = 0; q < PY; ++q) wsum[(s * NW + warp) * HD + j0 + pr * PY + q] = y[q];
    }
    __syncthreads();

    // the chunk's gradients, as rows, with the u terms
    for (int e = tid; e < n * HD; e += NT) {
      const int s = e / HD, i = e - s * HD;
      const size_t off = seq + (size_t)t0 * HD + e;
      const float ev = es[s];
      float dvs = 0.f;
#pragma unroll
      for (int q = 0; q < NW; ++q) dvs += wsum[(s * NW + q) * HD + i];
      dr[off] = from_f32<R>(sums[s * HD + i] + us[i] * ks[e] * ev);
      dk[off] = from_f32<R>(sums[(kChunk + s) * HD + i] + us[i] * rs[e] * ev);
      dw[off] = from_f32<W>(sums[(2 * kChunk + s) * HD + i]);
      dv[off] = from_f32<R>(dvs + ds[e] * cs[s]);
    }
    if (tid < HD) {
      for (int s = n - 1; s >= 0; --s)
        du_acc = fmaf(rs[s * HD + tid] * ks[s * HD + tid], es[s], du_acc);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) ds0[row + (size_t)(i0 + a) * HD + j0 + b] = G[a][b];
  if (tid < HD) du[(size_t)bh * HD + tid] = du_acc;
}

template <typename R, typename W, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* ck, const void* dout, const float* dsN,
                   void* dr, void* dk, void* dv, void* dw, float* du, float* ds0, int BH,
                   int T, cudaStream_t s) {
  using L = Layout<HD>;
  auto kernel = wkv6_bwd_kernel<R, W, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<BH, L::NT, L::kBytes, s>>>(
      static_cast<const R*>(r), static_cast<const R*>(k), static_cast<const R*>(v),
      static_cast<const W*>(w), u, ck, static_cast<const R*>(dout), dsN,
      static_cast<R*>(dr), static_cast<R*>(dk), static_cast<R*>(dv), static_cast<W*>(dw),
      du, ds0, T);
  return cudaGetLastError();
}

template <typename R, typename W>
cudaError_t launch_hd(const void* r, const void* k, const void* v, const void* w,
                      const float* u, const float* ck, const void* dout, const float* dsN,
                      void* dr, void* dk, void* dv, void* dw, float* du, float* ds0,
                      int BH, int T, int hd, cudaStream_t s) {
  if (hd == 32)
    return launch<R, W, 32>(r, k, v, w, u, ck, dout, dsN, dr, dk, dv, dw, du, ds0, BH, T, s);
  if (hd == 64)
    return launch<R, W, 64>(r, k, v, w, u, ck, dout, dsN, dr, dk, dv, dw, du, ds0, BH, T, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, dout (BH, T, hd) in `dtype`; w (BH, T, hd) in `w_dtype` (fp32 or
// `dtype`); u (BH, hd) fp32; ck (BH, ceil(T / 8), hd, hd) fp32, the
// forward's checkpoints; dsN (BH, hd, hd) fp32. Writes dr, dk, dv (BH, T,
// hd) in `dtype`, dw (BH, T, hd) in `w_dtype`, du (BH, hd) and ds0 (BH, hd,
// hd) fp32. All contiguous; hd in {32, 64}; T >= 1. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* ck,
                               const void* dout, const void* dsN, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* ds0, int BH, int T,
                               int hd, int dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || T <= 0) return cudaErrorInvalidValue;
  const float* up = static_cast<const float*>(u);
  const float* ckp = static_cast<const float*>(ck);
  const float* dsp = static_cast<const float*>(dsN);
  float* dup = static_cast<float*>(du);
  float* d0p = static_cast<float*>(ds0);
  if (dtype == kFloat32 && w_dtype == kFloat32)
    return launch_hd<float, float>(r, k, v, w, up, ckp, dout, dsp, dr, dk, dv, dw, dup, d0p,
                                   BH, T, hd, s);
  if (dtype == kBFloat16 && w_dtype == kFloat32)
    return launch_hd<__nv_bfloat16, float>(r, k, v, w, up, ckp, dout, dsp, dr, dk, dv, dw,
                                           dup, d0p, BH, T, hd, s);
  if (dtype == kBFloat16 && w_dtype == kBFloat16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, up, ckp, dout, dsp, dr, dk,
                                                   dv, dw, dup, d0p, BH, T, hd, s);
  return cudaErrorInvalidValue;
}
