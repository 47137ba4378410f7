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
// expression (w * S + k * v, so the same fp32 bits), then walks them in
// reverse.
//
// What bounds it on this card: per state element and step the reverse walk
// takes 4 products (S.do, G.v, G.S and G^T k: 8 flops) and the update of G
// (3), the recompute 3 more; the rows of r/k/v/w/do and of the gradients are
// O(hd) a step against O(hd^2) of work. At the training shape (B*H = 256
// rows of hd 64, T = 128) the function's least work is ~0.02 ms of fp32
// flops; what a design adds is moving partial sums between threads and the
// barriers between a chunk's phases, and those set its time.
//
// Design:
//  - Thread (ti, tj) keeps a 2 x 4 tile of G (rows 2ti.., columns 4tj..)
//    and the chunk's 8 recomputed states of that tile in registers (64
//    floats; the chunk's steps fully unrolled, so the ring is indexed at
//    compile time): a ring in shared memory would take 128 KB a row and a
//    load and a store a state element and step.
//  - Partial sums go through shared memory, not shuffle trees: each step a
//    thread stores its 3 x 2 row partials (float2s: dr, dk, dw over its
//    columns) and its 4 column partials (a float4: dv over its rows); after
//    every kSub steps one barrier, and the block sums them in a fixed order
//    (column threads, then row threads) with 16-byte loads, 4 outputs a
//    thread. kSub = 4 halves the partial buffers.
//  - The next chunk to walk (the earlier one in time) is copied by cp.async
//    into a second buffer (its rows of r/k/w/v/do and its checkpoint rows)
//    while the current one walks; the rows are widened to fp32 once a chunk.
//  - One CTA a (b, h) row (hd / 2 x hd / 4 threads: 512 at hd 64), so
//    every sum stays inside it. Splitting a row's state rows over a
//    cluster of 2, 4 or 8 CTAs, with dv summed in distributed shared
//    memory, measured slower on an H100 (each cluster barrier waits for the
//    slowest CTA of the cluster; PERF.md has the times).
//  - A chunk's gradients are staged in shared memory and written to device
//    memory as whole rows after the chunk's last barrier. du sums over T
//    inside the CTA, in reverse step order.
//  - No atomics: every sum has a fixed order, so two launches give the same
//    bits.
#include "sm90.cuh"

namespace {

constexpr int kChunk = kCkptSteps;   // steps between the forward's checkpoints
constexpr int kSub = 4;              // steps whose partials are summed together
constexpr int kRA = 2;               // state rows a thread keeps
constexpr int kCB = 4;               // state columns a thread keeps
static_assert(kChunk % kSub == 0, "a chunk is whole sub-chunks");

template <int HD>
struct Cfg {
  static constexpr int R = HD;               // state rows
  static constexpr int TC = HD / kCB;        // column threads
  static constexpr int TR = R / kRA;         // row threads
  static constexpr int NT = TR * TC;         // threads
  static constexpr int NW = NT / 32;
  static_assert(NT % 32 == 0 && R % 8 == 0, "whole warps; 16-byte row slices");
  // row partials [kSub][3][TC][RS]: a column thread's R rows (stride RS, 16
  // B aligned), a (step, kind) block of BS floats with BS = R (mod 32), so
  // that the 8 lanes of a 16-byte load in the sum fall on distinct banks
  static constexpr int RS = R + 4;
  static constexpr int BS = TC * RS + ((R - TC * RS) % 32 + 32) % 32;
  // floats of each shared-memory region
  static constexpr int kWide = kChunk * (3 * R + 2 * HD);   // r, k, w; v, do
  static constexpr int kRowPart = kSub * 3 * BS;
  static constexpr int kColPart = kSub * TR * HD;
  static constexpr int kDv = kChunk * HD;
  static constexpr int kOut = 3 * kChunk * R;               // dr, dk, dw of a chunk
  static constexpr int kSmall = 2 * kChunk + R;             // do . v, sum u r k; u
  template <typename Tr, typename Tw>
  __host__ __device__ static constexpr int stage_bytes() {       // one raw copy of a chunk
    return kChunk * R * (2 * int(sizeof(Tr)) + int(sizeof(Tw))) +
           2 * kChunk * HD * int(sizeof(Tr)) + R * HD * 4;
  }
  template <typename Tr, typename Tw>
  __host__ __device__ static constexpr int bytes() {
    return 2 * stage_bytes<Tr, Tw>() +
           4 * (kWide + kRowPart + kColPart + kDv + kOut + kSmall);
  }
};

template <typename Tr, typename Tw, int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT, 512 / Cfg<HD>::NT)
wkv6_bwd_kernel(const Tr* __restrict__ r, const Tr* __restrict__ k,
                const Tr* __restrict__ v, const Tw* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ ck,
                const Tr* __restrict__ dout, const float* __restrict__ dsN,
                Tr* __restrict__ dr, Tr* __restrict__ dk, Tr* __restrict__ dv,
                Tw* __restrict__ dw, float* __restrict__ du, float* __restrict__ ds0,
                int T) {
  using C = Cfg<HD>;
  constexpr int R = C::R, TC = C::TC, TR = C::TR, NT = C::NT, NW = C::NW;
  constexpr int RS = C::RS, BS = C::BS;
  constexpr int kStage = C::template stage_bytes<Tr, Tw>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* const wide = reinterpret_cast<float*>(smem + 2 * kStage);
  float* const wr = wide;                    // [kChunk][R] r, k, w
  float* const wk = wr + kChunk * R;
  float* const ww = wk + kChunk * R;
  float* const wv = ww + kChunk * R;         // [kChunk][HD] v, do
  float* const wd = wv + kChunk * HD;
  float* const rp = wide + C::kWide;         // row partials
  float* const cpart = rp + C::kRowPart;     // [kSub][TR][HD] column partials
  float* const dvl = cpart + C::kColPart;    // [kChunk][HD] the chunk's dv
  float* const ob = dvl + C::kDv;            // [3][kChunk][R] the chunk's dr, dk, dw
  float* const es = ob + C::kOut;            // [kChunk] do . v
  float* const cs = es + kChunk;             // [kChunk] sum over rows of u r k
  float* const us = cs + kChunk;             // [R]

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tj = tid % TC, ti = tid / TC;
  const int i0 = kRA * ti, j0 = kCB * tj;    // the thread's rows (local) and columns
  const size_t seq = (size_t)bh * T * HD;
  const size_t mat = (size_t)bh * HD * HD;
  const int nck = (T + kChunk - 1) / kChunk;
  for (int i = tid; i < R; i += NT) us[i] = u[(size_t)bh * HD + i];

  float G[kRA][kCB];
#pragma unroll
  for (int a = 0; a < kRA; ++a) {
    const float4 g4 = *reinterpret_cast<const float4*>(dsN + mat + (size_t)(i0 + a) * HD + j0);
    G[a][0] = g4.x, G[a][1] = g4.y, G[a][2] = g4.z, G[a][3] = g4.w;
  }
  float du_acc = 0.f;        // row tid's du (tid < R)

  // copy chunk c's rows of r, k, w, v, do and its checkpoint into raw
  // stage c % 2, 16 bytes a copy
  auto stage = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
    Tr* sr = reinterpret_cast<Tr*>(smem + (c & 1) * kStage);
    Tr* sk = sr + kChunk * R;
    Tw* sw = reinterpret_cast<Tw*>(sk + kChunk * R);
    Tr* sv = reinterpret_cast<Tr*>(sw + kChunk * R);
    Tr* sd = sv + kChunk * HD;
    float* sc = reinterpret_cast<float*>(sd + kChunk * HD);
    constexpr int kR = 16 / int(sizeof(Tr)), kW = 16 / int(sizeof(Tw));
    for (int e = tid; e < n * (R / kR); e += NT) {
      const int s = e / (R / kR), x = e - s * (R / kR);
      const size_t off = seq + (size_t)(t0 + s) * HD + x * kR;
      cp_async16(sr + s * R + x * kR, r + off, true);
      cp_async16(sk + s * R + x * kR, k + off, true);
    }
    for (int e = tid; e < n * (R / kW); e += NT) {
      const int s = e / (R / kW), x = e - s * (R / kW);
      cp_async16(sw + s * R + x * kW, w + seq + (size_t)(t0 + s) * HD + x * kW, true);
    }
    for (int e = tid; e < n * (HD / kR); e += NT) {
      const size_t off = seq + (size_t)t0 * HD + e * kR;
      cp_async16(sv + e * kR, v + off, true);
      cp_async16(sd + e * kR, dout + off, true);
    }
    const float* cp = ck + ((size_t)bh * nck + c) * HD * HD;
    for (int e = tid; e < R * HD / 4; e += NT) cp_async16(sc + 4 * e, cp + 4 * e, true);
    cp_async_commit();
  };

  // the sums of one sub-chunk's partials and the u terms: dr, dk, dw into
  // ob, dv into dvl; steps [sb, se) of the chunk
  auto epilogue = [&](int sb, int se) {
    constexpr int kRowItems = kSub * 3 * (R / 4), kColItems = kSub * (HD / 4);
    for (int it = tid; it < kRowItems + kColItems; it += NT) {
      if (it < kRowItems) {
        const int i4 = it % (R / 4), sk = it / (R / 4), sl = sk / 3, kind = sk - 3 * sl;
        if (sb + sl >= se) continue;
        const float* pp = rp + sk * BS + 4 * i4;
        float4 acc = *reinterpret_cast<const float4*>(pp);
#pragma unroll 4
        for (int x = 1; x < TC; ++x) {
          const float4 y = *reinterpret_cast<const float4*>(pp + x * RS);
          acc.x += y.x, acc.y += y.y, acc.z += y.z, acc.w += y.w;
        }
        const int s = sb + sl, i = 4 * i4;
        const float sum[4] = {acc.x, acc.y, acc.z, acc.w};
        const float ev = es[s];
        const float* uterm = kind == 0 ? wk : wr;   // dr: u k (do . v), dk: u r (do . v)
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = kind == 2 ? sum[e] : sum[e] + us[i + e] * uterm[s * R + i + e] * ev;
        *reinterpret_cast<float4*>(ob + (kind * kChunk + s) * R + i) =
            make_float4(o[0], o[1], o[2], o[3]);
      } else {
        const int jt = it - kRowItems, j4 = jt % (HD / 4), sl = jt / (HD / 4);
        if (sb + sl >= se) continue;
        const float* pp = cpart + sl * TR * HD + 4 * j4;
        float4 acc = *reinterpret_cast<const float4*>(pp);
#pragma unroll 4
        for (int x = 1; x < TR; ++x) {
          const float4 y = *reinterpret_cast<const float4*>(pp + x * HD);
          acc.x += y.x, acc.y += y.y, acc.z += y.z, acc.w += y.w;
        }
        const int s = sb + sl;
        const float cq = cs[s];
        const float4 d4 = *reinterpret_cast<const float4*>(wd + s * HD + 4 * j4);
        *reinterpret_cast<float4*>(dvl + s * HD + 4 * j4) =
            make_float4(fmaf(d4.x, cq, acc.x), fmaf(d4.y, cq, acc.y), fmaf(d4.z, cq, acc.z),
                        fmaf(d4.w, cq, acc.w));
      }
    }
    if (tid < R) {
      for (int s = se - 1; s >= sb; --s)
        du_acc = fmaf(wr[s * R + tid] * wk[s * R + tid], es[s], du_acc);
    }
  };

  stage(nck - 1);
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0), p = c & 1;
    cp_async_wait<0>();
    __syncthreads();        // chunk c is in; the previous chunk's epilogue is done
    if (c > 0) stage(c - 1);                 // in flight during this chunk's walk
    {
      const Tr* sr = reinterpret_cast<const Tr*>(smem + p * kStage);
      const Tr* sk = sr + kChunk * R;
      const Tw* sw = reinterpret_cast<const Tw*>(sk + kChunk * R);
      const Tr* sv = reinterpret_cast<const Tr*>(sw + kChunk * R);
      const Tr* sd = sv + kChunk * HD;
      for (int e = tid; e < n * R; e += NT) {
        wr[e] = to_f32<Tr>(sr[e]);
        wk[e] = to_f32<Tr>(sk[e]);
        ww[e] = to_f32<Tw>(sw[e]);
      }
      for (int e = tid; e < n * HD; e += NT) {
        wv[e] = to_f32<Tr>(sv[e]);
        wd[e] = to_f32<Tr>(sd[e]);
      }
    }
    __syncthreads();

    // per step: do . v over columns, and sum u r k over rows
    for (int s = warp; s < n; s += NW) {
      float e = 0.f, cc = 0.f;
      for (int j = lane; j < HD; j += 32) e = fmaf(wd[s * HD + j], wv[s * HD + j], e);
      for (int i = lane; i < R; i += 32) cc = fmaf(us[i] * wr[s * R + i], wk[s * R + i], cc);
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        e += __shfl_xor_sync(0xffffffffu, e, m);
        cc += __shfl_xor_sync(0xffffffffu, cc, m);
      }
      if (lane == 0) es[s] = e, cs[s] = cc;
    }

    // the chunk's states S_t0 .. S_{t0+n-1} of the thread's tile, the
    // forward's way, from the checkpoint rows
    float ring[kChunk][kRA][kCB];
    {
      const float* sc = reinterpret_cast<const float*>(
          smem + p * kStage + kChunk * R * (2 * sizeof(Tr) + sizeof(Tw)) +
          2 * kChunk * HD * sizeof(Tr));
#pragma unroll
      for (int a = 0; a < kRA; ++a) {
        const float4 c4 = *reinterpret_cast<const float4*>(sc + (i0 + a) * HD + j0);
        ring[0][a][0] = c4.x, ring[0][a][1] = c4.y, ring[0][a][2] = c4.z, ring[0][a][3] = c4.w;
      }
    }
#pragma unroll
    for (int s = 0; s + 1 < kChunk; ++s) {
      if (s + 1 < n) {
        const float2 k2 = *reinterpret_cast<const float2*>(wk + s * R + i0);
        const float2 w2 = *reinterpret_cast<const float2*>(ww + s * R + i0);
        const float4 v4 = *reinterpret_cast<const float4*>(wv + s * HD + j0);
        const float kk[kRA] = {k2.x, k2.y}, wv2[kRA] = {w2.x, w2.y};
        const float vv[kCB] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < kRA; ++a)
#pragma unroll
          for (int b = 0; b < kCB; ++b) {
            const float av = kk[a] * vv[b];
            ring[s + 1][a][b] = wv2[a] * ring[s][a][b] + av;
          }
      }
    }

    // the chunk's steps in reverse; after each sub-chunk, the sums
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      const int sl = s % kSub;
      if (s < n) {
        const float2 r2 = *reinterpret_cast<const float2*>(wr + s * R + i0);
        const float2 k2 = *reinterpret_cast<const float2*>(wk + s * R + i0);
        const float2 w2 = *reinterpret_cast<const float2*>(ww + s * R + i0);
        const float4 v4 = *reinterpret_cast<const float4*>(wv + s * HD + j0);
        const float4 d4 = *reinterpret_cast<const float4*>(wd + s * HD + j0);
        const float rr[kRA] = {r2.x, r2.y}, kk[kRA] = {k2.x, k2.y}, wv2[kRA] = {w2.x, w2.y};
        const float vv[kCB] = {v4.x, v4.y, v4.z, v4.w}, dd[kCB] = {d4.x, d4.y, d4.z, d4.w};
        float x[3][kRA], y[kCB];
#pragma unroll
        for (int a = 0; a < kRA; ++a) {
          float p0 = 0.f, p1 = 0.f, p2 = 0.f;
#pragma unroll
          for (int b = 0; b < kCB; ++b) {
            p0 = fmaf(ring[s][a][b], dd[b], p0);
            p1 = fmaf(G[a][b], vv[b], p1);
            p2 = fmaf(G[a][b], ring[s][a][b], p2);
          }
          x[0][a] = p0, x[1][a] = p1, x[2][a] = p2;
        }
#pragma unroll
        for (int b = 0; b < kCB; ++b) {
          float yy = 0.f;
#pragma unroll
          for (int a = 0; a < kRA; ++a) yy = fmaf(G[a][b], kk[a], yy);
          y[b] = yy;
        }
#pragma unroll
        for (int a = 0; a < kRA; ++a)
#pragma unroll
          for (int b = 0; b < kCB; ++b) G[a][b] = fmaf(wv2[a], G[a][b], rr[a] * dd[b]);
        float* px = rp + sl * 3 * BS + tj * RS + i0;
#pragma unroll
        for (int kind = 0; kind < 3; ++kind)
          *reinterpret_cast<float2*>(px + kind * BS) = make_float2(x[kind][0], x[kind][1]);
        *reinterpret_cast<float4*>(cpart + (sl * TR + ti) * HD + j0) =
            make_float4(y[0], y[1], y[2], y[3]);
      }
      if (sl == 0) {
        __syncthreads();    // the sub-chunk's partials are in
        if (s < n) epilogue(s, min(n, s + kSub));
        if (s > 0) __syncthreads();   // ... and summed before the next overwrites them
      }
    }

    // the chunk's gradients, whole rows; the next chunk's first barrier
    // keeps its epilogue from overwriting them before they are read
    __syncthreads();
    for (int e = tid; e < n * HD; e += NT) dv[seq + (size_t)t0 * HD + e] = from_f32<Tr>(dvl[e]);
    for (int e = tid; e < 3 * n * R; e += NT) {
      const int kind = e / (n * R), x = e - kind * n * R, s = x / R, i = x - s * R;
      const float o = ob[(kind * kChunk + s) * R + i];
      const size_t off = seq + (size_t)(t0 + s) * HD + i;
      if (kind == 0)
        dr[off] = from_f32<Tr>(o);
      else if (kind == 1)
        dk[off] = from_f32<Tr>(o);
      else
        dw[off] = from_f32<Tw>(o);
    }
  }

#pragma unroll
  for (int a = 0; a < kRA; ++a)
    *reinterpret_cast<float4*>(ds0 + mat + (size_t)(i0 + a) * HD + j0) =
        make_float4(G[a][0], G[a][1], G[a][2], G[a][3]);
  if (tid < R) du[(size_t)bh * HD + tid] = du_acc;
}

template <typename Tr, typename Tw, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* ck, const void* dout, const float* dsN,
                   void* dr, void* dk, void* dv, void* dw, float* du, float* ds0, int BH,
                   int T, cudaStream_t s) {
  using C = Cfg<HD>;
  constexpr int kBytes = C::template bytes<Tr, Tw>();
  auto kernel = wkv6_bwd_kernel<Tr, Tw, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<BH, C::NT, kBytes, s>>>(static_cast<const Tr*>(r), static_cast<const Tr*>(k),
                                   static_cast<const Tr*>(v), static_cast<const Tw*>(w), u, ck,
                                   static_cast<const Tr*>(dout), dsN, static_cast<Tr*>(dr),
                                   static_cast<Tr*>(dk), static_cast<Tr*>(dv),
                                   static_cast<Tw*>(dw), du, ds0, T);
  return cudaGetLastError();
}

// the launch's layout: CTAs an SM, threads a CTA, shared bytes a CTA,
// registers a thread
template <typename Tr, typename Tw, int HD>
cudaError_t occupancy(int* out) {
  using C = Cfg<HD>;
  constexpr int kBytes = C::template bytes<Tr, Tw>();
  auto kernel = wkv6_bwd_kernel<Tr, Tw, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, C::NT, kBytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  out[1] = C::NT;
  out[2] = kBytes + int(fa.sharedSizeBytes);
  out[3] = fa.numRegs;
  return cudaSuccess;
}

template <typename Tr, typename Tw>
cudaError_t launch_hd(const void* r, const void* k, const void* v, const void* w,
                      const float* u, const float* ck, const void* dout, const float* dsN,
                      void* dr, void* dk, void* dv, void* dw, float* du, float* ds0,
                      int BH, int T, int hd, cudaStream_t s) {
  if (hd == 32)
    return launch<Tr, Tw, 32>(r, k, v, w, u, ck, dout, dsN, dr, dk, dv, dw, du, ds0, BH, T, s);
  if (hd == 64)
    return launch<Tr, Tw, 64>(r, k, v, w, u, ck, dout, dsN, dr, dk, dv, dw, du, ds0, BH, T, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// r, k, v, dout (BH, T, hd) in `dtype`; w (BH, T, hd) in `w_dtype` (fp32 or
// `dtype`); u (BH, hd) fp32; ck (BH, ceil(T / CKPT_STEPS), hd, hd) fp32, the
// forward's checkpoints; dsN (BH, hd, hd) fp32. Writes dr, dk, dv (BH, T,
// hd) in `dtype`, dw (BH, T, hd) in `w_dtype`, du (BH, hd) and ds0 (BH, hd,
// hd) fp32. All contiguous and 16-byte aligned; hd in {32, 64}; T >= 1.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* ck,
                               const void* dout, const void* dsN, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* ds0, int BH, int T,
                               int hd, int dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || T <= 0) return cudaErrorInvalidValue;
  const void* ptrs[] = {r, k, v, w, u, ck, dout, dsN, dr, dk, dv, dw, du, ds0};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
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

// The launch's layout for (hd, dtype, w_dtype) into out[4] (see
// `occupancy`); returns a CUDA error code.
extern "C" int wkv6_bwd_occupancy(int hd, int dtype, int w_dtype, void* out) {
  int* o = static_cast<int*>(out);
  auto pick = [&](auto tr, auto tw) -> cudaError_t {
    using Tr = decltype(tr);
    using Tw = decltype(tw);
    if (hd == 32) return occupancy<Tr, Tw, 32>(o);
    if (hd == 64) return occupancy<Tr, Tw, 64>(o);
    return cudaErrorInvalidValue;
  };
  if (dtype == kFloat32 && w_dtype == kFloat32) return pick(float{}, float{});
  if (dtype == kBFloat16 && w_dtype == kFloat32) return pick(__nv_bfloat16{}, float{});
  if (dtype == kBFloat16 && w_dtype == kBFloat16)
    return pick(__nv_bfloat16{}, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}
