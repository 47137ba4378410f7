// RWKV6 ("Finch") recurrence with data-dependent decay, for Hopper (sm_90a).
//
// Replaces: repro/kernels/wkv6.py::wkv6 (the Pallas `_kernel`). For each
// (batch, head) row bh and time step t, with the (K, V) = (hd, hd) state S:
//   o_t[j] = sum_k r_t[k] * (S[k][j] + u[k] * k_t[k] * v_t[j])
//   S[k][j] = w_t[k] * S[k][j] + k_t[k] * v_t[j]
// the same products, in the same order inside each term, as the reference
// model's jnp scan (repro/models/rwkv6.py::_wkv_chunk); the state is fp32
// throughout, o is rounded once to r's dtype (round to nearest even).
//
// What bounds it on this card: at decode (T = 1), bytes: the two fp32
// states (2 * hd * hd * 4 B per row) dwarf the rows of r/k/v/w/o. Over a
// prefill the operations (5 fp32 flops per state element and step: k*v,
// w*S + a, r^T S; at 67 TFLOP/s, no tensor cores) outweigh the bytes. But
// the scan is T dependent steps, so a long prefill at small B*H is bounded
// in practice by the latency of one step times T: with one thread per
// column walking all hd rows, a step is an hd-long chain of shared-memory
// loads and FMAs, and B*H = 64 rows of 2 warps leave most SMs idle.
//
// What the design does about it: the state's columns are independent
// (column j is updated from w, k and v_j alone) and the update never reads
// o, so each row's state is split two ways:
//  - over blocks by columns: a block takes `cols` columns (16 or 32) and
//    all hd rows of them;
//  - over warps by rows: thread (g, j) keeps KR = 8 or 16 state elements
//    S[KR g ..][j] in registers for the whole launch, so the state is read
//    once and written once and a step is a chain of KR, not hd.
// The wrapper's `plan` takes 8 rows and 16 columns (short chains, more
// blocks) unless B*H already gives every SM two blocks of 32 columns; then
// 16 rows and 32 columns spend less on partial sums.
// Each step a thread updates its elements in the same expression order as
// the reference (S = w*S + a, a = k*v), so sN keeps its fp32 rounding per
// element, and writes its partial o_t[j] over its rows to shared memory.
// Rows of r/k/w (all hd) and v (the block's columns) are loaded into
// registers one tile of 16 steps ahead with coalesced loads, so the next
// tile's loads are in flight while this one's steps run, and widened into
// shared memory; a thread reads its rows of r/k/w as float4s (a broadcast
// across its warp). A full tile's steps are unrolled: they depend on each
// other only through S. The partials of o are summed once per tile, with
// three barriers a tile, not one a step. One launch carries the state over any T >= 1 (the
// TPU kernel's chunk grid axis becomes the loop). The chunked-parallel
// (tensor-core) form is not used: it sums the state over T in another
// order and needs decay ratios in log space, which underflow for RWKV6's
// data-dependent w.
//
// Under a gradient the wrapper passes `ck`, and the launch also writes the
// fp32 state before every kCkpt-th step, (BH, ceil(T / kCkpt), hd, hd):
// wkv6_bwd.cu recomputes each chunk of kCkpt steps from its checkpoint
// instead of running the recurrence backwards (S_{t-1} = (S_t - a_t) / w_t
// is inf/NaN once a decay underflows). With ck null the launch takes the
// build without the stores (CKPT = false): the serving kernel's code and
// bits. A branch on ck inside one build instead gave the same bits but cost
// the serving launch time (0.0046 against 0.0038 ms at BH 256, T 1; H100,
// scripts/kernel_ab.py --parent), so each instantiation is built twice.
#include "common.cuh"

namespace {

constexpr int kTile = 16;       // steps staged at a time
constexpr int kCkpt = kCkptSteps;   // steps between state checkpoints (wkv6_bwd.cu's kChunk)
static_assert(kTile % kCkpt == 0, "a checkpoint falls on a tile's step");

// one 16-byte shared-memory load into four registers
__device__ __forceinline__ void split4(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// KR state rows a thread keeps, COLS state columns a block takes; CKPT:
// write the checkpoints (a null ck launches the CKPT = false build, the
// serving kernel's own code)
template <typename R, typename W, int HD, int KR, int COLS, bool CKPT>
__global__ void __launch_bounds__(HD / KR * COLS)
wkv6_kernel(const R* __restrict__ r, const R* __restrict__ k,
            const R* __restrict__ v, const W* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            R* __restrict__ o, float* __restrict__ sN, float* __restrict__ ck,
            int T) {
  constexpr int G = HD / KR;                 // row groups
  constexpr int NT = G * COLS;               // threads
  constexpr int kPer = kTile * HD / NT;      // staged r/k/w elements a thread loads
  constexpr int kPerV = kTile * COLS / NT;   // ... and of v
  static_assert(kPer * NT == kTile * HD && kPerV * NT == kTile * COLS, "tile split");
  __shared__ __align__(16) float rs[kTile][HD];
  __shared__ __align__(16) float ks[kTile][HD];
  __shared__ __align__(16) float ws[kTile][HD];
  __shared__ float vs[kTile][COLS];
  __shared__ float po[kTile][G][COLS];       // partial o of each row group

  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * COLS;
  const int tid = threadIdx.x;
  const int g = tid / COLS, j = tid - g * COLS;
  const int k0 = g * KR, col = c0 + j;
  const size_t seq = (size_t)bh * T * HD;
  const float* s0b = s0 + (size_t)bh * HD * HD;

  float S[KR], uu[KR];                 // rows k0.. of column col
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    S[i] = s0b[(size_t)(k0 + i) * HD + col];
    uu[i] = u[(size_t)bh * HD + k0 + i];
  }

  // a tile's rows of r/k/w (all HD) and v (this block's columns) are loaded
  // into registers one tile ahead and widened into shared memory after
  R fr[kPer], fk[kPer], fv[kPerV];
  W fw[kPer];
  auto fetch = [&](int t0) {
    const int n = min(kTile, T - t0);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + q * NT, t = i / HD, c = i - t * HD;
      if (t < n) {
        const size_t off = seq + (size_t)(t0 + t) * HD + c;
        fr[q] = r[off];
        fk[q] = k[off];
        fw[q] = w[off];
      }
    }
#pragma unroll
    for (int q = 0; q < kPerV; ++q) {
      const int i = tid + q * NT, t = i / COLS, c = i - t * COLS;
      if (t < n) fv[q] = v[seq + (size_t)(t0 + t) * HD + c0 + c];
    }
  };
  auto stage = [&](int n) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + q * NT, t = i / HD, c = i - t * HD;
      if (t < n) {
        rs[t][c] = to_f32<R>(fr[q]);
        ks[t][c] = to_f32<R>(fk[q]);
        ws[t][c] = to_f32<W>(fw[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kPerV; ++q) {
      const int i = tid + q * NT, t = i / COLS, c = i - t * COLS;
      if (t < n) vs[t][c] = to_f32<R>(fv[q]);
    }
  };
  // one step: this thread's rows of column col, and its partial o_t[col]
  auto step = [&](int t) {
    const float vj = vs[t][j];
    float rr[KR], kk[KR], wv[KR];
#pragma unroll
    for (int q = 0; q < KR / 4; ++q) {
      split4(rr + 4 * q, &rs[t][k0 + 4 * q]);
      split4(kk + 4 * q, &ks[t][k0 + 4 * q]);
      split4(wv + 4 * q, &ws[t][k0 + 4 * q]);
    }
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const float a = kk[i] * vj;
      acc[i & 1] += rr[i] * (S[i] + uu[i] * a);
      S[i] = wv[i] * S[i] + a;
    }
    po[t][g][j] = acc[0] + acc[1];
  };

  // this thread's state elements before step t, into checkpoint t / kCkpt
  const int nck = (T + kCkpt - 1) / kCkpt;
  auto save = [&](int t) {
    float* c = ck + ((size_t)bh * nck + t / kCkpt) * HD * HD;
#pragma unroll
    for (int i = 0; i < KR; ++i) c[(size_t)(k0 + i) * HD + col] = S[i];
  };

  fetch(0);
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    __syncthreads();                   // the previous tile is consumed
    stage(n);
    __syncthreads();
    if (t0 + kTile < T) fetch(t0 + kTile);   // in flight during the steps
    if (n == kTile) {                  // steps are independent but for S
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if constexpr (CKPT) {
          if (t % kCkpt == 0) save(t0 + t);
        }
        step(t);
      }
    } else {
      for (int t = 0; t < n; ++t) {
        if constexpr (CKPT) {
          if (t % kCkpt == 0) save(t0 + t);
        }
        step(t);
      }
    }
    __syncthreads();                   // every row group's partials are in
    for (int i = tid; i < n * COLS; i += NT) {
      const int t = i / COLS, c = i - t * COLS;
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < G; ++p) sum += po[t][p][c];
      o[seq + (size_t)(t0 + t) * HD + c0 + c] = from_f32<R>(sum);
    }
  }

  float* sNb = sN + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < KR; ++i) sNb[(size_t)(k0 + i) * HD + col] = S[i];
}

template <typename R, typename W, int HD, int KR>
cudaError_t launch_cols(const R* r, const R* k, const R* v, const W* w, const float* u,
                        const float* s0, R* o, float* sN, float* ck, int BH, int T,
                        int cols, cudaStream_t s) {
  const dim3 grid(HD / cols, BH);
  constexpr int G = HD / KR;
  if (cols == 32 && ck != nullptr)
    wkv6_kernel<R, W, HD, KR, 32, true><<<grid, G * 32, 0, s>>>(r, k, v, w, u, s0, o, sN, ck, T);
  else if (cols == 32)
    wkv6_kernel<R, W, HD, KR, 32, false><<<grid, G * 32, 0, s>>>(r, k, v, w, u, s0, o, sN, ck, T);
  else if (cols == 16 && ck != nullptr)
    wkv6_kernel<R, W, HD, KR, 16, true><<<grid, G * 16, 0, s>>>(r, k, v, w, u, s0, o, sN, ck, T);
  else if (cols == 16)
    wkv6_kernel<R, W, HD, KR, 16, false><<<grid, G * 16, 0, s>>>(r, k, v, w, u, s0, o, sN, ck, T);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename R, typename W>
cudaError_t launch_hd(const void* r, const void* k, const void* v, const void* w,
                      const float* u, const float* s0, void* o, float* sN, float* ck,
                      int BH, int T, int hd, int rows, int cols, cudaStream_t s) {
  const R* rp = static_cast<const R*>(r);
  const R* kp = static_cast<const R*>(k);
  const R* vp = static_cast<const R*>(v);
  const W* wp = static_cast<const W*>(w);
  R* op = static_cast<R*>(o);
  if (cols > hd) return cudaErrorInvalidValue;
#define WKV6_CASE(HD, KR)                                                           \
  if (hd == HD && rows == KR)                                                       \
    return launch_cols<R, W, HD, KR>(rp, kp, vp, wp, u, s0, op, sN, ck, BH, T, cols, s);
  WKV6_CASE(32, 8)
  WKV6_CASE(32, 16)
  WKV6_CASE(64, 8)
  WKV6_CASE(64, 16)
#undef WKV6_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v (BH, T, hd) in `dtype`; w (BH, T, hd) in `w_dtype` (fp32, or
// `dtype`); u (BH, hd) and s0 (BH, hd, hd) fp32; o (BH, T, hd) in `dtype`;
// sN (BH, hd, hd) fp32; ck null, or (BH, ceil(T / 8), hd, hd) fp32 for the
// state before every 8th step. All contiguous; hd in {32, 64}, T >= 1; each
// thread keeps `rows` (8 or 16) state rows of one of the block's `cols` (16
// or 32, at most hd) state columns. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0, void* o,
                           void* sN, void* ck, int BH, int T, int hd, int rows,
                           int cols, int dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || T <= 0) return cudaErrorInvalidValue;
  const float* up = static_cast<const float*>(u);
  const float* s0p = static_cast<const float*>(s0);
  float* sNp = static_cast<float*>(sN);
  float* ckp = static_cast<float*>(ck);
  if (dtype == kFloat32 && w_dtype == kFloat32)
    return launch_hd<float, float>(r, k, v, w, up, s0p, o, sNp, ckp, BH, T, hd, rows, cols, s);
  if (dtype == kBFloat16 && w_dtype == kFloat32)
    return launch_hd<__nv_bfloat16, float>(r, k, v, w, up, s0p, o, sNp, ckp, BH, T, hd,
                                           rows, cols, s);
  if (dtype == kBFloat16 && w_dtype == kBFloat16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, up, s0p, o, sNp, ckp, BH, T,
                                                   hd, rows, cols, s);
  return cudaErrorInvalidValue;
}
