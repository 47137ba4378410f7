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
// states (2 * hd * hd * 4 B per row) dwarf the rows of r/k/v/w/o. The
// recurrence needs 5 fp32 flops per state element and step (k*v, w*S + a,
// r^T S; this form spends 7), so over a long prefill the operations (at
// 67 TFLOP/s, no tensor cores) outweigh the bytes. The scan
// is sequential in T, so a long prefill is bounded in practice by the
// latency of T dependent steps, not by either roofline term.
//
// What the design does about it: one block per bh with hd threads; thread
// j keeps column j of the state in registers (hd floats) for the whole
// launch, so the state is read from device memory once and written once,
// and a single launch carries it over any T >= 1 (the TPU kernel's chunk
// grid axis becomes this loop). Rows of r/k/w/v are staged into shared
// memory a tile of steps at a time with coalesced loads (consecutive
// threads on consecutive channels); inside a step every thread reads the
// same r/k/w/u element (a shared-memory broadcast). Four partial sums
// break the dependent add chain of o. Splitting K over warps and the
// chunked-parallel form for long prefill are left to a later change.
#include "common.cuh"

namespace {

constexpr int kStageFloats = 2048;   // floats per staged array: kTile * HD

template <typename R, typename W, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const R* __restrict__ r, const R* __restrict__ k,
            const R* __restrict__ v, const W* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            R* __restrict__ o, float* __restrict__ sN, int T) {
  constexpr int kTile = kStageFloats / HD;   // steps staged at a time
  __shared__ float rs[kTile][HD];
  __shared__ float ks[kTile][HD];
  __shared__ float ws[kTile][HD];
  __shared__ float vs[kTile][HD];
  __shared__ float us[HD];

  const int bh = blockIdx.x;
  const int j = threadIdx.x;
  const size_t seq = (size_t)bh * T * HD;
  const float* s0b = s0 + (size_t)bh * HD * HD;

  float S[HD];                         // column j of the state
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0b[(size_t)i * HD + j];
  us[j] = u[(size_t)bh * HD + j];

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    __syncthreads();                   // the previous tile is consumed
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const size_t off = seq + (size_t)(t0 + t) * HD + j;
      rs[t][j] = to_f32<R>(r[off]);
      ks[t][j] = to_f32<R>(k[off]);
      vs[t][j] = to_f32<R>(v[off]);
      ws[t][j] = to_f32<W>(w[off]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float a = ks[t][i] * vj;
        acc[i & 3] += rs[t][i] * (S[i] + us[i] * a);
        S[i] = ws[t][i] * S[i] + a;
      }
      o[seq + (size_t)(t0 + t) * HD + j] =
          from_f32<R>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

  float* sNb = sN + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) sNb[(size_t)i * HD + j] = S[i];
}

template <typename R, typename W>
cudaError_t launch_hd(const void* r, const void* k, const void* v, const void* w,
                      const float* u, const float* s0, void* o, float* sN, int BH,
                      int T, int hd, cudaStream_t s) {
  const R* rp = static_cast<const R*>(r);
  const R* kp = static_cast<const R*>(k);
  const R* vp = static_cast<const R*>(v);
  const W* wp = static_cast<const W*>(w);
  R* op = static_cast<R*>(o);
  if (hd == 32)
    wkv6_kernel<R, W, 32><<<BH, 32, 0, s>>>(rp, kp, vp, wp, u, s0, op, sN, T);
  else if (hd == 64)
    wkv6_kernel<R, W, 64><<<BH, 64, 0, s>>>(rp, kp, vp, wp, u, s0, op, sN, T);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// r, k, v (BH, T, hd) in `dtype`; w (BH, T, hd) in `w_dtype` (fp32, or
// `dtype`); u (BH, hd) and s0 (BH, hd, hd) fp32; o (BH, T, hd) in `dtype`;
// sN (BH, hd, hd) fp32. All contiguous; hd in {32, 64}, T >= 1.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0, void* o,
                           void* sN, int BH, int T, int hd, int dtype,
                           int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || T <= 0) return cudaErrorInvalidValue;
  const float* up = static_cast<const float*>(u);
  const float* s0p = static_cast<const float*>(s0);
  float* sNp = static_cast<float*>(sN);
  if (dtype == kFloat32 && w_dtype == kFloat32)
    return launch_hd<float, float>(r, k, v, w, up, s0p, o, sNp, BH, T, hd, s);
  if (dtype == kBFloat16 && w_dtype == kFloat32)
    return launch_hd<__nv_bfloat16, float>(r, k, v, w, up, s0p, o, sNp, BH, T,
                                           hd, s);
  if (dtype == kBFloat16 && w_dtype == kBFloat16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, up, s0p, o, sNp,
                                                   BH, T, hd, s);
  return cudaErrorInvalidValue;
}
