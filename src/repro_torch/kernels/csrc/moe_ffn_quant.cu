// Dequantizing, slot-indexed grouped expert FFN for Hopper (sm_90a): B1's
// design (moe_ffn_tc.cuh) over fp16 or int8 wire weights, fp32 math on the
// CUDA cores, rows and experts with nothing routed to them skipped.
//
// Replaces: repro/kernels/moe_ffn.py::moe_ffn_quant (the Pallas
// `_quant_kernel`), reached through `moe_ffn_slots`. The expert weights are
// the device slot cache's wire buffers: (n_slots, d, f) / (n_slots, f, d) in
// fp16, or int8 with per-output-channel fp32 scales (n_slots, f) for
// w_gate/w_up and (n_slots, d) for w_down. Expert e reads slot slot_ids[e].
// Computes, per expert e, entirely in fp32:
//   x32 = float(x);  W = float(q) * scale  (float(w) for fp16)
//   h   = act(x32 @ W_gate, x32 @ W_up)             (kept in fp32)
//   y   = h @ W_down                               (rounded once, to out)
// which is `moe_ffn_quant_ref` and the Pallas kernel's math (h is not
// rounded to x's dtype, unlike B1).
//
// What bounds it on this card: reading the wire weights of the experts that
// have a routed row. At decode a pool of 4 tokens routes top-8 over 128
// experts, so ~32 experts have one routed row each of C = 8, and the rest
// of xg is exact zeros. Those experts' int8 weights and scales are
// 32 x 18.9 MB = 605 MB, 0.18 ms at 3.35 TB/s; their routed rows need only
// 1.2 GFLOP of fp32 FMA. With every row of every expert filled, the int8
// weights are 2.42 GB (0.72 ms) against 38.7 GFLOP (0.58 ms at 67 TFLOP/s):
// still bytes, but close to the fp32 line, so widening a weight must cost
// a few instructions, once per weight and not once per FMA.
//
// What the design does about it (moe_ffn_tc.cuh):
//  - One scan_rows launch marks xg's non-zero rows on the device (no host
//    sync). A block with no marked row writes +0.0 and exits without
//    reading a weight or a scale; unmarked rows are written +0.0. The
//    down-projection takes the same marks: a zero row of x gives a zero
//    row of h under every activation.
//  - The weights stream in their wire type as 16-byte cp.async copies into
//    a 6-stage ring for int8 (4 KB tiles) and 3 stages for fp16, zero-filled
//    past the edges; rows that are not a multiple of 16 bytes (ragged d or
//    f) fill the ring with element loads.
//  - Each weight is widened to fp32 once as it leaves the ring (int8 by a
//    byte permute into a float's mantissa and one add; fp16 by the half2
//    conversion) and feeds one FMA per marked row. The int8 scale is per
//    output column, so a thread keeps its four columns' scales in
//    registers and applies them once to its partial sums
//    (sum_k x q s = s sum_k x q), not once per weight. A block gathers its
//    marked rows to the front of its x tile and loops over those alone, so
//    a routed expert's single decode row costs one FMA per weight, not
//    C = 8; 8 rows a block keep the registers to three blocks an SM.
//  - fp32 CUDA-core FMA, not tensor cores: bf16 x times int8 would be exact
//    on the tensor cores, but the down-projection's x is the fp32 h, and
//    fp16 weights or a split of h into bf16 pieces would change the
//    reference's fp32 numbers or triple the MMA work; at decode the FMAs
//    are well under the bytes line.
//  - The expert -> slot indirection is folded into the weight pointers, so
//    the reference's gather (`jnp.take` over slots) is never made. Two GEMM
//    launches after the scan: up + activation into an fp32 scratch h
//    (E, C, f), then the down-projection over all of f. Ragged C, d and f
//    are masked.
#include "moe_ffn_tc.cuh"

namespace {

template <typename TX, typename TW, bool SCALED>
cudaError_t quant_typed(const void* xg, const void* w_gate, const void* w_up,
                        const void* w_down, const float* s_gate, const float* s_up,
                        const float* s_down, const int* slot_ids, int* row_nz, float* h,
                        void* y, int E, int C, int d, int f, int act, int out_dtype,
                        cudaStream_t s) {
  const TX* x = static_cast<const TX*>(xg);
  const TW* wg = static_cast<const TW*>(w_gate);
  const TW* wu = static_cast<const TW*>(w_up);
  const TW* wd = static_cast<const TW*>(w_down);
  cudaError_t err = moe_tc::scan<TX>(x, E, C, d, row_nz, s);
  if (err != cudaSuccess) return err;
  err = moe_tc::launch_act<TX, TW, float, SCALED>(act, x, wu, wg, s_up, s_gate, slot_ids,
                                                  row_nz, h, E, C, d, f, s);
  if (err != cudaSuccess) return err;
  if (out_dtype == kFloat32)
    return moe_tc::launch<float, TW, float, moe_tc::kNone, SCALED>(
        h, wd, nullptr, s_down, nullptr, slot_ids, row_nz, static_cast<float*>(y), E, C, f,
        d, s);
  if (out_dtype == kBFloat16)
    return moe_tc::launch<float, TW, __nv_bfloat16, moe_tc::kNone, SCALED>(
        h, wd, nullptr, s_down, nullptr, slot_ids, row_nz, static_cast<__nv_bfloat16*>(y),
        E, C, f, d, s);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t quant_x(const void* xg, const void* w_gate, const void* w_up,
                    const void* w_down, const float* s_gate, const float* s_up,
                    const float* s_down, const int* slot_ids, int* row_nz, float* h, void* y,
                    int E, int C, int d, int f, int act, int w_dtype, int out_dtype,
                    cudaStream_t s) {
  if (w_dtype == kInt8)
    return quant_typed<TX, int8_t, true>(xg, w_gate, w_up, w_down, s_gate, s_up, s_down,
                                         slot_ids, row_nz, h, y, E, C, d, f, act,
                                         out_dtype, s);
  if (w_dtype == kFloat16)
    return quant_typed<TX, __half, false>(xg, w_gate, w_up, w_down, s_gate, s_up, s_down,
                                          slot_ids, row_nz, h, y, E, C, d, f, act,
                                          out_dtype, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// xg (E, C, d) fp32/bf16; w_gate, w_up (n_slots, d, f) and w_down
// (n_slots, f, d) in fp16 or int8 (w_gate null for ungated activations);
// s_gate, s_up (n_slots, f) and s_down (n_slots, d) fp32, int8 only (null
// for fp16); slot_ids (E,) int32 in [0, n_slots); flags int32 scratch of
// E * C (row marks); h (E, C, f) fp32 scratch; y (E, C, d) in out_dtype
// (fp32 or bf16). All contiguous. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int moe_ffn_quant_launch(const void* xg, const void* w_gate,
                                    const void* w_up, const void* w_down,
                                    const void* s_gate, const void* s_up,
                                    const void* s_down, const void* slot_ids,
                                    void* flags, void* h, void* y, int E, int C, int d,
                                    int f, int act, int x_dtype, int w_dtype,
                                    int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(s_gate);
  const float* su = static_cast<const float*>(s_up);
  const float* sd = static_cast<const float*>(s_down);
  const int* slots = static_cast<const int*>(slot_ids);
  int* fl = static_cast<int*>(flags);
  float* hp = static_cast<float*>(h);
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0) return cudaSuccess;
  if (w_dtype == kInt8 && (su == nullptr || sd == nullptr)) return cudaErrorInvalidValue;
  if (x_dtype == kFloat32)
    return quant_x<float>(xg, w_gate, w_up, w_down, sg, su, sd, slots, fl, hp, y,
                          E, C, d, f, act, w_dtype, out_dtype, s);
  if (x_dtype == kBFloat16)
    return quant_x<__nv_bfloat16>(xg, w_gate, w_up, w_down, sg, su, sd, slots, fl, hp, y,
                                  E, C, d, f, act, w_dtype, out_dtype, s);
  return cudaErrorInvalidValue;
}
