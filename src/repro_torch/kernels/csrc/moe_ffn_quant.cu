// Dequantizing, slot-indexed grouped expert FFN for Hopper (sm_90a),
// CUDA-core FMA.
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
// What bounds it on this card: reading the wire weights. At decode C = 8
// rows per expert, so each int8 weight byte feeds 16 fp32 flops and each
// fp16 byte 8, against the H100's ~20 flop/B fp32 ridge (67 TFLOP/s over
// 3.35 TB/s). For E=128, d=4096, f=1536 the int8 weights are 2.42 GB
// (0.72 ms) against 38.7 GFLOP of fp32 FMA (0.58 ms): bound by bytes, and
// close to the compute line, so the dequantization must cost no more than
// one multiply per weight element.
//
// What the design does about it (grouped_gemm.cuh): the expert -> slot
// indirection is folded into the weight pointers, so the gather of the
// reference (`jnp.take` over slots, 18.9 MB per expert in int8) is never
// materialized. Weights are streamed along their contiguous axis and
// widened in registers right before the FMA; a thread's 4 output columns
// keep their scales in registers for the whole k loop, so int8 dequant is
// one multiply. Each loaded weight is reused for all C rows of x, which sit
// in shared memory in fp32. Two launches: up+activation into an fp32 scratch
// h (E, C, f), then the down-projection over all of f. Ragged C, d and f are
// masked. Idle experts are still computed (skipping them is left to a later
// change), and no tensor core is used: TF32 or int8 MMA would change the
// reference's fp32 numerics.
#include "grouped_gemm.cuh"

namespace {

template <typename TX, typename TW, bool SCALED>
cudaError_t quant_typed(const void* xg, const void* w_gate, const void* w_up,
                        const void* w_down, const float* s_gate,
                        const float* s_up, const float* s_down,
                        const int* slot_ids, float* h, void* y, int E, int C,
                        int d, int f, int act, int out_dtype, cudaStream_t s) {
  cudaError_t err = grouped::launch_act<TX, TW, float, SCALED>(
      act, xg, w_up, w_gate, s_up, s_gate, slot_ids, h, E, C, d, f, s);
  if (err != cudaSuccess) return err;
  if (out_dtype == kFloat32)
    return grouped::launch<float, TW, float, grouped::kNone, SCALED>(
        h, w_down, nullptr, s_down, nullptr, slot_ids, y, E, C, f, d, s);
  if (out_dtype == kBFloat16)
    return grouped::launch<float, TW, __nv_bfloat16, grouped::kNone, SCALED>(
        h, w_down, nullptr, s_down, nullptr, slot_ids, y, E, C, f, d, s);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t quant_x(const void* xg, const void* w_gate, const void* w_up,
                    const void* w_down, const float* s_gate, const float* s_up,
                    const float* s_down, const int* slot_ids, float* h, void* y,
                    int E, int C, int d, int f, int act, int w_dtype,
                    int out_dtype, cudaStream_t s) {
  if (w_dtype == kInt8)
    return quant_typed<TX, int8_t, true>(xg, w_gate, w_up, w_down, s_gate, s_up, s_down,
                                         slot_ids, h, y, E, C, d, f, act, out_dtype, s);
  if (w_dtype == kFloat16)
    return quant_typed<TX, __half, false>(xg, w_gate, w_up, w_down, s_gate, s_up, s_down,
                                          slot_ids, h, y, E, C, d, f, act, out_dtype, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// xg (E, C, d) fp32/bf16; w_gate, w_up (n_slots, d, f) and w_down
// (n_slots, f, d) in fp16 or int8 (w_gate null for ungated activations);
// s_gate, s_up (n_slots, f) and s_down (n_slots, d) fp32, int8 only (null
// for fp16); slot_ids (E,) int32 in [0, n_slots); h (E, C, f) fp32 scratch;
// y (E, C, d) in out_dtype (fp32 or bf16). All contiguous. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int moe_ffn_quant_launch(const void* xg, const void* w_gate,
                                    const void* w_up, const void* w_down,
                                    const void* s_gate, const void* s_up,
                                    const void* s_down, const void* slot_ids,
                                    void* h, void* y, int E, int C, int d, int f,
                                    int act, int x_dtype, int w_dtype,
                                    int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(s_gate);
  const float* su = static_cast<const float*>(s_up);
  const float* sd = static_cast<const float*>(s_down);
  const int* slots = static_cast<const int*>(slot_ids);
  float* hp = static_cast<float*>(h);
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0) return cudaSuccess;
  if (w_dtype == kInt8 && (su == nullptr || sd == nullptr)) return cudaErrorInvalidValue;
  if (x_dtype == kFloat32)
    return quant_x<float>(xg, w_gate, w_up, w_down, sg, su, sd, slots, hp, y,
                          E, C, d, f, act, w_dtype, out_dtype, s);
  if (x_dtype == kBFloat16)
    return quant_x<__nv_bfloat16>(xg, w_gate, w_up, w_down, sg, su, sd, slots, hp, y,
                                  E, C, d, f, act, w_dtype, out_dtype, s);
  return cudaErrorInvalidValue;
}
