// Grouped expert FFN for Hopper (sm_90a), CUDA-core FMA.
//
// Replaces: repro/kernels/moe_ffn.py::moe_ffn (the Pallas `_kernel`).
// Computes, per expert e:  h = act(x @ W_gate, x @ W_up) rounded to x's
// dtype, then y = h @ W_down, accumulated in fp32 over all of f and
// rounded once (the reference `moe_ffn_ref`, not the Pallas kernel's
// per-f-block rounding). With `slot_ids` the weights are the slot cache's
// (n_slots, ...) buffers and expert e reads slot slot_ids[e]; null means
// slot e (the dense (E, ...) weights).
//
// What bounds it on this card: reading the expert weights. At decode the
// dispatch capacity C is a handful of rows per expert (C = 8 at the served
// shapes), so every weight byte feeds 2*C flops: ~16 flop/B in bf16 against
// the ~295 flop/B the H100 needs before compute is the limit. The bound is
// 3*E*d*f weight elements over 3.35 TB/s (4.83 GB, 1.44 ms per launch for
// E=128, d=4096, f=1536 in bf16).
//
// What the design does about it (grouped_gemm.cuh): every weight element is
// read from device memory exactly once per block row of C, by threads that
// walk the contiguous axis (each warp load is one fully used 64 B (bf16) or
// 128 B (fp32) segment). The C rows of x are staged in shared memory in fp32
// and broadcast, so each loaded weight is reused C times from a register.
// Two launches: up+activation into a scratch h (E, C, f) in x's dtype, then
// down-projection into y. Ragged C and f are masked; nothing needs to divide
// a tile. Experts with no routed rows are still computed (their x rows are
// zero, so their y rows are zero): skipping them is left to a later change.
#include "grouped_gemm.cuh"

namespace {

template <typename T>
cudaError_t moe_ffn_typed(const void* xg, const void* w_gate, const void* w_up,
                          const void* w_down, const int* slot_ids, void* h,
                          void* y, int E, int C, int d, int f, int act,
                          cudaStream_t s) {
  cudaError_t err = grouped::launch_act<T, T, T, false>(
      act, xg, w_up, w_gate, nullptr, nullptr, slot_ids, h, E, C, d, f, s);
  if (err != cudaSuccess) return err;
  return grouped::launch<T, T, T, grouped::kNone, false>(
      h, w_down, nullptr, nullptr, nullptr, slot_ids, y, E, C, f, d, s);
}

}  // namespace

// xg (E, C, d); w_gate, w_up (n, d, f) (w_gate may be null for ungated
// activations); w_down (n, f, d); slot_ids (E,) int32 in [0, n) or null
// (then n = E); h (E, C, f) scratch; y (E, C, d). All contiguous, one dtype.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int moe_ffn_launch(const void* xg, const void* w_gate, const void* w_up,
                              const void* w_down, const void* slot_ids, void* h,
                              void* y, int E, int C, int d, int f, int act,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* slots = static_cast<const int*>(slot_ids);
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0) return cudaSuccess;
  if (dtype == kFloat32)
    return moe_ffn_typed<float>(xg, w_gate, w_up, w_down, slots, h, y, E, C, d, f, act, s);
  if (dtype == kBFloat16)
    return moe_ffn_typed<__nv_bfloat16>(xg, w_gate, w_up, w_down, slots, h, y, E, C, d, f, act, s);
  return cudaErrorInvalidValue;
}
