// Grouped expert FFN for Hopper (sm_90a): tensor cores in bf16, cp.async
// weight ring, experts and rows with nothing routed to them skipped.
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
// shape), so each 2-byte weight feeds 2 * C = 16 flops against the ~295
// flop/B at which the bf16 tensor cores would become the limit. Reading
// every expert (E=128, d=4096, f=1536) is 4.83 GB, 1.44 ms at 3.35 TB/s.
// But at decode the pool routes 4 tokens to top-8 experts, so at most 32 of
// the 128 experts have a routed row: the rows of the rest are exact zeros
// (the dispatch fills them from a zero row), and their weights need not be
// read at all. What is left, ~29 experts x 37.7 MB, is ~0.33 ms.
//
// What the design does about it (moe_ffn_tc.cuh):
//  - A first small launch marks the non-zero rows of xg (reading xg, 8 MB
//    at decode, on the device: no host sync). A block whose rows are all
//    unmarked (every block of an expert nothing was routed to) writes
//    zeros and exits before any weight is read; rows marked zero are
//    written as +0.0. The function is unchanged: every activation maps a
//    zero row to zero.
//  - The weights stream as 16-byte cp.async copies into a shared-memory
//    ring (4 stages in bf16, 3 in fp32), so each block keeps several 16 KB
//    stages in flight.
//  - bf16 multiplies on the tensor cores with the operands swapped
//    (y^T = W^T x^T, mma.sync m16n8k16): the weight tile is the M side, the
//    few routed rows the N side, fp32 accumulation. No per-element widening
//    or FMA issue is left to bound the SM. fp32 weights (the streaming fp32
//    wire) keep CUDA-core FMAs, fed from the same ring.
//  - Two launches after the scan: up+activation into a scratch h (E, C, f)
//    in x's dtype (3 MB at decode, L2-resident), then the down-projection.
//    Fusing them would need a block to own all of f for its rows, or a
//    cross-block reduction over f; at decode the split costs one more
//    launch and a read of h from L2, so they stay apart. Ragged C, d and f
//    are masked; nothing needs to divide a tile.
#include "moe_ffn_tc.cuh"

namespace {

template <typename T>
cudaError_t moe_ffn_typed(const void* xg, const void* w_gate, const void* w_up,
                          const void* w_down, const int* slot_ids, int* row_nz,
                          void* h, void* y, int E, int C, int d, int f, int act,
                          cudaStream_t s) {
  const T* x = static_cast<const T*>(xg);
  cudaError_t err = moe_tc::scan<T>(x, E, C, d, row_nz, s);
  if (err != cudaSuccess) return err;
  err = moe_tc::launch_act<T, T, T, false>(act, x, static_cast<const T*>(w_up),
                                           static_cast<const T*>(w_gate), nullptr, nullptr,
                                           slot_ids, row_nz, static_cast<T*>(h), E, C, d, f, s);
  if (err != cudaSuccess) return err;
  return moe_tc::launch<T, T, T, moe_tc::kNone, false>(
      static_cast<const T*>(h), static_cast<const T*>(w_down), nullptr, nullptr, nullptr,
      slot_ids, row_nz, static_cast<T*>(y), E, C, f, d, s);
}

}  // namespace

// xg (E, C, d); w_gate, w_up (n, d, f) (w_gate may be null for ungated
// activations); w_down (n, f, d); slot_ids (E,) int32 in [0, n) or null
// (then n = E); flags int32 scratch of E * C (row marks); h (E, C, f)
// scratch; y (E, C, d). All contiguous, one dtype. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int moe_ffn_launch(const void* xg, const void* w_gate, const void* w_up,
                              const void* w_down, const void* slot_ids, void* flags,
                              void* h, void* y, int E, int C, int d, int f, int act,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* slots = static_cast<const int*>(slot_ids);
  int* fl = static_cast<int*>(flags);
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0) return cudaSuccess;
  if (dtype == kFloat32)
    return moe_ffn_typed<float>(xg, w_gate, w_up, w_down, slots, fl, h, y, E, C, d, f, act, s);
  if (dtype == kBFloat16)
    return moe_ffn_typed<__nv_bfloat16>(xg, w_gate, w_up, w_down, slots, fl, h, y, E, C, d, f,
                                        act, s);
  return cudaErrorInvalidValue;
}
