// Fixed-order warp reductions for the backward kernels (wkv6_bwd.cu,
// selective_scan_bwd.cu): no atomics, so two launches give the same bits.
#pragma once

#include <cuda_runtime.h>

// Sum v over the L lanes of a group that differ in bits (L/2 .. 1) << SHIFT
// of the lane index; p is the lane's index in its group. Recursive halving:
// at each level a lane keeps one half of its live values, sends the other
// to its partner and adds what it receives, so L lanes reduce V values with
// V - V/L shuffles. On return lane p holds in v[0 .. V/L) the group's sums
// of the values at indices [p V/L, (p+1) V/L). The order of every addition
// is fixed, so the result is the same on every launch. Call with M = L / 2
// and NV = V (the recursion's live count); V and L powers of two, V >= L.
template <int SHIFT, int M, int NV, int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int p) {
  if constexpr (M >= 1) {
    constexpr int H = NV / 2;
    const bool up = (p & M) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M << SHIFT);
    }
    reduce_scatter<SHIFT, M / 2, H, V>(v, p);
  }
}

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }
