// Grouped expert GEMM + activation over per-expert (slot-indexed) weights,
// skipping rows and experts with nothing routed to them: the design of
// moe_ffn.cu (B1), written to be shared with the dequantizing B2 later.
//
//   out[e, c, n] = act(sum_k x[e,c,k] * W2[s,k,n], sum_k x[e,c,k] * W1[s,k,n])
//
// with s = slot_ids[e] (or e when slot_ids is null). W2 is the gate weight,
// read only for gated activations. x, the weights and out share one dtype
// T (bf16 or fp32); sums are fp32 and out is rounded once.
//
// Zero rows. With no bias every activation maps a zero row to zero
// (silu(0)*0, gelu(0)*0, relu(0)^2, gelu(0)), so a row of x that is all zero
// gives an all-zero row of out. `scan_rows` marks each row of x and each
// expert that has a non-zero row; the GEMM writes +0.0 to every row marked
// zero, and a block of an expert with no marked row writes its zeros and
// exits without reading a weight. Both launches of an FFN (up + act, then
// down) take the marks of the FFN's input.
//
// Layout: a block owns kTileN = 64 output columns (n, the weights'
// contiguous axis) and up to kRows rows of x (32 in bf16, 16 in fp32), and
// walks all of K in stages of kTileK = 64. Each stage's weight tile(s) and
// x tile go into a kStages-deep shared-memory ring with 16-byte cp.async
// (zero-filled past the edges), so several stages of weights are in flight
// per block while the tensor cores work. bf16 computes y^T = W^T x^T with
// mma.sync m16n8k16: each of the 4 warps takes 16 weight columns as the M
// side (ldmatrix.trans from the swizzled tile), x's rows are the N side in
// n-tiles of 8 (ldmatrix), fp32 accumulators. fp32 keeps CUDA-core FMAs
// (TF32 would change the numbers): a thread owns 4 columns (one float4 of
// the weight row) for every row, over an eighth of each stage's k, so each
// weight leaves the ring once; the eight partial sums meet in shared memory
// at the end. When a row of x or of a weight is not a multiple of 16 bytes
// (ragged K or N), the ring is filled with plain element loads instead of
// cp.async.
#pragma once

#include "sm90.cuh"

namespace moe_tc {

enum Act : int { kNone = 0, kSwiglu = 1, kGeglu = 2, kRelu2 = 3, kGelu = 4 };

constexpr int kThreads = 128;
constexpr int kTileN = 64;     // output columns per block, 16 per warp
constexpr int kTileK = 64;     // reduction depth of one ring stage
constexpr int kScanThreads = 256;
static_assert(kTileK == kTileN, "x and weight tiles share one row layout");

template <typename T>
struct Ring {
  static constexpr int kVec = 16 / sizeof(T);          // elements per 16 B
  static constexpr int kCpr = kTileN / kVec;           // 16 B chunks per tile row
  static constexpr int kStages = sizeof(T) == 2 ? 4 : 3;
  // rows of x per block, in n-tiles of 8: four in bf16; two in fp32, so
  // that two blocks of the gated fp32 ring fit on an SM
  static constexpr int kRows = sizeof(T) == 2 ? 32 : 16;
  static constexpr int kTiles = kRows / 8;
  static constexpr int kW = kTileK * kTileN;           // one weight tile
  static constexpr int kX = kRows * kTileK;            // one x tile
  __host__ __device__ static constexpr int stage(bool gated) {
    return (gated ? 2 : 1) * kW + kX;
  }
  __host__ __device__ static constexpr size_t bytes(bool gated) {
    return (size_t)kStages * stage(gated) * sizeof(T);
  }
  // element offset of chunk ch of tile row r (both tiles have rows of 64)
  __device__ static int at(int r, int ch) {
    if constexpr (sizeof(T) == 2) return swizzle<T>(r, ch, kCpr);
    else return (r * kCpr + ch) * kVec;
  }
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;      // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

template <int ACT>
__device__ __forceinline__ float act(float g, float u) {
  if (ACT == kSwiglu) return g / (1.f + expf(-g)) * u;
  if (ACT == kGeglu) return gelu_tanh(g) * u;
  if (ACT == kRelu2) {
    const float p = fmaxf(u, 0.f);
    return p * p;
  }
  if (ACT == kGelu) return gelu_tanh(u);
  return u;
}

// 16 bytes of x hold a non-zero value (-0.0 counts as zero; NaN does not)
template <typename T>
__device__ __forceinline__ bool nonzero16(uint4 v) {
  const uint32_t mask = sizeof(T) == 2 ? 0x7fff7fffu : 0x7fffffffu;
  return ((v.x & mask) | (v.y & mask) | (v.z & mask) | (v.w & mask)) != 0u;
}

template <typename T>
__device__ __forceinline__ bool nonzero(T v) {
  return fabsf(to_f32(v)) != 0.f || to_f32(v) != to_f32(v);
}

// row_nz[e*C + c] = row c of expert e has a non-zero value; expert_nz[e] =
// any of its rows does. One block per expert, one warp per row at a time.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
scan_rows(const T* __restrict__ x, int C, int K, int aligned,
          int* __restrict__ row_nz, int* __restrict__ expert_nz) {
  const int e = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int any = 0;
  for (int c = warp; c < C; c += kScanThreads / 32) {
    const T* xr = x + ((size_t)e * C + c) * K;
    bool nz = false;
    if (aligned) {
      const uint4* v = reinterpret_cast<const uint4*>(xr);
      const int n = K / Ring<T>::kVec;
#pragma unroll 4
      for (int i = lane; i < n; i += 32) nz |= nonzero16<T>(v[i]);
    } else {
      for (int i = lane; i < K; i += 32) nz |= nonzero(xr[i]);
    }
    nz = __any_sync(0xffffffffu, nz);
    if (lane == 0) row_nz[(size_t)e * C + c] = nz;
    any |= nz;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) expert_nz[e] = any;
}

// x (E, C, K); w1, w2 (n_slots, K, N); out (E, C, N). aligned: every x row
// and weight row starts on 16 bytes (K and N multiples of 16 / sizeof(T),
// aligned bases), which the cp.async path needs.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
gemm_act(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ w2,
         const int* __restrict__ slot_ids, const int* __restrict__ row_nz,
         const int* __restrict__ expert_nz, T* __restrict__ out, int C, int K,
         int N, int aligned) {
  using R = Ring<T>;
  constexpr bool kGated = (ACT == kSwiglu || ACT == kGeglu);
  constexpr bool kTensor = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int e = blockIdx.z;
  const int n0 = blockIdx.x * kTileN, c0 = blockIdx.y * R::kRows;
  const int rows = min(R::kRows, C - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* oe = out + ((size_t)e * C + c0) * N;

  if (!expert_nz[e]) {                // nothing routed here: zeros, no weights
    for (int i = tid; i < rows * kTileN; i += kThreads) {
      const int r = i / kTileN, n = n0 + i - r * kTileN;
      if (n < N) oe[(size_t)r * N + n] = from_f32<T>(0.f);
    }
    return;
  }
  const int nnt = (rows + 7) / 8;     // n-tiles of 8 rows that hold rows
  const size_t slot = slot_ids ? (size_t)slot_ids[e] : (size_t)e;
  const T* w1e = w1 + slot * K * N;
  const T* w2e = kGated ? w2 + slot * K * N : w1e;
  const T* xe = x + ((size_t)e * C + c0) * K;
  const int ktiles = (K + kTileK - 1) / kTileK;

  auto copy = [&](T* dst, const T* src, int row, int col, int ld, bool ok) {
    if (aligned) {
      cp_async16(dst, ok ? src + (size_t)row * ld + col : src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < R::kVec; ++j)
        dst[j] = (ok && col + j < ld) ? src[(size_t)row * ld + col + j] : from_f32<T>(0.f);
    }
  };
  auto load = [&](int stage, int kt) {
    T* ws = sm + (size_t)stage * R::stage(kGated);
    const int k0 = kt * kTileK;
    for (int i = tid; i < kTileK * R::kCpr; i += kThreads) {
      const int r = i / R::kCpr, ch = i - r * R::kCpr;
      const int k = k0 + r, n = n0 + ch * R::kVec;
      const bool ok = k < K && n < N;
      copy(ws + R::at(r, ch), w1e, k, n, N, ok);
      if (kGated) copy(ws + R::kW + R::at(r, ch), w2e, k, n, N, ok);
    }
    T* xs = ws + (kGated ? 2 : 1) * R::kW;
    for (int i = tid; i < nnt * 8 * R::kCpr; i += kThreads) {
      const int r = i / R::kCpr, ch = i - r * R::kCpr;
      const int k = k0 + ch * R::kVec;
      copy(xs + R::at(r, ch), xe, r, k, K, r < rows && k < K);
    }
    cp_async_commit();
  };

  // accumulators for the up (1) and gate (2) products: bf16, [n-tile] of
  // one mma fragment; fp32, [n-tile] of 8 rows x 4 columns over this
  // thread's eighth of each stage's k
  constexpr int kAcc = kTensor ? 4 : 32;
  float acc1[R::kTiles][kAcc] = {}, acc2[R::kTiles][kAcc] = {};
#pragma unroll
  for (int s = 0; s < R::kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    else cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<R::kStages - 2>();
    __syncthreads();                  // stage kt landed; stage kt-1 is free
    const int nk = kt + R::kStages - 1;
    if (nk < ktiles) load(nk % R::kStages, nk);
    else cp_async_commit();
    const T* ws = sm + (size_t)(kt % R::kStages) * R::stage(kGated);
    const T* xs = ws + (kGated ? 2 : 1) * R::kW;
    if constexpr (kTensor) {
      const int q4 = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int ks = 0; ks < kTileK / 16; ++ks) {
        // A = W^T: matrices (k lo, m lo), (k lo, m hi), (k hi, m lo), (k hi, m hi)
        const int kr = ks * 16 + (q4 >> 1) * 8 + r8;
        const int wa = R::at(kr, warp * 2 + (q4 & 1));
        uint32_t a1[4], a2[4];
        ldsm_x4_trans(a1, ws + wa);
        if (kGated) ldsm_x4_trans(a2, ws + R::kW + wa);
#pragma unroll
        for (int nt = 0; nt < R::kTiles; ++nt) {
          if (nt >= nnt) break;
          // B = x^T: matrices (rows nt*8.., k lo), (same rows, k hi)
          uint32_t b[2];
          ldsm_x2(b, xs + R::at(nt * 8 + r8, ks * 2 + (q4 & 1)));
          mma_bf16(acc1[nt], a1, b[0], b[1]);
          if (kGated) mma_bf16(acc2[nt], a2, b[0], b[1]);
        }
      }
    } else {
      // thread: columns cg*4.. (one float4 of a weight row) for every row,
      // at k = kg, kg + 8, ...: each weight is read from the ring once
      const int cg = tid & 15, kg = tid >> 4;
#pragma unroll 2
      for (int kk = kg; kk < kTileK; kk += 8) {
        const float4 u = *reinterpret_cast<const float4*>(ws + kk * kTileN + cg * 4);
        float4 g = u;
        if (kGated) g = *reinterpret_cast<const float4*>(ws + R::kW + kk * kTileN + cg * 4);
#pragma unroll
        for (int nt = 0; nt < R::kTiles; ++nt) {
          if (nt >= nnt) break;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float xv = to_f32(xs[(nt * 8 + r) * kTileK + kk]);
            acc1[nt][r * 4 + 0] = fmaf(xv, u.x, acc1[nt][r * 4 + 0]);
            acc1[nt][r * 4 + 1] = fmaf(xv, u.y, acc1[nt][r * 4 + 1]);
            acc1[nt][r * 4 + 2] = fmaf(xv, u.z, acc1[nt][r * 4 + 2]);
            acc1[nt][r * 4 + 3] = fmaf(xv, u.w, acc1[nt][r * 4 + 3]);
            if (kGated) {
              acc2[nt][r * 4 + 0] = fmaf(xv, g.x, acc2[nt][r * 4 + 0]);
              acc2[nt][r * 4 + 1] = fmaf(xv, g.y, acc2[nt][r * 4 + 1]);
              acc2[nt][r * 4 + 2] = fmaf(xv, g.z, acc2[nt][r * 4 + 2]);
              acc2[nt][r * 4 + 3] = fmaf(xv, g.w, acc2[nt][r * 4 + 3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: act, +0.0 on rows marked zero, rounded once to T
  const int* nz = row_nz + (size_t)e * C + c0;
  if constexpr (kTensor) {
#pragma unroll
    for (int nt = 0; nt < R::kTiles; ++nt) {
      if (nt >= nnt) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // d: (m g, n 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
        const int r = nt * 8 + 2 * (lane & 3) + (i & 1);
        const int n = n0 + warp * 16 + (lane >> 2) + (i >> 1) * 8;
        if (r < rows && n < N)
          oe[(size_t)r * N + n] = from_f32<T>(nz[r] ? act<ACT>(acc2[nt][i], acc1[nt][i]) : 0.f);
      }
    }
  } else {
    // the eight k-groups' partial sums meet in the (now idle) ring
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem_raw);     // [2][8][kRows][kTileN]
    constexpr int kPart = 8 * R::kRows * kTileN;
    const int cg = tid & 15, kg = tid >> 4;
#pragma unroll
    for (int nt = 0; nt < R::kTiles; ++nt) {
      if (nt >= nnt) break;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int at = (kg * R::kRows + nt * 8 + r) * kTileN + cg * 4;
        *reinterpret_cast<float4*>(red + at) =
            make_float4(acc1[nt][r * 4], acc1[nt][r * 4 + 1], acc1[nt][r * 4 + 2],
                        acc1[nt][r * 4 + 3]);
        if (kGated)
          *reinterpret_cast<float4*>(red + kPart + at) =
              make_float4(acc2[nt][r * 4], acc2[nt][r * 4 + 1], acc2[nt][r * 4 + 2],
                          acc2[nt][r * 4 + 3]);
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * kTileN; i += kThreads) {
      const int r = i / kTileN, c = i - r * kTileN, n = n0 + c;
      if (n >= N) continue;
      float u = 0.f, g = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        u += red[(x * R::kRows + r) * kTileN + c];
        if (kGated) g += red[kPart + (x * R::kRows + r) * kTileN + c];
      }
      oe[(size_t)r * N + n] = from_f32<T>(nz[r] ? act<ACT>(g, u) : 0.f);
    }
  }
}

template <typename T, int ACT>
cudaError_t launch(const T* x, const T* w1, const T* w2, const int* slot_ids,
                   const int* row_nz, const int* expert_nz, T* out, int E, int C,
                   int K, int N, cudaStream_t s) {
  constexpr bool kGated = (ACT == kSwiglu || ACT == kGeglu);
  constexpr size_t smem = Ring<T>::bytes(kGated);
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_act<T, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  auto a16 = [](const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = Ring<T>::kVec;
  const int aligned = K % vec == 0 && N % vec == 0 && a16(x) && a16(w1) && a16(w2);
  const dim3 grid((N + kTileN - 1) / kTileN, (C + Ring<T>::kRows - 1) / Ring<T>::kRows, E);
  gemm_act<T, ACT><<<grid, kThreads, smem, s>>>(x, w1, w2, slot_ids, row_nz, expert_nz,
                                                out, C, K, N, aligned);
  return cudaGetLastError();
}

// The same with the activation chosen at run time (the up-projection;
// kNone, the down-projection's, is not taken).
template <typename T>
cudaError_t launch_act(int act, const T* x, const T* w1, const T* w2, const int* slot_ids,
                       const int* row_nz, const int* expert_nz, T* out, int E, int C,
                       int K, int N, cudaStream_t s) {
  switch (act) {
    case kSwiglu: return launch<T, kSwiglu>(x, w1, w2, slot_ids, row_nz, expert_nz, out, E, C, K, N, s);
    case kGeglu: return launch<T, kGeglu>(x, w1, w2, slot_ids, row_nz, expert_nz, out, E, C, K, N, s);
    case kRelu2: return launch<T, kRelu2>(x, w1, w2, slot_ids, row_nz, expert_nz, out, E, C, K, N, s);
    case kGelu: return launch<T, kGelu>(x, w1, w2, slot_ids, row_nz, expert_nz, out, E, C, K, N, s);
    default: return cudaErrorInvalidValue;
  }
}

// Marks of x's rows and experts: one scan_rows launch.
template <typename T>
cudaError_t scan(const T* x, int E, int C, int K, int* row_nz, int* expert_nz,
                 cudaStream_t s) {
  const int aligned = K % Ring<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  scan_rows<T><<<E, kScanThreads, 0, s>>>(x, C, K, aligned, row_nz, expert_nz);
  return cudaGetLastError();
}

}  // namespace moe_tc
