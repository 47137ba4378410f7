// Grouped expert GEMM + activation over per-expert (slot-indexed) weights,
// skipping rows and experts with nothing routed to them: the one building
// block of moe_ffn.cu (B1, bf16/fp32 weights) and moe_ffn_quant.cu (B2,
// fp16 or int8 wire weights with fp32 per-output-column scales).
//
//   out[e, c, n] = act(sum_k x[e,c,k] * W2[s,k,n], sum_k x[e,c,k] * W1[s,k,n])
//
// with s = slot_ids[e] (or e when slot_ids is null) and, under SCALED,
// W = float(q) * scale[s, n]. W2 is the gate weight, read only for gated
// activations. x is TX (bf16 or fp32), the weights TW (bf16, fp32, fp16 or
// int8), out TO (bf16 or fp32); sums are fp32 and out is rounded once.
//
// Zero rows. With no bias every activation maps a zero row to zero
// (silu(0)*0, gelu(0)*0, relu(0)^2, gelu(0)), so a row of x that is all zero
// gives an all-zero row of out. `scan_rows` marks each row of x that has a
// non-zero value. A block writes +0.0 to its unmarked rows, gathers its
// marked rows into the front of its x tile and computes only those; a
// block with no marked row reads no weight and no scale. Both launches of
// an FFN (up + act, then down) take the marks of the FFN's input.
//
// Layout: a block owns kTileN = 64 output columns (n, the weights'
// contiguous axis) and up to kRows rows of x, and walks all of K in stages
// of kTileK = 64. Each stage's weight tile(s), in the weights' own (narrow)
// type, and the x tile go into a kStages-deep shared-memory ring with
// 16-byte cp.async (zero-filled past the edges), so several stages of
// weights are in flight per block. When a row of x or of a weight is not a
// multiple of 16 bytes (ragged K or N), the ring is filled with plain
// element loads instead of cp.async.
//  - bf16 x and bf16 weights (B1) compute y^T = W^T x^T on the tensor cores
//    with mma.sync m16n8k16: each of the 4 warps takes 16 weight columns as
//    the M side (ldmatrix.trans from the swizzled tile), the marked rows are
//    the N side in n-tiles of 8 (ldmatrix), fp32 accumulators.
//  - Every other pairing computes in fp32 on the CUDA cores (TF32 or int8
//    MMA would change the fp32 numbers): a thread owns 4 columns of the
//    weight tile over 8 consecutive k of each stage, reads x 16 bytes at a
//    time, widens each weight once as it leaves the ring and reuses it for
//    every marked row (in steps of 4; wire types take exactly the marked
//    rows when there are fewer than 4). The eight partial sums meet in shared memory at the end,
//    each multiplied first by its column's scale (SCALED), which the
//    thread keeps in registers.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace moe_tc {

enum Act : int { kNone = 0, kSwiglu = 1, kGeglu = 2, kRelu2 = 3, kGelu = 4 };

constexpr int kThreads = 128;
constexpr int kTileN = 64;     // output columns per block, 16 per warp
constexpr int kTileK = 64;     // reduction depth of one ring stage
constexpr int kScanThreads = 256;
static_assert(kTileK == kTileN, "x and weight tiles share one row length");

template <typename TX, typename TW>
struct Ring {
  static constexpr bool kTensor = std::is_same<TX, __nv_bfloat16>::value &&
                                  std::is_same<TW, __nv_bfloat16>::value;
  static constexpr bool kNarrow = sizeof(TW) < 4 && !kTensor;   // fp16/int8
  // rows of x per block: four n-tiles of 8 on the tensor cores; on the CUDA
  // cores 16 for fp32 weights, and for the wire types 8 (the decode
  // capacity), which keeps the registers to three blocks an SM
  static constexpr int kRows = kTensor ? 32 : kNarrow ? 8 : 16;
  static constexpr int kTiles = kRows / 8;
  static constexpr int kMinBlocks = kNarrow ? 3 : 1;
  // CUDA cores: marked rows are computed in steps of kStep rows (zero rows
  // of the x tile past the last), which leaves the compiler fewer branches
  // to schedule around; a block of wire-type weights with fewer than kFew
  // marked rows computes exactly those (a decode row is often alone in its
  // expert). fp32 weights (B1's fp32 wire) keep one path, which holds its
  // registers.
  static constexpr int kFew = 4, kStep = 4;
  // an int8 tile is 4 KB, so the ring can be deep
  static constexpr int kStages = kTensor ? 4 : sizeof(TW) == 1 ? 6 : 3;
  static constexpr int kWBytes = kTileK * kTileN * (int)sizeof(TW);
  static constexpr int kXBytes = kRows * kTileK * (int)sizeof(TX);
  __host__ __device__ static constexpr int stage(bool gated) {
    return (gated ? 2 : 1) * kWBytes + kXBytes;
  }
  // the ring; on the CUDA cores at least the [2][8][kRows][kTileN] fp32
  // partial sums that reuse it at the end
  __host__ __device__ static constexpr size_t bytes(bool gated) {
    const size_t ring = (size_t)kStages * stage(gated);
    const size_t red = kTensor ? 0 : (size_t)(gated ? 2 : 1) * 8 * kRows * kTileN * 4;
    return ring > red ? ring : red;
  }
  // element offset of 16-byte chunk ch of tile row r (rows of 64 elements)
  template <typename T>
  __device__ static int at(int r, int ch) {
    constexpr int vec = 16 / sizeof(T), chunks = 64 / vec;
    if constexpr (kTensor) return swizzle<T>(r, ch, chunks);
    else return (r * chunks + ch) * vec;
  }
  // the same in the weight tile. On the CUDA cores a warp reads two rows 8
  // apart at once; an int8 row is 64 bytes, half the banks, so rows of odd
  // groups of 8 swap neighbours and the two land on different halves.
  __device__ static int wat(int r, int ch) {
    if constexpr (sizeof(TW) == 1 && !kTensor) r ^= (r >> 3) & 1;
    return at<TW>(r, ch);
  }
};

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// element i of 16 bytes of x (i a compile-time constant after unrolling)
template <typename TX>
__device__ __forceinline__ float xval(const uint4& v, int i) {
  if constexpr (sizeof(TX) == 4) {
    return __uint_as_float(word(v, i));
  } else {
    const uint32_t p = word(v, i >> 1);     // bf16: element 2w in the low half
    return __uint_as_float((i & 1) ? (p & 0xffff0000u) : (p << 16));
  }
}

// a1 += xv * u and, gated, a2 += xv * g, over four columns
template <bool kGated>
__device__ __forceinline__ void fma4x2(float (&a1)[4], float (&a2)[4], float xv, float4 u,
                                       float4 g) {
  a1[0] = fmaf(xv, u.x, a1[0]);
  a1[1] = fmaf(xv, u.y, a1[1]);
  a1[2] = fmaf(xv, u.z, a1[2]);
  a1[3] = fmaf(xv, u.w, a1[3]);
  if (kGated) {
    a2[0] = fmaf(xv, g.x, a2[0]);
    a2[1] = fmaf(xv, g.y, a2[1]);
    a2[2] = fmaf(xv, g.z, a2[2]);
    a2[3] = fmaf(xv, g.w, a2[3]);
  }
}

template <int N> struct Bits;
template <> struct Bits<1> { using T = uint8_t; };
template <> struct Bits<2> { using T = uint16_t; };
template <> struct Bits<4> { using T = uint32_t; };

// 16 bytes from src[row * ld + col ..] into dst, zero past the row's end
// (col + j >= ld) or everywhere when !ok; cp.async when rows are aligned.
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, int row, int col, int ld,
                                       bool ok, bool aligned) {
  if (aligned) {
    cp_async16(dst, ok ? src + (size_t)row * ld + col : src, ok);
  } else {
    using B = typename Bits<sizeof(T)>::T;     // zero is all bits clear in every T
    B* d = reinterpret_cast<B*>(dst);
    const B* s = reinterpret_cast<const B*>(src) + (size_t)row * ld;
#pragma unroll
    for (int j = 0; j < 16 / (int)sizeof(T); ++j) d[j] = (ok && col + j < ld) ? s[col + j] : B(0);
  }
}

// four consecutive weights from the ring, widened to fp32
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 widen4(const __half* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// int8: byte b + 128 becomes the low mantissa bits of 2^23, so
// float(b) = bits(0x4B000000 | (b ^ 0x80)) - (2^23 + 128), exactly
__device__ __forceinline__ float4 widen4(const int8_t* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  const float bias = 8388736.f;
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - bias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - bias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - bias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - bias);
}

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

// row_nz[e*C + c] = row c of expert e has a non-zero value. One block per
// expert, one warp per row at a time.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
scan_rows(const T* __restrict__ x, int C, int K, int aligned, int* __restrict__ row_nz) {
  const int e = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < C; c += kScanThreads / 32) {
    const T* xr = x + ((size_t)e * C + c) * K;
    bool nz = false;
    if (aligned) {
      const uint4* v = reinterpret_cast<const uint4*>(xr);
      const int n = K / (16 / (int)sizeof(T));
#pragma unroll 4
      for (int i = lane; i < n; i += 32) nz |= nonzero16<T>(v[i]);
    } else {
      for (int i = lane; i < K; i += 32) nz |= nonzero(xr[i]);
    }
    nz = __any_sync(0xffffffffu, nz);
    if (lane == 0) row_nz[(size_t)e * C + c] = nz;
  }
}

// x (E, C, K); w1, w2 (n_slots, K, N); s1, s2 (n_slots, N) fp32 scales,
// read only when SCALED; out (E, C, N). aligned: every x row and weight row
// starts on 16 bytes (K and N multiples of 16 bytes' worth of elements,
// aligned bases), which the cp.async path needs.
template <typename TX, typename TW, typename TO, int ACT, bool SCALED>
__global__ void __launch_bounds__(kThreads, (Ring<TX, TW>::kMinBlocks))
gemm_act(const TX* __restrict__ x, const TW* __restrict__ w1, const TW* __restrict__ w2,
         const float* __restrict__ s1, const float* __restrict__ s2,
         const int* __restrict__ slot_ids, const int* __restrict__ row_nz,
         TO* __restrict__ out, int C, int K, int N, int aligned) {
  using R = Ring<TX, TW>;
  constexpr bool kGated = (ACT == kSwiglu || ACT == kGeglu);
  constexpr int kW = kGated ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int e = blockIdx.z;
  const int n0 = blockIdx.x * kTileN, c0 = blockIdx.y * R::kRows;
  const int rows = min(R::kRows, C - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  TO* oe = out + ((size_t)e * C + c0) * N;
  // the slot table is read alongside the marks (it is not a weight)
  const size_t slot = slot_ids ? (size_t)slot_ids[e] : (size_t)e;

  // this block's marked rows, as a bit mask every warp makes for itself
  const unsigned mask = __ballot_sync(
      0xffffffffu, lane < rows && row_nz[(size_t)e * C + c0 + lane] != 0);
  const int nr = __popc(mask);
  auto zero_unmarked = [&]() {
    for (int i = tid; i < rows * kTileN; i += kThreads) {
      const int r = i / kTileN, n = n0 + i - r * kTileN;
      if (!((mask >> r) & 1u) && n < N) oe[(size_t)r * N + n] = from_f32<TO>(0.f);
    }
  };
  if (nr == 0) {                      // nothing routed here: no weight is read
    zero_unmarked();
    return;
  }
  // tile row r holds row rmap(r): on the CUDA cores the r-th marked row
  // (the marked rows gathered to the front); on the tensor cores row r
  // itself (an n-tile of 8 rows costs the same however many are marked)
  auto rmap = [mask](int r) { return R::kTensor ? r : (int)__fns(mask, 0, r + 1); };
  const int nx = R::kTensor ? rows : nr;          // tile rows that hold data

  const TW* w1e = w1 + slot * K * N;
  const TW* w2e = kGated ? w2 + slot * K * N : w1e;
  const TX* xe = x + ((size_t)e * C + c0) * K;
  const int ktiles = (K + kTileK - 1) / kTileK;
  // x tile rows to fill (past nx with zeros): whole n-tiles on the tensor
  // cores, else the marked rows, in steps of kStep when there are many
  const int step = R::kTensor ? 8 : R::kNarrow && nx < R::kFew ? 1 : R::kStep;
  const int xrows = (nx + step - 1) / step * step;
  constexpr int kCw = 64 * (int)sizeof(TW) / 16, kCx = 64 * (int)sizeof(TX) / 16;
  // the x chunks this thread copies each stage, and their source rows
  constexpr int kXIter = (R::kRows * kCx + kThreads - 1) / kThreads;
  int xsrc[kXIter];
#pragma unroll
  for (int j = 0; j < kXIter; ++j) {
    const int r = (tid + j * kThreads) / kCx;
    xsrc[j] = r < nx ? rmap(r) : -1;
  }

  auto load = [&](int stage, int kt) {
    unsigned char* st = smem_raw + (size_t)stage * R::stage(kGated);
    TW* ws = reinterpret_cast<TW*>(st);
    TX* xs = reinterpret_cast<TX*>(st + kW * R::kWBytes);
    const int k0 = kt * kTileK;
    for (int i = tid; i < kTileK * kCw; i += kThreads) {
      const int r = i / kCw, ch = i - r * kCw;
      const int k = k0 + r, n = n0 + ch * (16 / (int)sizeof(TW));
      const bool ok = k < K && n < N;
      const int at = R::wat(r, ch);
      copy16(ws + at, w1e, k, n, N, ok, aligned);
      if (kGated) copy16(ws + R::kWBytes / (int)sizeof(TW) + at, w2e, k, n, N, ok, aligned);
    }
#pragma unroll
    for (int j = 0; j < kXIter; ++j) {
      const int i = tid + j * kThreads;
      if (i >= xrows * kCx) break;
      const int r = i / kCx, ch = i - r * kCx;
      const int k = k0 + ch * (16 / (int)sizeof(TX));
      const bool ok = xsrc[j] >= 0 && k < K;
      copy16(xs + R::template at<TX>(r, ch), xe, ok ? xsrc[j] : 0, k, K, ok, aligned);
    }
    cp_async_commit();
  };

  // accumulators for the up (1) and gate (2) products: tensor cores,
  // [n-tile] of one mma fragment; CUDA cores, [tile row] of 4 columns over
  // this thread's eighth of each stage's k
  constexpr int kA = R::kTensor ? R::kTiles : R::kRows;
  float acc1[kA][4] = {}, acc2[kA][4] = {};
  const int cg = tid & 15, kg = tid >> 4;   // CUDA cores: columns cg*4.., k kg*8..
  float4 sc1 = make_float4(1.f, 1.f, 1.f, 1.f), sc2 = sc1;
  if constexpr (SCALED) {   // this thread's four columns keep their scales
    float* a1 = &sc1.x;
    float* a2 = &sc2.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + cg * 4 + j;
      a1[j] = n < N ? s1[slot * N + n] : 0.f;
      if (kGated) a2[j] = n < N ? s2[slot * N + n] : 0.f;
    }
  }
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
    const unsigned char* st = smem_raw + (size_t)(kt % R::kStages) * R::stage(kGated);
    const TW* ws = reinterpret_cast<const TW*>(st);
    const TW* ws2 = ws + R::kWBytes / (int)sizeof(TW);
    const TX* xs = reinterpret_cast<const TX*>(st + kW * R::kWBytes);
    if constexpr (R::kTensor) {
      const int nnt = (nx + 7) / 8;   // n-tiles that hold rows
      const int q4 = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int ks = 0; ks < kTileK / 16; ++ks) {
        // A = W^T: matrices (k lo, m lo), (k lo, m hi), (k hi, m lo), (k hi, m hi)
        const int kr = ks * 16 + (q4 >> 1) * 8 + r8;
        const int wa = R::wat(kr, warp * 2 + (q4 & 1));
        uint32_t a1[4], a2[4];
        ldsm_x4_trans(a1, ws + wa);
        if (kGated) ldsm_x4_trans(a2, ws2 + wa);
#pragma unroll
        for (int nt = 0; nt < R::kTiles; ++nt) {
          if (nt >= nnt) break;
          // B = x^T: matrices (rows nt*8.., k lo), (same rows, k hi)
          uint32_t b[2];
          ldsm_x2(b, xs + R::template at<TX>(nt * 8 + r8, ks * 2 + (q4 & 1)));
          mma_bf16(acc1[nt], a1, b[0], b[1]);
          if (kGated) mma_bf16(acc2[nt], a2, b[0], b[1]);
        }
      }
    } else {
      // thread (cg, kg): columns cg*4.. of the tile over k rows kg*8..+7,
      // in chunks of 16 bytes of x (8 bf16 or 4 fp32 values of k). Each
      // weight leaves the ring once, widened, and feeds every marked row.
      auto fma_tile = [&](auto rstep) {
        constexpr int kS = decltype(rstep)::value;
        constexpr int kC = 16 / (int)sizeof(TX);
#pragma unroll
        for (int q = 0; q < 8 / kC; ++q) {
          const int kb = kg * 8 + q * kC;
          uint4 xq[R::kRows];
#pragma unroll
          for (int r = 0; r < R::kRows; ++r) {
            if (r % kS == 0 && r >= nr) break;
            xq[r] = *reinterpret_cast<const uint4*>(xs + r * kTileK + kb);
          }
#pragma unroll
          for (int i = 0; i < kC; ++i) {
            const int wr = R::wat(kb + i, 0) + cg * 4;
            const float4 u = widen4(ws + wr);
            const float4 g = kGated ? widen4(ws2 + wr) : u;
#pragma unroll
            for (int r = 0; r < R::kRows; ++r) {
              if (r % kS == 0 && r >= nr) break;
              fma4x2<kGated>(acc1[r], acc2[r], xval<TX>(xq[r], i), u, g);
            }
          }
        }
      };
      if (R::kNarrow && step == 1) fma_tile(std::integral_constant<int, 1>{});
      else fma_tile(std::integral_constant<int, R::kStep>{});
    }
  }
  cp_async_wait<0>();

  // epilogue: act on the marked rows, +0.0 on the others, rounded once to TO
  if constexpr (R::kTensor) {
    const int nnt = (nx + 7) / 8;
#pragma unroll
    for (int nt = 0; nt < R::kTiles; ++nt) {
      if (nt >= nnt) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // d: (m g, n 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
        const int r = nt * 8 + 2 * (lane & 3) + (i & 1);
        const int n = n0 + warp * 16 + (lane >> 2) + (i >> 1) * 8;
        if (r < rows && n < N)
          oe[(size_t)r * N + n] =
              from_f32<TO>((mask >> r) & 1u ? act<ACT>(acc2[nt][i], acc1[nt][i]) : 0.f);
      }
    }
  } else {
    zero_unmarked();
    // the eight k-groups' partial sums meet in the (now idle) ring
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem_raw);     // [2][8][kRows][kTileN]
    constexpr int kPart = 8 * R::kRows * kTileN;
#pragma unroll
    for (int r = 0; r < R::kRows; ++r) {
      if (r >= nr) break;
      // a column's scale multiplies its partial sums: sum_k x q s = s sum_k x q
      const int at = (kg * R::kRows + r) * kTileN + cg * 4;
      *reinterpret_cast<float4*>(red + at) =
          make_float4(acc1[r][0] * sc1.x, acc1[r][1] * sc1.y, acc1[r][2] * sc1.z,
                      acc1[r][3] * sc1.w);
      if (kGated)
        *reinterpret_cast<float4*>(red + kPart + at) =
            make_float4(acc2[r][0] * sc2.x, acc2[r][1] * sc2.y, acc2[r][2] * sc2.z,
                        acc2[r][3] * sc2.w);
    }
    __syncthreads();
    for (int i = tid; i < nr * kTileN; i += kThreads) {
      const int r = i / kTileN, c = i - r * kTileN, n = n0 + c;
      if (n >= N) continue;
      float u = 0.f, g = 0.f;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        u += red[(p * R::kRows + r) * kTileN + c];
        if (kGated) g += red[kPart + (p * R::kRows + r) * kTileN + c];
      }
      oe[(size_t)rmap(r) * N + n] = from_f32<TO>(act<ACT>(g, u));
    }
  }
}

template <typename TX, typename TW, typename TO, int ACT, bool SCALED>
cudaError_t launch(const TX* x, const TW* w1, const TW* w2, const float* s1, const float* s2,
                   const int* slot_ids, const int* row_nz, TO* out, int E, int C, int K,
                   int N, cudaStream_t s) {
  using R = Ring<TX, TW>;
  constexpr bool kGated = (ACT == kSwiglu || ACT == kGeglu);
  constexpr size_t smem = R::bytes(kGated);
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_act<TX, TW, TO, ACT, SCALED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  auto a16 = [](const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int aligned = K % (16 / (int)sizeof(TX)) == 0 && N % (16 / (int)sizeof(TW)) == 0 &&
                      a16(x) && a16(w1) && a16(w2);
  const dim3 grid((N + kTileN - 1) / kTileN, (C + R::kRows - 1) / R::kRows, E);
  gemm_act<TX, TW, TO, ACT, SCALED><<<grid, kThreads, smem, s>>>(
      x, w1, w2, s1, s2, slot_ids, row_nz, out, C, K, N, aligned);
  return cudaGetLastError();
}

// The same with the activation chosen at run time (the up-projection;
// kNone, the down-projection's, is not taken).
template <typename TX, typename TW, typename TO, bool SCALED>
cudaError_t launch_act(int act, const TX* x, const TW* w1, const TW* w2, const float* s1,
                       const float* s2, const int* slot_ids, const int* row_nz, TO* out,
                       int E, int C, int K, int N, cudaStream_t s) {
#define MOE_TC_ACT(A) \
  launch<TX, TW, TO, A, SCALED>(x, w1, w2, s1, s2, slot_ids, row_nz, out, E, C, K, N, s)
  switch (act) {
    case kSwiglu: return MOE_TC_ACT(kSwiglu);
    case kGeglu: return MOE_TC_ACT(kGeglu);
    case kRelu2: return MOE_TC_ACT(kRelu2);
    case kGelu: return MOE_TC_ACT(kGelu);
    default: return cudaErrorInvalidValue;
  }
#undef MOE_TC_ACT
}

// Marks of x's non-zero rows: one scan_rows launch.
template <typename T>
cudaError_t scan(const T* x, int E, int C, int K, int* row_nz, cudaStream_t s) {
  const int aligned = K % (16 / (int)sizeof(T)) == 0 &&
                      (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  scan_rows<T><<<E, kScanThreads, 0, s>>>(x, C, K, aligned, row_nz);
  return cudaGetLastError();
}

}  // namespace moe_tc
