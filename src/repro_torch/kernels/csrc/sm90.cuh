// PTX building blocks shared by the tensor-core kernels (flash_decode.cu,
// moe_ffn_tc.cuh, decode_scores.cu, decode_values.cu): 16-byte asynchronous
// global -> shared copies, ldmatrix fragment loads and the bf16 m16n8k16
// tensor-core product with fp32 accumulation. All need sm_80 or later; the
// port builds for sm_90a.
#pragma once

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1. With valid false
// nothing is read and the 16 bytes are zero-filled (src must still be a
// mapped address; callers pass the tensor's base).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j,
// register j receives it. Without .trans lane i holds row i/4, columns
// 2(i%4) and 2(i%4)+1; with .trans it holds rows 2(i%4), 2(i%4)+1 of
// column i/4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// two matrices, addressed by lanes 0..15
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate. With
// g = lane/4, t = lane%4: a = {(g, 2t..), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)} as (row, k) pairs; b = {(k 2t.., n g), (k 2t+8.., n g)};
// d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Element offset of 16-byte chunk ch of row r in a tile whose rows hold
// `chunks` such chunks: the chunk index is XORed with r % 8, so the eight
// rows an ldmatrix reads at one logical chunk land in eight different bank
// groups (rows of 64 or 128 bf16 would otherwise all hit one).
template <typename T>
__device__ __forceinline__ int swizzle(int r, int ch, int chunks) {
  constexpr int kVec = 16 / sizeof(T);
  return (r * chunks + (ch ^ (r & 7))) * kVec;
}

// Index, in 16-byte chunks, of chunk ch of row r in a tile whose rows hold
// kChunks (a power of two) such chunks, XOR-swizzled so that the eight rows
// an ldmatrix reads at one logical chunk land in eight different bank
// groups. Rows of 128 bytes or more XOR with r % 8, as swizzle() does; rows
// narrower than that share a 128-byte line (8 / kChunks rows each), so they
// XOR with the line's index instead. Rows of one chunk need no swizzle.
template <int kChunks>
__device__ __forceinline__ int swizzle_chunk(int r, int ch) {
  static_assert(kChunks > 0 && (kChunks & (kChunks - 1)) == 0, "a power of two");
  if constexpr (kChunks >= 8) return r * kChunks + (ch ^ (r & 7));
  else return r * kChunks + (ch ^ ((r / (8 / kChunks)) & (kChunks - 1)));
}
