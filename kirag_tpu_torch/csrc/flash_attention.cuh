// What the flash attention kernels share (flash_attention.cu, the forward,
// and flash_attention_bwd.cu, the two backward kernels): tile sizes, element
// strides, and the mma.sync m16n8k16 bf16 fragment helpers (wgmma's
// accumulator and register operand use the same fragments, a warp's 16 rows
// at a time).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace kirag_flash {

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // queries per tile
constexpr int BK = 64;        // keys per tile
constexpr int SK = HD + 8;    // bf16 row stride of a staged tile (bank spread)
constexpr int BF16_THREADS = 128;

struct Strides {  // element strides of [B, H, T, 64] with d contiguous
  long long b, h, t;
};

template <typename T>  // two neighbouring bf16 values as one 32-bit word
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the lower 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   A 16x16: a0 = A[g][2c..2c+1], a1 = A[g+8][2c..], a2 = A[g][2c+8..], a3 = A[g+8][2c+8..]
//   B 16x8:  b0 = B[2c..2c+1][g], b1 = B[2c+8..2c+9][g]
//   C 16x8:  c0, c1 = C[g][2c..2c+1], c2, c3 = C[g+8][2c..2c+1]
// So the C tiles 2j and 2j + 1 of a [16 x 64] product, rounded to bf16, are
// the A fragment of its columns 16j..16j+15.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c_even, const float* c_odd) {
  a[0] = pack_bf16(c_even[0], c_even[1]);
  a[1] = pack_bf16(c_even[2], c_even[3]);
  a[2] = pack_bf16(c_odd[0], c_odd[1]);
  a[3] = pack_bf16(c_odd[2], c_odd[3]);
}

__device__ __forceinline__ float row_max4(float x) {  // over the 4 lanes of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

inline Strides strides_at(const long long* s, int which) {
  return Strides{s[3 * which], s[3 * which + 1], s[3 * which + 2]};
}

}  // namespace kirag_flash
