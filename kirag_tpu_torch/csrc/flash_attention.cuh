// What the flash attention kernels share (flash_attention.cu, the forward,
// and flash_attention_bwd.cu, the two backward kernels): tile sizes, element
// strides, the mma.sync m16n8k16 bf16 fragment layout (wgmma's accumulator
// and register operand use the same fragments, a warp's 16 rows at a time)
// and the segment ranges of 64-row tiles that the exact tile skip tests.
// hopper.cuh holds the bf16 kernels' TMA, mbarrier and wgmma pieces.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace kirag_flash {

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // queries per tile
constexpr int BK = 64;        // keys per tile
constexpr int BF16_THREADS = 128;

struct Strides {  // element strides of [B, H, T, 64] with d contiguous
  long long b, h, t;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the lower 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
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

// Each 64-row tile's smallest and largest segment id, r[i] = (lo, hi); all
// threads of the block take part.
__device__ __forceinline__ void tile_ranges(int2* r, const int* segb, int n_tiles) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n_tiles; i += blockDim.x / 32) {
    const int x = segb[64 * i + lane], y = segb[64 * i + 32 + lane];
    const int lo = __reduce_min_sync(0xffffffffu, min(x, y));
    const int hi = __reduce_max_sync(0xffffffffu, max(x, y));
    if (lane == 0) r[i] = make_int2(lo, hi);
  }
}

// Whether two segment ranges meet. A pair of tiles whose ranges do not holds
// no same-segment pair: every logit between them is -inf (the exact skip).
__device__ __forceinline__ bool overlap(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }

// The first tile from j on (of n_tiles, ranges r) whose range meets own.
__device__ __forceinline__ int next_kept(const int2* r, int2 own, int j, int n_tiles) {
  while (j < n_tiles && !overlap(r[j], own)) ++j;
  return j;
}

inline Strides strides_at(const long long* s, int which) {
  return Strides{s[3 * which], s[3 * which + 1], s[3 * which + 2]};
}

}  // namespace kirag_flash
