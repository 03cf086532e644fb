// Shared corpus scoring for the exact-search kernels (stream_capture.cu and
// gather_groups.cu).
//
// Both kernels score (query, corpus row) pairs, and the exactness check of the
// capture-domain selection compares values that come from different kernels:
// the capture's group maxima and raw scores (stream_capture) and the fallback
// gather's re-scored groups (gather_groups). So every score of every kernel is
// computed by score_group() below, in ONE fixed order:
//
//     s = +0.0f;  for d = 0 .. D-1 ascending:  s = fma(q[d], c[d], s)
//
// with q and c converted to f32 first (bf16 -> f32 is exact, so every product
// is the exact product of the stored values). Rows are staged through shared
// memory one [128 rows x KD columns] tile at a time (cp.async, several tiles
// in flight), columns past D are staged as zeros (fma(0, 0, s) == s), and
// each thread walks its tile row in column order, so the sequence of fma
// operations for a (query, row) pair never depends on which kernel, block or
// thread computes it. Equal inputs give bitwise-equal f32 scores everywhere.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace kirag {

constexpr int LANES = 128;          // rows per group (the TPU kernels' lane width)
constexpr int KD = 32;              // columns of one staged corpus tile
constexpr int THREADS = 256;        // two halves of 128 threads, one row per thread
constexpr int STAGES = 4;           // corpus tiles a block keeps in flight
constexpr float FIN_MIN = -1e30f;   // finite mask value of the reference kernels

__host__ __device__ constexpr int padded_depth(int d) { return (d + KD - 1) / KD * KD; }

// Unpack one 16-byte vector of corpus values into f32.
__device__ __forceinline__ void unpack(const uint4& raw, const float*, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, const __nv_bfloat16*, float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: the lower half is the earlier value
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Corpus tiles live in shared memory as raw values, [LANES rows][KD + one
// 16-byte vector of padding] so that the per-row 16-byte reads of a warp hit
// distinct banks. A block keeps STAGES of them in flight.
template <typename T>
__host__ __device__ constexpr int tile_stride() { return KD + 16 / static_cast<int>(sizeof(T)); }
template <typename T>
__host__ __device__ constexpr int tile_elems() { return LANES * tile_stride<T>(); }

// One 16-byte asynchronous copy global -> shared; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Start copying corpus rows [row0, row0 + LANES) x columns [d0, d0 + KD) into
// `tile`; the NT threads of the caller's group (index t) issue 16-byte copies,
// neighbouring threads on neighbouring vectors of a row (coalesced). Needs
// d % 8 == 0 and a 16-byte aligned corpus, so that a vector never straddles
// the end of a row (the wrappers check both); vectors past d are zeros.
template <typename T, int NT>
__device__ __forceinline__ void issue_tile(T* tile, const T* __restrict__ corpus, int64_t row0,
                                           int d, int d0, int t) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = KD / VEC;
  constexpr int PER = LANES * VPR / NT;
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int i = t + m * NT;
    const int r = i / VPR;
    const int v = (i % VPR) * VEC;
    const bool valid = d0 + v < d;
    const T* src = valid ? corpus + (row0 + r) * static_cast<int64_t>(d) + d0 + v : corpus;
    cp_async16(tile + r * tile_stride<T>() + v, src, valid);
  }
}

// Advance NQ running scores by one staged tile: acc[j] takes the fma of
// q[j * q_stride + d0 + c] and trow[c] for c = 0 .. KD-1 in order. `q` points
// at f32 query rows in shared memory (16-byte aligned, zero-padded to a
// multiple of KD); `trow` at this thread's row of the staged tile.
template <int NQ, typename T>
__device__ __forceinline__ void fma_tile(float (&acc)[NQ], const float* q, int q_stride,
                                         int d0, const T* trow) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < KD; c += VEC) {
    float cv[VEC];
    unpack(*reinterpret_cast<const uint4*>(trow + c), trow, cv);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(q + j * q_stride + d0 + c + e);
        acc[j] = __fmaf_rn(qv.x, cv[e], acc[j]);
        acc[j] = __fmaf_rn(qv.y, cv[e + 1], acc[j]);
        acc[j] = __fmaf_rn(qv.z, cv[e + 2], acc[j]);
        acc[j] = __fmaf_rn(qv.w, cv[e + 3], acc[j]);
      }
    }
  }
}

// THE scoring routine of every kernel. Scores the 128 rows [row0, row0 + 128)
// against NQ query rows (q, q + q_stride, ...): on return acc[j] holds the
// score of query j and row row0 + lane. The NT threads of the calling group
// (index t within it) stream the rows through NS tiles at `tiles`, so that
// NS - 1 tiles are being copied while one is multiplied. Every
// thread of the block must call it the same number of times (it
// synchronises the block); groups that have nothing to score pass
// active = false.
template <typename T, int NT, int NQ, int NS>
__device__ __forceinline__ void score_group(float (&acc)[NQ], const T* __restrict__ corpus,
                                            int64_t row0, int d, const float* q,
                                            int q_stride, T* tiles, int t, int lane,
                                            bool active) {
  constexpr int TILE = tile_elems<T>();
  const int n_tiles = padded_depth(d) / KD;
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = 0.f;
  __syncthreads();  // the previous call may still be reading these tiles
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (active && s < n_tiles) issue_tile<T, NT>(tiles + s * TILE, corpus, row0, d, s * KD, t);
    cp_async_commit();  // one group per tile slot, empty or not: the waits count them
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile `it` have landed
    __syncthreads();              // everyone's have; tile it - 1 is no longer read
    const int next = it + NS - 1;
    if (active && next < n_tiles) {
      issue_tile<T, NT>(tiles + (next % NS) * TILE, corpus, row0, d, next * KD, t);
    }
    cp_async_commit();
    if (active) {
      fma_tile<NQ>(acc, q, q_stride, it * KD,
                   tiles + (it % NS) * TILE + lane * tile_stride<T>());
    }
  }
}

// Copy `nq` query rows (f32, row stride d) into shared memory as [nq][d_pad]
// with zero padding; rows at or past n_q (the ragged last tile) are zero.
__device__ __forceinline__ void stage_queries(float* q_s, const float* __restrict__ q,
                                              int q0, int nq, int n_q, int d, int d_pad) {
  for (int i = threadIdx.x; i < nq * d_pad; i += blockDim.x) {
    const int j = i / d_pad;
    const int c = i % d_pad;
    q_s[i] = (q0 + j < n_q && c < d) ? q[static_cast<int64_t>(q0 + j) * d + c] : 0.f;
  }
}

}  // namespace kirag
