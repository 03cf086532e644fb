// Shared corpus scoring for the search kernels (stream_capture.cu,
// gather_groups.cu and group_max.cu).
//
// The kernels score (query, corpus row) pairs, and the exactness check of the
// capture-domain selection compares values that come from different kernels:
// the capture's group maxima and raw scores (stream_capture) and the fallback
// gather's re-scored groups (gather_groups); the approximate search
// (group_max) promises the exact search's scores. So every score of every
// kernel is computed by score_group() below, in ONE fixed order:
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
//
// Float32 and bfloat16 corpora have a second form of the same loop for the
// scoring sweeps of K1, K5 and K7a, score_passes() below: a thread holds a
// register tile of PASS_R rows x J queries and the block stages queries and
// rows together, 128 bytes of each row at a time. Only which thread computes
// which pairs changes: every pair still runs the chain above over the same
// padded_depth(d) columns, so score_passes and score_group give the same bits for the same
// (query, row), and K2 (score_group) stays bitwise equal to K1, K5 and K7a.
//
// Quantized corpora (K4: the in-kernel dequant of the TPU kernels,
// kirag_tpu/ops/pallas_exact.py::_chunk_scores) take queries that the wrapper
// rounded to bf16 once, so every product of a query value and an int8 code or
// an int4 level n - 7.5 is exact in f32 and only the sums round:
//
//   int8: the fma chain above over the codes, then s = s * row_scale;
//   int4: one fma chain per 128-dim block b giving p_b, then in block order
//         s = p_0 * scale_0;  s = s + p_b * scale_b  for b = 1 .. NB-1, each
//         product and sum rounded on its own (the reference's
//         `p = p * s; out = out + p`). Byte t of a packed row holds dim t
//         (low nibble, block t / 128) and dim t + D/2 (high nibble, block
//         t / 128 + NB/2): the low-plane partials fold as their block ends,
//         the high-plane ones wait in NB/2 registers a query;
//   pq4:  4-bit product-quantization codes, m / 2 bytes a row (byte t:
//         subspace t in the low nibble, t + m / 2 in the high one; subspace
//         s owns dims j * m + s, j < DS = D / m), decoded through the level
//         table rounded to bf16 once. One fma chain per (component j,
//         plane p) over the m / 2 dims [j * m + p * m / 2, +m / 2) in
//         ascending order, then s = p_(0,lo);  s = s + p_(0,hi);
//         s = s + p_(1,lo); ... (the reference's `out = out + p`). Walking a
//         row's bytes in order advances all 2 * DS chains at once, so they
//         stay in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace kirag {

constexpr int LANES = 128;          // rows per group (the TPU kernels' lane width)
constexpr int KD = 32;              // stored columns of one staged corpus tile
constexpr int THREADS = 256;        // two halves of 128 threads, one row per thread
constexpr int STAGES = 4;           // corpus tiles a block keeps in flight
constexpr int INT4_BLOCK = 128;     // dims per int4 scale
constexpr float FIN_MIN = -1e30f;   // finite mask value of the reference kernels

__host__ __device__ constexpr int padded_depth(int d) { return (d + KD - 1) / KD * KD; }

// Corpus formats: the stored element T; for packed int4, NBH = D / 256, the
// 128-byte blocks of a row; for pq4, DS = D / m, the components of a
// subspace. Both are fixed at compile time so that the partials stay in
// registers.
template <typename T_, int NBH_ = 0, int DS_ = 0>
struct Fmt {
  using T = T_;
  static constexpr int NBH = NBH_;
  static constexpr int DS = DS_;
};
using F32 = Fmt<float>;
using BF16 = Fmt<__nv_bfloat16>;
using I8 = Fmt<int8_t>;
template <int NBH>
using I4 = Fmt<uint8_t, NBH>;
template <int DS>
using PQ4 = Fmt<uint8_t, 0, DS>;

// pq4's level table lives in shared memory as bf16 [m][16][DS]: entry
// (s, code, j) = L[code, j * m + s], so one vector read gives a code's DS
// component values, and the 32 rows of a warp reading subspace s hit one
// 32 * DS-byte span. Other formats stage no table.
template <typename F>
__host__ __device__ constexpr int table_bytes(int d) {
  return F::DS > 0 ? d * 16 * static_cast<int>(sizeof(__nv_bfloat16)) : 0;
}

// Copy the wrapper's bf16 [m][16][DS] table (`scales`, global memory) into
// `table_s` (16-byte aligned shared memory) and return it, for pq4; return
// `scales` unchanged for the other formats. The caller synchronises the
// block before the first score_group.
template <typename F>
__device__ __forceinline__ const float* stage_table(void* table_s, const float* __restrict__ scales,
                                                    int d) {
  if constexpr (F::DS > 0) {
    const uint4* src = reinterpret_cast<const uint4*>(scales);
    uint4* dst = static_cast<uint4*>(table_s);
    for (int i = threadIdx.x; i < table_bytes<F>(d) / 16; i += blockDim.x) dst[i] = src[i];
    return static_cast<const float*>(table_s);
  } else {
    return scales;
  }
}

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
// Codes become f32 exactly by building a float in the mantissa and taking
// its offset off: two full-rate integer and float operations, where a
// conversion instruction runs at a quarter of the fma rate.
//   int8 code c (its 8 bits in `byte`): 2^23 + (c + 128), minus 2^23 + 128;
//   int4 code n: 2^22 + n (the mantissa's last bit is worth 0.5 at 2^22),
//   minus 2^22 + 7.5, which is the level n - 7.5.
__device__ __forceinline__ float int8_value(unsigned byte) {
  return __uint_as_float(0x4B000000u | ((byte & 0xFFu) ^ 0x80u)) - 8388736.0f;
}
__device__ __forceinline__ float int4_level(unsigned n) {
  return __uint_as_float(0x4A800000u | (n << 1)) - 4194311.5f;
}

__device__ __forceinline__ void unpack(const uint4& raw, const int8_t*, float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) out[4 * i + b] = int8_value(w[i] >> (8 * b));
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

// Start copying corpus rows [row0, row0 + LANES) x stored columns [c0, c0 + KD)
// into `tile`; w is the stored width of a row. The NT threads of the caller's
// group (index t) issue 16-byte copies, neighbouring threads on neighbouring
// vectors of a row (coalesced). Needs w a multiple of one vector and a
// 16-byte aligned corpus, so that a vector never straddles the end of a row
// (the wrappers check both); vectors past w are zeros.
template <typename T, int NT>
__device__ __forceinline__ void issue_tile(T* tile, const T* __restrict__ corpus, int64_t row0,
                                           int w, int c0, int t) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = KD / VEC;
  constexpr int PER = LANES * VPR / NT;
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int i = t + m * NT;
    const int r = i / VPR;
    const int v = (i % VPR) * VEC;
    const bool valid = c0 + v < w;
    const T* src = valid ? corpus + (row0 + r) * static_cast<int64_t>(w) + c0 + v : corpus;
    cp_async16(tile + r * tile_stride<T>() + v, src, valid);
  }
}

// The tile pipeline of score_group: tiles_begin starts the first NS - 1
// copies; tiles_next(it) waits for tile `it`, starts the copy of tile
// it + NS - 1 into the slot that tile it - 1 left, and returns this thread's
// row of tile it. Both synchronise the block.
template <typename T, int NT, int NS>
__device__ __forceinline__ void tiles_begin(T* tiles, const T* __restrict__ corpus, int64_t row0,
                                            int w, int n_tiles, int t, bool active) {
  __syncthreads();  // the previous call may still be reading these tiles
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (active && s < n_tiles) {
      issue_tile<T, NT>(tiles + s * tile_elems<T>(), corpus, row0, w, s * KD, t);
    }
    cp_async_commit();  // one group per tile slot, empty or not: the waits count them
  }
}
template <typename T, int NT, int NS>
__device__ __forceinline__ const T* tiles_next(T* tiles, const T* __restrict__ corpus,
                                               int64_t row0, int w, int n_tiles, int it, int t,
                                               int lane, bool active) {
  cp_async_wait<NS - 2>();  // this thread's copies of tile `it` have landed
  __syncthreads();          // everyone's have; tile it - 1 is no longer read
  const int next = it + NS - 1;
  if (active && next < n_tiles) {
    issue_tile<T, NT>(tiles + (next % NS) * tile_elems<T>(), corpus, row0, w, next * KD, t);
  }
  cp_async_commit();
  return tiles + (it % NS) * tile_elems<T>() + lane * tile_stride<T>();
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

// The packed-int4 form of fma_tile: byte c of the tile row holds the codes of
// dim c0 + c (low nibble, into lo) and dim half + c0 + c (high nibble, into
// hi), half = D / 2.
template <int NQ>
__device__ __forceinline__ void fma_tile_int4(float (&lo)[NQ], float (&hi)[NQ], const float* q,
                                              int q_stride, int c0, int half,
                                              const uint8_t* trow) {
#pragma unroll
  for (int c = 0; c < KD; c += 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(trow + c);
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
    float cl[16], ch[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        cl[4 * i + b] = int4_level((w[i] >> (8 * b)) & 15u);
        ch[4 * i + b] = int4_level((w[i] >> (8 * b + 4)) & 15u);
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 16; e += 4) {
        const float4 ql = *reinterpret_cast<const float4*>(q + j * q_stride + c0 + c + e);
        lo[j] = __fmaf_rn(ql.x, cl[e], lo[j]);
        lo[j] = __fmaf_rn(ql.y, cl[e + 1], lo[j]);
        lo[j] = __fmaf_rn(ql.z, cl[e + 2], lo[j]);
        lo[j] = __fmaf_rn(ql.w, cl[e + 3], lo[j]);
        const float4 qh = *reinterpret_cast<const float4*>(q + j * q_stride + half + c0 + c + e);
        hi[j] = __fmaf_rn(qh.x, ch[e], hi[j]);
        hi[j] = __fmaf_rn(qh.y, ch[e + 1], hi[j]);
        hi[j] = __fmaf_rn(qh.z, ch[e + 2], hi[j]);
        hi[j] = __fmaf_rn(qh.w, ch[e + 3], hi[j]);
      }
    }
  }
}

// score_group for packed int4 with NBH = D / 256 (see the header note).
template <int NBH, int NT, int NQ, int NS>
__device__ __forceinline__ void score_group_int4(float (&acc)[NQ],
                                                 const uint8_t* __restrict__ corpus,
                                                 const float* __restrict__ scales, int64_t row0,
                                                 const float* q, int q_stride, uint8_t* tiles,
                                                 int t, int lane, bool active) {
  constexpr int NB = 2 * NBH;             // scales (128-dim blocks) of a row
  constexpr int W = NBH * INT4_BLOCK;     // bytes of a row, D / 2
  constexpr int TPB = INT4_BLOCK / KD;    // tiles of one block's bytes
  float s[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) s[b] = active ? scales[(row0 + lane) * NB + b] : 0.f;
  float lo[NQ], hi[NBH][NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    acc[j] = 0.f;
    lo[j] = 0.f;
#pragma unroll
    for (int h = 0; h < NBH; ++h) hi[h][j] = 0.f;
  }
  tiles_begin<uint8_t, NT, NS>(tiles, corpus, row0, W, NBH * TPB, t, active);
#pragma unroll
  for (int h = 0; h < NBH; ++h) {  // unrolled: hi[h] and s[h] stay in registers
#pragma unroll 1
    for (int i = 0; i < TPB; ++i) {
      const int it = h * TPB + i;
      const uint8_t* trow =
          tiles_next<uint8_t, NT, NS>(tiles, corpus, row0, W, NBH * TPB, it, t, lane, active);
      if (active) fma_tile_int4<NQ>(lo, hi[h], q, q_stride, it * KD, W, trow);
    }
    if (active) {  // low block h is complete: fold it
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float p = __fmul_rn(lo[j], s[h]);
        acc[j] = h == 0 ? p : __fadd_rn(acc[j], p);
        lo[j] = 0.f;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int h = 0; h < NBH; ++h) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(hi[h][j], s[NBH + h]));
    }
  }
}

// DS bf16 levels at `p` (aligned to their size) as f32.
template <int DS>
__device__ __forceinline__ void load_levels(const __nv_bfloat16* p, float (&out)[DS]) {
  if constexpr (DS == 1) {
    out[0] = __uint_as_float(static_cast<unsigned>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  } else {
    constexpr int WORDS = DS / 2;
    unsigned w[WORDS];
    if constexpr (DS == 2) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else if constexpr (DS == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// The pq4 form of fma_tile: bytes c0 .. c0 + KD - 1 of this thread's row
// (subspaces c0 + c and m2 + c0 + c, m2 = m / 2) advance part[j][p][.], the
// chain of component j and plane p, by the dims j * m + p * m2 + c0 + c in
// ascending order. Bytes at or past m2 (the zeros of a tile's tail) are not
// codes and are skipped (m2 % 16 == 0).
template <int DS, int NQ>
__device__ __forceinline__ void fma_tile_pq4(float (&part)[DS][2][NQ], const float* q,
                                             int q_stride, int c0, int m, int m2,
                                             const __nv_bfloat16* table, const uint8_t* trow) {
#pragma unroll
  for (int c = 0; c < KD; c += 16) {
    if (c0 + c >= m2) break;
    const uint4 raw = *reinterpret_cast<const uint4*>(trow + c);
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bytes c0 + c + 4i .. +3
      const int s0 = c0 + c + 4 * i;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float v[4][DS];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const unsigned code = (w[i] >> (8 * b + 4 * p)) & 15u;
          load_levels<DS>(table + ((p * m2 + s0 + b) * 16 + code) * DS, v[b]);
        }
#pragma unroll
        for (int jq = 0; jq < NQ; ++jq) {
#pragma unroll
          for (int j = 0; j < DS; ++j) {
            const float4 qv =
                *reinterpret_cast<const float4*>(q + jq * q_stride + j * m + p * m2 + s0);
            float a = part[j][p][jq];
            a = __fmaf_rn(qv.x, v[0][j], a);
            a = __fmaf_rn(qv.y, v[1][j], a);
            a = __fmaf_rn(qv.z, v[2][j], a);
            a = __fmaf_rn(qv.w, v[3][j], a);
            part[j][p][jq] = a;
          }
        }
      }
    }
  }
}

// score_group for pq4 with DS = D / m (see the header note); `table` is the
// staged level table (stage_table).
template <int DS, int NT, int NQ, int NS>
__device__ __forceinline__ void score_group_pq4(float (&acc)[NQ],
                                                const uint8_t* __restrict__ corpus,
                                                const float* table, int64_t row0, int d,
                                                const float* q, int q_stride, uint8_t* tiles,
                                                int t, int lane, bool active) {
  const int m = d / DS;
  const int m2 = m / 2;  // bytes of a row
  const int n_tiles = (m2 + KD - 1) / KD;
  const __nv_bfloat16* lv = reinterpret_cast<const __nv_bfloat16*>(table);
  float part[DS][2][NQ];
#pragma unroll
  for (int j = 0; j < DS; ++j) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int jq = 0; jq < NQ; ++jq) part[j][p][jq] = 0.f;
    }
  }
  tiles_begin<uint8_t, NT, NS>(tiles, corpus, row0, m2, n_tiles, t, active);
  for (int it = 0; it < n_tiles; ++it) {
    const uint8_t* trow =
        tiles_next<uint8_t, NT, NS>(tiles, corpus, row0, m2, n_tiles, it, t, lane, active);
    if (active) fma_tile_pq4<DS, NQ>(part, q, q_stride, it * KD, m, m2, lv, trow);
  }
#pragma unroll
  for (int jq = 0; jq < NQ; ++jq) {
    float s = __fadd_rn(part[0][0][jq], part[0][1][jq]);
#pragma unroll
    for (int j = 1; j < DS; ++j) {
      s = __fadd_rn(s, part[j][0][jq]);
      s = __fadd_rn(s, part[j][1][jq]);
    }
    acc[jq] = s;
  }
}

// THE scoring routine of every kernel. Scores the 128 rows [row0, row0 + 128)
// against NQ query rows (q, q + q_stride, ...) of depth d: on return acc[j]
// holds the score of query j and row row0 + lane. `scales` is read for
// quantized formats only (int8: [rows], int4: [rows][D / 128], pq4: the
// level table that stage_table put in shared memory). The NT
// threads of the calling group (index t within it) stream the rows through NS
// tiles at `tiles`, so that NS - 1 tiles are being copied while one is
// multiplied. Every thread of the block must call it the same number of times
// (it synchronises the block); groups that have nothing to score pass
// active = false.
template <typename F, int NT, int NQ, int NS>
__device__ __forceinline__ void score_group(float (&acc)[NQ],
                                            const typename F::T* __restrict__ corpus,
                                            const float* __restrict__ scales, int64_t row0, int d,
                                            const float* q, int q_stride, typename F::T* tiles,
                                            int t, int lane, bool active) {
  using T = typename F::T;
  if constexpr (F::NBH > 0) {
    score_group_int4<F::NBH, NT, NQ, NS>(acc, corpus, scales, row0, q, q_stride, tiles, t, lane,
                                         active);
  } else if constexpr (F::DS > 0) {
    score_group_pq4<F::DS, NT, NQ, NS>(acc, corpus, scales, row0, d, q, q_stride, tiles, t,
                                       lane, active);
  } else {
    constexpr bool kInt8 = std::is_same<T, int8_t>::value;
    const float row_scale = kInt8 && active ? scales[row0 + lane] : 0.f;
    const int n_tiles = padded_depth(d) / KD;
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc[j] = 0.f;
    tiles_begin<T, NT, NS>(tiles, corpus, row0, d, n_tiles, t, active);
    for (int it = 0; it < n_tiles; ++it) {
      const T* trow = tiles_next<T, NT, NS>(tiles, corpus, row0, d, n_tiles, it, t, lane, active);
      if (active) fma_tile<NQ>(acc, q, q_stride, it * KD, trow);
    }
    if (kInt8 && active) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) acc[j] = __fmul_rn(acc[j], row_scale);
    }
  }
}

// ------------------------------------------------ float corpora: score_passes
//
// A block of THREADS threads scores PASS_ROWS = 256 corpus rows (two groups)
// against QT = 4 * J queries per pass. Warp w owns group w / 4 of the pass
// and the J queries [(w % 4) J, (w % 4 + 1) J) of the tile: lane l holds the
// pairs (row 32 i + l of the group, query (w % 4) J + j), i < PASS_R, j < J.
// Per four columns a thread reads PASS_R corpus vectors (one 16-byte read per
// row for f32's four columns or bf16's eight; the 32 lanes read 32
// consecutive padded rows, four banks apart) and J query vectors, the same
// address in every lane (one broadcast), for 4 * PASS_R * J fmas: 128 fmas
// for 12 loads at J = 8. A warp holds all 128 rows of its group, so a
// group's maximum is one warp reduction, and 32 lanes store 128 consecutive
// bytes of scores. One ring slot holds the pass's rows and queries for SC =
// 128 bytes of each row (32 f32 or 64 bf16 columns, a whole 128-byte line),
// so a 32-query tile needs no room for whole query rows, and NS slots are in
// flight.
constexpr int PASS_ROWS = 256;        // corpus rows a pass: two groups
constexpr int PASS_R = 4;             // rows a thread holds

// Columns of a ring slot (SC), its padded corpus row (elements) and padded
// query row (floats); ring slots of the float sweeps. At 32 queries a slot
// takes 41 KB (f32) or 45 KB (bf16), so two blocks share an SM either way.
// On an H100 at 1M x 1024, 128-byte rows, two slots and two blocks an SM
// beat 64- and 256-byte rows, three slots, and one block an SM (PERF.md §6).
constexpr int SWEEP_ROW_BYTES = 128;
constexpr int SWEEP_STAGES = 2;
constexpr int SWEEP_BLOCKS_PER_SM = 2;  // launch bounds' minimum: 128 registers a thread
template <typename T>
__host__ __device__ constexpr int sweep_cols() {
  return SWEEP_ROW_BYTES / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int sweep_row_stride() {
  return sweep_cols<T>() + 16 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int sweep_q_stride() { return sweep_cols<T>() + 4; }

template <typename T>
__host__ __device__ constexpr int pass_corpus_bytes() {
  return PASS_ROWS * sweep_row_stride<T>() * static_cast<int>(sizeof(T));
}
template <typename T, int QT>
__host__ __device__ constexpr int pass_stage_bytes() {
  return pass_corpus_bytes<T>() + QT * sweep_q_stride<T>() * static_cast<int>(sizeof(float));
}

// Start copying rows [row0, row0 + live_rows) x stored columns [c0, c0 + SC)
// of the corpus (row stride d) and query rows [q0, min(q0 + QT, n_q)) of the
// same columns into one ring slot; rows past live_rows, queries past n_q and
// columns past d are zeros. All THREADS threads issue (index t), eight
// neighbours on one row's 128 bytes.
template <typename T, int QT>
__device__ __forceinline__ void issue_pass_stage(char* slot, const T* __restrict__ corpus,
                                                 int64_t row0, int live_rows, const float* q,
                                                 int q0, int n_q, int d, int c0, int t) {
  constexpr int SC = sweep_cols<T>();
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = SC / VEC;                      // vectors a row: 8
  constexpr int RPI = THREADS / VPR;                 // rows an issue round: 32
  T* ctile = reinterpret_cast<T*>(slot);
  float* qtile = reinterpret_cast<float*>(slot + pass_corpus_bytes<T>());
  const int r0 = t / VPR;
  const int v = (t % VPR) * VEC;
  const bool col_ok = c0 + v < d;
  const T* src = corpus + (row0 + r0) * static_cast<int64_t>(d) + c0 + v;
  T* dst = ctile + r0 * sweep_row_stride<T>() + v;
#pragma unroll
  for (int m = 0; m < PASS_ROWS / RPI; ++m) {
    const bool valid = col_ok && r0 + m * RPI < live_rows;
    cp_async16(dst + m * RPI * sweep_row_stride<T>(),
               valid ? src + static_cast<int64_t>(m) * RPI * d : corpus, valid);
  }
  constexpr int QV = SC / 4;                         // query vectors a row
  for (int i = t; i < QT * QV; i += THREADS) {
    const int r = i / QV;
    const int qv = (i % QV) * 4;
    const bool valid = q0 + r < n_q && c0 + qv < d;
    const float* qsrc = valid ? q + static_cast<int64_t>(q0 + r) * d + c0 + qv : q;
    cp_async16(qtile + r * sweep_q_stride<T>() + qv, qsrc, valid);
  }
}

// Four columns [e, e + 4) of a 16-byte vector of corpus values as f32.
__device__ __forceinline__ void unpack4(const uint4& raw, int, const float*, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack4(const uint4& raw, int e, const __nv_bfloat16*,
                                        float (&out)[4]) {
  const unsigned lo = e == 0 ? raw.x : raw.z;  // e is 0 or 4, known at compile time
  const unsigned hi = e == 0 ? raw.y : raw.w;
  out[0] = __uint_as_float(lo << 16);
  out[1] = __uint_as_float(lo & 0xffff0000u);
  out[2] = __uint_as_float(hi << 16);
  out[3] = __uint_as_float(hi & 0xffff0000u);
}

// Advance the thread's PASS_R x J running scores by the first `cols` (KD or
// SC) columns of one ring slot, in column order.
template <typename T, int J, int QT>
__device__ __forceinline__ void fma_pass_tile(float (&acc)[PASS_R][J], const char* slot,
                                              int cols, int row, int q) {
  constexpr int SC = sweep_cols<T>();
  constexpr int VEC = 16 / sizeof(T);
  const T* crow = reinterpret_cast<const T*>(slot) + row * sweep_row_stride<T>();
  const float* qrow = reinterpret_cast<const float*>(slot + pass_corpus_bytes<T>()) +
                      q * sweep_q_stride<T>();
#pragma unroll
  for (int c = 0; c < SC; c += VEC) {
    if (c >= cols) break;
    uint4 raw[PASS_R];
#pragma unroll
    for (int i = 0; i < PASS_R; ++i) {
      raw[i] = *reinterpret_cast<const uint4*>(crow + 32 * i * sweep_row_stride<T>() + c);
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      float cv[PASS_R][4];
#pragma unroll
      for (int i = 0; i < PASS_R; ++i) unpack4(raw[i], e, crow, cv[i]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qrow + j * sweep_q_stride<T>() + c + e);
#pragma unroll
        for (int i = 0; i < PASS_R; ++i) {
          float a = acc[i][j];
          a = __fmaf_rn(qv.x, cv[i][0], a);
          a = __fmaf_rn(qv.y, cv[i][1], a);
          a = __fmaf_rn(qv.z, cv[i][2], a);
          a = __fmaf_rn(qv.w, cv[i][3], a);
          acc[i][j] = a;
        }
      }
    }
  }
}

// Score n_groups groups of a float32 or bfloat16 corpus, the rows from
// row_base on (row stride d), against queries [q0, q0 + 4 J) (f32, row
// stride d; rows past n_q score as zero queries), two groups a pass, through
// an NS-slot cp.async ring at `ring` that runs on across passes. Each pair
// takes the padded_depth(d) columns of score_group, no more: a slot's second
// half of 32 columns is skipped where it lies past them. After each pass,
// epi(p, live, acc) gets the pass index, its live groups (1 or 2) and the
// thread's scores, acc[i][j] for row 32 i + lane of the pass's group w / 4 and
// tile query (w % 4) J + j (lane layout above); every thread of the block
// calls it, so it may synchronise the block. Warps of a dead group (live ==
// 1) skip the fmas.
template <typename T, int J, int NS, typename Epi>
__device__ __forceinline__ void score_passes(const T* __restrict__ corpus, int64_t row_base,
                                             int n_groups, const float* q, int q0, int n_q,
                                             int d, char* ring, Epi&& epi) {
  constexpr int QT = 4 * J;
  constexpr int SC = sweep_cols<T>();
  constexpr int STAGE = pass_stage_bytes<T, QT>();
  const int t = threadIdx.x;
  const int w = t / 32;
  const int my_row = (w / 4) * LANES + t % 32;  // row 0 of the thread's, in the pass
  const int my_q = (w % 4) * J;                 // query 0 of the thread's, in the tile
  const int d_pad = padded_depth(d);
  const int n_tiles = (d_pad + SC - 1) / SC;
  const int last_cols = d_pad - (n_tiles - 1) * SC;  // KD or SC
  const int passes = (n_groups + 1) / 2;
  const int total = passes * n_tiles;
  auto issue = [&](int k) {  // flat tile k = pass * n_tiles + column tile
    if (k < total) {
      const int p = k / n_tiles;
      const int live_rows = min(2, n_groups - 2 * p) * LANES;
      issue_pass_stage<T, QT>(ring + (k % NS) * STAGE, corpus,
                              row_base + static_cast<int64_t>(p) * PASS_ROWS, live_rows, q, q0,
                              n_q, d, (k - p * n_tiles) * SC, t);
    }
    cp_async_commit();  // one group per tile, empty or not: the waits count them
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);
  int k = 0;
  for (int p = 0; p < passes; ++p) {
    const bool mine = w / 4 < min(2, n_groups - 2 * p);
    float acc[PASS_R][J];
#pragma unroll
    for (int i = 0; i < PASS_R; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
    }
    for (int it = 0; it < n_tiles; ++it, ++k) {
      cp_async_wait<NS - 2>();  // this thread's copies of tile k have landed
      __syncthreads();          // everyone's have; tile k - 1 is no longer read
      issue(k + NS - 1);
      if (mine) {
        fma_pass_tile<T, J, QT>(acc, ring + (k % NS) * STAGE, it + 1 < n_tiles ? SC : last_cols,
                                my_row, my_q);
      }
    }
    epi(p, min(2, n_groups - 2 * p), acc);
  }
}

// An epilogue's first step: each warp's maximum of its group for each of its
// J queries, handed to out(j, m) in lane 0; the thread's rows are row0 + lane
// + 32 i (global ids, row0 the group's first), and rows at or past
// valid_rows count as FIN_MIN.
template <int J, typename Out>
__device__ __forceinline__ void pass_warp_maxima(float (&acc)[PASS_R][J], int64_t row0,
                                                 int64_t valid_rows, Out&& out) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float m = row0 + lane < valid_rows ? acc[0][j] : FIN_MIN;
#pragma unroll
    for (int i = 1; i < PASS_R; ++i) {
      m = fmaxf(m, row0 + lane + 32 * i < valid_rows ? acc[i][j] : FIN_MIN);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0) out(j, m);
  }
}

// True when `splits` ranges of `gpb` groups cover a chunk of g_count groups,
// the last range holding 1 .. gpb of them (kernels/exact.py's search_plan).
inline bool sweep_cut_fits(int g_count, int splits, int gpb) {
  return splits >= 1 && gpb >= 1 && static_cast<int64_t>(splits - 1) * gpb < g_count &&
         static_cast<int64_t>(splits) * gpb >= g_count;
}

// Call fn(std::integral_constant<int, J>{}) for a query tile of 4 J = 4, 8,
// 16 or 32 queries; cudaErrorInvalidValue for any other tile.
template <typename Fn>
cudaError_t with_query_tile(int q_tile, Fn&& fn) {
  switch (q_tile) {
    case 4:
      return fn(std::integral_constant<int, 1>{});
    case 8:
      return fn(std::integral_constant<int, 2>{});
    case 16:
      return fn(std::integral_constant<int, 4>{});
    case 32:
      return fn(std::integral_constant<int, 8>{});
    default:
      return cudaErrorInvalidValue;
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

// Call fn(Fmt{}) with the format of `kind` (0 float32, 1 bfloat16, 2 int8,
// 3 packed int4 of depth d = 256 * NBH, NBH = 1 .. 8, so D = 256 .. 2048;
// 4 + log2(DS) pq4 with DS = D / m in {1, 2, 4, 8}, when kPQ);
// cudaErrorInvalidValue for anything else. At NBH = 8 a thread keeps 8 x NQ
// high-plane partials and 16 scales in registers, at DS = 8 pq4 keeps
// 16 x NQ partials (ptxas -v reports any spill).
template <bool kPQ = true, typename Fn>
cudaError_t with_format(int kind, int d, Fn&& fn) {
  if (kind >= 4 && kind <= 7) {
    if constexpr (kPQ) {
      switch (kind) {
        case 4:
          return fn(PQ4<1>{});
        case 5:
          return fn(PQ4<2>{});
        case 6:
          return fn(PQ4<4>{});
        default:
          return fn(PQ4<8>{});
      }
    }
    return cudaErrorInvalidValue;
  }
  switch (kind) {
    case 0:
      return fn(F32{});
    case 1:
      return fn(BF16{});
    case 2:
      return fn(I8{});
    case 3:
      if (d % 256 != 0) return cudaErrorInvalidValue;
      switch (d / 256) {
        case 1:
          return fn(I4<1>{});
        case 2:
          return fn(I4<2>{});
        case 3:
          return fn(I4<3>{});
        case 4:
          return fn(I4<4>{});
        case 5:
          return fn(I4<5>{});
        case 6:
          return fn(I4<6>{});
        case 7:
          return fn(I4<7>{});
        case 8:
          return fn(I4<8>{});
        default:
          return cudaErrorInvalidValue;
      }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace kirag
