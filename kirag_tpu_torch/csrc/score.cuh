// Shared corpus scoring for the search kernels (stream_capture.cu,
// gather_groups.cu, group_max.cu and score_gmax.cu).
//
// The kernels score (query, corpus row) pairs, and the exactness check of the
// capture-domain selection compares values that come from different kernels:
// the capture's group maxima and raw scores (stream_capture) and the fallback
// gather's re-scored groups (gather_groups); the approximate search
// (group_max) and the fused scoring pass (score_gmax) promise the exact
// search's scores. So every score of a corpus format is computed in ONE fixed
// order, whichever kernel, block, warp or thread computes it. There are two
// orders, one for float corpora, one for int8, packed-int4 and pq4 ones.
//
// The fma order (float32, bfloat16), score_passes():
//
//     s = +0.0f;  for d = 0 .. D-1 ascending:  s = fma(q[d], c[d], s)
//
// with q and c converted to f32 first (bf16 -> f32 is exact, so every product
// is the exact product of the stored values), over the padded_depth(d)
// columns: columns past D are staged as zeros (fma(0, 0, s) == s). A thread
// holds a register tile of PASS_R rows x J queries and the block stages rows
// and queries together, 128 bytes of each row at a time; only which thread
// computes which pairs changes between the float sweeps of K1, K5 and K7a and
// K2's re-score (gather_groups.cu), every pair runs the chain above over the
// same columns, so they give the same bits. Tensor cores are out for these
// formats: TF32 would round the products.
//
// The mma order (int8, packed int4 and pq4: K4, the in-kernel dequant of the
// TPU kernels, kirag_tpu/ops/pallas_exact.py::_chunk_scores, which sends the
// codes as bf16 to the matrix unit), mma_passes(), pq_passes() and their
// slot routines below. The wrapper rounds the queries to bf16 once; the codes
// are decoded exactly to bf16 (int8: the code c in [-128, 127]; int4: the
// level n - 7.5; pq4: the level table's entry, rounded to bf16 once by the
// wrapper), so every product is exact and only the sums round:
//
//   products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, corpus
//         rows as A (M), queries as B (N), over k-steps of 16 dims in
//         ascending order, accumulator from +0.0f. Inside a k-step of dims
//         [16 s, 16 s + 16), dim 16 s + 4 t + e sits at k-slot 2 t + e
//         (e = 0, 1) and 2 t + 8 + (e - 2) (e = 2, 3), so lane t of a
//         fragment holds four consecutive dims of a row and of a query;
//   int8: one chain over all D (D % 16 == 0, exactly D / 16 k-steps), then
//         s = s * row_scale;
//   int4: byte t of a packed row holds dim t (low nibble, block t / 128) and
//         dim t + D/2 (high nibble, block t / 128 + NB/2). One chain of 8
//         k-steps per 128-dim block b giving p_b, then in block order
//         s = p_0 * scale_0;  s = s + p_b * scale_b  for b = 1 .. NB-1, each
//         product and sum rounded on its own (the reference's
//         `p = p * s; out = out + p`). The row's bytes are walked once
//         (the high plane's partials wait in registers) or twice (the low
//         plane's blocks, then the high plane's): the same operations;
//   pq4:  4-bit product-quantization codes, m / 2 bytes a row (byte b:
//         subspace b in the low nibble, plane 0, and b + m / 2 in the high
//         one, plane 1; subspace s owns dims j * m + s, j < DS = D / m). The
//         nibble n of byte b, plane p, component j decodes to the bf16 level
//         L[n, j * m + p * m / 2 + b], looked up in the table in shared
//         memory (pq_slot). One chain per (component j, plane p) over the
//         m / 2 dims [j * m + p * m / 2, +m / 2) in k-steps of 16 ascending
//         (dims 4 t .. 4 t + 3 of a k-step are bytes 16 s + 4 t .. + 3 of the
//         row, one 32-bit word, at nibble p), then s = p_(0,lo);
//         s = s + p_(0,hi);  s = s + p_(1,lo); ... each sum rounded on its
//         own (the reference's `out = out + p`).
//
// An mma output element depends on its A row, its B column and its C value
// only, not on where the row and the query sit in the tile (tested on the
// card with score_probe, a pair placed at every (m, n) of a fragment), so K1,
// K5 and K7a (a query at column j % 8 of n-tile j / 8) and K2 (the query at
// column 0) give the same bits for a (row, query) pair.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace kirag {

constexpr int LANES = 128;          // rows per group (the TPU kernels' lane width)
constexpr int KD = 32;              // the fma order's column granule (padded_depth)
constexpr int THREADS = 256;        // a sweep block: 8 warps
constexpr int INT4_BLOCK = 128;     // dims per int4 scale
constexpr float FIN_MIN = -1e30f;   // finite mask value of the reference kernels

__host__ __device__ constexpr int padded_depth(int d) { return (d + KD - 1) / KD * KD; }

// Corpus formats: the stored element T; for pq4, DS = D / m, the components
// of a subspace, fixed at compile time so that the chains stay in registers;
// INT4 marks packed int4, PQ pq4. QUANT: int8, int4 and pq4, the mma order.
template <typename T_, int DS_ = 0, bool INT4_ = false>
struct Fmt {
  using T = T_;
  static constexpr int DS = DS_;
  static constexpr bool INT4 = INT4_;
  static constexpr bool PQ = DS_ > 0;
  static constexpr bool QUANT = INT4_ || PQ || std::is_same<T_, int8_t>::value;
};
using F32 = Fmt<float>;
using BF16 = Fmt<__nv_bfloat16>;
using I8 = Fmt<int8_t>;
using I4 = Fmt<uint8_t, 0, true>;
template <int DS>
using PQ4 = Fmt<uint8_t, DS>;

// One 16-byte asynchronous copy global -> shared; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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
// takes the padded_depth(d) columns and no more: a slot's second
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

// ------------------------------------------------ int8, int4 and pq4: the mma order
//
// The quantized sweeps keep score_passes' block (THREADS threads, a pass of
// PASS_ROWS rows, two groups, against QT = 4 J queries) and its epilogue
// layout, but the products go through the tensor cores. Warp w owns the 32
// pass rows [32 w, 32 w + 32) (two m16 tiles) against every query of the
// tile (NT = ceil(QT / 8) n8 tiles), so each code of the pass is decoded once
// for the block and query tile. A ring slot holds MMA_SLOT_BYTES bytes of
// each pass row (int8: 128 dims; int4: 128 dims of each plane) and the query
// tile's bf16 values of the slot's MMA_SLOT_DIMS dims (int4: of the plane
// being walked, or of both planes). int4 walks a row's bytes once when the
// query tile is one n8 tile and D <= 1024: the high plane's block partials
// wait in registers (at most 4 x 8 a lane) until the low blocks are folded;
// otherwise twice, the low plane's blocks, then the high plane's. Either way
// each block's chain and the fold are the same operations in the same order.
// After the pass, the accumulators go through shared memory (the slot just
// read) into the epilogue's layout: thread lane of warp w gets rows 32 i +
// lane of group w / 4 for queries (w % 4) J + j. pq4 keeps the block, the
// warps' rows and the transpose (pq_passes, below), with its own slots.
constexpr int MMA_SLOT_BYTES = 128;                  // bytes of each corpus row a slot holds
constexpr int MMA_ROW_STRIDE = MMA_SLOT_BYTES + 16;  // a slot row: 4 t + 36 g words, no conflict
constexpr int MMA_SLOT_DIMS = 128;                   // query dims a slot holds
constexpr int MMA_Q_STRIDE = MMA_SLOT_DIMS + 16;     // bf16: 288 bytes, rows 8 banks apart
constexpr int MMA_KSTEP = 16;                        // dims of one mma

constexpr int MMA_ONE_WALK_NBH = 4;                  // int4 walks once up to D = 1024 ...
template <int QT>
__host__ __device__ constexpr int mma_q_rows() { return (QT + 7) / 8 * 8; }  // whole n8 tiles
template <int QT>
__host__ __device__ constexpr int mma_q_planes() { return QT <= 8 ? 2 : 1; }  // ... at one n8 tile
template <int QT>
__host__ __device__ constexpr int mma_stage_bytes() {
  return PASS_ROWS * MMA_ROW_STRIDE + mma_q_planes<QT>() * mma_q_rows<QT>() * MMA_Q_STRIDE *
                                          static_cast<int>(sizeof(__nv_bfloat16));
}

// pq4's level table in shared memory (the wrapper builds it in this layout
// once per table; kernels/exact.py's _pq_kernel_table). An entry holds the
// bf16 levels of one (subspace s, code n) for U components: a pair,
// components U h and U h + 1 in its low and high halves, for DS >= 2; one
// bf16 for DS = 1. A (subspace, code) has H = DS / U entries. With t =
// s / 4 % 4 (the lane of a k-step that reads s), e = s % 4 and s' = s / 16,
// entry h of code n lies at byte
//     (t / W) * Q + ((4 s' + e) * H + h) * 128 + (t % W) * 16 EB + n * EB
// (EB = 2 U bytes an entry; W = 128 / (16 EB) = 2 or 4 values of t share
// each 128-byte slot, t % W picking its 16 EB bytes; Q = 32 m H the bytes of
// one t / W; 32 D bytes in all). So one load of a k-step puts lanes of t and
// t + 1 on other bank halves (EB = 4; t and t + 2 share one) or each t on
// its own bank quarter (EB = 2); lanes of one t read one subspace's 16
// codes, distinct banks or one word. And the address of a lookup is one
// prmt: byte 0 is byte e of the row's code word shifted to n * EB with
// (t % W) * 16 EB and bit 7 (h & 1) or'd in, bytes 1-3 are the lane's base
// (the table's address, a multiple of PQ_TABLE_ALIGN, (t / W) * Q, and
// (4 s' H + h & ~1) * 128 for the plane's and slot's bytes), and the load's
// immediate adds the k-step's and byte's (4 ks + e) * H * 128.
template <int DS>
__host__ __device__ constexpr int pq_u() { return DS == 1 ? 1 : 2; }
template <int DS>
__host__ __device__ constexpr int pq_h() { return DS / pq_u<DS>(); }
template <int DS>
__host__ __device__ constexpr int pq_entry_bytes() { return 2 * pq_u<DS>(); }
template <int DS>
__host__ __device__ constexpr int pq_ways() { return 128 / (16 * pq_entry_bytes<DS>()); }
template <int DS>
__host__ __device__ constexpr int pq_table_bytes(int m) {
  return 4 / pq_ways<DS>() * (32 * m * pq_h<DS>());  // 32 D
}
constexpr int PQ_TABLE_ALIGN = 256;  // the table's shared address: byte 0 is the lookup's

// pq4's query tile stays in shared memory for the block's passes: every
// dim of mma_q_rows rows (bf16, row stride D + PQ_Q_PAD: 2 D + 32 bytes, so
// the 8-byte B loads of four rows hit distinct banks), since a slot's codes
// reach 2 DS slices of the queries.
constexpr int PQ_Q_PAD = 16;
template <int QT>
__host__ __device__ constexpr int pq_query_bytes(int d) {
  return mma_q_rows<QT>() * (d + PQ_Q_PAD) * static_cast<int>(sizeof(__nv_bfloat16));
}

// A sweep's ring slot: the fma order's (score_passes) or the mma order's
// (pq4: the codes alone, 128 bytes of each pass row with no padding, its
// 16-byte chunk c of row r at chunk c ^ (r % 8), so that the word t loads of
// rows g hit banks 4 (ks ^ g) + t, no conflict; and room for the transpose
// of 32 queries). The float, int8 and int4 sweeps run SWEEP_STAGES
// slots and SWEEP_BLOCKS_PER_SM blocks an SM: on an H100 at 21M int8/int4
// rows, 3 or 4 slots, or 2 at one block an SM, were no faster at Q = 8, 32
// or 256 (PERF.md §6, tools/time_quantized_kernels.py). pq4 blocks run two
// an SM up to 8 queries (at D = 1024 the table, the slots and the query tile
// of two fit an SM, one block's lookups run through the other's barriers and
// epilogue), one at 16 and 32 (whose chains take up to 255 registers).
template <typename F, int QT>
__host__ __device__ constexpr int sweep_stage_bytes() {
  if constexpr (F::PQ) {
    return PASS_ROWS * (QT + 1) * 4 > PASS_ROWS * MMA_SLOT_BYTES ? PASS_ROWS * (QT + 1) * 4
                                                                   : PASS_ROWS * MMA_SLOT_BYTES;
  } else if constexpr (F::QUANT) {
    return mma_stage_bytes<QT>();
  } else {
    return pass_stage_bytes<typename F::T, QT>();
  }
}
constexpr int PQ_TWO_BLOCKS_MAX_QT = 8;  // pq4: the largest query tile at two blocks an SM
template <typename F, int QT>
__host__ __device__ constexpr int sweep_blocks_per_sm() {
  return F::PQ && QT > PQ_TWO_BLOCKS_MAX_QT ? 1 : SWEEP_BLOCKS_PER_SM;
}
// A sweep block's shared memory ahead of its epilogue's: the ring, and for
// pq4 the level table ahead of it (at the start of the block's shared
// memory, which is PQ_TABLE_ALIGN-aligned) and the query tile behind it.
template <typename F, int QT>
__host__ __device__ inline int sweep_ring_bytes(int d) {
  int bytes = SWEEP_STAGES * sweep_stage_bytes<F, QT>();
  if constexpr (F::PQ) bytes += pq_table_bytes<F::DS>(d / F::DS) + pq_query_bytes<QT>(d);
  return bytes;
}


__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}
// a + c on two bf16 values, as a * 1 + c (exact wherever the sum is)
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3f803f80u), "r"(c));
  return d;
}

// The decode: four codes of a row (bytes 0-3 of w, dims 4 t .. 4 t + 3 of a
// k-step) as two bf16x2 operands, lo = dims 4 t, 4 t + 1 and hi = 4 t + 2,
// 4 t + 3 (the earlier dim in the lower half). Exact, in integer and bf16
// operations (tests/test_torch_quant_decode.py restates them):
//   int8 code c, bits m = c & 0x7f and sign bit b7: the bf16 0x4300 | m is
//     128 + m, and 0xC300 | b7 << 7 is -128 or -256, so their sum is c;
//   int4 nibble n (plane 0: the low nibble, 1: the high one): the bf16
//     0x4280 | 2 n is 64 + n, and 64 + n - 71.5 is the level n - 7.5.
// prmt's selector 0x4140 puts bytes 0 and 1 of its first operand under a
// byte of its second (0x4342: bytes 2 and 3).
__device__ __forceinline__ void decode_i8(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t m = w & 0x7f7f7f7fu;
  const uint32_t b7 = w & 0x80808080u;
  lo = bf16x2_add(prmt(m, 0x43434343u, 0x4140u), prmt(b7, 0xC3C3C3C3u, 0x4140u));
  hi = bf16x2_add(prmt(m, 0x43434343u, 0x4342u), prmt(b7, 0xC3C3C3C3u, 0x4342u));
}
__device__ __forceinline__ void decode_i4(uint32_t w, int plane, uint32_t& lo, uint32_t& hi) {
  const uint32_t x = ((plane ? w >> 3 : w << 1) & 0x1e1e1e1eu) | 0x80808080u;  // 0x80 | 2 n
  lo = bf16x2_add(prmt(x, 0x42424242u, 0x4140u), 0xC28FC28Fu);  // + (-71.5, -71.5)
  hi = bf16x2_add(prmt(x, 0x42424242u, 0x4342u), 0xC28FC28Fu);
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Advance a warp's 32 rows x NT * 8 queries by the first `ksteps` k-steps
// of one slot: `crows` is the warp's first row in the slot (stride
// MMA_ROW_STRIDE), `qs` the slot's first query row (stride MMA_Q_STRIDE).
// Lane (g, t) = (lane / 4, lane % 4) reads word t of each k-step of rows g,
// g + 8, g + 16, g + 24 and four dims of query g of each n8 tile.
// acc[m][n] is the D fragment of m16 tile m and n8 tile n.
template <bool kInt4, int NT>
__device__ __forceinline__ void mma_slot(float (&acc)[2][NT][4], const uint8_t* crows,
                                         const __nv_bfloat16* qs, int ksteps, int plane,
                                         int lane) {
  const uint8_t* c = crows + (lane / 4) * MMA_ROW_STRIDE + 4 * (lane % 4);
  const __nv_bfloat16* qv = qs + (lane / 4) * MMA_Q_STRIDE + 4 * (lane % 4);
#pragma unroll
  for (int ks = 0; ks < MMA_SLOT_DIMS / MMA_KSTEP; ++ks) {
    if (ks >= ksteps) break;
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // a[h]: rows g (+ 8 h), k-slots 2 t..; a[2 + h]: 2 t + 8..
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(c + (16 * m + 8 * h) * MMA_ROW_STRIDE +
                                               MMA_KSTEP * ks);
        if constexpr (kInt4) {
          decode_i4(w, plane, a[m][h], a[m][2 + h]);
        } else {
          decode_i8(w, a[m][h], a[m][2 + h]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint2 b = *reinterpret_cast<const uint2*>(qv + n * 8 * MMA_Q_STRIDE + MMA_KSTEP * ks);
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_bf16(acc[m][n], a[m], b.x, b.y);
    }
  }
}

// int4's one walk: the k-steps of one slot for both planes at once, each
// loaded word decoded twice: plane 0 into lo's chain (against the queries'
// low-plane dims at qs_lo), plane 1 into hi's (qs_hi). Each chain is
// mma_slot's for its plane.
template <int NT>
__device__ __forceinline__ void mma_slot_planes(float (&lo)[2][NT][4], float (&hi)[2][NT][4],
                                                const uint8_t* crows,
                                                const __nv_bfloat16* qs_lo,
                                                const __nv_bfloat16* qs_hi, int lane) {
  const uint8_t* c = crows + (lane / 4) * MMA_ROW_STRIDE + 4 * (lane % 4);
  const int q_off = (lane / 4) * MMA_Q_STRIDE + 4 * (lane % 4);
#pragma unroll 2  // fuller unrolling spills (ptxas -v)
  for (int ks = 0; ks < MMA_SLOT_DIMS / MMA_KSTEP; ++ks) {
    uint32_t w[2][2];  // rows g + 16 m + 8 h
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        w[m][h] = *reinterpret_cast<const uint32_t*>(c + (16 * m + 8 * h) * MMA_ROW_STRIDE +
                                                     MMA_KSTEP * ks);
      }
    }
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {  // one plane's operands live at a time
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) decode_i4(w[m][h], plane, a[m][h], a[m][2 + h]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint2 b = *reinterpret_cast<const uint2*>((plane ? qs_hi : qs_lo) + q_off +
                                                        n * 8 * MMA_Q_STRIDE + MMA_KSTEP * ks);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_bf16(plane ? hi[m][n] : lo[m][n], a[m], b.x, b.y);
      }
    }
  }
}

// acc = p * scale (first) or acc + p * scale, each product and sum rounded
// on its own: the int4 fold of one block.
template <int NT>
__device__ __forceinline__ void fold_block(float (&acc)[2][NT][4], const float (&p)[2][NT][4],
                                           const float (&bs)[2][2], bool first) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __fmul_rn(p[m][n][e], bs[m][e / 2]);
        acc[m][n][e] = first ? v : __fadd_rn(acc[m][n][e], v);
      }
    }
  }
}

// The f32 values at p[(r0 + 16 m + 8 h) * stride] for the lane's four rows
// (D fragment element e of m16 tile m is row g + 8 (e / 2)); zeros when !live.
__device__ __forceinline__ void lane_row_values(float (&v)[2][2], const float* __restrict__ p,
                                                int64_t r0, int stride, bool live) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) v[m][h] = live ? p[(r0 + 16 * m + 8 * h) * stride] : 0.f;
  }
}

// One slot of a pass in the mma order: int8 advances the row's one chain by
// the slot's k-steps (the dims of slot s that lie below d); int4 forms block
// s's partial (8 k-steps; blocks 0 .. NB/2 - 1 are the low plane's, the row's
// bytes walked once for each plane) and folds it in with the lane's block
// scales bs: s = p_0 * scale_0, then s = s + p_b * scale_b.
template <bool kInt4, int NT>
__device__ __forceinline__ void mma_slot_fold(float (&acc)[2][NT][4], const uint8_t* crows,
                                              const __nv_bfloat16* qs, int s, int d,
                                              const float (&bs)[2][2], int lane) {
  if constexpr (kInt4) {
    float p[2][NT][4] = {};
    const int nbh = d / (2 * INT4_BLOCK);
    mma_slot<true, NT>(p, crows, qs, MMA_SLOT_DIMS / MMA_KSTEP, s >= nbh, lane);
    fold_block<NT>(acc, p, bs, s == 0);
  } else {
    mma_slot<false, NT>(acc, crows, qs, min(MMA_SLOT_DIMS, d - s * MMA_SLOT_DIMS) / MMA_KSTEP,
                        0, lane);
  }
}

// int8's last step: s = s * row_scale.
template <int NT>
__device__ __forceinline__ void scale_rows(float (&acc)[2][NT][4], const float (&rs)[2][2]) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = __fmul_rn(acc[m][n][e], rs[m][e / 2]);
    }
  }
}

// Slots a pass walks: int8 ceil(D / 128); int4 D / 256 in one walk, D / 128
// in two (the row's D / 2 bytes once for each plane).
__host__ __device__ inline int mma_slots(bool int4, bool one_walk, int d) {
  return int4 ? d / MMA_SLOT_DIMS / (one_walk ? 2 : 1) : (d + MMA_SLOT_DIMS - 1) / MMA_SLOT_DIMS;
}

// Start copying slot s of a pass into `slot`: bytes [128 c, 128 c + 128) of
// the pass's rows (group gl's rows from row0[gl]; row0 < 0: a dead group, its
// rows zeros; issue_mma_rows alone) and the dims [qd0, qd0 + 128) of query rows [q0, min(q0 +
// mma_q_rows, n_q)) (bf16, row stride d; rows past n_q and dims past d are
// zeros), and when qd1 >= 0 the dims [qd1, qd1 + 128) into the second query
// plane. All THREADS threads issue (index t), eight neighbours on one row's
// 128 bytes.
// kSwizzle: a pq4 slot, rows MMA_SLOT_BYTES apart with chunk v / 16 of row
// r at chunk v / 16 ^ r % 8 (sweep_stage_bytes); else rows MMA_ROW_STRIDE
// apart.
template <bool kSwizzle = false>
__device__ __forceinline__ void issue_mma_rows(char* slot, const uint8_t* __restrict__ corpus,
                                               int64_t row0_a, int64_t row0_b, int row_bytes,
                                               int c0, int t) {
  constexpr int VPR = MMA_SLOT_BYTES / 16;  // vectors a row: 8
  constexpr int RPI = THREADS / VPR;        // rows an issue round: 32
  const int v = (t % VPR) * 16;
  const bool col_ok = c0 + v < row_bytes;
#pragma unroll
  for (int m = 0; m < PASS_ROWS / RPI; ++m) {
    const int r = t / VPR + m * RPI;  // group r / LANES, known per m at compile time
    const int64_t g0 = m < LANES / RPI ? row0_a : row0_b;
    const bool valid = col_ok && g0 >= 0;
    const uint8_t* src =
        valid ? corpus + (g0 + r % LANES) * static_cast<int64_t>(row_bytes) + c0 + v : corpus;
    cp_async16(slot + (kSwizzle ? r * MMA_SLOT_BYTES + (v ^ r % 8 * 16) : r * MMA_ROW_STRIDE + v),
               src, valid);
  }
}
template <int QT>
__device__ __forceinline__ void issue_mma_stage(char* slot, const uint8_t* __restrict__ corpus,
                                                int64_t row0_a, int64_t row0_b, int row_bytes,
                                                int c0, const __nv_bfloat16* __restrict__ q,
                                                int q0, int n_q, int d, int qd0, int qd1,
                                                int t) {
  issue_mma_rows(slot, corpus, row0_a, row0_b, row_bytes, c0, t);
  constexpr int QV = MMA_SLOT_DIMS / 8;  // 16-byte vectors of a query row's slice
  constexpr int QR = mma_q_rows<QT>();
  __nv_bfloat16* qtile = reinterpret_cast<__nv_bfloat16*>(slot + PASS_ROWS * MMA_ROW_STRIDE);
  const int planes = qd1 >= 0 ? 2 : 1;
  for (int i = t; i < planes * QR * QV; i += THREADS) {
    const int r = i / QV;  // plane r / QR, query row r % QR
    const int e = (i % QV) * 8;
    const int dim = (r < QR ? qd0 : qd1) + e;
    const bool valid = q0 + r % QR < n_q && dim < d;
    const __nv_bfloat16* src = valid ? q + static_cast<int64_t>(q0 + r % QR) * d + dim : q;
    cp_async16(qtile + r * MMA_Q_STRIDE + e, src, valid);
  }
}

// The end of a pass of the mma order: the warps' accumulators (acc[m][n],
// the D fragments; `mine`: the warp's group is live) go through `slot` (the
// slot just read, STAGE bytes: no copy lands there before the next pass's
// first barrier)
// into score_passes' epilogue layout, out[i][j] for row 32 i + lane of the
// pass's group w / 4 and tile query (w % 4) J + j, handed to epi(p, out).
// Every thread of the block calls it; it synchronises the block.
template <int J, int STAGE, int NT, typename Epi>
__device__ __forceinline__ void mma_epilogue(const float (&acc)[2][NT][4], char* slot, bool mine,
                                             int p, Epi&& epi) {
  constexpr int QT = 4 * J;
  constexpr int TS = QT + 1;  // the transpose's row of scores, odd: reads are conflict free
  static_assert(PASS_ROWS * TS * 4 <= STAGE, "the transpose fits a slot of STAGE bytes");
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();
  float* tb = reinterpret_cast<float*>(slot);
  if (mine) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * (lane % 4) + e % 2;
          if (col < QT) tb[(32 * w + 16 * m + lane / 4 + 8 * (e / 2)) * TS + col] = acc[m][n][e];
        }
      }
    }
  }
  __syncthreads();
  float out[PASS_R][J];
#pragma unroll
  for (int i = 0; i < PASS_R; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) out[i][j] = tb[((w / 4) * LANES + 32 * i + lane) * TS + (w % 4) * J + j];
  }
  epi(p, out);
}

// Score `passes` passes of an int8 or packed-int4 corpus (row bytes d or
// d / 2; `scales` [rows] or [rows][d / 128]) in the mma order, through an
// NS-slot cp.async ring at `ring` that runs on across passes: pass p holds
// group gl (0, 1) from corpus row row_of(p, gl), or none when that is
// negative, against queries [q0, q0 + 4 J) (bf16, row stride d; rows past
// n_q score as zero queries). After each pass, epi(p, out) gets the scores
// in score_passes' epilogue layout: out[i][j] for row 32 i + lane of the
// pass's group w / 4 and tile query (w % 4) J + j. Every thread of the block
// calls it, so it may synchronise the block; a dead group's scores are
// garbage. Warps of a dead group skip the mmas.
template <typename F, int J, int NS, typename RowOf, typename Epi>
__device__ __forceinline__ void mma_passes(const uint8_t* __restrict__ corpus,
                                           const float* __restrict__ scales, int passes,
                                           RowOf&& row_of, const __nv_bfloat16* q, int q0,
                                           int n_q, int d, char* ring, Epi&& epi) {
  static_assert(F::QUANT && !F::PQ, "mma_passes scores int8 and int4 corpora");
  constexpr bool kInt4 = F::INT4;
  constexpr int QT = 4 * J;
  constexpr int NT = mma_q_rows<QT>() / 8;
  constexpr int STAGE = mma_stage_bytes<QT>();
  const int t = threadIdx.x;
  const int w = t / 32;
  const int lane = t % 32;
  const int row_bytes = kInt4 ? d / 2 : d;
  const int nbh = d / (2 * INT4_BLOCK);  // int4: blocks of one plane
  // int4 in one walk: a single n8 tile and D <= 1024 (see above)
  const bool one_walk = kInt4 && mma_q_planes<QT>() == 2 && nbh <= MMA_ONE_WALK_NBH;
  const int n_slots = mma_slots(kInt4, one_walk, d);
  const int total = passes * n_slots;
  auto issue = [&](int k) {  // flat slot k = pass * n_slots + slot
    if (k < total) {
      const int p = k / n_slots;
      const int s = k - p * n_slots;
      const int c = kInt4 && !one_walk && s >= nbh ? s - nbh : s;  // the slot's bytes
      const int qd0 = (kInt4 && !one_walk && s >= nbh ? d / 2 : 0) + c * MMA_SLOT_DIMS;
      issue_mma_stage<QT>(ring + (k % NS) * STAGE, corpus, row_of(p, 0), row_of(p, 1),
                          row_bytes, c * MMA_SLOT_BYTES, q, q0, n_q, d, qd0,
                          one_walk ? d / 2 + c * MMA_SLOT_DIMS : -1, t);
    }
    cp_async_commit();  // one group per slot, empty or not: the waits count them
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);
  int k = 0;
  for (int p = 0; p < passes; ++p) {
    const int64_t g0 = row_of(p, w / 4);
    const bool mine = g0 >= 0;
    const int64_t r0 = g0 + (w % 4) * 32 + lane / 4;  // the lane's rows: r0 + 16 m + 8 h
    float acc[2][NT][4] = {};
    float sc[2][2];  // int8: the row scales; int4: block s's
    if constexpr (!kInt4) lane_row_values(sc, scales, r0, 1, mine);
    auto slot_rows = [&](int kk) {
      return reinterpret_cast<const uint8_t*>(ring + (kk % NS) * STAGE) + w * 32 * MMA_ROW_STRIDE;
    };
    auto slot_queries = [&](int kk, int plane) {
      return reinterpret_cast<const __nv_bfloat16*>(ring + (kk % NS) * STAGE +
                                                    PASS_ROWS * MMA_ROW_STRIDE) +
             plane * mma_q_rows<QT>() * MMA_Q_STRIDE;
    };
    if constexpr (kInt4 && mma_q_planes<QT>() == 2) {
      if (one_walk) {
        // slot s: low block s, folded now, and high block nbh + s, kept
        float hi[MMA_ONE_WALK_NBH][2][NT][4];
#pragma unroll
        for (int s = 0; s < MMA_ONE_WALK_NBH; ++s) {
          if (s >= n_slots) break;  // the same in every thread
          lane_row_values(sc, scales + s, r0, 2 * nbh, mine);
          cp_async_wait<NS - 2>();
          __syncthreads();
          issue(k + NS - 1);
          if (mine) {
            float lo[2][NT][4] = {};
#pragma unroll
            for (int m = 0; m < 2; ++m) {
#pragma unroll
              for (int n = 0; n < NT; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) hi[s][m][n][e] = 0.f;
              }
            }
            mma_slot_planes<NT>(lo, hi[s], slot_rows(k), slot_queries(k, 0),
                                slot_queries(k, 1), lane);
            fold_block<NT>(acc, lo, sc, s == 0);
          }
          ++k;
        }
        if (mine) {
#pragma unroll
          for (int s = 0; s < MMA_ONE_WALK_NBH; ++s) {
            if (s < n_slots) {
              lane_row_values(sc, scales + nbh + s, r0, 2 * nbh, true);
              fold_block<NT>(acc, hi[s], sc, false);
            }
          }
        }
      }
    }
    for (int s = 0; s < (one_walk ? 0 : n_slots); ++s, ++k) {
      if constexpr (kInt4) lane_row_values(sc, scales + s, r0, 2 * nbh, mine);  // block s
      cp_async_wait<NS - 2>();  // this thread's copies of slot k have landed
      __syncthreads();          // everyone's have; slot k - 1 is no longer read
      issue(k + NS - 1);
      if (mine) mma_slot_fold<kInt4, NT>(acc, slot_rows(k), slot_queries(k, 0), s, d, sc, lane);
    }
    if constexpr (!kInt4) {
      if (mine) scale_rows<NT>(acc, sc);
    }
    mma_epilogue<J, STAGE>(acc, ring + ((k - 1) % NS) * STAGE, mine, p, epi);
  }
}

// ------------------------------------------------ pq4 in the mma order
//
// pq_passes keeps mma_passes' block, passes, warps and transpose. What
// differs: the level table (pq_table_bytes) and the query tile
// (pq_query_bytes) are copied into shared memory once, the table ahead of
// the ring and the queries behind it, and a ring slot holds MMA_SLOT_BYTES
// bytes of each pass row (sweep_stage_bytes) and nothing else. A warp walks
// its 32 rows' bytes once for each entry h of the table (a pair of
// components), both planes at once: four chains live, (U h, lo), (U h, hi),
// (U h + 1, lo), (U h + 1, hi), folded into the row's sum in that order when
// the walk ends. A row that fits one slot (m <= 256) is read by every walk
// from that slot; a longer one is staged again for each walk, slot by slot,
// its chains held across the slots.

// One table entry (EB bytes) at shared address `addr`, zero-extended.
template <int EB>
__device__ __forceinline__ uint32_t lds_entry(uint32_t addr) {
  uint32_t v;
  if constexpr (EB == 4) {
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  } else {
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  }
  return v;
}

// A lane's base in the table: the table's shared address `table` (a
// multiple of PQ_TABLE_ALIGN) and its t's (t / W) * Q.
template <int DS>
__device__ __forceinline__ uint32_t pq_lane_base(uint32_t table, int m, int lane) {
  return table + lane % 4 / pq_ways<DS>() * (32 * m * pq_h<DS>());
}

// One slot of a walk: entry h (components U h .. U h + U - 1) of bytes [c0,
// c0 + 16 ksteps) of the warp's 32 rows at `crows` (a pq4 slot's rows,
// issue_mma_rows<true>'s layout), both planes. ch[u][p] is the D fragment set of
// component U h + u and plane p; `qs` the query tile (stride q_stride) and
// `tbase` the lane's base in the table (pq_lane_base), both in shared
// memory. Lane (g, t) reads word t of each k-step of rows g + 8 r + 16 mt,
// looks byte e at plane p up in subspace p m / 2 + c0 + 16 ks + 4 t + e, and
// packs the levels of bytes e = 0, 1 (and 2, 3) of one component into one
// bf16x2 A register, as mma_slot's int8 decode does.
template <int DS, int NT>
__device__ __forceinline__ void pq_slot(float (&ch)[pq_u<DS>()][2][2][NT][4],
                                        const uint8_t* crows, const __nv_bfloat16* qs,
                                        int q_stride, uint32_t tbase, int m, int h, int c0,
                                        int ksteps, int lane) {
  constexpr int U = pq_u<DS>();
  constexpr int H = pq_h<DS>();
  constexpr int EB = pq_entry_bytes<DS>();
  constexpr int W = pq_ways<DS>();
  const int g = lane / 4;
  const int t = lane % 4;
  const int m2 = m / 2;
  const uint8_t* c = crows + g * MMA_SLOT_BYTES + 4 * t;
  const __nv_bfloat16* qv = qs + g * q_stride + 4 * t + U * h * m + c0;
  // or'd into each byte of a code word: t % W's bytes of the slot and h's
  // low bit; h's other bits go to the base
  const uint32_t tw = static_cast<uint32_t>(t % W * 16 * EB | (h & 1) << 7) * 0x01010101u;
  const uint32_t tb = tbase + (h >> 1) * 256;
#pragma unroll
  for (int ks = 0; ks < MMA_SLOT_BYTES / MMA_KSTEP; ++ks) {
    if (ks >= ksteps) break;
    uint32_t w[2][2];  // rows g + 16 mt + 8 r: chunk ks of each at chunk ks ^ g
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        w[mt][r] = *reinterpret_cast<const uint32_t*>(c + (16 * mt + 8 * r) * MMA_SLOT_BYTES +
                                                      ((ks ^ g) * 16));
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t tp = tb + (p * m2 + c0) / 16 * (512 * H);  // the slot's subspaces s'
      uint32_t v[2][2][4];  // the entries of bytes e = 0 .. 3 of each word
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // each byte's nibble at plane p times EB, with tw: byte 0 of its address
          const uint32_t x = (EB == 4 ? (p ? w[mt][r] >> 2 : w[mt][r] << 2) & 0x3C3C3C3Cu
                                      : (p ? w[mt][r] >> 3 : w[mt][r] << 1) & 0x1E1E1E1Eu) |
                             tw;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // byte e of x under bytes 1-3 of tp, then the k-step's and byte's slots
            v[mt][r][e] = lds_entry<EB>(prmt(x, tp, 0x7650u | e) + (4 * ks + e) * H * 128);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t sel = u ? 0x7632u : 0x5410u;  // the entries' high or low halves
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            a[mt][r] = prmt(v[mt][r][0], v[mt][r][1], sel);
            a[mt][2 + r] = prmt(v[mt][r][2], v[mt][r][3], sel);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint2 b = *reinterpret_cast<const uint2*>(qv + n * 8 * q_stride + u * m +
                                                          p * m2 + MMA_KSTEP * ks);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(ch[u][p][mt][n], a[mt], b.x, b.y);
        }
      }
    }
  }
}

template <int U, int NT>
__device__ __forceinline__ void pq_zero(float (&ch)[U][2][2][NT][4]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ch[u][p][mt][n][e] = 0.f;
        }
      }
    }
  }
}

// The fold of one walk's chains in (component, plane) order, each sum
// rounded on its own: acc = ch[0][0] (the first walk) or acc + ch[0][0],
// then + ch[0][1], + ch[1][0], + ch[1][1].
template <int U, int NT>
__device__ __forceinline__ void pq_fold(float (&acc)[2][NT][4], const float (&ch)[U][2][2][NT][4],
                                        bool first) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = first ? ch[0][0][mt][n][e] : __fadd_rn(acc[mt][n][e], ch[0][0][mt][n][e]);
        s = __fadd_rn(s, ch[0][1][mt][n][e]);
#pragma unroll
        for (int u = 1; u < U; ++u) {
          s = __fadd_rn(s, ch[u][0][mt][n][e]);
          s = __fadd_rn(s, ch[u][1][mt][n][e]);
        }
        acc[mt][n][e] = s;
      }
    }
  }
}

// Start copying `bytes` bytes (a multiple of 16) from global `src` to shared
// `dst` with all THREADS threads (index t).
__device__ __forceinline__ void issue_copy(char* dst, const char* __restrict__ src, int bytes,
                                           int t) {
  for (int i = 16 * t; i < bytes; i += 16 * THREADS) cp_async16(dst + i, src + i, true);
}

// Start copying query rows [q0, q0 + mma_q_rows) (bf16, row stride d; rows
// past n_q zeros) into the tile at q_s (row stride d + PQ_Q_PAD) with all
// THREADS threads (index t).
template <int QT>
__device__ __forceinline__ void issue_query_tile(__nv_bfloat16* q_s,
                                                 const __nv_bfloat16* __restrict__ q, int q0,
                                                 int n_q, int d, int t) {
  const int qv = d / 8;  // 16-byte vectors of a row
  for (int i = t; i < mma_q_rows<QT>() * qv; i += THREADS) {
    const int r = i / qv;
    const int e = (i % qv) * 8;
    const bool valid = q0 + r < n_q;
    cp_async16(q_s + r * (d + PQ_Q_PAD) + e,
               valid ? q + static_cast<int64_t>(q0 + r) * d + e : q, valid);
  }
}

// The shared address of the table at `smem`, the start of the block's
// dynamic shared memory; a block whose shared memory is not aligned to
// PQ_TABLE_ALIGN (the lookups' addresses take their byte 0 from the codes)
// stops the launch.
__device__ __forceinline__ uint32_t pq_table_at(const char* smem) {
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (at % PQ_TABLE_ALIGN != 0) __trap();
  return at;
}

// mma_passes for a pq4 corpus (codes [rows][m / 2], m = d / DS; `table` the
// level table in pq_table_bytes' layout, global memory): the same passes,
// row_of, queries and epilogue. `smem`, the block's dynamic shared memory,
// holds the table, then the ring, then the query tile (sweep_ring_bytes);
// the table and the queries are copied ahead of the first slot.
template <typename F, int J, int NS, typename RowOf, typename Epi>
__device__ __forceinline__ void pq_passes(const uint8_t* __restrict__ corpus,
                                          const char* __restrict__ table, int passes,
                                          RowOf&& row_of, const __nv_bfloat16* q, int q0,
                                          int n_q, int d, char* smem, Epi&& epi) {
  static_assert(F::PQ, "pq_passes scores pq4 corpora");
  constexpr int DS = F::DS;
  constexpr int QT = 4 * J;
  constexpr int NT = mma_q_rows<QT>() / 8;
  constexpr int STAGE = sweep_stage_bytes<F, QT>();
  const int t = threadIdx.x;
  const int w = t / 32;
  const int lane = t % 32;
  const int m = d / DS;
  const int m2 = m / 2;  // bytes of a row
  char* ring = smem + pq_table_bytes<DS>(m);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(ring + NS * STAGE);
  issue_copy(smem, table, pq_table_bytes<DS>(m), t);
  issue_query_tile<QT>(q_s, q, q0, n_q, d, t);
  cp_async_commit();  // the first slot's wait waits for them too
  const uint32_t tbase = pq_lane_base<DS>(pq_table_at(smem), m, lane);
  const int row_slots = (m2 + MMA_SLOT_BYTES - 1) / MMA_SLOT_BYTES;
  const int items = row_slots == 1 ? 1 : pq_h<DS>() * row_slots;  // slots a pass
  const int total = passes * items;
  auto issue = [&](int k) {  // flat slot k = pass * items + item
    if (k < total) {
      const int p = k / items;
      issue_mma_rows<true>(ring + (k % NS) * STAGE, corpus, row_of(p, 0), row_of(p, 1), m2,
                           (k - p * items) % row_slots * MMA_SLOT_BYTES, t);
    }
    cp_async_commit();  // one group per slot, empty or not: the waits count them
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);
  int k = 0;
  float ch[pq_u<DS>()][2][2][NT][4];
  for (int p = 0; p < passes; ++p) {
    const bool mine = row_of(p, w / 4) >= 0;
    float acc[2][NT][4] = {};
    for (int it = 0; it < items; ++it, ++k) {
      cp_async_wait<NS - 2>();  // this thread's copies of slot k have landed
      __syncthreads();          // everyone's have; slot k - 1 is no longer read
      issue(k + NS - 1);
      if (!mine) continue;
      const int c = it % row_slots;
      const int h0 = row_slots == 1 ? 0 : it / row_slots;
      const int h1 = row_slots == 1 ? pq_h<DS>() : h0 + 1;
      const uint8_t* rows =
          reinterpret_cast<const uint8_t*>(ring + (k % NS) * STAGE) + w * 32 * MMA_SLOT_BYTES;
      const int ksteps = min(MMA_SLOT_BYTES, m2 - c * MMA_SLOT_BYTES) / MMA_KSTEP;
      for (int h = h0; h < h1; ++h) {
        if (c == 0) pq_zero(ch);
        pq_slot<DS, NT>(ch, rows, q_s, d + PQ_Q_PAD, tbase, m, h, c * MMA_SLOT_BYTES, ksteps,
                        lane);
        if (c == row_slots - 1) pq_fold(acc, ch, h == 0);
      }
    }
    mma_epilogue<J, STAGE>(acc, ring + ((k - 1) % NS) * STAGE, mine, p, epi);
  }
}

// The mma order's passes of a format: pq_passes for pq4 (`scales` its level
// table), mma_passes for int8 and int4.
template <typename F, int J, int NS, typename RowOf, typename Epi>
__device__ __forceinline__ void quant_passes(const uint8_t* __restrict__ corpus,
                                             const float* __restrict__ scales, int passes,
                                             RowOf&& row_of, const __nv_bfloat16* q, int q0,
                                             int n_q, int d, char* ring, Epi&& epi) {
  if constexpr (F::PQ) {
    pq_passes<F, J, NS>(corpus, reinterpret_cast<const char*>(scales), passes, row_of, q, q0,
                        n_q, d, ring, epi);
  } else {
    mma_passes<F, J, NS>(corpus, scales, passes, row_of, q, q0, n_q, d, ring, epi);
  }
}

// The sweeps' scoring (K1, K5, K7a): n_groups groups from corpus row row_base,
// two a pass, against queries [q0, q0 + 4 J) (f32 for a float corpus, bf16
// for int8/int4/pq4), in the format's order; epi(p, live, acc) as
// score_passes'. `ring` holds sweep_ring_bytes<F, 4 J>(d) bytes.
template <typename F, int J, int NS, typename Epi>
__device__ __forceinline__ void sweep_passes(const void* corpus, const float* scales,
                                             int64_t row_base, int n_groups, const void* q,
                                             int q0, int n_q, int d, char* ring, Epi&& epi) {
  if constexpr (F::QUANT) {
    quant_passes<F, J, NS>(
        static_cast<const uint8_t*>(corpus), scales, (n_groups + 1) / 2,
        [=](int p, int gl) -> int64_t {
          const int g = 2 * p + gl;
          return g < n_groups ? row_base + static_cast<int64_t>(g) * LANES : -1;
        },
        static_cast<const __nv_bfloat16*>(q), q0, n_q, d, ring,
        [&](int p, auto& out) { epi(p, min(2, n_groups - 2 * p), out); });
  } else {
    score_passes<typename F::T, J, NS>(static_cast<const typename F::T*>(corpus), row_base,
                                       n_groups, static_cast<const float*>(q), q0, n_q, d, ring,
                                       epi);
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

// Call fn(Fmt{}) with the format of `kind` (0 float32, 1 bfloat16, 2 int8,
// 3 packed int4 of depth d = 256 .. MAX_INT4_DIM in steps of 256; 4 +
// log2(DS) pq4 with DS = D / m in {1, 2, 4, 8}, m / 2 a multiple of 16 and
// d <= MAX_PQ_DIM, when kPQ); cudaErrorInvalidValue for anything else.
constexpr int MAX_INT4_DIM = 2048;
constexpr int MAX_PQ_DIM = 2048;  // the table and a query tile beside the ring

template <bool kPQ = true, typename Fn>
cudaError_t with_format(int kind, int d, Fn&& fn) {
  if (kind >= 4 && kind <= 7) {
    const int ds = 1 << (kind - 4);
    if (!kPQ || d % ds != 0 || (d / ds) % 32 != 0 || d > MAX_PQ_DIM) return cudaErrorInvalidValue;
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
      if (d % MMA_KSTEP != 0) return cudaErrorInvalidValue;
      return fn(I8{});
    case 3:
      if (d % 256 != 0 || d < 256 || d > MAX_INT4_DIM) return cudaErrorInvalidValue;
      return fn(I4{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace kirag
