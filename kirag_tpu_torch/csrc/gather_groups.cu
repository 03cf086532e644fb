// gather_groups: re-score each query's selected 128-row groups.
//
// Replaces the TPU kernel kirag_tpu/ops/pallas_exact.py::_gather_kernel
// (launched by _twopass_gather, the exact fallback of the stream search), over
// a float32, bfloat16, int8, packed-int4 or 4-bit PQ corpus (K4's scoring,
// score.cuh).
// For queries [Q, D] and sorted group ids gsel [Q, k] it writes
// cand[q, j, l] = score(q, row gsel[q, j] * 128 + l). A group id outside the
// corpus gives zeros, as the reference's one-hot accumulation does.
//
// What bounds it on the H100: it reads k * 128 rows per query, Q x k x 128 x D
// corpus values in all (1.7 GB at Q = 32, k = 100, D = 1024 f32), with D
// products per row. The reference instead re-read the whole corpus and
// multiplied by a one-hot matrix; here only the selected rows are read. An
// int8 or int4 corpus reads 4x or 8x fewer bytes for the same products.
//
// What the design does about it: each selected group is staged through
// shared memory (coalesced reads) and scored in the format's order of
// score.cuh, so the values are bitwise those the capture kernel computed for
// the same rows. Float32 and bfloat16 corpora: one block per (query, 8
// slots); each half of the block stages one group's rows and scores them
// against the query in the fma order (score_group). int8, int4 and pq4
// corpora: one block per (query, 2 slots), the two groups one pass of K1's
// own scoring (mma_passes; pq4: pq_passes, the block copying the level table
// and the query first), with the query in column 0 of the n8 tile (the other
// columns zero), each warp 32 rows of a group.
//
// score_probe_kernel and pq_probe_kernel (kirag_score_probe) are the mma
// order on its own, one warp scoring 32 rows against 8 queries, for the
// card's tests of it.
#include "score.cuh"

using namespace kirag;

namespace {

constexpr int SLOTS = 8;  // selected groups per block, two at a time

// Float32 and bfloat16 corpora: see the header note.
template <typename F>
__global__ void __launch_bounds__(THREADS)
    gather_groups_kernel(const float* __restrict__ q, const typename F::T* __restrict__ corpus,
                         const int* __restrict__ gsel, float* __restrict__ cand, int n_q, int d,
                         int k, int64_t n_groups) {
  using T = typename F::T;
  extern __shared__ __align__(16) float smem[];
  const int d_pad = padded_depth(d);
  float* q_s = smem;                                 // [d_pad]
  T* tiles = reinterpret_cast<T*>(q_s + d_pad);      // [STAGES][LANES][stride]
  const int t = threadIdx.x;
  const int half = t / LANES;
  const int lane = t % LANES;
  const int qi = blockIdx.y;

  stage_queries(q_s, q, qi, 1, n_q, d, d_pad);
  __syncthreads();

  T* my_tiles = tiles + half * (STAGES / 2) * tile_elems<T>();  // this half's pipeline
  for (int s0 = 0; s0 < SLOTS; s0 += 2) {
    const int slot = blockIdx.x * SLOTS + s0 + half;
    const bool in_k = slot < k;
    const int64_t g = in_k ? gsel[static_cast<int64_t>(qi) * k + slot] : -1;
    const bool active = g >= 0 && g < n_groups;
    float acc[1];
    score_group<F, LANES, 1, STAGES / 2>(acc, corpus, g * LANES, d, q_s, 0, my_tiles, lane,
                                         lane, active);
    if (in_k) {
      cand[(static_cast<int64_t>(qi) * k + slot) * LANES + lane] = active ? acc[0] : 0.f;
    }
  }
}

template <typename F>
cudaError_t launch(const float* q, const void* corpus, const int* gsel, float* cand, int n_q,
                   int d, int k, int64_t n_rows, cudaStream_t stream) {
  using T = typename F::T;
  const size_t smem = sizeof(float) * padded_depth(d) + sizeof(T) * STAGES * tile_elems<T>();
  auto kernel = gather_groups_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const dim3 grid((k + SLOTS - 1) / SLOTS, n_q);
  kernel<<<grid, THREADS, smem, stream>>>(q, static_cast<const T*>(corpus), gsel, cand, n_q, d,
                                          k, n_rows / LANES);
  return cudaGetLastError();
}

// int8, int4 and pq4 corpora: block (x, qi) scores query qi's slots 2 x and
// 2 x + 1 as one pass of K1's quant_passes (a 4-query tile holding query qi
// alone); warps 0 and 4 hold the groups' scores in the epilogue layout and
// store them. Shared memory: sweep_ring_bytes.
constexpr int MMA_GATHER_SLOTS = 2;  // a pass: two groups

template <typename F>
__global__ void __launch_bounds__(THREADS, (sweep_blocks_per_sm<F, 4>()))
    gather_mma_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ corpus,
                      const float* __restrict__ scales, const int* __restrict__ gsel,
                      float* __restrict__ cand, int n_q, int d, int k, int64_t n_groups) {
  extern __shared__ __align__(16) char smem_raw[];
  const int qi = blockIdx.y;
  const int slot0 = blockIdx.x * MMA_GATHER_SLOTS;
  auto row_of = [&](int, int gl) -> int64_t {
    const int slot = slot0 + gl;
    const int64_t g = slot < k ? gsel[static_cast<int64_t>(qi) * k + slot] : -1;
    return g >= 0 && g < n_groups ? g * LANES : -1;
  };
  quant_passes<F, 1, SWEEP_STAGES>(
      corpus, scales, 1, row_of, q, qi, qi + 1, d, smem_raw, [&](int, auto& out) {
        const int w = threadIdx.x / 32;
        const int slot = slot0 + w / 4;
        if (w % 4 != 0 || slot >= k) return;  // warps 0 and 4 hold query qi's scores
        const bool live = row_of(0, w / 4) >= 0;
        float* dst = cand + (static_cast<int64_t>(qi) * k + slot) * LANES + threadIdx.x % 32;
#pragma unroll
        for (int i = 0; i < PASS_R; ++i) dst[32 * i] = live ? out[i][0] : 0.f;
      });
}

template <typename F>
cudaError_t launch_mma(const void* q, const void* corpus, const float* scales, const int* gsel,
                       float* cand, int n_q, int d, int k, int64_t n_rows, cudaStream_t stream) {
  const size_t smem = sweep_ring_bytes<F, 4>(d);
  auto kernel = gather_mma_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const dim3 grid((k + MMA_GATHER_SLOTS - 1) / MMA_GATHER_SLOTS, n_q);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const __nv_bfloat16*>(q),
                                          static_cast<const uint8_t*>(corpus), scales, gsel,
                                          cand, n_q, d, k, n_rows / LANES);
  return cudaGetLastError();
}

// The mma order alone: one warp a tile scores the tile's 32 rows (codes
// [32][row bytes], scales [32] or [32][d / 128]) against its 8 queries (bf16
// [8][d]) through mma_slot_fold and scale_rows, staging each slot itself,
// and writes out [32][8] f32. int4 in two walks (the one walk's chains and
// fold are the same).
template <bool kInt4>
__global__ void __launch_bounds__(32)
    score_probe_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                       const __nv_bfloat16* __restrict__ q, float* __restrict__ out, int d) {
  __shared__ __align__(16) uint8_t rows_s[32 * MMA_ROW_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 q_s[8 * MMA_Q_STRIDE];
  const int lane = threadIdx.x;
  const int row_bytes = kInt4 ? d / 2 : d;
  const int n_slots = mma_slots(kInt4, false, d);
  const int nbh = n_slots / 2;
  const int64_t tile = blockIdx.x;
  codes += tile * 32 * row_bytes;
  scales += tile * 32 * (kInt4 ? d / INT4_BLOCK : 1);
  q += tile * 8 * d;
  const int r0 = lane / 4;  // the lane's rows: r0 + 16 m + 8 h
  float acc[2][1][4] = {};
  float sc[2][2];
  if constexpr (!kInt4) lane_row_values(sc, scales, r0, 1, true);
  for (int s = 0; s < n_slots; ++s) {
    const int c = kInt4 && s >= nbh ? s - nbh : s;
    const int qd0 = (kInt4 && s >= nbh ? d / 2 : 0) + c * MMA_SLOT_DIMS;
    __syncwarp();
    for (int i = lane; i < 32 * 8; i += 32) {  // 32 rows x 8 vectors
      const int r = i / 8;
      const int v = c * MMA_SLOT_BYTES + (i % 8) * 16;
      *reinterpret_cast<uint4*>(rows_s + r * MMA_ROW_STRIDE + (i % 8) * 16) =
          v < row_bytes ? *reinterpret_cast<const uint4*>(codes + r * row_bytes + v)
                        : make_uint4(0, 0, 0, 0);
    }
    for (int i = lane; i < 8 * 16; i += 32) {  // 8 queries x 16 vectors
      const int r = i / 16;
      const int e = (i % 16) * 8;
      *reinterpret_cast<uint4*>(q_s + r * MMA_Q_STRIDE + e) =
          qd0 + e < d ? *reinterpret_cast<const uint4*>(q + r * d + qd0 + e)
                      : make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
    if constexpr (kInt4) lane_row_values(sc, scales + s, r0, 2 * nbh, true);
    mma_slot_fold<kInt4, 1>(acc, rows_s, q_s, s, d, sc, lane);
  }
  if constexpr (!kInt4) scale_rows<1>(acc, sc);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[tile * 256 + (16 * m + r0 + 8 * (e / 2)) * 8 + 2 * (lane % 4) + e % 2] = acc[m][0][e];
    }
  }
}

// pq4's mma order alone: one warp a tile scores the tile's 32 rows (codes
// [32][m / 2]) against its 8 queries (bf16 [8][d]) through pq_slot and
// pq_fold, the level table (`table`, pq_table_bytes' layout; at the start
// of the shared memory) and the queries copied into shared memory, each slot
// of the rows staged by the warp in issue_mma_rows<true>'s layout, one walk at a
// time; writes out [32][8] f32.
template <int DS>
__global__ void __launch_bounds__(32)
    pq_probe_kernel(const uint8_t* __restrict__ codes, const char* __restrict__ table,
                    const __nv_bfloat16* __restrict__ q, float* __restrict__ out, int d) {
  extern __shared__ __align__(16) char smem_raw[];
  const int lane = threadIdx.x;
  const int m = d / DS;
  const int m2 = m / 2;
  const int qs = d + PQ_Q_PAD;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + pq_table_bytes<DS>(m));
  uint8_t* rows_s = reinterpret_cast<uint8_t*>(q_s + 8 * qs);
  const int64_t tile = blockIdx.x;
  codes += tile * 32 * m2;
  q += tile * 8 * d;
  for (int i = 16 * lane; i < pq_table_bytes<DS>(m); i += 16 * 32) {
    *reinterpret_cast<uint4*>(smem_raw + i) = *reinterpret_cast<const uint4*>(table + i);
  }
  for (int i = lane; i < d; i += 32) {  // 8 queries x d / 8 vectors
    const int r = i / (d / 8);
    const int e = i % (d / 8) * 8;
    *reinterpret_cast<uint4*>(q_s + r * qs + e) = *reinterpret_cast<const uint4*>(q + r * d + e);
  }
  const uint32_t tbase = pq_lane_base<DS>(pq_table_at(smem_raw), m, lane);
  const int row_slots = (m2 + MMA_SLOT_BYTES - 1) / MMA_SLOT_BYTES;
  float acc[2][1][4] = {};
  float ch[pq_u<DS>()][2][2][1][4];
  for (int h = 0; h < pq_h<DS>(); ++h) {
    pq_zero(ch);
    for (int c = 0; c < row_slots; ++c) {
      __syncwarp();
      for (int i = lane; i < 32 * 8; i += 32) {  // 32 rows x 8 chunks, swizzled
        const int r = i / 8;
        const int v = c * MMA_SLOT_BYTES + i % 8 * 16;
        *reinterpret_cast<uint4*>(rows_s + r * MMA_SLOT_BYTES + (i % 8 ^ r % 8) * 16) =
            v < m2 ? *reinterpret_cast<const uint4*>(codes + r * m2 + v) : make_uint4(0, 0, 0, 0);
      }
      __syncwarp();
      pq_slot<DS, 1>(ch, rows_s, q_s, qs, tbase, m, h, c * MMA_SLOT_BYTES,
                     min(MMA_SLOT_BYTES, m2 - c * MMA_SLOT_BYTES) / MMA_KSTEP, lane);
    }
    pq_fold(acc, ch, h == 0);
  }
  const int r0 = lane / 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[tile * 256 + (16 * mt + r0 + 8 * (e / 2)) * 8 + 2 * (lane % 4) + e % 2] = acc[mt][0][e];
    }
  }
}

}  // namespace

// Queries [n_q, d] (f32 for float corpora, else bf16); corpus
// [n_rows, *] in the format of `kind` (as kirag_stream_capture's, with its
// `scales`), n_rows a multiple of 128; gsel int32 [n_q, k]; cand f32
// [n_q, k, 128]. Returns the launch's cudaError_t.
extern "C" int kirag_gather_groups(const void* q, const void* corpus, int kind,
                                   const float* scales, const int* gsel, float* cand, int n_q,
                                   int d, int k, long long n_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_format(kind, d, [&](auto fmt) {
    using F = decltype(fmt);
    if constexpr (F::QUANT) {
      return launch_mma<F>(q, corpus, scales, gsel, cand, n_q, d, k, n_rows, s);
    } else {
      return launch<F>(static_cast<const float*>(q), corpus, gsel, cand, n_q, d, k, n_rows, s);
    }
  });
}

// `tiles` tiles of the mma order alone: codes int8 [tiles, 32, d] (kind 2)
// with f32 scales [tiles, 32], packed int4 [tiles, 32, d / 2] (kind 3) with
// f32 scales [tiles, 32, d / 128] (score_probe_kernel), or pq4 codes
// [tiles, 32, m / 2] (kind 4 + log2(d / m)) with the level table of every
// tile in `scales` (pq_probe_kernel); queries bf16 [tiles, 8, d], out f32
// [tiles, 32, 8]. Returns the launch's cudaError_t.
extern "C" int kirag_score_probe(const void* codes, int kind, const float* scales,
                                 const void* q, float* out, int tiles, int d, void* stream) {
  if (tiles < 1 || kind < 2) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_format(kind, d, [&](auto fmt) {
    using F = decltype(fmt);
    const auto* c = static_cast<const uint8_t*>(codes);
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    if constexpr (F::PQ) {
      const int smem = pq_table_bytes<F::DS>(d / F::DS) + pq_query_bytes<8>(d) +
                       32 * MMA_SLOT_BYTES;
      auto kernel = pq_probe_kernel<F::DS>;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
      }
      kernel<<<tiles, 32, smem, s>>>(c, reinterpret_cast<const char*>(scales), qb, out, d);
      return cudaGetLastError();
    } else if constexpr (F::QUANT) {
      score_probe_kernel<F::INT4><<<tiles, 32, 0, s>>>(c, scales, qb, out, d);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  });
}
