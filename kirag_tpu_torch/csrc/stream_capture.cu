// stream_capture: one corpus read with per-chunk top-B group capture.
//
// Replaces the TPU kernel kirag_tpu/ops/pallas_exact.py::_stream_kernel
// (launched by _stream_body with select="capdom") over a float32, bfloat16,
// int8, packed-int4 or 4-bit PQ corpus; the quantized scoring (K4,
// `_chunk_scores`) is score.cuh's. For each corpus chunk and each query it emits, as that kernel
// does:
//   gmax   [C, G, Q] f32  maximum of every 128-row group; rows >= valid_rows
//                         count as FIN_MIN, and the maximum is clamped to FIN_MIN
//   capture[C, Q, B*128]  the raw scores of the chunk's top-B groups
//   gids   [C, B, Q] i32  their global group ids
//   capmax [C, B, Q] f32  their maxima, descending, ties to the lower group id
//   resid  [C, 1, Q] f32  the largest maximum not captured (-inf when B == G)
// Captured scores stay raw (the tail masks invalid rows by row id).
//
// What bounds it on the H100: the dot products run on the CUDA cores in f32
// (Q x N x D fmas), fed from shared memory (one staged corpus value per fma
// column, one 16-byte query read per four fmas); at 1M x 1024 that takes
// longer than reading the corpus once from HBM (4 GB f32 at 3.35 TB/s,
// about 1.2 ms). The corpus is read once per query tile. A quantized corpus
// moves 4x (int8), 8x (int4) or 32x (pq4 at m = D / 4) fewer bytes for the
// same fmas, plus the decode of each code (a conversion, or pq4's table
// read), so it is bound by the CUDA cores even more.
//
// What the design does about it: one block per (query tile, chunk), query
// tiles on the fast grid axis so the tiles of one chunk run together and share
// the chunk through L2; corpus tiles stream into shared memory with cp.async,
// three in flight (score.cuh). The block walks the chunk's groups, keeps only the
// [tile, G] group maxima in shared memory (scores never leave the SM), peels B
// groups per query (one warp per query), then re-scores just those B groups to
// write their 128 raw scores. All scores come from score.cuh's one fma order,
// so capture, re-score and the fallback gather agree bitwise, and the strict
// check `kth > resid` of the tail is taken on the values it returns. Tensor
// cores (wgmma) would fix a different summation order; moving every kernel to
// one such order is later work.
#include "score.cuh"

using namespace kirag;

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// strict total order of the peel: larger value first, then the lower id
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename F, int QPT>
__global__ void __launch_bounds__(THREADS)
    stream_capture_kernel(const float* __restrict__ q, const typename F::T* __restrict__ corpus,
                          const float* __restrict__ scales,
                          float* __restrict__ gmax, float* __restrict__ capture,
                          int* __restrict__ gids, float* __restrict__ capmax,
                          float* __restrict__ resid, int n_q, int d, int chunk_size,
                          int b, int64_t valid_rows) {
  using T = typename F::T;
  constexpr int NQ = 2 * QPT;  // queries of this block
  extern __shared__ __align__(16) float smem[];
  const int d_pad = padded_depth(d);
  const int g_count = chunk_size / LANES;
  float* q_s = smem;                                     // [NQ][d_pad]
  char* table_s = reinterpret_cast<char*>(q_s + NQ * d_pad);  // pq4's level table
  T* tiles = reinterpret_cast<T*>(table_s + table_bytes<F>(d));  // [STAGES][LANES][stride]
  float* gmax_s = reinterpret_cast<float*>(tiles + STAGES * tile_elems<T>());  // [NQ][g]
  float* red_s = gmax_s + NQ * g_count;                  // [8 warps][QPT]
  int* sel_s = reinterpret_cast<int*>(red_s + 8 * QPT);  // [NQ][b]

  const int t = threadIdx.x;
  const int half = t / LANES;
  const int lane = t % LANES;
  const int warp = t / 32;
  const int wl = t % 32;
  const int q0 = blockIdx.x * NQ;
  const int nq_here = min(NQ, n_q - q0);
  const int chunk = blockIdx.y;
  const int64_t chunk_row0 = static_cast<int64_t>(chunk) * chunk_size;

  stage_queries(q_s, q, q0, NQ, n_q, d, d_pad);
  const float* sc = stage_table<F>(table_s, scales, d);
  __syncthreads();

  // 1. group maxima. Half h scores block queries h, h + 2, ... against row
  //    `lane` of the group; warps 0-3 are half 0, warps 4-7 half 1.
  for (int g = 0; g < g_count; ++g) {
    const int64_t row0 = chunk_row0 + static_cast<int64_t>(g) * LANES;
    float acc[QPT];
    score_group<F, THREADS, QPT, STAGES>(acc, corpus, sc, row0, d, q_s + half * d_pad,
                                         2 * d_pad, tiles, t, lane, true);
    const bool valid = row0 + lane < valid_rows;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      float v = valid ? acc[j] : FIN_MIN;
      for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
      if (wl == 0) red_s[warp * QPT + j] = v;
    }
    __syncthreads();
    if (t < NQ) {  // block query t lives in half t % 2, slot t / 2
      const int h = t % 2;
      const int j = t / 2;
      float m = red_s[(4 * h) * QPT + j];
      for (int w = 1; w < 4; ++w) m = fmaxf(m, red_s[(4 * h + w) * QPT + j]);
      gmax_s[t * g_count + g] = fmaxf(m, FIN_MIN);
    }
    // red_s is rewritten only after the next group's first __syncthreads
  }
  __syncthreads();

  for (int i = t; i < g_count * nq_here; i += THREADS) {
    const int g = i / nq_here;
    const int lq = i % nq_here;
    gmax[(static_cast<int64_t>(chunk) * g_count + g) * n_q + q0 + lq] =
        gmax_s[lq * g_count + g];
  }
  __syncthreads();

  // 2. peel the top-b groups of each query, one warp per query. Peeled
  //    entries become -inf; every live entry is >= FIN_MIN, so the marker
  //    never ties one, and what is left afterwards is the residual.
  for (int lq = warp; lq < nq_here; lq += THREADS / 32) {
    float* row = gmax_s + lq * g_count;
    for (int bi = 0; bi < b; ++bi) {
      float bv = -CUDART_INF_F;
      int bidx = g_count;
      for (int g = wl; g < g_count; g += 32) {
        const float v = row[g];
        if (beats(v, g, bv, bidx)) {
          bv = v;
          bidx = g;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
        const int oi = __shfl_xor_sync(FULL_MASK, bidx, o);
        if (beats(ov, oi, bv, bidx)) {
          bv = ov;
          bidx = oi;
        }
      }
      if (wl == 0) {  // every lane holds the same winner
        sel_s[lq * b + bi] = bidx;
        const int64_t o = (static_cast<int64_t>(chunk) * b + bi) * n_q + q0 + lq;
        gids[o] = chunk * g_count + bidx;
        capmax[o] = bv;
        row[bidx] = -CUDART_INF_F;
      }
      __syncwarp();
    }
    float r = -CUDART_INF_F;
    for (int g = wl; g < g_count; g += 32) r = fmaxf(r, row[g]);
    for (int o = 16; o > 0; o >>= 1) r = fmaxf(r, __shfl_xor_sync(FULL_MASK, r, o));
    if (wl == 0) resid[static_cast<int64_t>(chunk) * n_q + q0 + lq] = r;
  }
  __syncthreads();

  // 3. re-score the captured groups, one (query, group) pair per half, each
  //    half streaming through its own half of the tiles
  const int npairs = nq_here * b;
  T* my_tiles = tiles + half * (STAGES / 2) * tile_elems<T>();
  for (int p0 = 0; p0 < npairs; p0 += 2) {
    const int p = p0 + half;
    const bool active = p < npairs;
    const int lq = active ? p / b : 0;
    const int bi = active ? p % b : 0;
    const int64_t row0 = chunk_row0 + static_cast<int64_t>(sel_s[lq * b + bi]) * LANES;
    float acc[1];
    score_group<F, LANES, 1, STAGES / 2>(acc, corpus, sc, row0, d, q_s + lq * d_pad, 0,
                                         my_tiles, lane, lane, active);
    if (active) {
      capture[(static_cast<int64_t>(chunk) * n_q + q0 + lq) * (static_cast<int64_t>(b) * LANES) +
              bi * LANES + lane] = acc[0];
    }
  }
}

template <typename F, int QPT>
cudaError_t launch(const float* q, const void* corpus, const float* scales, float* gmax,
                   float* capture, int* gids, float* capmax, float* resid, int n_q, int d,
                   int num_chunks, int chunk_size, int b, int64_t valid_rows,
                   cudaStream_t stream) {
  using T = typename F::T;
  constexpr int NQ = 2 * QPT;
  const int d_pad = padded_depth(d);
  const int g_count = chunk_size / LANES;
  const size_t smem = sizeof(float) * (NQ * d_pad + NQ * g_count + 8 * QPT) +
                      table_bytes<F>(d) + sizeof(T) * STAGES * tile_elems<T>() +
                      sizeof(int) * NQ * b;
  auto kernel = stream_capture_kernel<F, QPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the returned code
    return err;
  }
  const dim3 grid((n_q + NQ - 1) / NQ, num_chunks);
  kernel<<<grid, THREADS, smem, stream>>>(q, static_cast<const T*>(corpus), scales, gmax,
                                          capture, gids, capmax, resid, n_q, d, chunk_size, b,
                                          valid_rows);
  return cudaGetLastError();
}

}  // namespace

// Queries f32 [n_q, d]; corpus [num_chunks * chunk_size, *] in the format of
// `kind` (0 float32 [., d], 1 bfloat16 [., d], 2 int8 [., d] with f32 row
// scales [rows], 3 packed int4 [., d / 2] with f32 block scales
// [rows, d / 128], 4 + log2(d / m) 4-bit PQ codes [., m / 2] with the bf16
// level table [m][16][d / m] (score.cuh); `scales` is null for 0 and 1);
// outputs as in the header
// note. qpt in {2, 4} queries per thread sets the query tile (2 * qpt queries
// per block). Returns the launch's cudaError_t.
extern "C" int kirag_stream_capture(const float* q, const void* corpus, int kind,
                                    const float* scales, float* gmax, float* capture, int* gids,
                                    float* capmax, float* resid, int n_q, int d, int num_chunks,
                                    int chunk_size, int b, long long valid_rows, int qpt,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_format(kind, d, [&](auto fmt) {
    using F = decltype(fmt);
    switch (qpt) {
      case 2:
        return launch<F, 2>(q, corpus, scales, gmax, capture, gids, capmax, resid, n_q, d,
                            num_chunks, chunk_size, b, valid_rows, s);
      case 4:
        return launch<F, 4>(q, corpus, scales, gmax, capture, gids, capmax, resid, n_q, d,
                            num_chunks, chunk_size, b, valid_rows, s);
      default:
        return cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* kirag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
