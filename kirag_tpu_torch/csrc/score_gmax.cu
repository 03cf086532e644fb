// score_gmax: every score of a corpus chunk and its 128-row group maxima.
//
// Replaces the TPU kernel kirag_tpu/ops/pallas_exact.py::_score_gmax_kernel
// (the fused scoring pass of impl="single", "single_strided" and "twopass"),
// over a float32, bfloat16, int8, packed-int4 or 4-bit PQ corpus (K4's
// scoring, score.cuh). For each corpus chunk and query it writes
//   gmax   [C, G, Q] f32  the maximum of every 128-row group; rows >= valid_rows
//                         count as FIN_MIN (not clamped: a -inf score stays -inf)
//   scores the raw f32 scores, at scores[chunk * s_chunk + q * s_q + row in chunk]:
//          chunk-major [C, Q, chunk] (impl="single"), row-major [Q, N]
//          ("single_strided"), or not at all (scores == null, "twopass" pass A).
// The maxima are masked, the scores are not (the tail masks rows by row id).
//
// What bounds it on the H100: the same 2 Q N D operations and corpus read as
// K1 (stream_capture.cu; float corpora on the CUDA cores, int8, int4 and pq4
// ones on the tensor cores), plus the score write, 4 * Q * N bytes (128 MB at 1M
// rows and Q = 32 against the f32 corpus's 4 GB; 2.7 GB at 21M rows, where
// an int4 corpus's codes are 10.8 GB), so the operations or the corpus read
// bound it, not the write.
//
// What the design does about it: K1's first launch with a store in place of
// its capture. Every format: one block per (query tile of 4-32 queries,
// chunk, range of the chunk's groups), cut by kernels/exact.py's
// search_plan, scoring through score.cuh's sweep_passes (float:
// score_passes, a register tile of 4 rows x up to 8 queries a thread;
// int8/int4: mma_passes, pq4: pq_passes, the tensor cores, the scores
// transposed into the same layout); per pass each warp holds one group for
// its queries, so it reduces the group's masked maximum itself and stores
// its scores 128 consecutive bytes an instruction. Because every
// score comes from score.cuh's one order for its format, the scores are
// bitwise K1's and K2's for the same rows, and the maxima bitwise K1's
// (before its clamp), so every impl of the exact search selects the same
// groups and returns the same values.
#include "score.cuh"

using namespace kirag;

namespace {

// Block x = (chunk * splits + split) * q_tiles + query tile, as K1's
// capture_sweep_kernel. Shared memory: the ring (sweep_ring_bytes).
template <typename F, int J>
__global__ void __launch_bounds__(THREADS, (sweep_blocks_per_sm<F, 4 * J>()))
    score_sweep_kernel(const void* __restrict__ q, const void* __restrict__ corpus,
                       const float* __restrict__ scales, float* __restrict__ scores,
                       float* __restrict__ gmax, int n_q, int d,
                       int chunk_size, int64_t valid_rows, int64_t s_chunk, int64_t s_q,
                       int q_tiles, int splits, int gpb) {
  constexpr int QT = 4 * J;
  constexpr int NS = SWEEP_STAGES;
  extern __shared__ __align__(16) char smem_raw[];

  const int t = threadIdx.x;
  const int w = t / 32;
  const int g_count = chunk_size / LANES;
  const int q0 = (blockIdx.x % q_tiles) * QT + (w % 4) * J;  // this warp's first query
  const int range = blockIdx.x / q_tiles;
  const int chunk = range / splits;
  const int g_begin = (range % splits) * gpb;
  const int64_t chunk_row0 = static_cast<int64_t>(chunk) * chunk_size;

  auto epilogue = [&](int p, int live, auto& acc) {
    const int g = g_begin + 2 * p + w / 4;  // this warp's group
    if (w / 4 >= live) return;              // no block barrier here
    pass_warp_maxima<J>(acc, chunk_row0 + static_cast<int64_t>(g) * LANES, valid_rows,
                        [&](int j, float m) {
                          if (q0 + j < n_q) {
                            gmax[(static_cast<int64_t>(chunk) * g_count + g) * n_q + q0 + j] = m;
                          }
                        });
    if (scores != nullptr) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (q0 + j < n_q) {
          float* dst = scores + chunk * s_chunk + (q0 + j) * s_q + g * LANES + t % 32;
#pragma unroll
          for (int i = 0; i < PASS_R; ++i) dst[32 * i] = acc[i][j];
        }
      }
    }
  };
  sweep_passes<F, J, NS>(corpus, scales, chunk_row0 + static_cast<int64_t>(g_begin) * LANES,
                         min(gpb, g_count - g_begin), q, (blockIdx.x % q_tiles) * QT, n_q, d,
                         smem_raw, epilogue);
}

template <typename F, int J>
cudaError_t launch_sweep(const void* q, const void* corpus, const float* scales, float* scores,
                         float* gmax, int n_q, int d, int num_chunks, int chunk_size,
                         int64_t valid_rows, int64_t s_chunk, int64_t s_q, int splits, int gpb,
                         int plan_smem, cudaStream_t stream) {
  constexpr int QT = 4 * J;
  const size_t smem = sweep_ring_bytes<F, QT>(d);
  if (!sweep_cut_fits(chunk_size / LANES, splits, gpb) ||
      smem != static_cast<size_t>(plan_smem)) {
    return cudaErrorInvalidValue;
  }
  const int q_tiles = (n_q + QT - 1) / QT;
  const int64_t blocks = static_cast<int64_t>(q_tiles) * num_chunks * splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = score_sweep_kernel<F, J>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the returned code
    return err;
  }
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      q, corpus, scales, scores, gmax, n_q, d, chunk_size, valid_rows, s_chunk, s_q, q_tiles,
      splits, gpb);
  return cudaGetLastError();
}

}  // namespace

// Queries [n_q, d] (f32 for float corpora, else bf16); corpus
// [num_chunks * chunk_size, *] in the format of `kind` with its `scales` (as
// kirag_stream_capture's); scores null or f32 with the strides s_chunk, s_q
// (see the header note); gmax f32 [num_chunks, chunk_size / 128, n_q].
// search_plan's cut (q_tile, splits, gpb, smem, as kirag_stream_capture's).
// Returns the launch's cudaError_t.
extern "C" int kirag_score_gmax(const void* q, const void* corpus, int kind,
                                const float* scales, float* scores, float* gmax, int n_q, int d,
                                int num_chunks, int chunk_size, long long valid_rows,
                                long long s_chunk, long long s_q, int q_tile, int splits,
                                int gpb, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_format(kind, d, [&](auto fmt) {
    using F = decltype(fmt);
    return with_query_tile(q_tile, [&](auto j) {
      return launch_sweep<F, decltype(j)::value>(q, corpus, scales, scores, gmax, n_q, d,
                                                 num_chunks, chunk_size, valid_rows, s_chunk,
                                                 s_q, splits, gpb, smem, s);
    });
  });
}
