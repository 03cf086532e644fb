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
// corpus values in all (1.7 GB at Q = 32, k = 100, D = 1024 f32), with D fmas
// per row on the CUDA cores. The reference instead re-read the whole corpus
// and multiplied by a one-hot matrix; here only the selected rows are read.
// An int8 or int4 corpus reads 4x or 8x fewer bytes for the same fmas.
//
// What the design does about it: one block per (query, 8 slots); each half of
// the block stages one group's rows through shared memory (coalesced reads)
// and scores them against the query in score.cuh's fma order, so the values
// are bitwise those the capture kernel computed for the same rows.
#include "score.cuh"

using namespace kirag;

namespace {

constexpr int SLOTS = 8;  // selected groups per block, two at a time

template <typename F>
__global__ void __launch_bounds__(THREADS)
    gather_groups_kernel(const float* __restrict__ q, const typename F::T* __restrict__ corpus,
                         const float* __restrict__ scales, const int* __restrict__ gsel,
                         float* __restrict__ cand, int n_q, int d, int k, int64_t n_groups) {
  using T = typename F::T;
  extern __shared__ __align__(16) float smem[];
  const int d_pad = padded_depth(d);
  float* q_s = smem;                                         // [d_pad]
  char* table_s = reinterpret_cast<char*>(q_s + d_pad);      // pq4's level table
  T* tiles = reinterpret_cast<T*>(table_s + table_bytes<F>(d));  // [STAGES][LANES][stride]
  const int t = threadIdx.x;
  const int half = t / LANES;
  const int lane = t % LANES;
  const int qi = blockIdx.y;

  stage_queries(q_s, q, qi, 1, n_q, d, d_pad);
  const float* sc = stage_table<F>(table_s, scales, d);
  __syncthreads();

  T* my_tiles = tiles + half * (STAGES / 2) * tile_elems<T>();  // this half's pipeline
  for (int s0 = 0; s0 < SLOTS; s0 += 2) {
    const int slot = blockIdx.x * SLOTS + s0 + half;
    const bool in_k = slot < k;
    const int64_t g = in_k ? gsel[static_cast<int64_t>(qi) * k + slot] : -1;
    const bool active = g >= 0 && g < n_groups;
    float acc[1];
    score_group<F, LANES, 1, STAGES / 2>(acc, corpus, sc, g * LANES, d, q_s, 0, my_tiles,
                                         lane, lane, active);
    if (in_k) {
      cand[(static_cast<int64_t>(qi) * k + slot) * LANES + lane] = active ? acc[0] : 0.f;
    }
  }
}

template <typename F>
cudaError_t launch(const float* q, const void* corpus, const float* scales, const int* gsel,
                   float* cand, int n_q, int d, int k, int64_t n_rows, cudaStream_t stream) {
  using T = typename F::T;
  const size_t smem = sizeof(float) * padded_depth(d) + table_bytes<F>(d) +
                      sizeof(T) * STAGES * tile_elems<T>();
  auto kernel = gather_groups_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const dim3 grid((k + SLOTS - 1) / SLOTS, n_q);
  kernel<<<grid, THREADS, smem, stream>>>(q, static_cast<const T*>(corpus), scales, gsel, cand,
                                          n_q, d, k, n_rows / LANES);
  return cudaGetLastError();
}

}  // namespace

// Queries f32 [n_q, d]; corpus [n_rows, *] in the format of `kind` (as
// kirag_stream_capture's, with its `scales`), n_rows a multiple of 128; gsel
// int32 [n_q, k]; cand f32 [n_q, k, 128]. Returns the launch's cudaError_t.
extern "C" int kirag_gather_groups(const float* q, const void* corpus, int kind,
                                   const float* scales, const int* gsel, float* cand, int n_q,
                                   int d, int k, long long n_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_format(kind, d, [&](auto fmt) {
    return launch<decltype(fmt)>(q, corpus, scales, gsel, cand, n_q, d, k, n_rows, s);
  });
}
