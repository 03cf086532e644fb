// group_max: the W best rows of every 128-row group, for each query (K5).
//
// Replaces the TPU kernel kirag_tpu/ops/pallas_mips.py::_group_max_kernel
// (launched by grouped_max_scores, the scoring pass of approx_topk_mips) over a
// float32, bfloat16, int8 or packed-int4 corpus (K4's scoring, score.cuh). For
// queries [Q, D] and a corpus of G groups of 128 rows it writes
//   gmax [Q, W, G] f32  each group's W largest scores, descending
//   gidx [Q, W, G] i32  their lanes (row - 128 g)
// found as the reference finds them: W rounds of a masked maximum, ties to the
// lowest lane, each winner set to -inf before the next round. Every row is
// scored, zero pad rows too; the caller masks rows past its valid count after
// the peel, as the reference does (pallas_mips.py:198-200).
//
// What bounds it on the H100: the same dot products as K1 (Q x N x D fmas on the
// CUDA cores, each corpus tile read once per query tile from shared memory), so
// it is bound by the CUDA cores and the shared-memory reads that feed them, not
// by the corpus bytes; the peel adds W rounds of a warp argmax per group and
// query, which at W = 1 is a few percent of the scoring.
//
// What the design does about it: one block per (query tile, range of groups),
// query tiles on the fast grid axis so the tiles of one range share its rows
// through L2, and enough ranges to fill the card whatever the corpus size (no
// chunk: the chunk of the reference has no meaning to the result). Each group
// is scored by score.cuh's score_group, so the scores are bitwise K1's and K2's,
// into shared memory [NQ][128]; one warp per query then peels its W winners,
// each lane holding 4 of the 128 scores. The scores never leave the SM.
#include <algorithm>

#include "score.cuh"

using namespace kirag;

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// the peel's strict order: larger value first, then the lower lane
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename F, int QPT>
__global__ void __launch_bounds__(THREADS)
    group_max_kernel(const float* __restrict__ q, const typename F::T* __restrict__ corpus,
                     const float* __restrict__ scales, float* __restrict__ gmax,
                     int* __restrict__ gidx, int n_q, int d, int64_t n_groups, int winners,
                     int groups_per_block) {
  using T = typename F::T;
  constexpr int NQ = 2 * QPT;  // queries of this block, one peeling warp each
  static_assert(NQ <= THREADS / 32, "one warp per query of the tile");
  extern __shared__ __align__(16) float smem[];
  const int d_pad = padded_depth(d);
  float* q_s = smem;                                                     // [NQ][d_pad]
  T* tiles = reinterpret_cast<T*>(q_s + NQ * d_pad);                     // [STAGES][LANES][stride]
  float* sc_s = reinterpret_cast<float*>(tiles + STAGES * tile_elems<T>());  // [NQ][LANES]

  const int t = threadIdx.x;
  const int half = t / LANES;
  const int lane = t % LANES;
  const int warp = t / 32;
  const int wl = t % 32;
  const int q0 = blockIdx.x * NQ;
  const int nq_here = min(NQ, n_q - q0);
  const int64_t g_begin = static_cast<int64_t>(blockIdx.y) * groups_per_block;
  const int64_t g_end =
      g_begin + groups_per_block < n_groups ? g_begin + groups_per_block : n_groups;

  stage_queries(q_s, q, q0, NQ, n_q, d, d_pad);
  __syncthreads();

  for (int64_t g = g_begin; g < g_end; ++g) {
    // Half h scores block queries h, h + 2, ... against row `lane` of the
    // group. score_group starts by synchronising the block, so no warp is
    // still peeling the previous group when sc_s is written below.
    float acc[QPT];
    score_group<F, THREADS, QPT, STAGES>(acc, corpus, scales, g * LANES, d, q_s + half * d_pad,
                                         2 * d_pad, tiles, t, lane, true);
#pragma unroll
    for (int j = 0; j < QPT; ++j) sc_s[(2 * j + half) * LANES + lane] = acc[j];
    __syncthreads();
    if (warp < nq_here) {
      float v[4];  // lanes wl, wl + 32, wl + 64, wl + 96 of the group
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = sc_s[warp * LANES + wl + 32 * i];
      const int64_t out0 = static_cast<int64_t>(q0 + warp) * winners * n_groups + g;
      for (int w = 0; w < winners; ++w) {
        float bv = v[0];
        int bi = wl;
#pragma unroll
        for (int i = 1; i < 4; ++i) {  // ascending lanes: strict > keeps the lowest
          if (v[i] > bv) {
            bv = v[i];
            bi = wl + 32 * i;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
          const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
          if (beats(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (wl == 0) {  // every lane holds the same winner
          gmax[out0 + w * n_groups] = bv;
          gidx[out0 + w * n_groups] = bi;
        }
        // the winner's owner masks it, by selects so that v stays in registers
        const bool owner = (bi & 31) == wl;
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = owner && i == bi / 32 ? -CUDART_INF_F : v[i];
      }
    }
  }
}

template <typename F, int QPT>
cudaError_t launch(const float* q, const void* corpus, const float* scales, float* gmax,
                   int* gidx, int n_q, int d, int64_t n_rows, int winners,
                   cudaStream_t stream) {
  using T = typename F::T;
  constexpr int NQ = 2 * QPT;
  const size_t smem = sizeof(float) * (NQ * padded_depth(d) + NQ * LANES) +
                      sizeof(T) * STAGES * tile_elems<T>();
  auto kernel = group_max_kernel<F, QPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the returned code
    return err;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // groups per block: about 8 blocks per SM in all, at most 64 groups a block,
  // and at least enough that the group ranges fit the grid's y limit
  const int64_t n_groups = n_rows / LANES;
  const int64_t q_tiles = (n_q + NQ - 1) / NQ;
  int64_t gpb = n_groups * q_tiles / (8 * static_cast<int64_t>(sms));
  gpb = std::max<int64_t>(1, std::min<int64_t>(64, gpb));
  gpb = std::max<int64_t>(gpb, (n_groups + 65534) / 65535);
  const dim3 grid(static_cast<unsigned>(q_tiles),
                  static_cast<unsigned>((n_groups + gpb - 1) / gpb));
  kernel<<<grid, THREADS, smem, stream>>>(q, static_cast<const T*>(corpus), scales, gmax, gidx,
                                          n_q, d, n_groups, winners, static_cast<int>(gpb));
  return cudaGetLastError();
}

}  // namespace

// Queries f32 [n_q, d]; corpus [n_rows, *] in the format of `kind` (as
// kirag_stream_capture's, with its `scales`), n_rows a positive multiple of
// 128; gmax f32 and gidx int32 [n_q, winners, n_rows / 128], 1 <= winners <=
// 128. qpt in {2, 4} queries per thread sets the query tile (2 * qpt queries
// per block). Returns the launch's cudaError_t.
extern "C" int kirag_group_max(const float* q, const void* corpus, int kind,
                               const float* scales, float* gmax, int* gidx, int n_q, int d,
                               long long n_rows, int winners, int qpt, void* stream) {
  if (winners < 1 || winners > LANES || n_rows <= 0 || n_rows % LANES) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_format<false>(kind, d, [&](auto fmt) {  // no pq4: approx on PQ serves exact
    using F = decltype(fmt);
    switch (qpt) {
      case 2:
        return launch<F, 2>(q, corpus, scales, gmax, gidx, n_q, d, n_rows, winners, s);
      case 4:
        return launch<F, 4>(q, corpus, scales, gmax, gidx, n_q, d, n_rows, winners, s);
      default:
        return cudaErrorInvalidValue;
    }
  });
}
