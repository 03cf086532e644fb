// group_max: the W best rows of every 128-row group, for each query (K5).
//
// Replaces the TPU kernel kirag_tpu/ops/pallas_mips.py::_group_max_kernel
// (launched by grouped_max_scores, the scoring pass of approx_topk_mips) over a
// float32, bfloat16, int8 or packed-int4 corpus (K4's scoring, score.cuh). For
// queries [Q, D] and a corpus of G groups of 128 rows it finds, for each query
// and group, the group's W largest scores, descending, and their lanes (row -
// 128 g), as the reference finds them: W rounds of a masked maximum, ties to
// the lowest lane, each winner set to -inf before the next round. Every row is
// scored, zero pad rows too; the caller masks rows past its valid count after
// the peel, as the reference does (pallas_mips.py:198-200).
//
// What bounds it on the H100: the same scoring as K1 (2 Q N D operations:
// float corpora on the CUDA cores, since TF32 would round the products;
// int8 and int4 ones on the tensor cores, their codes exact in bf16) against
// one read of the corpus (4 GB f32 at 1M x 1024: 1.2 ms at 3.35 TB/s, the
// fmas 1.0 ms at Q = 32 at the f32 peak; an int4 corpus at 21M x 1024,
// 11.4 GB: 3.4 ms); the peel adds W rounds of a warp argmax per group and
// query, which at W = 1 is under 1% of the scoring and at W = 128 more than
// the scoring.
//
// What the design does about it: K7a's sweep (score_gmax.cu) with the peel
// in place of the store. One block per (query tile of 4-32 queries, range
// of groups), the whole corpus one chunk, cut by kernels/exact.py's
// search_plan, scoring through score.cuh's sweep_passes (float32 and
// bfloat16: score_passes, a register tile of 4 rows x up to 8 queries a
// thread; int8 and int4: mma_passes on the tensor cores, the scores
// transposed into the same layout), so a corpus row is read from HBM once
// for up to 32 queries. After each pass lane l of warp w holds
// rows l + 32 i of its group for its J queries, the peel's own layout, so each
// warp peels its group in registers: no score leaves the registers and the
// epilogue adds no barrier. Up to PEEL_MAX_WINNERS winners it runs the
// reference's rounds (a warp argmax each: two redux.sync over order keys);
// above, one bitonic sort of the 128 (score, lane) pairs by the peel's order,
// whose first W places are the rounds' winners (once only -inf is left the
// rounds return lane 0, and so does the sort's tail). Winners go out
// [Q, G, W], a query's W of a group in consecutive words (the wrapper returns
// the [Q, W, G] view; storing [Q, W, G] took 2.3x as long at W = 128). Every
// score comes from score.cuh's one order for its format, so the scores are
// bitwise K1's and K2's.
#include "score.cuh"

using namespace kirag;

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// the peel's strict order: larger value first, then the lower lane
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// ------------------------------------------------ the sweep

// Winners a group up to which the float sweep runs the reference's rounds;
// above it one sort of the group's 128 pairs does. On an H100 at 1M x 1024,
// Q = 32, a round costs 0.017-0.020 ms and the sort 0.46-0.51 ms, so they
// cross near W = 27 (PERF.md §6).
constexpr int PEEL_MAX_WINNERS = 24;
static_assert(PASS_R * 32 == LANES, "a warp holds one whole group");

// A score as an unsigned key in the peel's value order: -0 as +0 (they tie),
// the sign flipped so that unsigned order is float order.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f + 0.f);  // -0 + +0 is +0, every other value stays
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The reference's W rounds over one warp's group, lane l holding v[i], the
// score of lane l + 32 i. A round: each lane's best key (ascending lanes, so
// a strict > keeps the lowest), the warp's largest by one redux.sync, the
// lowest lane holding it by another, and its owner masks it to -inf's key.
// Round r's winner is kept by lane r % 32, and every 32 rounds the kept
// winners go out as one run of consecutive words (gmax[r], gidx[r]: the
// group's r-th), each value read back from its row's register (-inf once
// only -inf is left, as the reference's masked rows give).
__device__ __forceinline__ void peel_rounds(const float (&v)[PASS_R], int winners,
                                            float* __restrict__ gmax, int* __restrict__ gidx) {
  const int lane = threadIdx.x % 32;
  const unsigned masked = order_key(-CUDART_INF_F);
  unsigned key[PASS_R];
#pragma unroll
  for (int i = 0; i < PASS_R; ++i) key[i] = order_key(v[i]);
  unsigned kept_k = masked;
  int kept_i = 0;
  for (int r = 0; r < winners; ++r) {
    unsigned bk = key[0];
    int bi = lane;
#pragma unroll
    for (int i = 1; i < PASS_R; ++i) {
      if (key[i] > bk) {
        bk = key[i];
        bi = lane + 32 * i;
      }
    }
    const unsigned top = __reduce_max_sync(FULL_MASK, bk);
    const int win = static_cast<int>(
        __reduce_min_sync(FULL_MASK, bk == top ? static_cast<unsigned>(bi) : 128u));
    if (lane == r % 32) {
      kept_k = top;
      kept_i = win;
    }
    if (r % 32 == 31 || r + 1 == winners) {
      float val = -CUDART_INF_F;  // the kept winner's score, from the lane that holds its row
#pragma unroll
      for (int i = 0; i < PASS_R; ++i) {
        const float vi = __shfl_sync(FULL_MASK, v[i], kept_i & 31);
        val = kept_i / 32 == i ? vi : val;
      }
      const int first = r - r % 32;
      if (lane <= r % 32) {
        gmax[first + lane] = kept_k == masked ? -CUDART_INF_F : val;
        gidx[first + lane] = kept_i;
      }
    }
    const bool owner = (win & 31) == lane;
#pragma unroll
    for (int i = 0; i < PASS_R; ++i) key[i] = owner && i == win / 32 ? masked : key[i];
  }
}

// One compare-exchange of a bitonic stage k inside a thread: places
// 4 lane + A < 4 lane + B end with the better pair (beats) first where the
// lower place has bit k clear, last where it has it set.
template <int A, int B>
__device__ __forceinline__ void order_pair(float (&v)[PASS_R], int (&id)[PASS_R], int k,
                                           int lane) {
  if (beats(v[B], id[B], v[A], id[A]) == (((4 * lane + A) & k) == 0)) {
    const float tv = v[A];
    const int ti = id[A];
    v[A] = v[B];
    id[A] = id[B];
    v[B] = tv;
    id[B] = ti;
  }
}

// The same W winners as peel_rounds by one bitonic sort of the group's 128
// (score, lane) pairs into the peel's order (larger score first, then the
// lower lane): the rounds take the pairs in that order while a score above
// -inf is left, and from then on return -inf at lane 0 (every score is -inf,
// peeled ones too), so the sort's -inf places report lane 0. Register i of
// lane l is place 4 l + i, so distances 1 and 2 stay inside a thread and 4-64
// are one shuffle each (15 of the network's 28 steps, not 25 with places
// l + 32 i); places 4 l .. 4 l + 3 go out as four consecutive words.
__device__ __forceinline__ void sort_winners(float (&v)[PASS_R], int winners,
                                             float* __restrict__ gmax, int* __restrict__ gidx) {
  const int lane = threadIdx.x % 32;
  int id[PASS_R];
#pragma unroll
  for (int i = 0; i < PASS_R; ++i) id[i] = lane + 32 * i;  // the row, wherever it sits
#pragma unroll 1
  for (int k = 2; k <= LANES; k *= 2) {
#pragma unroll 1
    for (int jj = k / 2; jj > 0; jj /= 2) {
      if (jj == 2) {
        order_pair<0, 2>(v, id, k, lane);
        order_pair<1, 3>(v, id, k, lane);
      } else if (jj == 1) {
        order_pair<0, 1>(v, id, k, lane);
        order_pair<2, 3>(v, id, k, lane);
      } else {  // the partner place e ^ jj is lane ^ (jj / 4)'s register i
#pragma unroll
        for (int i = 0; i < PASS_R; ++i) {
          const int e = 4 * lane + i;
          const float ov = __shfl_xor_sync(FULL_MASK, v[i], jj / 4);
          const int oi = __shfl_xor_sync(FULL_MASK, id[i], jj / 4);
          // this place keeps the better of the two where (e & jj == 0) == (e & k == 0)
          if (beats(ov, oi, v[i], id[i]) == (((e & jj) == 0) == ((e & k) == 0))) {
            v[i] = ov;
            id[i] = oi;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PASS_R; ++i) {
    const int r = 4 * lane + i;
    if (r < winners) {
      gmax[r] = v[i];
      gidx[r] = v[i] == -CUDART_INF_F ? 0 : id[i];
    }
  }
}

// Block x = range * q_tiles + query tile; the range holds the groups
// [range * gpb, min((range + 1) * gpb, n_groups)). Shared memory: the ring.
template <typename F, int J>
__global__ void __launch_bounds__(THREADS, SWEEP_BLOCKS_PER_SM)
    group_max_sweep_kernel(const void* __restrict__ q, const void* __restrict__ corpus,
                           const float* __restrict__ scales, float* __restrict__ gmax,
                           int* __restrict__ gidx, int n_q, int d,
                           int n_groups, int winners, int q_tiles, int gpb) {
  constexpr int QT = 4 * J;
  extern __shared__ __align__(16) char smem_raw[];
  const int g_begin = blockIdx.x / q_tiles * gpb;
  const int tile_q0 = blockIdx.x % q_tiles * QT;

  auto epilogue = [&](int p, int live, auto& acc) {
    const int w = threadIdx.x / 32;
    if (w / 4 >= live) return;             // no block barrier here
    const int g = g_begin + 2 * p + w / 4;  // this warp's group
    const int q0 = tile_q0 + (w % 4) * J;   // and its first query
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (q0 + j >= n_q) break;  // the same in every lane of the warp
      const int64_t out = (static_cast<int64_t>(q0 + j) * n_groups + g) * winners;
      float v[PASS_R];
#pragma unroll
      for (int i = 0; i < PASS_R; ++i) v[i] = acc[i][j];
      if (winners <= PEEL_MAX_WINNERS) {
        peel_rounds(v, winners, gmax + out, gidx + out);
      } else {
        sort_winners(v, winners, gmax + out, gidx + out);
      }
    }
  };
  sweep_passes<F, J, SWEEP_STAGES>(corpus, scales, static_cast<int64_t>(g_begin) * LANES,
                                   min(gpb, n_groups - g_begin), q, tile_q0, n_q, d, smem_raw,
                                   epilogue);
}

template <typename F, int J>
cudaError_t launch_sweep(const void* q, const void* corpus, const float* scales, float* gmax,
                         int* gidx, int n_q, int d, int n_groups, int winners, int splits,
                         int gpb, int plan_smem, cudaStream_t stream) {
  constexpr int QT = 4 * J;
  const size_t smem = static_cast<size_t>(SWEEP_STAGES) * sweep_stage_bytes<F, QT>();
  if (!sweep_cut_fits(n_groups, splits, gpb) || smem != static_cast<size_t>(plan_smem)) {
    return cudaErrorInvalidValue;
  }
  const int q_tiles = (n_q + QT - 1) / QT;
  const int64_t blocks = static_cast<int64_t>(q_tiles) * splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = group_max_sweep_kernel<F, J>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the returned code
    return err;
  }
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      q, corpus, scales, gmax, gidx, n_q, d, n_groups, winners, q_tiles, gpb);
  return cudaGetLastError();
}

}  // namespace

// Queries [n_q, d] (f32, or bf16 for int8 and int4 corpora); corpus
// [n_rows, *] in the format of `kind` (as kirag_stream_capture's, with its
// `scales`; no pq4), n_rows a positive multiple of 128; 1 <= winners <= 128.
// search_plan's cut of one chunk of n_rows / 128 groups (q_tile, splits, gpb,
// smem, as kirag_score_gmax's); writes gmax f32 and gidx int32 [n_q,
// n_rows / 128, winners]. Returns the launch's cudaError_t.
extern "C" int kirag_group_max(const void* q, const void* corpus, int kind,
                               const float* scales, float* gmax, int* gidx, int n_q, int d,
                               long long n_rows, int winners, int q_tile, int splits, int gpb,
                               int smem, void* stream) {
  if (winners < 1 || winners > LANES || n_rows <= 0 || n_rows % LANES ||
      n_rows / LANES > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_groups = static_cast<int>(n_rows / LANES);
  return with_format<false>(kind, d, [&](auto fmt) {  // no pq4: approx on PQ serves exact
    using F = decltype(fmt);
    return with_query_tile(q_tile, [&](auto j) {
      return launch_sweep<F, decltype(j)::value>(q, corpus, scales, gmax, gidx, n_q, d, n_groups,
                                                 winners, splits, gpb, smem, s);
    });
  });
}
