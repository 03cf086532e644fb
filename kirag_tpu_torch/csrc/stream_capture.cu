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
// What bounds it on the H100: one read of the corpus against 2 Q N D
// operations. A float corpus scores in score.cuh's fma order on the CUDA
// cores (67 GFLOP at 1M x 1024 and Q = 32, 1.0 ms at the f32 peak) against
// 4 GB of f32 (1.24 ms at 3.35 TB/s; bf16 half); tensor cores are out for it,
// since TF32 would round the products. An int8, packed-int4 or pq4 corpus
// (K4) moves 4x, 8x or (pq4 at m = D / 4) 32x fewer bytes, and its codes and
// levels are exact in bf16, so it scores on the tensor cores in score.cuh's
// mma order: at 21M x 1024 its bytes bound it up to Q = 32 (int8 6.4 ms,
// int4 3.4 ms, pq4 0.8 ms), its bf16 operations at Q = 256 (11 TFLOP, 11.1
// ms at 989 TFLOP/s), and the decode of every code for each query tile sits
// between the two (pq4: a shared-memory lookup of its level per (row,
// subspace, pair of components), D / 2 a row).
//
// What the design does about it, every format (two launches a call, cut by
// kernels/exact.py's `search_plan`):
//   1. capture_sweep_kernel: one block per (query tile of 4-32 queries,
//      chunk, range of the chunk's groups), enough blocks to fill the card at
//      any Q and corpus size. A float corpus runs score.cuh's score_passes (a
//      register tile of 4 rows x up to 8 queries a thread: 128 fmas per 12
//      shared loads at 32 queries; queries staged with the rows, 128 bytes of
//      each row at a time); an int8 or int4 corpus runs mma_passes (a warp
//      32 rows x the tile's queries on mma.sync, each code decoded once for
//      the block, 128 bytes of each row and the tile's bf16 queries a slot,
//      the scores transposed into score_passes' layout through shared
//      memory; pq4 runs pq_passes, the same with the level table and the
//      query tile in shared memory and the codes looked up to bf16), so a
//      chunk is read from HBM once for up to 32 queries.
//      Per pass it writes the clamped group maxima and keeps, for each query,
//      the scores of its range's top-`slots` groups in a scratch
//      [C, splits, Q, slots, 128] (every group when slots = its groups; else
//      a group replaces the worst held one when it beats it, by the peel's
//      order). The chunk's top-B groups of a query are among the top-B of
//      each range, so the capture is copied from scores already computed,
//      never re-scored. The scratch is at most `splits` times the capture.
//   2. peel_capture_kernel: one warp per (chunk, query) peels B groups from
//      the maxima, writes gids, capmax and resid, and copies each captured
//      group's 128 scores out of the scratch (one 16-byte vector a lane).
// Every score of a format comes from score.cuh's one order for it, so the
// capture and the fallback gather's re-scores agree bitwise, and the strict
// check `kth > resid` of the tail is taken on the values it returns.
#include <algorithm>

#include "score.cuh"

using namespace kirag;

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// strict total order of the peel: larger value first, then the lower id
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The worst of n held groups by the peel's order: the smallest maximum,
// ties to the higher group id.
__device__ __forceinline__ int worst_slot(const float* v, const int* g, int n) {
  int ws = 0;
  for (int s = 1; s < n; ++s) {
    if (beats(v[ws], g[ws], v[s], g[s])) ws = s;
  }
  return ws;
}

// Launch 1 (see the header note). Block x = (chunk * splits + split) * q_tiles
// + query tile; the range `split` holds the chunk's groups [split * gpb,
// min((split + 1) * gpb, G)). Shared memory: the ring (sweep_ring_bytes),
// then the pass's maxima [2][QT], slots [2][QT] and, when slots < gpb, the
// held maxima [QT][slots], their group ids [QT][slots] and the worst slot
// [QT]. Blocks an SM that the launch bounds promise: at bf16 and 32 queries
// the capture's epilogue and the unpacked rows need more than two blocks'
// 128 registers a thread, and ptxas would spill, so that instantiation runs
// one block an SM, as pq4 does (sweep_blocks_per_sm).
template <typename F, int J>
constexpr int capture_blocks_per_sm() {
  return std::is_same<F, BF16>::value && J == 8 ? 1 : sweep_blocks_per_sm<F, 4 * J>();
}

template <typename F, int J>
__global__ void __launch_bounds__(THREADS, (capture_blocks_per_sm<F, J>()))
    capture_sweep_kernel(const void* __restrict__ q, const void* __restrict__ corpus,
                         const float* __restrict__ scales, float* __restrict__ gmax,
                         float* __restrict__ scratch,
                         int* __restrict__ scratch_gid, int n_q, int d, int chunk_size,
                         int64_t valid_rows, int q_tiles, int splits, int gpb, int slots) {
  constexpr int QT = 4 * J;
  constexpr int NS = SWEEP_STAGES;
  extern __shared__ __align__(16) char smem_raw[];
  const int g_count = chunk_size / LANES;
  const int range = blockIdx.x / q_tiles;
  const int g_begin = range % splits * gpb;

  // What only the epilogue reads is worked out there, so that it holds no
  // register through the fma loop.
  auto epilogue = [&](int p, int live, auto& acc) {
    float* red_s = reinterpret_cast<float*>(smem_raw + sweep_ring_bytes<F, QT>(d));
    int* slot_s = reinterpret_cast<int*>(red_s + 2 * QT);
    float* held_v = reinterpret_cast<float*>(slot_s + 2 * QT);
    int* held_g = reinterpret_cast<int*>(held_v + QT * slots);
    int* worst_s = held_g + QT * slots;
    const int t = threadIdx.x;
    const int w = t / 32;
    const int lane = t % 32;
    const int q0 = (blockIdx.x % q_tiles) * QT;
    const int chunk = range / splits;
    const bool keep_best = slots < gpb;  // else every group of the range has its slot
    const int64_t chunk_row0 = static_cast<int64_t>(chunk) * chunk_size;
    const int64_t held0 = (static_cast<int64_t>(range) * n_q + q0) * slots;  // (range, q0, 0)
    const int gl_me = w / 4;  // this warp's group of the pass, and its queries
    float* red_me = red_s + gl_me * QT + (w % 4) * J;
    if (gl_me < live) {
      pass_warp_maxima<J>(acc, chunk_row0 + (g_begin + 2 * p + gl_me) * static_cast<int64_t>(LANES),
                          valid_rows, [&](int j, float m) { red_me[j] = m; });
    }
    __syncthreads();
    if (t < QT) {  // tile query t: maxima, then its held groups, in group order
      int prev = -1;
      for (int gl = 0; gl < live; ++gl) {
        const int local = 2 * p + gl;  // group index within the range
        const int g = g_begin + local;
        int slot = -1;
        if (q0 + t < n_q) {
          const float m = fmaxf(red_s[gl * QT + t], FIN_MIN);
          gmax[(static_cast<int64_t>(chunk) * g_count + g) * n_q + q0 + t] = m;
          float* hv = held_v + t * slots;
          int* hg = held_g + t * slots;
          if (!keep_best) {
            slot = local;
          } else if (local < slots) {
            slot = local;
            hv[slot] = m;
            hg[slot] = g;
            if (local == slots - 1) worst_s[t] = worst_slot(hv, hg, slots);
          } else if (beats(m, g, hv[worst_s[t]], hg[worst_s[t]])) {
            slot = worst_s[t];
            hv[slot] = m;
            hg[slot] = g;
            worst_s[t] = worst_slot(hv, hg, slots);
          }
          if (keep_best && slot >= 0) {
            scratch_gid[held0 + static_cast<int64_t>(t) * slots + slot] = g;
          }
        }
        if (slot >= 0 && slot == prev) slot_s[t] = -1;  // group 1 took group 0's slot
        slot_s[gl * QT + t] = slot;
        prev = slot;
      }
    }
    __syncthreads();
    if (gl_me < live) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int lq = (w % 4) * J + j;
        const int slot = slot_s[gl_me * QT + lq];
        if (slot >= 0) {
          float* dst = scratch + (held0 + static_cast<int64_t>(lq) * slots + slot) * LANES + lane;
#pragma unroll
          for (int i = 0; i < PASS_R; ++i) dst[32 * i] = acc[i][j];
        }
      }
    }
  };
  sweep_passes<F, J, NS>(corpus, scales,
                         static_cast<int64_t>(range / splits) * chunk_size +
                             static_cast<int64_t>(g_begin) * LANES,
                         min(gpb, g_count - g_begin), q, (blockIdx.x % q_tiles) * QT, n_q, d,
                         smem_raw, epilogue);
}

// Launch 2 (see the header note). Block (chunk, y): warp w peels query
// y * qpb + w. Shared memory: the maxima [qpb][G], then the picks [qpb][b].
__global__ void __launch_bounds__(THREADS)
    peel_capture_kernel(const float* __restrict__ gmax, const float* __restrict__ scratch,
                        const int* __restrict__ scratch_gid, float* __restrict__ capture,
                        int* __restrict__ gids, float* __restrict__ capmax,
                        float* __restrict__ resid, int n_q, int g_count, int b, int splits,
                        int gpb, int slots, int qpb) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int wl = threadIdx.x % 32;
  const int chunk = blockIdx.x;
  const int lq = blockIdx.y * qpb + warp;
  if (warp >= qpb || lq >= n_q) return;  // no block barrier below
  float* row = smem + warp * g_count;
  int* sel = reinterpret_cast<int*>(smem + qpb * g_count) + warp * b;
  for (int g = wl; g < g_count; g += 32) {
    row[g] = gmax[(static_cast<int64_t>(chunk) * g_count + g) * n_q + lq];
  }
  __syncwarp();
  // peeled entries become -inf; every live entry is >= FIN_MIN, so the
  // marker never ties one, and what is left afterwards is the residual
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
      sel[bi] = bidx;
      const int64_t o = (static_cast<int64_t>(chunk) * b + bi) * n_q + lq;
      gids[o] = chunk * g_count + bidx;
      capmax[o] = bv;
      row[bidx] = -CUDART_INF_F;
    }
    __syncwarp();
  }
  float r = -CUDART_INF_F;
  for (int g = wl; g < g_count; g += 32) r = fmaxf(r, row[g]);
  for (int o = 16; o > 0; o >>= 1) r = fmaxf(r, __shfl_xor_sync(FULL_MASK, r, o));
  if (wl == 0) resid[static_cast<int64_t>(chunk) * n_q + lq] = r;

  // copy each pick's 128 scores from its range's held slot, a vector a lane
  bool lost = false;
  for (int bi = 0; bi < b; ++bi) {
    const int g = sel[bi];
    const int split = g / gpb;
    const int64_t held = ((static_cast<int64_t>(chunk) * splits + split) * n_q + lq) * slots;
    int slot = g - split * gpb;
    if (slots < gpb) {  // find the slot that holds g (it is there: see the header note)
      slot = -1;
      for (int s0 = 0; s0 < slots && slot < 0; s0 += 32) {
        const unsigned hit =
            __ballot_sync(FULL_MASK, s0 + wl < slots && scratch_gid[held + s0 + wl] == g);
        if (hit) slot = s0 + __ffs(hit) - 1;
      }
      lost = lost || slot < 0;
    }
    const float4 v = slot >= 0
                         ? reinterpret_cast<const float4*>(scratch + (held + slot) * LANES)[wl]
                         : make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
    reinterpret_cast<float4*>(capture + ((static_cast<int64_t>(chunk) * n_q + lq) * b + bi) *
                                            LANES)[wl] = v;
  }
  // a pick with no held slot: a broken scratch fails the call (a trap inside
  // the loop slowed the one-chunk b = 128 peel by 9%, PERF.md §6)
  if (lost) __trap();
}

template <typename F, int J>
cudaError_t launch_sweep(const void* q, const void* corpus, const float* scales, float* gmax,
                         float* capture, int* gids, float* capmax, float* resid,
                         float* scratch, int* scratch_gid, int n_q, int d, int num_chunks,
                         int chunk_size, int b, int64_t valid_rows, int splits, int gpb,
                         int slots, int plan_smem, cudaStream_t stream) {
  constexpr int QT = 4 * J;
  const int g_count = chunk_size / LANES;
  const size_t smem =
      static_cast<size_t>(sweep_ring_bytes<F, QT>(d)) + sizeof(float) * 2 * QT + sizeof(int) * 2 * QT +
      (slots < gpb ? (sizeof(float) + sizeof(int)) * QT * slots + sizeof(int) * QT : 0);
  if (!sweep_cut_fits(g_count, splits, gpb) || slots != std::min(b, gpb) ||
      (slots < gpb && scratch_gid == nullptr) || smem != static_cast<size_t>(plan_smem)) {
    return cudaErrorInvalidValue;
  }
  const int q_tiles = (n_q + QT - 1) / QT;
  const int64_t blocks = static_cast<int64_t>(q_tiles) * num_chunks * splits;
  const int peel_qpb =
      std::min(8, static_cast<int>(232448 / (sizeof(float) * (g_count + b))));
  if (blocks > 0x7fffffff || peel_qpb < 1) return cudaErrorInvalidValue;
  auto sweep = capture_sweep_kernel<F, J>;
  cudaError_t err = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    sweep<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
        q, corpus, scales, gmax, scratch, scratch_gid, n_q, d, chunk_size, valid_rows, q_tiles,
        splits, gpb, slots);
    err = cudaGetLastError();
  }
  const size_t peel_smem = sizeof(float) * peel_qpb * (g_count + b);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(peel_capture_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(peel_smem));
  }
  if (err == cudaSuccess) {
    const dim3 grid(num_chunks, (n_q + peel_qpb - 1) / peel_qpb);
    peel_capture_kernel<<<grid, THREADS, peel_smem, stream>>>(
        gmax, scratch, scratch_gid, capture, gids, capmax, resid, n_q, g_count, b, splits, gpb,
        slots, peel_qpb);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the caller raises on the code
  return err;
}

}  // namespace

// Queries [n_q, d], f32 for float32 and bfloat16 corpora and bf16 for the
// others; corpus [num_chunks * chunk_size, *] in the format of `kind` (0
// float32 [., d], 1 bfloat16 [., d], 2 int8 [., d] with f32 row scales
// [rows], 3 packed int4 [., d / 2] with f32 block scales [rows, d / 128], 4 +
// log2(d / m) 4-bit PQ codes [., m / 2] with the bf16 level table in
// score.cuh's pq_table_bytes layout; `scales` is null for 0 and 1); outputs
// as in the header note. search_plan's cut: q_tile in {4, 8, 16, 32}
// queries a block, each chunk's G groups in `splits` ranges of `gpb`,
// `slots` = min(b, gpb), and the scratch f32 [num_chunks * splits, n_q,
// slots, 128] with, when slots < gpb, its group ids int32 [num_chunks *
// splits, n_q, slots] (else null), and `smem` the plan's shared memory of a
// sweep block; a cut that does not cover the call, or whose `smem` is not
// the launch's own, is refused. Returns the first launch error.
extern "C" int kirag_stream_capture(const void* q, const void* corpus, int kind,
                                    const float* scales, float* gmax, float* capture, int* gids,
                                    float* capmax, float* resid, float* scratch,
                                    int* scratch_gid, int n_q, int d, int num_chunks,
                                    int chunk_size, int b, long long valid_rows, int q_tile,
                                    int splits, int gpb, int slots, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_format(kind, d, [&](auto fmt) {
    using F = decltype(fmt);
    return with_query_tile(q_tile, [&](auto j) {
      return launch_sweep<F, decltype(j)::value>(q, corpus, scales, gmax, capture, gids, capmax,
                                                 resid, scratch, scratch_gid, n_q, d, num_chunks,
                                                 chunk_size, b, valid_rows, splits, gpb, slots,
                                                 smem, s);
    });
  });
}

extern "C" const char* kirag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
