// gather_groups: re-score each query's selected 128-row groups.
//
// Replaces the TPU kernel kirag_tpu/ops/pallas_exact.py::_gather_kernel
// (launched by _twopass_gather, the exact fallback of the stream search), over
// a float32, bfloat16, int8, packed-int4 or 4-bit PQ corpus (K4's scoring,
// score.cuh).
// For queries [Q, D] and group ids gsel [Q, k] it writes
// cand[q, j, l] = score(q, row gsel[q, j] * 128 + l). A group id outside the
// corpus gives zeros, as the reference's one-hot accumulation does.
//
// What bounds it on the H100: the selected groups' rows, each distinct group
// once, and the products (Q k 128 D). The reference instead re-read the whole
// corpus and multiplied by a one-hot matrix; here only the selected rows are
// read. An int8 or int4 corpus reads 4x or 8x fewer bytes for the same
// products. Queries of one batch often select the same groups (on a corpus
// of 128 groups, 64 queries select about 50 each): read once a group, the
// bytes fall by that factor and the products bound the call.
//
// What the design does about it, float32 and bfloat16 corpora
// (gather_float_kernel): a block owns two (query, slot) pairs of the flat
// [Q * k] list, and its warps scan the pairs of the block's window of 32
// queries for the other pairs that selected each owned pair's group. A
// group's pairs in a window, in list order, form tiles of up to 32; the
// block that owns a tile's first pair scores the group once against the
// tile's queries and scatters the scores to their pairs, so every pair is
// written once. Those first pairs lie mostly in a window's first queries,
// so the windows' blocks are launched in turns, first queries first. The
// scoring is score_passes' (score.cuh): two groups a pass, 4 rows x J
// queries in each thread's registers (J = 1, 2, 4, 8 by the larger tile;
// warps past a tile's queries idle), rows and the tiles' queries streamed
// through the same cp.async ring of 128-byte row slots, each pair's fma
// chain over the padded_depth(d) columns in column order, so the scores are
// bitwise K1's. int8, int4 and pq4 corpora: one block per (query, 2 slots),
// the two groups one pass of K1's own scoring (mma_passes; pq4: pq_passes,
// the block copying the level table and the query first), with the query in
// column 0 of the n8 tile (the other columns zero), each warp 32 rows of a
// group.
//
// score_probe_kernel and pq_probe_kernel (kirag_score_probe) are the mma
// order on its own, one warp scoring 32 rows against 8 queries, for the
// card's tests of it.
#include "score.cuh"

using namespace kirag;

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int FLOAT_PAIRS = 2;               // pairs a block owns: one pass, a group each
constexpr int TILE_QUERIES = 32;             // a tile's pairs (J = 8), a window's queries
constexpr int SCAN_WARPS = THREADS / 32;
constexpr int SCAN_KEEP = TILE_QUERIES - 1;  // later pairs of a group a warp keeps
constexpr int SCAN_INTS = 2 + SCAN_KEEP;     // a warp's pair: earlier, later, the later list

template <typename T>
__host__ __device__ constexpr int gather_stage_bytes() {
  return pass_stage_bytes<T, FLOAT_PAIRS * TILE_QUERIES>();
}

// One slot of the ring: columns [c0, c0 + SC) of the rows of each tile's
// group g[u] (rows [128 u, 128 u + 128)) and of its queries (tile u's pair m
// in query row 32 u + m, m < qrows; zeros past the tile).
template <typename T>
__device__ __forceinline__ void issue_gather_stage(char* slot, const T* __restrict__ corpus,
                                                   const float* __restrict__ q, const int* g,
                                                   int (*members)[TILE_QUERIES],
                                                   const int* n_members, int tiles, int qrows,
                                                   int d, int k, int c0, int t) {
  constexpr int SC = sweep_cols<T>();
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = SC / VEC;
  constexpr int RPI = THREADS / VPR;
  T* ctile = reinterpret_cast<T*>(slot);
  float* qtile = reinterpret_cast<float*>(slot + pass_corpus_bytes<T>());
  const int r0 = t / VPR;
  const int v = (t % VPR) * VEC;
  const bool col_ok = c0 + v < d;
#pragma unroll
  for (int m = 0; m < PASS_ROWS / RPI; ++m) {
    const int r = r0 + m * RPI;
    const int u = r / LANES;
    if (u < tiles) {
      const T* src = corpus + (static_cast<int64_t>(g[u]) * LANES + r % LANES) * d + c0 + v;
      cp_async16(ctile + r * sweep_row_stride<T>() + v, col_ok ? src : corpus, col_ok);
    }
  }
  constexpr int QV = SC / 4;
  for (int i = t; i < tiles * qrows * QV; i += THREADS) {
    const int r = i / QV;
    const int u = r / qrows, m = r % qrows;
    const int qv = (i % QV) * 4;
    const bool valid = m < n_members[u] && c0 + qv < d;
    const float* src = valid ? q + static_cast<int64_t>(members[u][m] / k) * d + c0 + qv : q;
    cp_async16(qtile + (u * TILE_QUERIES + m) * sweep_q_stride<T>() + qv, src, valid);
  }
}

// Score the block's tiles (one pass) at J queries a thread and scatter.
template <typename T, int J>
__device__ __forceinline__ void gather_pass(const T* __restrict__ corpus,
                                            const float* __restrict__ q,
                                            float* __restrict__ cand, const int* g,
                                            int (*members)[TILE_QUERIES],
                                            const int* n_members, int tiles, int d, int k,
                                            char* ring) {
  constexpr int SC = sweep_cols<T>();
  constexpr int NS = SWEEP_STAGES;
  constexpr int STAGE = gather_stage_bytes<T>();
  const int t = threadIdx.x;
  const int w = t / 32;
  const int u = w / 4;                          // the warp's tile
  const int my_row = u * LANES + t % 32;        // its rows 32 i + lane of the tile's group
  const int my_q = u * TILE_QUERIES + (w % 4) * J;
  const bool busy = u < tiles && (w % 4) * J < n_members[u];  // a warp past the tile's pairs
  const int d_pad = padded_depth(d);
  const int n_tiles = (d_pad + SC - 1) / SC;
  const int last_cols = d_pad - (n_tiles - 1) * SC;
  auto issue = [&](int it) {
    if (it < n_tiles) {
      issue_gather_stage<T>(ring + (it % NS) * STAGE, corpus, q, g, members, n_members, tiles,
                            4 * J, d, k, it * SC, t);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);
  float acc[PASS_R][J];
#pragma unroll
  for (int i = 0; i < PASS_R; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    issue(it + NS - 1);
    if (busy) {
      fma_pass_tile<T, J, 4 * J>(acc, ring + (it % NS) * STAGE,
                                 it + 1 < n_tiles ? SC : last_cols, my_row, my_q);
    }
  }
  if (!busy) return;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int m = (w % 4) * J + j;
    if (m < n_members[u]) {
      float* dst = cand + static_cast<int64_t>(members[u][m]) * LANES + t % 32;
#pragma unroll
      for (int i = 0; i < PASS_R; ++i) dst[32 * i] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, SWEEP_BLOCKS_PER_SM)
    gather_float_kernel(const float* __restrict__ q, const T* __restrict__ corpus,
                        const int* __restrict__ gsel, float* __restrict__ cand, int n_q, int d,
                        int k, int64_t n_groups) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ int members[FLOAT_PAIRS][TILE_QUERIES];
  __shared__ int n_members[FLOAT_PAIRS];
  __shared__ int tile_group[FLOAT_PAIRS];
  __shared__ int n_tiles_s;
  const int t = threadIdx.x;
  const int w = t / 32;
  const int lane = t % 32;
  const int n_pairs = n_q * k;
  // windows of TILE_QUERIES queries, taken in turns: the blocks of every
  // window's first queries, whose pairs start the tiles, run first
  const int n_win = (n_q + TILE_QUERIES - 1) / TILE_QUERIES;
  const int win = blockIdx.x % n_win;
  const int lo = win * TILE_QUERIES * k;                 // the window's pairs: [lo, hi)
  const int hi = min(n_pairs, lo + TILE_QUERIES * k);
  const int p0 = lo + blockIdx.x / n_win * FLOAT_PAIRS;
  if (p0 >= hi) return;
  int own_g[FLOAT_PAIRS];
  bool own_in[FLOAT_PAIRS];
#pragma unroll
  for (int i = 0; i < FLOAT_PAIRS; ++i) {
    const int p = p0 + i;
    own_g[i] = p < hi ? gsel[p] : -1;
    own_in[i] = p < hi && own_g[i] >= 0 && own_g[i] < n_groups;
  }
  if (w < FLOAT_PAIRS && p0 + w < hi && !own_in[w]) {  // outside the corpus: zeros
    reinterpret_cast<float4*>(cand + static_cast<int64_t>(p0 + w) * LANES)[lane] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the scan of the window: warp w's stretch, its pairs of each owned pair's
  // group before the owned pair (counted) and after it (counted, the first
  // SCAN_KEEP kept in list order)
  int* scan = reinterpret_cast<int*>(smem_raw);  // [warp][pair][SCAN_INTS], in the ring
  {
    const int stretch = (hi - lo + SCAN_WARPS * 32 - 1) / (SCAN_WARPS * 32) * 32;
    const int s_lo = lo + w * stretch, s_hi = min(hi, s_lo + stretch);
    int before[FLOAT_PAIRS] = {}, after[FLOAT_PAIRS] = {};
    constexpr int UNROLL = 4;
    for (int base = s_lo; base < s_hi; base += 32 * UNROLL) {
      int gv[UNROLL];
#pragma unroll
      for (int x = 0; x < UNROLL; ++x) {
        const int p = base + 32 * x + lane;
        gv[x] = p < s_hi ? gsel[p] : -1;
      }
#pragma unroll
      for (int x = 0; x < UNROLL; ++x) {
        const int p = base + 32 * x + lane;
#pragma unroll
        for (int i = 0; i < FLOAT_PAIRS; ++i) {
          if (!own_in[i]) continue;
          const bool match = gv[x] == own_g[i];
          before[i] += __popc(__ballot_sync(FULL_MASK, match && p < p0 + i));
          const unsigned later = __ballot_sync(FULL_MASK, match && p > p0 + i);
          const int at = after[i] + __popc(later & ((1u << lane) - 1));
          if (match && p > p0 + i && at < SCAN_KEEP) {
            scan[(w * FLOAT_PAIRS + i) * SCAN_INTS + 2 + at] = p;
          }
          after[i] += __popc(later);
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < FLOAT_PAIRS; ++i) {
        scan[(w * FLOAT_PAIRS + i) * SCAN_INTS] = before[i];
        scan[(w * FLOAT_PAIRS + i) * SCAN_INTS + 1] = after[i];
      }
    }
  }
  __syncthreads();
  // the tiles this block scores: an owned pair whose place among its group's
  // pairs in the window is a multiple of TILE_QUERIES starts one, with the
  // pairs after it
  if (t == 0) {
    int tiles = 0;
    for (int i = 0; i < FLOAT_PAIRS; ++i) {
      if (!own_in[i]) continue;
      int place = 0, later = 0;
      for (int x = 0; x < SCAN_WARPS; ++x) {
        place += scan[(x * FLOAT_PAIRS + i) * SCAN_INTS];
        later += scan[(x * FLOAT_PAIRS + i) * SCAN_INTS + 1];
      }
      if (place % TILE_QUERIES != 0) continue;
      const int n = min(TILE_QUERIES, later + 1);
      members[tiles][0] = p0 + i;
      for (int x = 0, m = 1; x < SCAN_WARPS && m < n; ++x) {
        const int* s = scan + (x * FLOAT_PAIRS + i) * SCAN_INTS;
        for (int y = 0; y < min(s[1], SCAN_KEEP) && m < n; ++y) members[tiles][m++] = s[2 + y];
      }
      n_members[tiles] = n;
      tile_group[tiles] = own_g[i];
      ++tiles;
    }
    n_tiles_s = tiles;
  }
  __syncthreads();
  const int tiles = n_tiles_s;
  if (tiles == 0) return;
  const int widest = tiles > 1 ? max(n_members[0], n_members[1]) : n_members[0];
  char* ring = smem_raw;
  if (widest <= 4) {
    gather_pass<T, 1>(corpus, q, cand, tile_group, members, n_members, tiles, d, k, ring);
  } else if (widest <= 8) {
    gather_pass<T, 2>(corpus, q, cand, tile_group, members, n_members, tiles, d, k, ring);
  } else if (widest <= 16) {
    gather_pass<T, 4>(corpus, q, cand, tile_group, members, n_members, tiles, d, k, ring);
  } else {
    gather_pass<T, 8>(corpus, q, cand, tile_group, members, n_members, tiles, d, k, ring);
  }
}

template <typename T>
cudaError_t launch_float(const float* q, const void* corpus, const int* gsel, float* cand,
                         int n_q, int d, int k, int64_t n_rows, cudaStream_t stream) {
  const int64_t n_pairs = static_cast<int64_t>(n_q) * k;
  if (n_pairs >= (int64_t{1} << 31) / LANES) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(SWEEP_STAGES) * gather_stage_bytes<T>();
  auto kernel = gather_float_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  // a block a pair of pairs; with several windows, every window gets as many
  // blocks as a whole one needs (the last one's extra blocks return at once)
  const int n_win = (n_q + TILE_QUERIES - 1) / TILE_QUERIES;
  const int64_t per_win = n_win > 1 ? int64_t{TILE_QUERIES} * k / FLOAT_PAIRS
                                     : (n_pairs + FLOAT_PAIRS - 1) / FLOAT_PAIRS;
  kernel<<<static_cast<unsigned>(n_win * per_win), THREADS, smem, stream>>>(
      q, static_cast<const T*>(corpus), gsel, cand, n_q, d, k, n_rows / LANES);
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
      return launch_float<typename F::T>(static_cast<const float*>(q), corpus, gsel, cand, n_q,
                                         d, k, n_rows, s);
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
