// flash_attention_bwd: the two backward kernels of the encoder's segment-id
// flash attention (flash_attention.cu), head_dim 64.
//
// Replace the TPU kernels of the Pallas flash attention's custom_vjp, which
// kirag_tpu/models/bert.py::_flash_attention reaches when the aligner trainer
// differentiates the encoder (jax/experimental/pallas/ops/tpu/
// flash_attention.py): _flash_attention_dkv_kernel (dK, dV; :796) and
// _flash_attention_dq_kernel (dQ; :1146). For q, k, v, dO [B, H, T, 64],
// seg [B, T], the forward's lse = m + log(l) and di = rowsum(o * dO) (both
// f32 [B, H, T], di computed outside, as the reference does) they compute,
// over the pairs (i, j) with seg[j] == seg[i]:
//
//     P[i, j]  = exp(sm_scale * q_i . k_j - lse_i)        (0 for other segments)
//     dS[i, j] = P[i, j] * (dO_i . v_j - di_i) * sm_scale
//     dV = P^T dO,   dK = dS^T Q,   dQ = dS K
//
// with f32 logits and accumulators; for bf16 inputs P and dS are rounded to
// bf16 before their products (the reference's p.astype(do.dtype) and
// ds.astype(k.dtype)) and the outputs are bf16.
//
// What bounds them on the H100: operations and bytes alike. Per
// same-segment (query, key) pair and head, dK/dV does 8 * 64 operations (it
// recomputes S = Q K^T and dP = dO V^T, then P^T dO and dS^T Q) and dQ 6 * 64
// (S, dP, dS K): at the aligner's query batch ([32, 16, 256, 64], every
// token real) 17 and 13 GFLOP, 0.017 and 0.013 ms at 989 TFLOP/s (bf16), or
// 0.10 and 0.08 ms at 165 TFLOP/s (f32-grade products as split TF32, below),
// against 0.10 and 0.09 GB of bf16 inputs and outputs, 0.030 and 0.026 ms at
// 3.35 TB/s. No [T, T] tensor reaches device memory.
//
// What the design does about it (bf16), following the reference's split into
// a kernel per key tile and one per query tile, so no atomics and the
// gradients are deterministic:
// - Tensor cores through wgmma (m64n64k16, bf16 in, f32 accumulate). A block
//   is one warpgroup that owns 64 rows (keys for dK/dV, queries for dQ) and
//   loads its two resident tiles (K and V, or Q and dO) once into shared
//   memory. S^T = K Q^T and dP^T = V dO^T (dQ: S = Q K^T, dP = dO V^T) take
//   both operands from shared memory; P^T and dS^T are formed in the
//   accumulator registers, rounded to bf16 and fed back as the register A
//   operand of dV += P^T dO and dK += dS^T Q (dQ += dS K).
// - Each streamed 64-row tile is staged once, [row][d] with the 128-byte
//   swizzle: the same tile is the K-major B operand of S^T and dP^T and,
//   through the descriptor's transpose bit, the MN-major B operand of the
//   second products.
// - Asynchronous copies: thread 0 fills a ring of 3 (dK/dV) or 2 (dQ)
//   stages by TMA (4-d tensor maps over the strided [B, H, T, 64] views, so
//   q, k, v may be slices of the fused QKV projection), each tile's lse, di
//   and segment ids riding on the same mbarrier as bulk copies, and refills a
//   stage as soon as the block is done with it.
// - 64 rows a block, not 128: dK/dV holds four [64 x 64] f32 accumulators a
//   warpgroup (about 168 registers a thread), so three such blocks fit on an
//   SM (dQ, 122 registers: four) where a block of two warpgroups fits once;
//   the first fills the SM better at these short T, though every streamed
//   tile then serves 64 rows.
// - Segment tile skipping, exact, in both dtypes: each block first takes
//   every 64-row tile's smallest and largest segment id; a streamed tile
//   whose range misses the block's own tile's range is neither loaded nor
//   computed. A pair of tiles whose ranges do not overlap holds no
//   same-segment pair, so every P and dS of it is 0 and skipping it changes
//   no bit (a range test, so it holds for segment ids in any order).
//
// f32: the same split and the same 64-row blocks, with f32-grade products
// on the tensor cores, as split TF32 ("3xTF32", as CUTLASS's
// OpMultiplyAddFastF32, which PyTorch's f32 memory-efficient attention
// uses):
// - Each operand a = hi + lo with hi = rna(a) and lo = rna(a - hi) (rna:
//   cvt.rna.tf32.f32's rounding, done in two integer operations, see
//   to_tf32), and each product as three mma.sync m16n8k8 TF32 products into
//   one f32 accumulator, lo.hi and hi.lo first, then hi.hi: about f32's
//   accuracy (the dropped lo.lo is 2^-22 of the product; one TF32 pass
//   keeps 11 bits). An operand is split once per fragment load, in
//   registers: an A fragment serves all n-tiles of its k-step, and the
//   three passes run over all n-tiles in turn, so no mma waits on the one
//   before it.
// - Four warps a block, 16 rows each. The streamed tiles come in halves of
//   32 rows: S^T and dP^T (dQ: S and dP) are [16 x 32] accumulators a warp;
//   P^T and dS^T (dQ: dS) are formed in them and fed as the A operand of the
//   second products with no shuffle: accumulator columns 2t, 2t + 1 serve
//   as A's columns t, t + 4, and the B operand's rows are read in the same
//   permutation (see update()).
// - mma.sync and not wgmma: wgmma takes TF32 only with both operands
//   K-major, and three of the six products read their B operand MN-major as
//   staged (dO and Q in dK/dV, K in dQ), so each would need a transposed
//   hi/lo copy. mma.sync loads its fragments from shared memory by index, so
//   no copy exists. A wgmma form is left for later. mma.sync's TF32 rate is
//   the ceiling: about 300-320 TFLOP/s measured on an H100 SXM (700 W), so
//   about 105 TFLOP/s of split-f32 products, against the data sheet's 495 /
//   3 = 165 for TF32 through wgmma.
// - Accuracy: mma.sync truncates its f32 sums, so each streamed unit's
//   second products are summed in fresh registers and added to dK, dV, dQ
//   with rounded f32 adds (add_part). Measured worst error against the
//   plain backward over three seeds at T = 128 / 256 / 512: 3.4e-6 /
//   5.0e-6 / 5.5e-6 of the largest gradient, against 3.9e-6 / 5.5e-6 /
//   1.1e-5 with one running accumulator (3% faster); the same for the
//   first products too gives 2.3e-6 at 20% more time.
// - Shared memory: tiles [rows][68] f32 (the padding spreads every fragment
//   read over 32 banks), the resident pair (K and V, or Q and dO) 34 KB, and
//   a cp.async ring of 2 stages, each the streamed pair's half tiles with
//   their lse, di and segment ids (17.4 KB): the next kept half loads while
//   the block computes this one. 70 KB a block: dq_tf32_kernel runs three
//   blocks an SM (165 registers), dkv_tf32_kernel two (220 registers; capped
//   at 168 for three it spills 36 bytes and runs 1.5% faster).
//   Measured, not kept: whole 64-row stages (3% slower); each streamed half
//   split once a block into hi/lo planes in shared memory (30% fewer
//   instructions, 2-12% slower: mma.sync's rate and the shared-memory
//   reads, not the issue slots, bound the kernels).
// - The same exact tile skip as bf16.
#include "hopper.cuh"

namespace {

using namespace kirag_flash;

// ring depths: shared memory for three dK/dV blocks or four dQ blocks an SM,
// as many as their registers allow
constexpr int DKV_STAGES = 3, DQ_STAGES = 2;

// --------------------------------------------------------- bf16: dK and dV

// Block: keys 64 * own .. + 63 of head h, sequence b, one warpgroup (S^T,
// dP^T, dK, dV as [64 keys x 64] accumulators); streams the kept query
// tiles of Q and dO.
template <int STAGES>
__global__ void __launch_bounds__(BF16_THREADS, 3)
    dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const int* __restrict__ seg,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t_len,
                    float sm_scale, Strides sdk, Strides sdv) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int* segb = seg + static_cast<long long>(b) * t_len;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * t_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int key0 = 64 * blockIdx.x + 16 * warp + g, key1 = key0 + 8;
  const int kseg0 = segb[key0], kseg1 = segb[key1];
  int ahead;
  const Ring<2, STAGES> r = start_ring<2, STAGES>(smem_raw, &tk, &tv, &tq, &tdo, segb, lse + row0,
                                                  di + row0, t_len, &ahead);
  const uint64_t k_desc = k_major(r.base), v_desc = k_major(r.base + TILE_BYTES);

  float dk_acc[32], dv_acc[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = s[i] = dp[i] = 0.f;
  int st_i = 0;
  uint32_t phase = 0;
  for (int j = r.next(0); j < r.n_tiles; j = r.next(j + 1)) {
    mbar_wait(&r.full[st_i], phase);
    const uint8_t* st = r.stage(st_i);  // Q tile, dO tile, lse, di, segment ids
    wgmma_fence();
    issue_scores(s, k_desc, st);                // S^T = K Q^T
    issue_scores(dp, v_desc, st + TILE_BYTES);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // P^T into s, dS^T into dp; element 4n + e is query 8n + 2c + e % 2
    const float* lse_s = stage_lse(st);
    const float* di_s = stage_di(st);
    const int* qseg_s = stage_seg(st);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * n + 2 * c + e;
        const float lq = lse_s[qi], dq = di_s[qi];
        const int qsg = qseg_s[qi];
        const float p0 = qsg == kseg0 ? __expf(s[4 * n + e] * sm_scale - lq) : 0.f;
        const float p1 = qsg == kseg1 ? __expf(s[4 * n + 2 + e] * sm_scale - lq) : 0.f;
        s[4 * n + e] = p0;
        s[4 * n + 2 + e] = p1;
        dp[4 * n + e] = p0 * (dp[4 * n + e] - dq) * sm_scale;
        dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - dq) * sm_scale;
      }
    }
    // dV += P^T dO and dK += dS^T Q over the tile's queries, 16 at a time
    uint32_t pa[4][4], dsa[4][4];
    to_a(pa, s);
    to_a(dsa, dp);
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    wgmma_fence();
    issue_update(dv_acc, pa, st + TILE_BYTES);
    issue_update(dk_acc, dsa, st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    __syncthreads();  // the stage is free
    if (ahead < r.n_tiles) {
      if (threadIdx.x == 0) r.load(ahead, st_i);
      ahead = r.next(ahead + 1);
    }
    if (++st_i == STAGES) st_i = 0, phase ^= 1;
  }

  __nv_bfloat16* dkb = dk + b * sdk.b + h * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * c;
    *reinterpret_cast<uint32_t*>(dkb + key0 * sdk.t + col) = pack_bf16(dk_acc[4 * n], dk_acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(dkb + key1 * sdk.t + col) = pack_bf16(dk_acc[4 * n + 2], dk_acc[4 * n + 3]);
    *reinterpret_cast<uint32_t*>(dvb + key0 * sdv.t + col) = pack_bf16(dv_acc[4 * n], dv_acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(dvb + key1 * sdv.t + col) = pack_bf16(dv_acc[4 * n + 2], dv_acc[4 * n + 3]);
  }
}

// -------------------------------------------------------------- bf16: dQ

// Block: queries 64 * own .. + 63, one warpgroup (S, dP, dQ as [64 queries
// x 64] accumulators); streams the kept key tiles of K and V.
template <int STAGES>
__global__ void __launch_bounds__(BF16_THREADS, 4)
    dq_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const int* __restrict__ seg, const float* __restrict__ lse,
                   const float* __restrict__ di, __nv_bfloat16* __restrict__ dq, int t_len,
                   float sm_scale, Strides sdq) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int* segb = seg + static_cast<long long>(b) * t_len;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * t_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int r0 = 64 * blockIdx.x + 16 * warp + g, r1 = r0 + 8;
  const int seg0 = segb[r0], seg1 = segb[r1];
  const float lse0 = lse[row0 + r0], lse1 = lse[row0 + r1];
  const float di0 = di[row0 + r0], di1 = di[row0 + r1];
  int ahead;
  const Ring<2, STAGES> r = start_ring<2, STAGES>(smem_raw, &tq, &tdo, &tk, &tv, segb, nullptr,
                                                  nullptr, t_len, &ahead);
  const uint64_t q_desc = k_major(r.base), do_desc = k_major(r.base + TILE_BYTES);

  float dq_acc[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = s[i] = dp[i] = 0.f;
  int st_i = 0;
  uint32_t phase = 0;
  for (int j = r.next(0); j < r.n_tiles; j = r.next(j + 1)) {
    mbar_wait(&r.full[st_i], phase);
    const uint8_t* st = r.stage(st_i);  // K tile, V tile, -, -, segment ids
    wgmma_fence();
    issue_scores(s, q_desc, st);                 // S = Q K^T
    issue_scores(dp, do_desc, st + TILE_BYTES);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // dS into dp; element 4n + e is key 8n + 2c + e % 2
    const int* kseg_s = stage_seg(st);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ksg = kseg_s[8 * n + 2 * c + e];
        const float p0 = ksg == seg0 ? __expf(s[4 * n + e] * sm_scale - lse0) : 0.f;
        const float p1 = ksg == seg1 ? __expf(s[4 * n + 2 + e] * sm_scale - lse1) : 0.f;
        dp[4 * n + e] = p0 * (dp[4 * n + e] - di0) * sm_scale;
        dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - di1) * sm_scale;
      }
    }
    // dQ += dS K over the tile's keys, 16 at a time
    uint32_t dsa[4][4];
    to_a(dsa, dp);
    fence_acc(dq_acc);
    wgmma_fence();
    issue_update(dq_acc, dsa, st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq_acc);
    __syncthreads();  // the stage is free
    if (ahead < r.n_tiles) {
      if (threadIdx.x == 0) r.load(ahead, st_i);
      ahead = r.next(ahead + 1);
    }
    if (++st_i == STAGES) st_i = 0, phase ^= 1;
  }

  __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * c;
    *reinterpret_cast<uint32_t*>(dqb + r0 * sdq.t + col) = pack_bf16(dq_acc[4 * n], dq_acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(dqb + r1 * sdq.t + col) = pack_bf16(dq_acc[4 * n + 2], dq_acc[4 * n + 3]);
  }
}

// ------------------------------------------------------------------ f32
// Split-f32 products on the tensor cores (mma.sync m16n8k8, TF32 in, f32
// accumulate). Fragment layout of m16n8k8.tf32 (g = lane / 4, t = lane % 4):
//   A 16x8: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B 8x8:  b0 = B[t][g], b1 = B[t+4][g]
//   C 16x8: c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// Every staged tile is [rows][FS] f32: a warp's reads of a B fragment
// (rows 8n + g, columns 8s + t) and of an update's B pair (rows 2t, 2t + 1,
// columns 16m + 2g) each hit 32 distinct banks.

constexpr int FS = HD + 4;
constexpr int F32_THREADS = 128;  // four warps of 16 rows
constexpr int F32_ROWS = 32;      // streamed rows a stage, half a 64-row tile
constexpr int F32_STAGES = 2;     // the ring's depth (see the note at the top)

// Shared memory in floats: the two resident 64-row tiles, then the ring
// (each stage the two streamed half tiles, then their lse, di and segment
// ids), then each 64-row tile's segment range.
struct F32Smem {
  static constexpr int TILE = 64 * FS, HALF = F32_ROWS * FS, RING = 2 * TILE,
                       STAGE = 2 * HALF + 3 * F32_ROWS, RANGES = RING + F32_STAGES * STAGE;
  static size_t bytes(int n_tiles) { return 4 * static_cast<size_t>(RANGES) + 8 * n_tiles; }
};

// cvt.rna.tf32.f32 (nearest, ties away from zero) for finite x in two integer
// operations: half the range of the 13 dropped bits added to the magnitude,
// then those bits cleared. The same bits as the instruction, which compiles
// to a longer sequence (it also handles NaN) and made the kernels 22%
// slower.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// N values, each split x = hi + lo into two TF32 values (22 significant bits)
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = to_tf32(x);
    lo[i] = to_tf32(x - __uint_as_float(hi[i]));
  }
};

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[n] += a b[n] for N n-tiles as split-f32 products: the small terms
// lo.hi and hi.lo first, then hi.hi (lo.lo, 2^-22 of the product, is
// dropped); pass by pass over the n-tiles, so that no mma waits on the one
// before it
template <int N>
__device__ __forceinline__ void mma3n(float (*acc)[4], const Split<4>& a, const Split<2>* b) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.lo, b[n].hi[0], b[n].hi[1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.hi, b[n].lo[0], b[n].lo[1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.hi, b[n].hi[0], b[n].hi[1]);
}

// acc += part, element by element: an f32 add rounded to nearest. mma.sync
// truncates its sum to f32 at every step, a bias of up to an ulp of the
// accumulator each time; over a whole row of keys (dK, dV) or queries (dQ)
// at T = 512, 192 such steps reached 1.1e-5 of the largest gradient. So
// each streamed unit's products (12 steps) go into fresh registers and are
// added to the running sum here (the first products' 24 steps over the 64
// columns stay in their accumulator).
template <int N>
__device__ __forceinline__ void add_part(float (*acc)[4], float (*part)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

// acc[n] (16 x 8) += A B_n^T over the 64 columns: A the warp's 16 resident
// rows, B_n the streamed rows 8n .. 8n + 7 (S^T = K Q^T, dP^T = V dO^T; dQ:
// S = Q K^T, dP = dO V^T). A's fragment is split once a k-step and serves
// all NT n-tiles.
template <int NT>
__device__ __forceinline__ void scores(float (*acc)[4], const float* a_rows, const float* b_rows,
                                       int g, int t) {
#pragma unroll
  for (int s = 0; s < HD / 8; ++s) {
    const float* ar = a_rows + g * FS + 8 * s + t;
    Split<4> a;
    a.set(0, ar[0]);
    a.set(1, ar[8 * FS]);
    a.set(2, ar[4]);
    a.set(3, ar[8 * FS + 4]);
    Split<2> b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* br = b_rows + (8 * n + g) * FS + 8 * s + t;
      b[n].set(0, br[0]);
      b[n].set(1, br[4]);
    }
    mma3n<NT>(acc, a, b);
  }
}

// acc (16 x 64) += P B: P the [16 x 8 NT] accumulator tiles p (P^T, dS^T;
// dQ: dS), B the streamed rows 0 .. 8 NT - 1, all 64 columns (dO, Q; dQ: K).
// No shuffle and no trip through shared memory: tile kk's accumulator
// columns 2t, 2t + 1 serve as A's columns t, t + 4, which permutes the
// reduction index, so B's rows are read in the same permutation (8kk + 2t,
// 8kk + 2t + 1 as B's rows t, t + 4). The output columns are permuted too:
// n-tile 2m + e's column j is column 16m + 2j + e, so a lane reads B as
// float2 pairs and holds columns 16m + 4t .. 16m + 4t + 3 of its two rows.
// The unit's sum goes into fresh registers, four n-tiles (32 columns) at a
// time, and is then added to acc (add_part).
template <int NT>
__device__ __forceinline__ void update(float (*acc)[4], float (*p)[4], const float* b_rows,
                                       int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // n-tiles 4h .. 4h + 3
    float part[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      Split<4> a;
      a.set(0, p[kk][0]);  // C (g, 2t) as A (g, t)
      a.set(1, p[kk][2]);  // C (g + 8, 2t) as A (g + 8, t)
      a.set(2, p[kk][1]);  // C (g, 2t + 1) as A (g, t + 4)
      a.set(3, p[kk][3]);  // C (g + 8, 2t + 1) as A (g + 8, t + 4)
      const float* r0 = b_rows + (8 * kk + 2 * t) * FS + 2 * g + 32 * h;
      Split<2> b[4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {  // n-tiles 4h + 2m, 4h + 2m + 1
        const float2 x = *reinterpret_cast<const float2*>(r0 + 16 * m);
        const float2 y = *reinterpret_cast<const float2*>(r0 + FS + 16 * m);
        b[2 * m].set(0, x.x);
        b[2 * m].set(1, y.x);
        b[2 * m + 1].set(0, x.y);
        b[2 * m + 1].set(1, y.y);
      }
      mma3n<4>(part, a, b);
    }
    add_part<4>(acc + 4 * h, part);
  }
}

// The warp's rows g and g + 8 of an update's output (row_g, row_g8: their
// first columns), each as float4s at columns 16m + 4t.
__device__ __forceinline__ void store_rows(float* row_g, float* row_g8, float (*acc)[4],
                                           int t) {
#pragma unroll
  for (int m = 0; m < HD / 16; ++m) {
    *reinterpret_cast<float4*>(row_g + 16 * m + 4 * t) =
        make_float4(acc[2 * m][0], acc[2 * m + 1][0], acc[2 * m][1], acc[2 * m + 1][1]);
    *reinterpret_cast<float4*>(row_g8 + 16 * m + 4 * t) =
        make_float4(acc[2 * m][2], acc[2 * m + 1][2], acc[2 * m][3], acc[2 * m + 1][3]);
  }
}

// Starts the copies of rows row0 .. row0 + ROWS - 1 of a strided [*, 64]
// f32 matrix into a staged tile.
template <int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* base, long long row_stride,
                                           int row0) {
  for (int i = threadIdx.x; i < ROWS * HD / 4; i += F32_THREADS) {
    const int row = i / (HD / 4), d = 4 * (i % (HD / 4));
    cp_async16(dst + row * FS + d, base + (row0 + row) * row_stride + d);
  }
}

// Starts the copies of streamed unit u (rows F32_ROWS u .. + F32_ROWS - 1,
// half u % 2 of tile u / 2) into stage st: rows of a and b, then their lse
// and di (dK/dV; null for dQ) and segment ids.
__device__ __forceinline__ void stage_unit(float* st, const float* a, long long sa,
                                           const float* b, long long sb, const float* lse,
                                           const float* di, const int* segb, int u) {
  const int row0 = F32_ROWS * u;
  stage_rows<F32_ROWS>(st, a, sa, row0);
  stage_rows<F32_ROWS>(st + F32Smem::HALF, b, sb, row0);
  float* rows = st + 2 * F32Smem::HALF;  // lse, di, segment ids: F32_ROWS each
  constexpr int V = F32_ROWS / 4;        // 16-byte copies a row vector
  const int i = threadIdx.x;
  if (i < V) {
    cp_async16(rows + 2 * F32_ROWS + 4 * i, segb + row0 + 4 * i);
  } else if (lse != nullptr && i < 3 * V) {
    const bool is_lse = i < 2 * V;
    const int r = i - (is_lse ? V : 2 * V);
    cp_async16(rows + (is_lse ? 0 : F32_ROWS) + 4 * r, (is_lse ? lse : di) + row0 + 4 * r);
  }
}

// A block's ring over the units (half tiles) of its kept streamed tiles.
struct F32Ring {
  float* sm;
  const int2* ranges;  // each 64-row tile's segment range
  int2 own;            // the block's own tile's
  int end;             // 2 n_tiles: past the last unit
  // the first unit: the first half of the first kept tile (the block's own
  // tile is always kept)
  __device__ __forceinline__ int first() const { return 2 * next_kept(ranges, own, 0, end / 2); }
  // the unit after u: the other half of its tile, else the first half of the
  // next kept tile (end if none)
  __device__ __forceinline__ int after(int u) const {
    return u % 2 == 0 ? u + 1 : 2 * next_kept(ranges, own, u / 2 + 1, end / 2);
  }
  __device__ __forceinline__ float* stage(int slot) const {
    return sm + F32Smem::RING + slot * F32Smem::STAGE;
  }
};

// Loads the block's two resident tiles (rows 64 * blockIdx.x .. + 63 of ra
// and rb) and the tile ranges, and starts the ring: the first F32_STAGES - 1
// units of the streamed sa, sb (lse, di) in flight, each stage its own commit
// group, empty or not, so that cp_async_wait<F32_STAGES - 2> finds the oldest
// one landed. *ahead: the next unit to load.
__device__ __forceinline__ F32Ring start_f32_ring(float* sm, const float* ra, long long sra,
                                                  const float* rb, long long srb, const float* sa,
                                                  long long ssa, const float* sb, long long ssb,
                                                  const float* lse, const float* di,
                                                  const int* segb, int n_tiles, int* ahead) {
  stage_rows<64>(sm, ra, sra, 64 * blockIdx.x);
  stage_rows<64>(sm + F32Smem::TILE, rb, srb, 64 * blockIdx.x);
  int2* ranges = reinterpret_cast<int2*>(sm + F32Smem::RANGES);
  tile_ranges(ranges, segb, n_tiles);
  __syncthreads();
  const F32Ring r{sm, ranges, ranges[blockIdx.x], 2 * n_tiles};
  *ahead = r.first();
#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (*ahead < r.end) {
      stage_unit(r.stage(s), sa, ssa, sb, ssb, lse, di, segb, *ahead);
      *ahead = r.after(*ahead);
    }
    cp_async_commit();
  }
  return r;
}

// Waits for the oldest unit in the ring and starts the next one's copies
// into the slot the block finished with last.
__device__ __forceinline__ void advance(const F32Ring& r, int slot, int* ahead, const float* sa,
                                        long long ssa, const float* sb, long long ssb,
                                        const float* lse, const float* di, const int* segb) {
  cp_async_wait<F32_STAGES - 2>();
  __syncthreads();  // the unit has landed for all; the block is done with the slot refilled
  if (*ahead < r.end) {
    stage_unit(r.stage((slot + F32_STAGES - 1) % F32_STAGES), sa, ssa, sb, ssb, lse, di, segb,
               *ahead);
    *ahead = r.after(*ahead);
  }
  cp_async_commit();
}

// Block: keys 64 * blockIdx.x .. + 63 of head h, sequence b; warp w owns
// keys 16w .. 16w + 15 of them (S^T, dP^T as [16 keys x F32_ROWS queries],
// dK, dV as [16 keys x 64]); K and V resident; streams the kept query tiles
// of Q, dO, lse, di and segment ids, half a tile a stage.
__global__ void __launch_bounds__(F32_THREADS, 2)
    dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ seg,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const float* __restrict__ dout, float* __restrict__ dk,
                    float* __restrict__ dv, int t_len, float sm_scale, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdk, Strides sdv) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y;
  const int* segb = seg + static_cast<long long>(b) * t_len;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * t_len;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  int ahead;
  const F32Ring r = start_f32_ring(sm, k + b * sk.b + h * sk.h, sk.t, v + b * sv.b + h * sv.h,
                                   sv.t, qb, sq.t, dob, sdo.t, lse + row0, di + row0, segb,
                                   t_len / 64, &ahead);

  const int key0 = 64 * blockIdx.x + 16 * warp + g;
  const int kseg0 = segb[key0], kseg1 = segb[key0 + 8];
  const float* k_rows = sm + 16 * warp * FS;
  const float* v_rows = k_rows + F32Smem::TILE;
  constexpr int NT = F32_ROWS / 8;
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }
  int slot = 0;
  for (int u = r.first(); u < r.end; u = r.after(u)) {
    advance(r, slot, &ahead, qb, sq.t, dob, sdo.t, lse + row0, di + row0, segb);
    const float* q_s = r.stage(slot);
    const float* do_s = q_s + F32Smem::HALF;
    const float* lse_s = q_s + 2 * F32Smem::HALF;
    const float* di_s = lse_s + F32_ROWS;
    const int* qseg_s = reinterpret_cast<const int*>(lse_s + 2 * F32_ROWS);
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    scores<NT>(s, k_rows, q_s, g, t);    // S^T = K Q^T
    scores<NT>(dp, v_rows, do_s, g, t);  // dP^T = V dO^T
    // P^T into s, dS^T into dp; element [n][2 (e / 2) + e % 2] is key
    // g + 8 (e / 2), the unit's query 8n + 2t + e % 2
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * n + 2 * t + e;
        const float lq = lse_s[qi], dq = di_s[qi];
        const int qsg = qseg_s[qi];
        const float p0 = qsg == kseg0 ? expf(s[n][e] * sm_scale - lq) : 0.f;
        const float p1 = qsg == kseg1 ? expf(s[n][2 + e] * sm_scale - lq) : 0.f;
        s[n][e] = p0;
        s[n][2 + e] = p1;
        dp[n][e] = p0 * (dp[n][e] - dq) * sm_scale;
        dp[n][2 + e] = p1 * (dp[n][2 + e] - dq) * sm_scale;
      }
    }
    update<NT>(dv_acc, s, do_s, g, t);  // dV += P^T dO
    update<NT>(dk_acc, dp, q_s, g, t);  // dK += dS^T Q
    slot = slot + 1 == F32_STAGES ? 0 : slot + 1;
  }

  float* dkr = dk + b * sdk.b + h * sdk.h + key0 * sdk.t;
  float* dvr = dv + b * sdv.b + h * sdv.h + key0 * sdv.t;
  store_rows(dkr, dkr + 8 * sdk.t, dk_acc, t);
  store_rows(dvr, dvr + 8 * sdv.t, dv_acc, t);
}

// Block: queries 64 * blockIdx.x .. + 63; warp w owns queries 16w .. 16w + 15
// (S, dP as [16 queries x F32_ROWS keys], dQ as [16 x 64]); Q and dO
// resident; streams the kept key tiles of K, V and segment ids, half a tile
// a stage.
__global__ void __launch_bounds__(F32_THREADS, 3)
    dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ seg,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   const float* __restrict__ dout, float* __restrict__ dq, int t_len,
                   float sm_scale, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y;
  const int* segb = seg + static_cast<long long>(b) * t_len;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * t_len;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  int ahead;
  const F32Ring r = start_f32_ring(sm, q + b * sq.b + h * sq.h, sq.t, dout + b * sdo.b + h * sdo.h,
                                   sdo.t, kb, sk.t, vb, sv.t, nullptr, nullptr, segb, t_len / 64,
                                   &ahead);

  const int r0 = 64 * blockIdx.x + 16 * warp + g;
  const int seg0 = segb[r0], seg1 = segb[r0 + 8];
  const float lse0 = lse[row0 + r0], lse1 = lse[row0 + r0 + 8];
  const float di0 = di[row0 + r0], di1 = di[row0 + r0 + 8];
  const float* q_rows = sm + 16 * warp * FS;
  const float* do_rows = q_rows + F32Smem::TILE;
  constexpr int NT = F32_ROWS / 8;
  float dq_acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.f;
  }
  int slot = 0;
  for (int u = r.first(); u < r.end; u = r.after(u)) {
    advance(r, slot, &ahead, kb, sk.t, vb, sv.t, nullptr, nullptr, segb);
    const float* k_s = r.stage(slot);
    const float* v_s = k_s + F32Smem::HALF;
    const int* kseg_s = reinterpret_cast<const int*>(k_s + 2 * F32Smem::HALF + 2 * F32_ROWS);
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    scores<NT>(s, q_rows, k_s, g, t);    // S = Q K^T
    scores<NT>(dp, do_rows, v_s, g, t);  // dP = dO V^T
    // dS into dp; element [n][2 (e / 2) + e % 2] is query g + 8 (e / 2),
    // the unit's key 8n + 2t + e % 2
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ksg = kseg_s[8 * n + 2 * t + e];
        const float p0 = ksg == seg0 ? expf(s[n][e] * sm_scale - lse0) : 0.f;
        const float p1 = ksg == seg1 ? expf(s[n][2 + e] * sm_scale - lse1) : 0.f;
        dp[n][e] = p0 * (dp[n][e] - di0) * sm_scale;
        dp[n][2 + e] = p1 * (dp[n][2 + e] - di1) * sm_scale;
      }
    }
    update<NT>(dq_acc, dp, k_s, g, t);  // dQ += dS K
    slot = slot + 1 == F32_STAGES ? 0 : slot + 1;
  }

  float* dqr = dq + b * sdq.b + h * sdq.h + r0 * sdq.t;
  store_rows(dqr, dqr + 8 * sdq.t, dq_acc, t);
}

}  // namespace

// ------------------------------------------------------------------- host

namespace {

struct Maps {
  CUtensorMap q, k, v, dout;
};

cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout,
                      const long long* strides, int batch, int heads, int t_len) {
  const void* bases[4] = {q, k, v, dout};
  CUtensorMap* maps[4] = {&m->q, &m->k, &m->v, &m->dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = rows_map(maps[i], bases[i], strides_at(strides, i), batch, heads, t_len);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Launches a bf16 kernel with its dynamic shared memory (a ring of STAGES);
// args after the four maps.
template <int STAGES, typename Kernel, typename... Args>
cudaError_t launch_bf16(Kernel kernel, const Maps& m, int batch, int heads, int t_len,
                        cudaStream_t stream, Args... args) {
  const size_t smem = Smem<2, STAGES>::bytes(t_len / 64);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(t_len / 64, heads, batch);
  kernel<<<grid, BF16_THREADS, smem, stream>>>(m.q, m.k, m.v, m.dout, args...);
  return cudaGetLastError();
}

// Launches an f32 kernel, one block per 64-row tile, with its dynamic
// shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch_f32(Kernel kernel, int batch, int heads, int t_len, cudaStream_t stream,
                       Args... args) {
  const size_t smem = F32Smem::bytes(t_len / 64);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(t_len / 64, heads, batch), F32_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: [batch, heads, t_len, 64] f32 (is_bf16 = 0) or bf16 (1);
// dk, dv (dQ: dq) of the same shape and type; each addressed through its
// element strides (strides[3 * i .. 3 * i + 2] = batch, head and token
// strides of q, k, v, dout, dq, dk, dv in turn; d contiguous, rows 16-byte
// aligned); seg int32 [batch, t_len], lse and di f32 [batch, heads, t_len],
// all contiguous and 16-byte aligned; t_len a multiple of 64. Each returns
// its launch's cudaError_t.
extern "C" int kirag_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                             const int* seg, const float* lse, const float* di,
                                             const void* dout, void* dk, void* dv, int is_bf16,
                                             int batch, int heads, int t_len, float sm_scale,
                                             const long long* strides, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), sdo = strides_at(strides, 3),
                sdk = strides_at(strides, 5), sdv = strides_at(strides, 6);
  if (is_bf16) {
    Maps m;
    const cudaError_t err = make_maps(&m, q, k, v, dout, strides, batch, heads, t_len);
    if (err != cudaSuccess) return err;
    auto* dkp = static_cast<__nv_bfloat16*>(dk);
    auto* dvp = static_cast<__nv_bfloat16*>(dv);
    return launch_bf16<DKV_STAGES>(dkv_bf16_kernel<DKV_STAGES>, m, batch, heads, t_len, s, seg,
                                   lse, di, dkp, dvp, t_len, sm_scale, sdk, sdv);
  }
  return launch_f32(dkv_tf32_kernel, batch, heads, t_len, s, static_cast<const float*>(q),
                    static_cast<const float*>(k), static_cast<const float*>(v), seg, lse, di,
                    static_cast<const float*>(dout), static_cast<float*>(dk),
                    static_cast<float*>(dv), t_len, sm_scale, sq, sk, sv, sdo, sdk, sdv);
}

extern "C" int kirag_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                            const int* seg, const float* lse, const float* di,
                                            const void* dout, void* dq, int is_bf16, int batch,
                                            int heads, int t_len, float sm_scale,
                                            const long long* strides, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), sdo = strides_at(strides, 3),
                sdq = strides_at(strides, 4);
  if (is_bf16) {
    Maps m;
    const cudaError_t err = make_maps(&m, q, k, v, dout, strides, batch, heads, t_len);
    if (err != cudaSuccess) return err;
    auto* dqp = static_cast<__nv_bfloat16*>(dq);
    return launch_bf16<DQ_STAGES>(dq_bf16_kernel<DQ_STAGES>, m, batch, heads, t_len, s, seg, lse,
                                  di, dqp, t_len, sm_scale, sdq);
  }
  return launch_f32(dq_tf32_kernel, batch, heads, t_len, s, static_cast<const float*>(q),
                    static_cast<const float*>(k), static_cast<const float*>(v), seg, lse, di,
                    static_cast<const float*>(dout), static_cast<float*>(dq), t_len, sm_scale,
                    sq, sk, sv, sdo, sdq);
}
