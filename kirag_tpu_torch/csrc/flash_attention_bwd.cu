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
// token real) 17 and 13 GFLOP, 0.017 and 0.013 ms at 989 TFLOP/s, against
// 0.10 and 0.09 GB of inputs and outputs, 0.030 and 0.026 ms at 3.35 TB/s.
// No [T, T] tensor reaches device memory.
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
// - Segment tile skipping, exact: each block first takes every 64-row tile's
//   smallest and largest segment id; a streamed tile whose range misses the
//   block's own tile's range is neither loaded nor computed. A pair of tiles
//   whose ranges do not overlap holds no same-segment pair, so every P and
//   dS of it is 0 and skipping it changes no bit (a range test, so it holds
//   for segment ids in any order).
// - f32: the same split on the CUDA cores (no TF32), two threads per key
//   (dK/dV) or query (dQ), each holding half of the row's 64 values and the
//   matching half of the accumulators; the two halves of each dot product
//   meet through a shuffle. So the card can hold it against the plain
//   version at a tight tolerance.
// - Keys of another segment give P = 0 by selection, never by exp(-inf), so
//   no NaN appears; lse is finite for every row (each query sees itself,
//   pad rows attend among pads).
// - dq, dk, dv are written through element strides as [B, T, H, 64] for the
//   projection's backward.
#include <cuda.h>  // CUtensorMap and its enums (the encoder is looked up at run time)

#include "flash_attention.cuh"

namespace {

using namespace kirag_flash;

constexpr int F32_THREADS = 2 * BQ;  // two threads per row

// ------------------------------------------------ Hopper: mbarrier, TMA, wgmma

constexpr int TILE_BYTES = 64 * HD * 2;  // one [64 rows x 64] bf16 tile, 128-byte swizzled
constexpr int ROW_BYTES = 64 * 4;        // one tile's lse, di or segment ids
// a ring stage: two streamed tiles, then lse, di and segment ids; 1024-byte
// aligned (the swizzle's period)
constexpr int STAGE_BYTES = 2 * TILE_BYTES + 1024;
// ring depths: shared memory for three dK/dV blocks or four dQ blocks an SM,
// as many as their registers allow
constexpr int DKV_STAGES = 3, DQ_STAGES = 2;

template <int STAGES>
struct Smem {  // byte offsets from a 1024-aligned base: the two resident tiles first
  static constexpr int RING = 2 * TILE_BYTES;
  static constexpr int BARS = RING + STAGES * STAGE_BYTES;  // full[STAGES], resident
  static constexpr int RANGES = BARS + (STAGES + 1) * 8;
  static size_t bytes(int n_tiles) { return 1024 + RANGES + 8 * static_cast<size_t>(n_tiles); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of the given parity to complete. A wait of seconds is a
// lost arrival, never a slow copy: it traps (a launch failure the caller
// sees) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - t0 > (1ll << 33)) __trap();  // about 4 s at the H100's clock
  }
}

// rows t0 .. t0 + 63 of head h of sequence b, all 64 columns, by TMA
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int t0, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(t0), "r"(h), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 1024-aligned swizzled tile: start
// address, leading and stride byte offsets (16-byte units), 128-byte swizzle.
// K-major (rows of the tile along M or N, its 64 columns along K): 8-row
// groups 1024 bytes apart, a 16-column k-step is +32 bytes (+2). MN-major
// (rows along K, columns along N, the transpose bit set): 8-row groups 1024
// bytes apart, a 16-row k-step is +2048 bytes (+128); N = 64 is one swizzle
// atom, so the atom stride is never used.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo, uint32_t sbo) {
  return ((smem_u32(tile) & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t k_major(const void* tile) { return desc_sw128(tile, 1, 64); }
__device__ __forceinline__ uint64_t mn_major(const void* tile) { return desc_sw128(tile, 64, 64); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define KIRAG_WGMMA_D                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define KIRAG_WGMMA_ACC(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory (K-major).
// Accumulator layout (warp w of the warpgroup, g = lane / 4, c = lane % 4):
// d[4n + e] is row 16w + g + 8 (e / 2), column 8n + 2c + e % 2, as mma.sync's
// C fragments of eight n-tiles.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KIRAG_WGMMA_D
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : KIRAG_WGMMA_ACC(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (each warp its 16
// rows as mma.sync's A fragment), B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KIRAG_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : KIRAG_WGMMA_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------- bf16: the shared frame

// Each 64-row tile's smallest and largest segment id, r[i] = (lo, hi); all
// threads of the block take part.
__device__ __forceinline__ void tile_ranges(int2* r, const int* segb, int n_tiles) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n_tiles; i += blockDim.x / 32) {
    const int x = segb[64 * i + lane], y = segb[64 * i + 32 + lane];
    const int lo = __reduce_min_sync(0xffffffffu, min(x, y));
    const int hi = __reduce_max_sync(0xffffffffu, max(x, y));
    if (lane == 0) r[i] = make_int2(lo, hi);
  }
}

__device__ __forceinline__ bool overlap(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }

// One block's shared memory: its own tile of two resident operands (K and V,
// or Q and dO) at base, then a ring of STAGES stages that streams the kept
// tiles of the other two, each with its lse and di (when given) and segment
// ids. Thread 0 issues every copy (TMA, on the stage's mbarrier); a stage is
// refilled once the whole block is done with it.
template <int STAGES>
struct Ring {
  uint8_t* base;
  uint64_t* full;  // [STAGES + 1]: a stage's copies landed; [STAGES]: the resident pair's
  int2* ranges;    // [n_tiles] each tile's segment range
  const CUtensorMap *map_a, *map_b;
  const int* segb;
  const float *lse_row, *di_row;
  int n_tiles, own, h, b;

  __device__ uint8_t* stage(int s) const { return base + Smem<STAGES>::RING + s * STAGE_BYTES; }

  // the first tile from j on whose range meets the block's own: a tile pair
  // whose ranges do not overlap holds no same-segment pair
  __device__ int next(int j) const {
    while (j < n_tiles && !overlap(ranges[j], ranges[own])) ++j;
    return j;
  }

  __device__ void load(int j, int s) const {
    uint8_t* st = stage(s);
    mbar_expect_tx(&full[s], 2 * TILE_BYTES + (lse_row != nullptr ? 3 : 1) * ROW_BYTES);
    tma_tile(st, map_a, 64 * j, h, b, &full[s]);
    tma_tile(st + TILE_BYTES, map_b, 64 * j, h, b, &full[s]);
    if (lse_row != nullptr) {
      bulk_copy(st + 2 * TILE_BYTES, lse_row + 64 * j, ROW_BYTES, &full[s]);
      bulk_copy(st + 2 * TILE_BYTES + ROW_BYTES, di_row + 64 * j, ROW_BYTES, &full[s]);
    }
    bulk_copy(st + 2 * TILE_BYTES + 2 * ROW_BYTES, segb + 64 * j, ROW_BYTES, &full[s]);
  }
};

// Sets the ring up (every thread): thread 0 starts the resident copies at
// once, the block takes the tile ranges, and thread 0 then fills the ring
// with the first kept tiles. Returns the first tile not yet issued in *ahead.
template <int STAGES>
__device__ __forceinline__ Ring<STAGES> start_ring(uint8_t* raw, const CUtensorMap* res_a,
                                                   const CUtensorMap* res_b,
                                                   const CUtensorMap* map_a,
                                                   const CUtensorMap* map_b, const int* segb,
                                                   const float* lse_row, const float* di_row,
                                                   int t_len, int* ahead) {
  uint8_t* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const Ring<STAGES> r{base,
                       reinterpret_cast<uint64_t*>(base + Smem<STAGES>::BARS),
                       reinterpret_cast<int2*>(base + Smem<STAGES>::RANGES),
                       map_a, map_b, segb, lse_row, di_row, t_len / 64,
                       static_cast<int>(blockIdx.x), static_cast<int>(blockIdx.y),
                       static_cast<int>(blockIdx.z)};
  uint64_t* res = &r.full[STAGES];
  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(&r.full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(res, 2 * TILE_BYTES);
    tma_tile(base, res_a, 64 * r.own, r.h, r.b, res);
    tma_tile(base + TILE_BYTES, res_b, 64 * r.own, r.h, r.b, res);
  }
  tile_ranges(r.ranges, segb, r.n_tiles);
  __syncthreads();
  int j = r.next(0);
  for (int s = 0; s < STAGES && j < r.n_tiles; ++s, j = r.next(j + 1)) {
    if (threadIdx.x == 0) r.load(j, s);
  }
  *ahead = j;
  mbar_wait(res, 0);
  return r;
}

// A stage's lse, di and segment ids
__device__ __forceinline__ const float* stage_lse(const uint8_t* st) {
  return reinterpret_cast<const float*>(st + 2 * TILE_BYTES);
}
__device__ __forceinline__ const float* stage_di(const uint8_t* st) {
  return reinterpret_cast<const float*>(st + 2 * TILE_BYTES + ROW_BYTES);
}
__device__ __forceinline__ const int* stage_seg(const uint8_t* st) {
  return reinterpret_cast<const int*>(st + 2 * TILE_BYTES + 2 * ROW_BYTES);
}

// S^T = A B^T (A: the resident [64 x 64] tile at a, B: the streamed tile at
// b, both K-major over d)
__device__ __forceinline__ void issue_scores(float (&d)[32], uint64_t a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, a + 2 * kk, k_major(b) + 2 * kk, kk);
}

// acc += A B, A: the bf16 fragments a (64 columns as 4 register k-steps), B:
// the streamed [64 x 64] tile at b read MN-major
__device__ __forceinline__ void issue_update(float (&acc)[32], const uint32_t (&a)[4][4],
                                             const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_t(acc, a[kk], mn_major(b + 2048 * kk));
}

__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) c_to_a(a[kk], &d[8 * kk], &d[8 * kk + 4]);
}

// Every product of a tile waits for the one before it to land before any
// other instruction writes its accumulators (ptxas would otherwise
// serialize the products); the block's three or four co-resident neighbours
// keep the tensor cores busy in the gaps.

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
  const Ring<STAGES> r = start_ring<STAGES>(smem_raw, &tk, &tv, &tq, &tdo, segb, lse + row0,
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
  const Ring<STAGES> r = start_ring<STAGES>(smem_raw, &tq, &tdo, &tk, &tv, segb, nullptr,
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
// f32: thread 2r + half of a block owns row r of its tile and the float4
// chunks 2i + half (i = 0..7) of the row's 64 values; neighbouring halves
// read neighbouring 16 bytes of a staged row, so a warp's shared-memory
// reads hit distinct banks.
__device__ __forceinline__ void load_half(float* dst, const float* row, int half) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = p[2 * i + half];
    dst[4 * i] = x.x;
    dst[4 * i + 1] = x.y;
    dst[4 * i + 2] = x.z;
    dst[4 * i + 3] = x.w;
  }
}

__device__ __forceinline__ void store_half(float* row, const float* src, int half) {
  float4* p = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p[2 * i + half] = make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2], src[4 * i + 3]);
  }
}

// this thread's half of a . row, summed with its partner's half
__device__ __forceinline__ float dot_pair(const float* a, const float4* row, int half) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = row[2 * i + half];
    acc = fmaf(a[4 * i], x.x, acc);
    acc = fmaf(a[4 * i + 1], x.y, acc);
    acc = fmaf(a[4 * i + 2], x.z, acc);
    acc = fmaf(a[4 * i + 3], x.w, acc);
  }
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

__device__ __forceinline__ void axpy_half(float* acc, float a, const float4* row, int half) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = row[2 * i + half];
    acc[4 * i] = fmaf(a, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(a, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(a, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(a, x.w, acc[4 * i + 3]);
  }
}

// Stages rows row0..row0+63 of a [*, 64] f32 matrix as [row][d / 4].
__device__ __forceinline__ void stage_f32(float4* dst, const float* base, long long row_stride,
                                          int row0, int tid) {
  for (int i = tid; i < 64 * HD / 4; i += F32_THREADS) {
    dst[i] = reinterpret_cast<const float4*>(base + (row0 + i / (HD / 4)) * row_stride)[i % (HD / 4)];
  }
}

__global__ void __launch_bounds__(F32_THREADS)
    dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ seg,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv,
                   int t_len, float sm_scale, Strides sq, Strides sk, Strides sv, Strides sdo,
                   Strides sdk, Strides sdv) {
  __shared__ __align__(16) float4 q_s[BQ * HD / 4];  // [query][d / 4]
  __shared__ __align__(16) float4 do_s[BQ * HD / 4];
  __shared__ float lse_s[BQ], di_s[BQ];
  __shared__ int qseg_s[BQ];

  const int tid = threadIdx.x, half = tid % 2;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key = blockIdx.x * BK + tid / 2;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const int* segb = seg + static_cast<long long>(b) * t_len;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * t_len;

  float kr[32], vr[32], dk_acc[32], dv_acc[32];
  load_half(kr, k + b * sk.b + h * sk.h + key * sk.t, half);
  load_half(vr, v + b * sv.b + h * sv.h + key * sv.t, half);
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int kseg = segb[key];

  for (int qt = 0; qt < t_len; qt += BQ) {
    __syncthreads();
    stage_f32(q_s, qb, sq.t, qt, tid);
    stage_f32(do_s, dob, sdo.t, qt, tid);
    if (tid < BQ) {
      lse_s[tid] = lse[row0 + qt + tid];
      di_s[tid] = di[row0 + qt + tid];
      qseg_s[tid] = segb[qt + tid];
    }
    __syncthreads();
    for (int j = 0; j < BQ; ++j) {
      const float4* qr = &q_s[j * (HD / 4)];
      const float4* dr = &do_s[j * (HD / 4)];
      const float s = dot_pair(kr, qr, half);
      const float dpv = dot_pair(vr, dr, half);
      const float p = qseg_s[j] == kseg ? expf(s * sm_scale - lse_s[j]) : 0.f;
      const float ds = p * (dpv - di_s[j]) * sm_scale;
      axpy_half(dv_acc, p, dr, half);
      axpy_half(dk_acc, ds, qr, half);
    }
  }
  store_half(dk + b * sdk.b + h * sdk.h + key * sdk.t, dk_acc, half);
  store_half(dv + b * sdv.b + h * sdv.h + key * sdv.t, dv_acc, half);
}

__global__ void __launch_bounds__(F32_THREADS)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ seg,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  const float* __restrict__ dout, float* __restrict__ dq, int t_len,
                  float sm_scale, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq) {
  __shared__ __align__(16) float4 k_s[BK * HD / 4];  // [key][d / 4]
  __shared__ __align__(16) float4 v_s[BK * HD / 4];
  __shared__ int kseg_s[BK];

  const int tid = threadIdx.x, half = tid % 2;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r = blockIdx.x * BQ + tid / 2;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int* segb = seg + static_cast<long long>(b) * t_len;
  const long long row = (static_cast<long long>(b) * gridDim.y + h) * t_len + r;

  float qr[32], dor[32], dq_acc[32];
  load_half(qr, q + b * sq.b + h * sq.h + r * sq.t, half);
  load_half(dor, dout + b * sdo.b + h * sdo.h + r * sdo.t, half);
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  const int my_seg = segb[r];
  const float my_lse = lse[row], my_di = di[row];

  for (int kt = 0; kt < t_len; kt += BK) {
    __syncthreads();
    stage_f32(k_s, kb, sk.t, kt, tid);
    stage_f32(v_s, vb, sv.t, kt, tid);
    if (tid < BK) kseg_s[tid] = segb[kt + tid];
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      const float4* kr = &k_s[j * (HD / 4)];
      const float s = dot_pair(qr, kr, half);
      const float dpv = dot_pair(dor, &v_s[j * (HD / 4)], half);
      const float p = kseg_s[j] == my_seg ? expf(s * sm_scale - my_lse) : 0.f;
      axpy_half(dq_acc, p * (dpv - my_di) * sm_scale, kr, half);
    }
  }
  store_half(dq + b * sdq.b + h * sdq.h + r * sdq.t, dq_acc, half);
}


}  // namespace

// ------------------------------------------------------------------- host

namespace {

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the library
// links against the runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a bf16 [B, H, T, 64] view with element strides s: dims (d,
// t, h, b), a box of one 64-row tile, 128-byte swizzle (wgmma's layout).
cudaError_t rows_map(CUtensorMap* map, const void* base, Strides s, int batch, int heads,
                     int t_len) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  // a dimension of size 1 may carry any stride; give it a legal one
  const long long st = s.t * 2, sh = heads > 1 ? s.h * 2 : st * t_len,
                  sb = batch > 1 ? s.b * 2 : sh * heads;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st), static_cast<cuuint64_t>(sh),
                                 static_cast<cuuint64_t>(sb)};
  const cuuint32_t box[4] = {HD, 64, 1, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

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
  const size_t smem = Smem<STAGES>::bytes(t_len / 64);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(t_len / 64, heads, batch);
  kernel<<<grid, BF16_THREADS, smem, stream>>>(m.q, m.k, m.v, m.dout, args...);
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
  const dim3 grid(t_len / BK, heads, batch);
  dkv_f32_kernel<<<grid, F32_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seg, lse, di, static_cast<const float*>(dout), static_cast<float*>(dk),
      static_cast<float*>(dv), t_len, sm_scale, sq, sk, sv, sdo, sdk, sdv);
  return cudaGetLastError();
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
  const dim3 grid(t_len / BQ, heads, batch);
  dq_f32_kernel<<<grid, F32_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seg, lse, di, static_cast<const float*>(dout), static_cast<float*>(dq), t_len, sm_scale,
      sq, sk, sv, sdo, sdq);
  return cudaGetLastError();
}
