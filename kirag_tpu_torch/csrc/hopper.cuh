// The Hopper pieces that the flash attention kernels share (the forward,
// flash_attention.cu, and the two backward kernels, flash_attention_bwd.cu):
// for the bf16 kernels mbarriers, TMA copies and the 4-d tensor maps that
// feed them, wgmma with its 128-byte-swizzle shared-memory descriptors, and
// the ring of stages that streams the kept 64-row tiles of two operands past
// a block's resident tiles; for the f32 kernels the cp.async copies of their
// rings.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is looked up at run time)

#include "flash_attention.cuh"

namespace kirag_flash {

constexpr int TILE_BYTES = 64 * HD * 2;  // one [64 rows x 64] bf16 tile, 128-byte swizzled
constexpr int ROW_BYTES = 64 * 4;        // one tile's lse, di or segment ids
// a ring stage: two streamed tiles, then lse, di and segment ids; 1024-byte
// aligned (the swizzle's period)
constexpr int STAGE_BYTES = 2 * TILE_BYTES + 1024;

template <int RESIDENT, int STAGES>
struct Smem {  // byte offsets from a 1024-aligned base: the resident tiles first
  static constexpr int RING = RESIDENT * TILE_BYTES;
  static constexpr int BARS = RING + STAGES * STAGE_BYTES;  // full[STAGES], resident
  static constexpr int RANGES = BARS + (STAGES + 1) * 8;
  static size_t bytes(int n_tiles) { return 1024 + RANGES + 8 * static_cast<size_t>(n_tiles); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- cp.async

// 16 bytes from device memory into shared memory, asynchronously (the f32
// kernels' tile rings)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // until at most N of this thread's committed groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ mbarrier, TMA

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

// ------------------------------------------------------------------- wgmma

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

// S = A B^T (A: the resident [64 x 64] tile at a, B: the streamed tile at b,
// both K-major over d)
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
// serialize the products); the block's co-resident neighbours keep the
// tensor cores busy in the gaps.

// ------------------------------------------------------------------ the ring

// One block's shared memory: its RESIDENT tiles (K and V, or Q and dO, or
// the forward's Q) at base, then a ring of STAGES stages that streams the
// kept tiles of two other operands, each with its lse and di (when given)
// and segment ids. Thread 0 issues every copy (TMA, on the stage's
// mbarrier); a stage is refilled once the whole block is done with it.
template <int RESIDENT, int STAGES>
struct Ring {
  uint8_t* base;
  uint64_t* full;  // [STAGES + 1]: a stage's copies landed; [STAGES]: the resident tiles'
  int2* ranges;    // [n_tiles] each tile's segment range
  int2 own;        // the segment range of the block's own tile
  const CUtensorMap *map_a, *map_b;
  const int* segb;
  const float *lse_row, *di_row;
  int n_tiles, h, b;

  __device__ uint8_t* stage(int s) const {
    return base + Smem<RESIDENT, STAGES>::RING + s * STAGE_BYTES;
  }

  // the first tile from j on whose range meets the block's own: a tile pair
  // whose ranges do not overlap holds no same-segment pair
  __device__ int next(int j) const { return next_kept(ranges, own, j, n_tiles); }

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
// once (the block's own tile, blockIdx.x, of res_a to slot 0 and, for
// RESIDENT = 2, of res_b to slot 1), the block takes the tile ranges, and
// thread 0 then fills the ring with the first kept tiles. Returns once the
// resident tiles have landed, the first tile not yet issued in *ahead.
template <int RESIDENT, int STAGES>
__device__ __forceinline__ Ring<RESIDENT, STAGES> start_ring(
    uint8_t* raw, const CUtensorMap* res_a, const CUtensorMap* res_b, const CUtensorMap* map_a,
    const CUtensorMap* map_b, const int* segb, const float* lse_row, const float* di_row,
    int t_len, int* ahead) {
  static_assert(RESIDENT == 1 || RESIDENT == 2, "one or two resident tiles");
  using S = Smem<RESIDENT, STAGES>;
  uint8_t* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring<RESIDENT, STAGES> r{base,
                           reinterpret_cast<uint64_t*>(base + S::BARS),
                           reinterpret_cast<int2*>(base + S::RANGES),
                           make_int2(0, 0), map_a, map_b, segb, lse_row, di_row, t_len / 64,
                           static_cast<int>(blockIdx.y), static_cast<int>(blockIdx.z)};
  const int own = blockIdx.x;
  uint64_t* res_bar = &r.full[STAGES];
  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(&r.full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(res_bar, RESIDENT * TILE_BYTES);
    tma_tile(base, res_a, 64 * own, r.h, r.b, res_bar);
    if (RESIDENT == 2) tma_tile(base + TILE_BYTES, res_b, 64 * own, r.h, r.b, res_bar);
  }
  tile_ranges(r.ranges, segb, r.n_tiles);
  __syncthreads();
  r.own = r.ranges[own];
  int j = r.next(0);
  for (int s = 0; s < STAGES && j < r.n_tiles; ++s, j = r.next(j + 1)) {
    if (threadIdx.x == 0) r.load(j, s);
  }
  *ahead = j;
  mbar_wait(res_bar, 0);
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

// -------------------------------------------------------------------- host

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the library
// links against the runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
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
inline cudaError_t rows_map(CUtensorMap* map, const void* base, Strides s, int batch, int heads,
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

}  // namespace kirag_flash
