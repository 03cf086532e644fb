// int4_matmul: weight-only 4-bit matmul of a decode step (K6).
//
// Replaces the TPU kernel kirag_tpu/ops/pallas_qmm.py::_qmm_kernel (launched
// by int4_matmul, called from kirag_tpu/models/llm.py::_dense for every
// projection of a 4-bit Llama when a step has at most 32 rows). For
// x [rows, in] (bf16 or f32), packed [in/2, out] uint8 and scales [in/64, out]
// f32 it writes
//
//     out[r, j] = sum_s scales[s, j] * sum_{i in block s} x[r, i] * w[i, j]
//
// where packed[i, j] holds w[2i, j] in its low nibble and w[2i + 1, j] in its
// high nibble: signed integers in [-8, 7] (linear int4), or, with a codebook,
// unsigned indices into 16 f32 values rounded to bf16 (NF4). Each block's
// partial sum is f32, multiplied by its f32 scale and added as acc + part *
// scale, as the reference does; the output is x's dtype.
//
// What bounds it on the H100: the bytes. A decode step of Llama-3-8B at NF4
// reads 3.75 GB of packed weights and 0.47 GB of scales, 1.26 ms at
// 3.35 TB/s, against 2 * rows * in * out operations that the tensor cores do
// in a tenth of that at rows <= 32. So the design reads each byte once and
// keeps enough of them in flight:
// - One launch a call. A block owns 128 output columns, all rows (up to 32;
//   more rows take one block row per 32) and a contiguous range of the 64-row
//   scale blocks. A cluster of 1-16 blocks along the grid's y shares the
//   columns and splits the reduction. At the end each block leaves its f32
//   sums in shared memory, and each block of the cluster adds, for its share
//   of the columns, the sums of all blocks in rank order (the order of their
//   ranges) through distributed shared memory: the same order on every run,
//   no atomics, no workspace.
// - Every packed byte is read from device memory once a call and decoded
//   once, for all rows together: a 4-stage cp.async ring brings each scale
//   block's [32 packed rows x 128 columns] tile, its scales and x's 64
//   values of every row (zeros past the last row, never read) into shared
//   memory; each thread's copy addresses are worked out once and move by a
//   fixed stride a scale block. Blocks are small (23-37 KB, under 80
//   registers a thread at 1-8 rows), so an SM holds several, each with 12 KB
//   of weights in flight.
// - bf16 rows go through the tensor cores (mma.sync m16n8k16, bf16 -> f32),
//   the operands swapped: output columns are M, x's rows N (8, 16, 24 or 32)
//   and the input rows K. A lane's A fragment holds the k pairs (2t, 2t+1) of
//   its columns, one packed byte each, so a byte decodes into one bf16x2
//   register; a lane owns 4 adjacent columns of its warp's 32 (two m-tiles),
//   so it reads them as one 4-byte word of a packed row, and the tile's
//   16-byte chunks are swizzled so that a warp's four rows hit distinct
//   banks. x's B fragments come by ldmatrix from rows padded to 144 bytes.
//   Each scale block gets fresh accumulators over its four k16 steps, then
//   acc = acc + part * scale in f32 with the column's scale. mma.sync is
//   enough: at N <= 32 the products take a fraction of the bytes' time, and
//   A, decoded in registers, needs no shared-memory layout of its own.
// - The nibbles are decoded in registers, exactly. Linear int4: prmt
//   builds each byte's bf16x2 of 128 + (n ^ 8) from 0x43 exponent bytes,
//   and one bf16x2 fma subtracts 136. NF4: the 16 levels, rounded to bf16,
//   live as low and high bytes in eight registers, looked up by prmt. The
//   decode is most of the instructions (13 a word of 4 bytes, NF4 22), so
//   at 1-8 rows the kernel needs many warps an SM to issue them.
// - f32 rows stay on the CUDA cores in f32 (TF32 would round x): each thread
//   owns one column and all rows, through the same ring, decode and
//   reduction, with no speed aim.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 128;    // four warps, 32 columns each
constexpr int TILE_COLS = 128;  // output columns per block
constexpr int SUB = 32;         // packed rows per scale block (64 input rows)
constexpr int STAGES = 4;       // cp.async ring depth
constexpr int MAX_CLUSTER = 16;
constexpr int W_BYTES = SUB * TILE_COLS;  // one scale block's packed tile
constexpr int S_BYTES = TILE_COLS * 4;    // its scales

// The stage layout of one instantiation (NT 8-row tiles of x, N rows) in
// bytes: the packed tile, its scales, x's 64 values of every row.
template <typename T, int NT>
struct Geo {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int N = 8 * NT;
  static constexpr int X_ROW = BF16 ? 64 * 2 + 16 : 64 * 4;  // bytes a row of x's 64 values
  static constexpr int X_CHUNKS = 64 * sizeof(T) / 16;
  static constexpr int S_OFF = W_BYTES;
  static constexpr int X_OFF = S_OFF + S_BYTES;
  static constexpr int STAGE = X_OFF + N * X_ROW;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(N * TILE_COLS * 4 <= SMEM, "the reduction reuses the ring");
};

// 16-byte chunk c of packed row r of a tile lies at chunk c ^ swizzle(r):
// the four rows a warp reads together (8 lanes each, 32 bytes) fall in
// distinct banks.
__device__ __forceinline__ int w_offset(int r, int byte) {
  return r * TILE_COLS + ((((byte >> 4) ^ ((r & 3) << 1))) << 4) + (byte & 15);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros and reads
// nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster; shared-memory writes before it
// are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ----------------------------------------------------------------- decode

// The NF4 levels rounded to bf16 (round to nearest even, as the reference's
// lookup rounds): low bytes of levels 4k..4k+3 in lo[k], high bytes in hi[k].
struct Levels {
  uint32_t lo[4], hi[4];
};

__device__ __forceinline__ Levels load_levels(const float* codebook) {
  Levels t;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t.lo[k] = 0;
    t.hi[k] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t v = __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(codebook + 4 * k + b)));
      t.lo[k] |= (v & 0xffu) << (8 * b);
      t.hi[k] |= (v >> 8) << (8 * b);
    }
  }
  return t;
}

// prmt in its default mode: a selector nibble below 8 copies that byte of
// {b, a}, one of 8 or more fills the byte with the sign of byte (nibble & 7)
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The four bytes of w (four columns of one packed row) as four bf16x2
// registers: r[k] = (weight of byte k's low nibble, of its high nibble).
template <bool NF4>
__device__ __forceinline__ void decode_word(uint32_t w, const Levels& t, uint32_t (&r)[4]) {
  if (NF4) {
    // nibble n looks up levels 0-7 as itself and levels 8-15 as n ^ 8 (a
    // nibble of 8 or more, sign mode, gives a byte that is not picked); its
    // bit 3 picks byte i of the first lookup or byte 4 + i of the second
    const uint32_t pick = ((w >> 1) & 0x44444444u) | 0x32103210u;
    const uint32_t wx = w ^ 0x88888888u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t s = w >> (16 * h), sx = wx >> (16 * h), p = pick >> (16 * h);
      const uint32_t lo = prmt(prmt(t.lo[0], t.lo[1], s), prmt(t.lo[2], t.lo[3], sx), p);
      const uint32_t hi = prmt(prmt(t.hi[0], t.hi[1], s), prmt(t.hi[2], t.hi[3], sx), p);
      r[2 * h] = prmt(lo, hi, 0x5140);      // byte 2h:   lo, hi nibble
      r[2 * h + 1] = prmt(lo, hi, 0x7362);  // byte 2h+1
    }
  } else {
    // (n ^ 8) in [0, 15] is the mantissa of the bf16 128 + (n ^ 8)
    const uint32_t lo = (w & 0x0f0f0f0fu) ^ 0x08080808u;
    const uint32_t hi = ((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u;
    const uint32_t pq[2] = {prmt(lo, hi, 0x5140), prmt(lo, hi, 0x7362)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t v = prmt(pq[k >> 1], 0x43434343u, (k & 1) ? 0x4342 : 0x4140);
      // v * 1 - 136, exact
      asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r[k]) : "r"(v), "r"(0x3f803f80u),
          "r"(0xc308c308u));
    }
  }
}

// A thread's share of every stage's copies, with its addresses worked out
// once: its two 16-byte chunks of the packed tile (rows r and r + 16), one
// of the scales (threads < 32) and up to XQ of x's rows, each moving by a
// fixed stride from one scale block to the next.
template <typename T, int NT>
struct Loader {
  using G = Geo<T, NT>;
  static constexpr int X_TOTAL = G::N * G::X_CHUNKS;
  static constexpr int XQ = (X_TOTAL + THREADS - 1) / THREADS;
  const uint8_t* w;
  const float* sc;
  const T* xp[XQ];
  int64_t w_step, w_half;  // bytes a scale block, 16 packed rows
  uint32_t w_dst, x_dst[XQ], x_bytes[XQ];
  int s_step;

  __device__ __forceinline__ Loader(const T* x, const uint8_t* packed, const float* scales,
                                    int rows, int row0, int in_dim, int out_dim, int col0) {
    const int r = threadIdx.x >> 3, c = (threadIdx.x & 7) << 4;
    w = packed + static_cast<int64_t>(r) * out_dim + col0 + c;
    w_step = static_cast<int64_t>(SUB) * out_dim;
    w_half = static_cast<int64_t>(16) * out_dim;
    w_dst = w_offset(r, c);
    sc = scales + col0 + 4 * (threadIdx.x & 31);
    s_step = out_dim;
#pragma unroll
    for (int k = 0; k < XQ; ++k) {
      const int q = threadIdx.x + k * THREADS;
      const int n = q / G::X_CHUNKS, c16 = q % G::X_CHUNKS;
      const bool real = q < X_TOTAL && row0 + n < rows;
      // a row past the last reads nothing (size 0 writes zeros) from row 0
      xp[k] = x + static_cast<int64_t>(real ? row0 + n : 0) * in_dim +
              c16 * (16 / static_cast<int>(sizeof(T)));
      x_dst[k] = G::X_OFF + n * G::X_ROW + c16 * 16;
      x_bytes[k] = real ? 16 : 0;
    }
  }

  // scale block s into the stage at shared address `base`
  __device__ __forceinline__ void load(uint32_t base, int s) const {
    const uint8_t* ws = w + s * w_step;
    cp_async16(base + w_dst, ws, 16);
    cp_async16(base + w_dst + 16 * TILE_COLS, ws + w_half, 16);
    if (threadIdx.x < S_BYTES / 16) {
      cp_async16(base + G::S_OFF + threadIdx.x * 16, sc + s * s_step, 16);
    }
#pragma unroll
    for (int k = 0; k < XQ; ++k) {
      if (k * THREADS + static_cast<int>(threadIdx.x) < X_TOTAL) {
        cp_async16(base + x_dst[k], xp[k] + s * 64, x_bytes[k]);
      }
    }
  }
};

// -------------------------------------------------------------- the kernel

template <typename T, int NT, bool NF4>
__global__ void __launch_bounds__(THREADS)
    qmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scales, const float* __restrict__ codebook,
               T* __restrict__ out, int rows, int half, int out_dim, int steps) {
  using G = Geo<T, NT>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t rank = cluster_rank(), ranks = cluster_size();
  const int col0 = blockIdx.x * TILE_COLS;
  const int row0 = blockIdx.z * G::N;
  const int in_dim = 2 * half;
  const int s0 = static_cast<int>(rank) * steps;  // this block's scale blocks: s0 .. s0 + steps
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Levels levels = {};
  if constexpr (NF4) levels = load_levels(codebook);

  const Loader<T, NT> loader(x, packed, scales, rows, row0, in_dim, out_dim, col0);
  const uint32_t ring = smem_u32(smem);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < steps) loader.load(ring + j * G::STAGE, s0 + j);
    cp_async_commit();
  }

  // bf16: a lane's accumulators, C fragments of 2 x NT tiles (its 4 columns,
  // 2 per m-tile, by x's rows); f32: one column's sums for N rows
  constexpr int ACC = G::BF16 ? 8 * NT : G::N;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  // bf16: the lane's first column, 4 of them a lane, 32 a warp
  const int cbyte = (threadIdx.x >> 5) * 32 + 4 * g;
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < steps) {
      loader.load(ring + ((j + STAGES - 1) % STAGES) * G::STAGE, s0 + j + STAGES - 1);
    }
    cp_async_commit();
    const uint8_t* wt = smem + (j % STAGES) * G::STAGE;
    const float* sc = reinterpret_cast<const float*>(wt + G::S_OFF);
    const uint8_t* xs = wt + G::X_OFF;
    float part[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) part[i] = 0.f;

    if constexpr (G::BF16) {
      // x's B fragments for the 4 k16 steps: b[nt][2 ks + e]
      uint32_t b[NT][8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          const int n = 8 * nt + (lane & 7), k = 32 * hk + 8 * (lane >> 3);
          uint32_t r4[4];
          ldmatrix_x4(r4, smem_u32(xs + n * G::X_ROW + 2 * k));
#pragma unroll
          for (int e = 0; e < 4; ++e) b[nt][4 * hk + e] = r4[e];
        }
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // packed rows 8 ks + t (k pair t) and 8 ks + t + 4 (k pair t + 4) of
        // the lane's 4 columns: byte 2m of a word is row g of m-tile m,
        // byte 2m + 1 its row g + 8
        uint32_t ra[4], rb[4];
        decode_word<NF4>(*reinterpret_cast<const uint32_t*>(wt + w_offset(8 * ks + t, cbyte)),
                         levels, ra);
        decode_word<NF4>(
            *reinterpret_cast<const uint32_t*>(wt + w_offset(8 * ks + t + 4, cbyte)), levels, rb);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_bf16(part + (m * NT + nt) * 4, ra[2 * m], ra[2 * m + 1], rb[2 * m],
                     rb[2 * m + 1], b[nt][2 * ks], b[nt][2 * ks + 1]);
          }
      }
      // acc + part * scale: C row g is the lane's column 2m, row g + 8 column 2m + 1
      const float4 s4 = *reinterpret_cast<const float4*>(sc + cbyte);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = (m * NT + nt) * 4 + e;
            acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], s[2 * m + (e >> 1)]));
          }
    } else {
      const int c = threadIdx.x;  // this thread's column
#pragma unroll 2
      for (int r4 = 0; r4 < SUB; r4 += 4) {
        const uint32_t w = wt[w_offset(r4, c)] | (wt[w_offset(r4 + 1, c)] << 8) |
                           (wt[w_offset(r4 + 2, c)] << 16) |
                           (static_cast<uint32_t>(wt[w_offset(r4 + 3, c)]) << 24);
        uint32_t r[4];
        decode_word<NF4>(w, levels, r);
        float wv[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wv[2 * k] = __uint_as_float(r[k] << 16);
          wv[2 * k + 1] = __uint_as_float(r[k] & 0xffff0000u);
        }
#pragma unroll
        for (int n = 0; n < G::N; ++n) {
          const float4* xr = reinterpret_cast<const float4*>(xs + n * G::X_ROW + 8 * r4);
          const float4 x0 = xr[0], x1 = xr[1];
          const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) part[n] = fmaf(xv[k], wv[k], part[n]);
        }
      }
      const float s = sc[c];
#pragma unroll
      for (int n = 0; n < G::N; ++n) acc[n] = __fadd_rn(acc[n], __fmul_rn(part[n], s));
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's sums into red[n][column] (the ring is free now)
  float* red = reinterpret_cast<float*>(smem);
  if constexpr (G::BF16) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 8 * nt + 2 * t + (e & 1), col = cbyte + 2 * m + (e >> 1);
          red[n * TILE_COLS + col] = acc[(m * NT + nt) * 4 + e];
        }
  } else {
#pragma unroll
    for (int n = 0; n < G::N; ++n) red[n * TILE_COLS + threadIdx.x] = acc[n];
  }
  cluster_sync();

  // this block's share of the columns: the blocks' sums added in rank order
  const int share = TILE_COLS / static_cast<int>(ranks);
  const int real = min(G::N, rows - row0);
  const uint32_t red_addr = smem_u32(red);
  for (int e = threadIdx.x; e < real * share; e += THREADS) {
    const int n = e / share, col = static_cast<int>(rank) * share + e % share;
    const uint32_t addr = red_addr + (n * TILE_COLS + col) * 4;
    float v[MAX_CLUSTER];
#pragma unroll
    for (int src = 0; src < MAX_CLUSTER; ++src) {  // all loads first, then the sum
      if (src < static_cast<int>(ranks)) v[src] = ld_cluster(addr, src);
    }
    float sum = v[0];
#pragma unroll
    for (int src = 1; src < MAX_CLUSTER; ++src) {
      if (src < static_cast<int>(ranks)) sum = __fadd_rn(sum, v[src]);
    }
    T* o = out + static_cast<int64_t>(row0 + n) * out_dim + col0 + col;
    if constexpr (G::BF16) {
      *o = __float2bfloat16_rn(sum);
    } else {
      *o = sum;
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

template <typename T, int NT, bool NF4>
cudaError_t launch(const void* x, const uint8_t* packed, const float* scales,
                   const float* codebook, void* out, int rows, int half, int out_dim,
                   dim3 grid, int steps, cudaStream_t stream) {
  using G = Geo<T, NT>;
  auto kernel = qmm_kernel<T, NT, NF4>;
  // the kernel's attributes, set once on each device (a decode step makes
  // hundreds of calls; setting them twice in a race is harmless)
  static std::atomic<uint64_t> ready{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  const uint64_t bit = device < 64 ? 1ull << device : 0;  // past 64: every call
  if (err == cudaSuccess && !(ready.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err == cudaSuccess) ready.fetch_or(bit);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the returned code
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), packed, scales, codebook,
                           static_cast<T*>(out), rows, half, out_dim, steps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool NF4>
cudaError_t launch_nt(int nt, const void* x, const uint8_t* packed, const float* scales,
                      const float* codebook, void* out, int rows, int half, int out_dim,
                      dim3 grid, int steps, cudaStream_t s) {
  switch (nt) {
    case 1:
      return launch<T, 1, NF4>(x, packed, scales, codebook, out, rows, half, out_dim, grid, steps,
                               s);
    case 2:
      return launch<T, 2, NF4>(x, packed, scales, codebook, out, rows, half, out_dim, grid, steps,
                               s);
    case 3:
      return launch<T, 3, NF4>(x, packed, scales, codebook, out, rows, half, out_dim, grid, steps,
                               s);
    case 4:
      return launch<T, 4, NF4>(x, packed, scales, codebook, out, rows, half, out_dim, grid, steps,
                               s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [rows, 2 * half] contiguous, bf16 (x_bf16 = 1) or f32 (0); packed uint8
// [half, out_dim]; scales f32 [half / 32, out_dim]; codebook f32 [16] for NF4
// or null for linear int4; out [rows, out_dim] in x's dtype; every pointer
// 16-byte aligned. The cut is kirag_tpu_torch.kernels.qmm.Plan's, checked
// here to cover the call exactly: nt 8-row tiles of x a block (1-4) and
// row_blocks blocks of them along z, col_blocks tiles of 128 columns along x,
// a cluster of 1, 2, 4, 8 or 16 blocks along y whose ranks take steps scale
// blocks each. Returns the launch's cudaError_t.
extern "C" int kirag_int4_matmul(const void* x, int x_bf16, const uint8_t* packed,
                                 const float* scales, const float* codebook, void* out, int rows,
                                 int half, int out_dim, int nt, int row_blocks, int col_blocks,
                                 int cluster, int steps, void* stream) {
  if (rows < 1 || nt < 1 || nt > 4 || row_blocks != (rows + 8 * nt - 1) / (8 * nt) ||
      row_blocks > 65535 || col_blocks < 1 || out_dim != col_blocks * TILE_COLS ||
      cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0 || steps < 1 ||
      half != cluster * steps * SUB) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(col_blocks, cluster, row_blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return codebook ? launch_nt<__nv_bfloat16, true>(nt, x, packed, scales, codebook, out, rows,
                                                     half, out_dim, grid, steps, s)
                    : launch_nt<__nv_bfloat16, false>(nt, x, packed, scales, codebook, out, rows,
                                                      half, out_dim, grid, steps, s);
  }
  return codebook ? launch_nt<float, true>(nt, x, packed, scales, codebook, out, rows, half,
                                           out_dim, grid, steps, s)
                  : launch_nt<float, false>(nt, x, packed, scales, codebook, out, rows, half,
                                            out_dim, grid, steps, s);
}
