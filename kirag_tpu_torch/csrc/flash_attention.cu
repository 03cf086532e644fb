// flash_attention: segment-id attention for the BERT encoder, head_dim 64.
//
// Replaces the TPU kernel that kirag_tpu/models/bert.py::_flash_attention
// calls: JAX's Pallas flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, forward body
// _flash_attention_kernel_single_batch). For q, k, v [B, H, T, 64] and one
// segment id per token seg [B, T] it writes
//
//     out[b, h, i] = sum_j softmax_j(sm_scale * q_i . k_j) v_j
//
// over the keys j with seg[b, j] == seg[b, i]. Every query sees at least
// itself, so no row is empty; padding (segment 0) attends among itself.
// Logits, the running maximum and the running sum are f32; for bf16 inputs
// the probabilities are rounded to bf16 before the product with V (as the
// reference's p.astype(v.dtype) @ v) and the output is bf16.
//
// What bounds it on the H100: at the encoder's shapes (B = 128, H = 16,
// T = 128..512) the bf16 kernel by bytes, the f32 kernel by operations. The
// operations are 4 * 64 per same-segment (query, key) pair and head (Q K^T
// and P V): at T = 512, 137 GFLOP if every pair shared a segment, 0.14 ms at
// the tensor cores' 989 TFLOP/s and 2.0 ms at the CUDA cores' 67; q, k, v
// and out are 0.54 GB (bf16), 0.16 ms at 3.35 TB/s. The [T, T] scores never
// reach device memory.
//
// What the design does about it:
// - bf16, tensor cores through wgmma (m64n64k16, bf16 in, f32 accumulate).
//   A block is one warpgroup that owns 64 queries; its query tile is loaded
//   once by TMA into 128-byte-swizzled shared memory. K and V stream through
//   a ring of two stages that thread 0 fills by TMA from 4-d tensor maps over
//   the strided [B, H, T, 64] views (so q, k, v may be slices of the fused
//   QKV projection), each tile's 64 segment ids riding on the stage's
//   mbarrier as a bulk copy; a stage is refilled as soon as the block is
//   done with it. S = Q K^T takes both operands from shared memory; the
//   online softmax runs on the f32 accumulators; P is rounded to bf16 in the
//   accumulator layout and fed as the register A operand of O += P V, with
//   the V tile read MN-major through the descriptor's transpose bit, so no
//   transposed copy of V exists. hopper.cuh holds the pieces the backward
//   kernels share.
// - The bf16 kernel is latency-bound: a warpgroup's tile is S, a wait, 32
//   exponentials a thread, P V, a wait. So it keeps the instructions between
//   the products few and the warpgroups an SM many: logits in base-2 units
//   (sm_scale * log2(e) folded into one multiply, exponentials as bare
//   MUFU.EX2), no per-key segment test in a tile that holds one segment,
//   the row's own, no rescale of O while no row's maximum moved; 96
//   registers and 44 KB a block, five blocks an SM.
// - f32, the CUDA cores (f32 FMAs, no TF32, so the card can hold it against
//   the plain version at a tight tolerance), tiled as an SGEMM is: a block of
//   256 threads owns 128 queries; each thread a micro-tile of 8 queries x 4
//   keys of S and 8 queries x 4 columns of O, so every 16-byte shared-memory
//   read feeds 8 or 16 FMAs. Row maxima and sums meet across a row's 16
//   threads by shuffles; P goes through shared memory (transposed) to the
//   O += P V micro-tiles; K and V tiles are double-buffered by cp.async, the
//   next kept tile loading while the block computes this one.
// - Segment tile skipping, exact, in both: the block takes every 64-key
//   tile's smallest and largest segment id; a key tile whose range misses
//   the range of the block's own queries is neither loaded nor computed.
//   Every logit of such a tile is -inf, so computing it would change no bit:
//   with a finite running maximum m the tile gives mn = max(m, -inf) = m,
//   alpha = exp(m - m) = 1 and p = exp(-inf - m) = 0, so m, l and O stay bit
//   for bit the same (O += 0 . v); with m = -inf (no key of the row's
//   segment seen yet) the stand-in maximum is 0, alpha = p = 0, and O and l
//   stay 0. (The same holds for exp2.) A range test, so it holds for
//   segment ids in any order.
// - A key tile wholly in another segment for some rows gives them logits of
//   -inf: the running maximum stays -inf and is replaced by 0 for the
//   exponentials, so exp(-inf - 0) = 0 and no NaN appears (the reference's
//   finite mask value and l == 0 guards serve the same purpose).
// - The output is written through element strides as [B, T, H, 64] for the
//   next projection.
// - For training, each row's lse = m + log(l) (in units of sm_scale * q . k)
//   is written out (the reference keeps l and m); the backward kernels
//   (flash_attention_bwd.cu) recompute the probabilities from it. At
//   inference lse is null and nothing changes.
#include "hopper.cuh"

namespace {

using namespace kirag_flash;

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ float ex2(float x) {  // 2^x, MUFU.EX2 (2^-inf = 0)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ring depth: a 16 KB stage (K, V, segment ids) and the resident 8 KB query
// tile make 44 KB a block, so five blocks fit on an SM (three stages would
// fit three)
constexpr int FWD_STAGES = 2;

// Block: queries 64 * blockIdx.x .. + 63 of head h, sequence b, one
// warpgroup (S and O as [64 queries x 64] accumulators); streams the kept
// key tiles of K and V. Fragment layouts: hopper.cuh's wgmma_ss.
__global__ void __launch_bounds__(BF16_THREADS, 5)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const int* __restrict__ seg,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int t_len,
                      float sm_scale, Strides so) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int* segb = seg + static_cast<long long>(b) * t_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int r0 = 64 * blockIdx.x + 16 * warp + g, r1 = r0 + 8;
  const int seg0 = segb[r0], seg1 = segb[r1];
  int ahead;
  const Ring<1, FWD_STAGES> r = start_ring<1, FWD_STAGES>(smem_raw, &tq, nullptr, &tk, &tv, segb,
                                                          nullptr, nullptr, t_len, &ahead);
  const uint64_t q_desc = k_major(r.base);
  const float scale2 = sm_scale * 1.4426950408889634f;  // log2(e)

  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running maxima of rows r0, r1
  float l0 = 0.f, l1 = 0.f;                      // this thread's part of the running sums
  float s[32], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = o[i] = 0.f;
  int st_i = 0;
  uint32_t phase = 0;
  for (int j = r.next(0); j < r.n_tiles; j = r.next(j + 1)) {
    mbar_wait(&r.full[st_i], phase);
    const uint8_t* st = r.stage(st_i);  // K tile, V tile, -, -, segment ids
    wgmma_fence();
    issue_scores(s, q_desc, st);  // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    // element 4n + e is row r0 (e < 2) or r1, key 8n + 2c + e % 2; the
    // logits in base-2 units, t = sm_scale * log2(e) * q . k
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
    const int2 kr = r.ranges[j];
    if (kr.x == kr.y && kr.x == seg0 && kr.x == seg1) {  // every key of the tile is kept
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * n + e] *= scale2;
          s[4 * n + 2 + e] *= scale2;
          mx0 = fmaxf(mx0, s[4 * n + e]);
          mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
        }
      }
    } else {
      const int* kseg_s = stage_seg(st);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int2 ks = *reinterpret_cast<const int2*>(kseg_s + 8 * n + 2 * c);
        s[4 * n] = ks.x == seg0 ? s[4 * n] * scale2 : -CUDART_INF_F;
        s[4 * n + 1] = ks.y == seg0 ? s[4 * n + 1] * scale2 : -CUDART_INF_F;
        s[4 * n + 2] = ks.x == seg1 ? s[4 * n + 2] * scale2 : -CUDART_INF_F;
        s[4 * n + 3] = ks.y == seg1 ? s[4 * n + 3] * scale2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
    }
    const float mn0 = fmaxf(m0, row_max4(mx0)), mn1 = fmaxf(m1, row_max4(mx1));
    // a row that has seen no key of its segment yet keeps a maximum of -inf;
    // 0 stands in for it, so every exponential below is exp2(-inf) = 0
    const float mu0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float mu1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float alpha0 = ex2(m0 - mu0), alpha1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
    if (alpha0 != 1.f || alpha1 != 1.f) {  // a row's maximum moved
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n] *= alpha0;
        o[4 * n + 1] *= alpha0;
        o[4 * n + 2] *= alpha1;
        o[4 * n + 3] *= alpha1;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[4 * n] = ex2(s[4 * n] - mu0);
      s[4 * n + 1] = ex2(s[4 * n + 1] - mu0);
      s[4 * n + 2] = ex2(s[4 * n + 2] - mu1);
      s[4 * n + 3] = ex2(s[4 * n + 3] - mu1);
      l0 += s[4 * n] + s[4 * n + 1];
      l1 += s[4 * n + 2] + s[4 * n + 3];
    }
    // O += P V over the tile's keys, 16 at a time
    uint32_t pa[4][4];
    to_a(pa, s);
    fence_acc(o);
    wgmma_fence();
    issue_update(o, pa, st + TILE_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    __syncthreads();  // the stage is free
    if (ahead < r.n_tiles) {
      if (threadIdx.x == 0) r.load(ahead, st_i);
      ahead = r.next(ahead + 1);
    }
    if (++st_i == FWD_STAGES) st_i = 0, phase ^= 1;
  }

  const float sum0 = row_sum4(l0), sum1 = row_sum4(l1);
  const float inv0 = sum0 > 0.f ? 1.f / sum0 : 0.f, inv1 = sum1 > 0.f ? 1.f / sum1 : 0.f;
  __nv_bfloat16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * c;
    *reinterpret_cast<uint32_t*>(ob + r0 * so.t + col) = pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(ob + r1 * so.t + col) = pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  if (lse != nullptr && c == 0) {  // the backward's residual: m + log(l) per row
    float* lb = lse + (static_cast<long long>(b) * gridDim.y + h) * t_len;
    lb[r0] = m0 * 0.6931471805599453f + logf(sum0);  // m in base-2 units, times ln(2)
    lb[r1] = m1 * 0.6931471805599453f + logf(sum1);
  }
}

// ------------------------------------------------------------------- f32

constexpr int F32_ROWS = 128;     // queries per block
constexpr int F32_THREADS = 256;  // 16 row groups x 16 column groups
constexpr int QS = HD + 4;        // f32 row stride of staged Q and K (bank spread)
constexpr int PS = F32_ROWS + 4;  // row stride of P^T

// Shared memory in floats: Q [128][QS], K [2][64][QS], V [2][64][64],
// P^T [64][PS] (key, then the block's rows in micro-tile order), segment ids
// [2][64], then each key tile's segment range.
struct F32Smem {
  static constexpr int Q = 0, K = Q + F32_ROWS * QS, V = K + 2 * 64 * QS, P = V + 2 * 64 * HD,
                       SEG = P + 64 * PS, RANGES = SEG + 2 * 64;
  static size_t bytes(int n_tiles) { return 4 * static_cast<size_t>(RANGES) + 8 * n_tiles; }
};

__device__ __forceinline__ float row_max16(float x) {  // over the 16 lanes of a row group
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Starts the copies of key tile j (K and V rows, segment ids) into buffer bb.
__device__ __forceinline__ void stage_kv(float* sm, int bb, const float* kb, const float* vb,
                                         const int* segb, long long skt, long long svt, int j) {
  float* ks = sm + F32Smem::K + bb * 64 * QS;
  float* vs = sm + F32Smem::V + bb * 64 * HD;
  for (int i = threadIdx.x; i < 64 * HD / 4; i += F32_THREADS) {
    const int key = i / (HD / 4), d = 4 * (i % (HD / 4));
    cp_async16(ks + key * QS + d, kb + (64 * j + key) * skt + d);
    cp_async16(vs + key * HD + d, vb + (64 * j + key) * svt + d);
  }
  if (threadIdx.x < 16) {
    cp_async16(sm + F32Smem::SEG + bb * 64 + 4 * threadIdx.x, segb + 64 * j + 4 * threadIdx.x);
  }
}

// Block: queries 128 * blockIdx.x .. + 127 (those below t_len) of head h,
// sequence b. Thread (warp w, lane) is row group rg = 2w + lane / 16 and
// column group cg = lane % 16: it owns rows rg + 16i (i < 8), the keys
// cg + 16t (t < 4) of each tile's S and the columns 4cg .. 4cg + 3 of O. So a
// warp's reads of a staged Q row, K row or P^T row hit distinct banks or
// broadcast.
__global__ void __launch_bounds__(F32_THREADS, 1)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     float* __restrict__ out, float* __restrict__ lse, int t_len,
                     float sm_scale, Strides sq, Strides sk, Strides sv, Strides so) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x % 32;
  const int rg = 2 * (threadIdx.x / 32) + lane / 16, cg = lane % 16;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = F32_ROWS * blockIdx.x, n_rows = min(F32_ROWS, t_len - q0);
  const int n_tiles = t_len / 64;
  const int* segb = seg + static_cast<long long>(b) * t_len;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* q_s = sm + F32Smem::Q;
  float* p_s = sm + F32Smem::P;
  int2* ranges = reinterpret_cast<int2*>(sm + F32Smem::RANGES);

  // the block's queries (zeros past t_len, whose rows are never written)
  const float* qb = q + b * sq.b + h * sq.h;
  for (int i = threadIdx.x; i < F32_ROWS * HD / 4; i += F32_THREADS) {
    const int row = i / (HD / 4), d = 4 * (i % (HD / 4));
    float* dst = sm + F32Smem::Q + row * QS + d;
    if (row < n_rows) {
      cp_async16(dst, qb + (q0 + row) * sq.t + d);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  tile_ranges(ranges, segb, n_tiles);
  __syncthreads();
  int2 own = ranges[q0 / 64];
  if (n_rows > 64) {
    const int2 second = ranges[q0 / 64 + 1];
    own = make_int2(min(own.x, second.x), max(own.y, second.y));
  }
  int j = next_kept(ranges, own, 0, n_tiles);  // the block's own tiles are always kept
  stage_kv(sm, 0, kb, vb, segb, sk.t, sv.t, j);
  cp_async_commit();

  int qseg[8];
  float m[8], l[8], o[8][4];  // running maxima, this thread's part of the sums, O
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = rg + 16 * i;
    qseg[i] = row < n_rows ? segb[q0 + row] : 0;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  }

  for (int bb = 0; j < n_tiles; bb ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile j is in buffer bb; the block is done with buffer bb ^ 1
    const int jn = next_kept(ranges, own, j + 1, n_tiles);
    if (jn < n_tiles) stage_kv(sm, bb ^ 1, kb, vb, segb, sk.t, sv.t, jn);
    cp_async_commit();
    const float* ks = sm + F32Smem::K + bb * 64 * QS;
    const float* vs = sm + F32Smem::V + bb * 64 * HD;
    const int* kseg_s = reinterpret_cast<const int*>(sm + F32Smem::SEG) + bb * 64;

    float s[8][4];  // S = Q K^T: rows rg + 16i, keys cg + 16t
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(q_s + (rg + 16 * i) * QS + d);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        kv[t] = *reinterpret_cast<const float4*>(ks + (cg + 16 * t) * QS + d);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          s[i][t] = fmaf(qv[i].x, kv[t].x, s[i][t]);
          s[i][t] = fmaf(qv[i].y, kv[t].y, s[i][t]);
          s[i][t] = fmaf(qv[i].z, kv[t].z, s[i][t]);
          s[i][t] = fmaf(qv[i].w, kv[t].w, s[i][t]);
        }
      }
    }

    int kseg[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) kseg[t] = kseg_s[cg + 16 * t];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        s[i][t] = kseg[t] == qseg[i] ? s[i][t] * sm_scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][t]);
      }
      const float mn = fmaxf(m[i], row_max16(mx));
      const float mu = mn == -CUDART_INF_F ? 0.f : mn;  // as in the bf16 kernel
      const float alpha = expf(m[i] - mu);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        s[i][t] = expf(s[i][t] - mu);
        l[i] += s[i][t];
      }
    }
    // P^T: row cg + 16t holds this thread's 8 rows at columns 8rg .. 8rg + 7
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float* pr = p_s + (cg + 16 * t) * PS + 8 * rg;
      *reinterpret_cast<float4*>(pr) = make_float4(s[0][t], s[1][t], s[2][t], s[3][t]);
      *reinterpret_cast<float4*>(pr + 4) = make_float4(s[4][t], s[5][t], s[6][t], s[7][t]);
    }
    __syncthreads();

    // O += P V: rows rg + 16i, columns 4cg .. 4cg + 3
#pragma unroll 8
    for (int key = 0; key < 64; ++key) {
      const float4 pa = *reinterpret_cast<const float4*>(p_s + key * PS + 8 * rg);
      const float4 pb = *reinterpret_cast<const float4*>(p_s + key * PS + 8 * rg + 4);
      const float4 vv = *reinterpret_cast<const float4*>(vs + key * HD + 4 * cg);
      const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[i][0] = fmaf(p[i], vv.x, o[i][0]);
        o[i][1] = fmaf(p[i], vv.y, o[i][1]);
        o[i][2] = fmaf(p[i], vv.z, o[i][2]);
        o[i][3] = fmaf(p[i], vv.w, o[i][3]);
      }
    }
    j = jn;
  }

  float* ob = out + b * so.b + h * so.h;
  const long long lse_row = (static_cast<long long>(b) * gridDim.y + h) * t_len + q0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = rg + 16 * i;
    const float sum = row_sum16(l[i]);
    if (row < n_rows) {
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      *reinterpret_cast<float4*>(ob + (q0 + row) * so.t + 4 * cg) =
          make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
      if (lse != nullptr && cg == 0) lse[lse_row + row] = m[i] + logf(sum);
    }
  }
}

}  // namespace

// q, k, v, out: [batch, heads, t_len, 64] f32 (is_bf16 = 0) or bf16 (1), each
// addressed through its element strides (strides[3 * i .. 3 * i + 2] = batch,
// head and token strides of q, k, v, out in turn; d contiguous, rows 16-byte
// aligned); seg int32 [batch, t_len] contiguous and 16-byte aligned; t_len a
// multiple of 64. lse, f32 [batch, heads, t_len] contiguous, receives each
// row's m + log(l) (the log of its softmax denominator, in units of
// sm_scale * q . k) for the backward kernels; null at inference. Returns the
// launch's cudaError_t.
extern "C" int kirag_flash_attention(const void* q, const void* k, const void* v,
                                     const int* seg, void* out, float* lse, int is_bf16,
                                     int batch, int heads, int t_len, float sm_scale,
                                     const long long* strides, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = t_len / 64;
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), so = strides_at(strides, 3);
  if (is_bf16) {
    CUtensorMap maps[3];
    const void* bases[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
      const cudaError_t err = rows_map(&maps[i], bases[i], strides_at(strides, i), batch, heads,
                                       t_len);
      if (err != cudaSuccess) return err;
    }
    const size_t smem = Smem<1, FWD_STAGES>::bytes(n_tiles);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bf16_kernel<<<dim3(n_tiles, heads, batch), BF16_THREADS, smem, s>>>(
        maps[0], maps[1], maps[2], seg, static_cast<__nv_bfloat16*>(out), lse, t_len, sm_scale,
        so);
  } else {
    const size_t smem = F32Smem::bytes(n_tiles);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_f32_kernel<<<dim3((t_len + F32_ROWS - 1) / F32_ROWS, heads, batch), F32_THREADS, smem,
                       s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), seg, static_cast<float*>(out), lse,
                            t_len, sm_scale, sq, sk, sv, so);
  }
  return cudaGetLastError();
}
