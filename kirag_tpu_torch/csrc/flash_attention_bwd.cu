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
#include "hopper.cuh"

namespace {

using namespace kirag_flash;

constexpr int F32_THREADS = 2 * BQ;  // two threads per row

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
