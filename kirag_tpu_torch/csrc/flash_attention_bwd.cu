// flash_attention_bwd: the two backward kernels of the encoder's segment-id
// flash attention (flash_attention.cu), head_dim 64.
//
// Replace the TPU kernels of the Pallas flash attention's custom_vjp, which
// kirag_tpu/models/bert.py::_flash_attention reaches when the aligner trainer
// differentiates the encoder (jax/experimental/pallas/ops/tpu/
// flash_attention.py): _flash_attention_dkv_kernel (dK, dV) and
// _flash_attention_dq_kernel (dQ). For q, k, v, dO [B, H, T, 64], seg [B, T],
// the forward's lse = m + log(l) and di = rowsum(o * dO) (both f32 [B, H, T],
// di computed outside, as the reference does) they compute, over the pairs
// (i, j) with seg[j] == seg[i]:
//
//     P[i, j]  = exp(sm_scale * q_i . k_j - lse_i)        (0 for other segments)
//     dS[i, j] = P[i, j] * (dO_i . v_j - di_i) * sm_scale
//     dV = P^T dO,   dK = dS^T Q,   dQ = dS K
//
// with f32 logits and accumulators; for bf16 inputs P and dS are rounded to
// bf16 before their products (the reference's p.astype(do.dtype) and
// ds.astype(k.dtype)) and the outputs are bf16.
//
// What bounds them on the H100: operations. At the aligner's query shapes
// ([32, 16, 256, 64]) the two kernels do 14 * B * H * T^2 * 64 operations
// (each recomputes S = Q K^T; dK/dV adds P^T dO, dO V^T and dS^T Q, dQ adds
// dO V^T and dS K): 30 GFLOP, 0.03 ms at 989 TFLOP/s, against 0.03 GB of
// inputs and outputs, 0.01 ms at 3.35 TB/s. No [T, T] tensor reaches device
// memory.
//
// What the design does about it (simple first, no wgmma/TMA yet), following
// the reference's split into a kernel per key tile and one per query tile,
// so no atomics and the gradients are deterministic:
// - bf16 dK/dV: one block of 4 warps per (64-key tile, head, sequence); each
//   warp keeps its 16 keys' K and V rows in registers as mma.sync A
//   fragments and the [16 x 64] dK and dV accumulators in f32 registers.
//   Query tiles of Q and dO stream through shared memory, each in two
//   layouts ([query][d] for the B operand of K Q^T and V dO^T, [d][query]
//   for that of P^T dO and dS^T Q; 37 KB). S^T and dP^T come out as C
//   fragments; P^T and dS^T are formed in registers and re-packed as the A
//   operand of the next products, as the forward does with P.
// - bf16 dQ: one block of 4 warps per (64-query tile, head, sequence); each
//   warp keeps its 16 query rows of Q and dO as A fragments and the dQ
//   accumulator in registers; key tiles of K (both layouts) and V stream
//   through shared memory (28 KB).
// - f32: the same tiling on the CUDA cores (no TF32), two threads per key
//   (dK/dV) or query (dQ), each holding half of the row's 64 values and the
//   matching half of the accumulators; the two halves of each dot product
//   meet through a shuffle. So the card can hold it against the plain
//   version at a tight tolerance.
// - Keys of another segment give P = 0 by selection, never by exp(-inf), so
//   no NaN appears; lse is finite for every row (each query sees itself,
//   pad rows attend among pads).
// - Inputs and outputs go through element strides (d contiguous): q, k, v
//   are views of the fused QKV projection, and dq, dk, dv are written as
//   [B, T, H, 64] for the projection's backward.
#include "flash_attention.cuh"

namespace {

using namespace kirag_flash;

constexpr int F32_THREADS = 2 * BQ;  // two threads per row

__global__ void __launch_bounds__(BF16_THREADS)
    dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int t_len, float sm_scale, Strides sq,
                    Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv) {
  __shared__ __align__(16) uint16_t q_s[BQ * SK];    // bf16 bits, [query][d]
  __shared__ __align__(16) uint16_t qt_s[HD * SK];   // [d][query]
  __shared__ __align__(16) uint16_t do_s[BQ * SK];   // [query][d]
  __shared__ __align__(16) uint16_t dot_s[HD * SK];  // [d][query]
  __shared__ float lse_s[BQ], di_s[BQ];
  __shared__ int qseg_s[BQ];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key0 = blockIdx.x * BK + warp * 16 + g, key1 = key0 + 8;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;
  const int* segb = seg + static_cast<long long>(b) * t_len;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * t_len;

  uint32_t kf[4][4], vf[4][4];  // A fragments of this warp's 16 keys of K and V
  load_a_rows(kf, k + b * sk.b + h * sk.h, sk.t, key0, c);
  load_a_rows(vf, v + b * sv.b + h * sv.h, sv.t, key0, c);
  const int kseg0 = segb[key0], kseg1 = segb[key1];

  float dk_acc[8][4], dv_acc[8][4];  // [16 keys x 64] as 8 C tiles over d
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int qt = 0; qt < t_len; qt += BQ) {
    __syncthreads();  // the previous tile is consumed
    stage_tile(q_s, qt_s, qb, sq.t, qt, tid, BF16_THREADS);
    stage_tile(do_s, dot_s, dob, sdo.t, qt, tid, BF16_THREADS);
    if (tid < BQ) {
      lse_s[tid] = lse[row0 + qt + tid];
      di_s[tid] = di[row0 + qt + tid];
      qseg_s[tid] = segb[qt + tid];
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T, [16 keys x 64 queries] as 8 C tiles
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint16_t* qp = &q_s[(n * 8 + g) * SK + ks * 16 + 2 * c];
        const uint16_t* dp_ = &do_s[(n * 8 + g) * SK + ks * 16 + 2 * c];
        const uint32_t qb_[2] = {ld32(qp), ld32(qp + 8)};
        const uint32_t db_[2] = {ld32(dp_), ld32(dp_ + 8)};
        mma_bf16(s[n], kf[ks], qb_);
        mma_bf16(dp[n], vf[ks], db_);
      }
    }
    // P^T into s, dS^T into dp; element e of tile n is query n * 8 + 2c + e
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = n * 8 + 2 * c + e;
        const float lq = lse_s[qi], dq = di_s[qi];
        const int qsg = qseg_s[qi];
        const float p0 = qsg == kseg0 ? __expf(s[n][e] * sm_scale - lq) : 0.f;
        const float p1 = qsg == kseg1 ? __expf(s[n][2 + e] * sm_scale - lq) : 0.f;
        s[n][e] = p0;
        s[n][2 + e] = p1;
        dp[n][e] = p0 * (dp[n][e] - dq) * sm_scale;
        dp[n][2 + e] = p1 * (dp[n][2 + e] - dq) * sm_scale;
      }
    }
    // dV += P^T dO and dK += dS^T Q, over the tile's queries 16j..16j+15
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pf[4], dsf[4];
      c_to_a(pf, s[2 * j], s[2 * j + 1]);
      c_to_a(dsf, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint16_t* dop = &dot_s[(n * 8 + g) * SK + j * 16 + 2 * c];
        const uint16_t* qp = &qt_s[(n * 8 + g) * SK + j * 16 + 2 * c];
        const uint32_t db_[2] = {ld32(dop), ld32(dop + 8)};
        const uint32_t qb_[2] = {ld32(qp), ld32(qp + 8)};
        mma_bf16(dv_acc[n], pf, db_);
        mma_bf16(dk_acc[n], dsf, qb_);
      }
    }
  }

  __nv_bfloat16* dkb = dk + b * sdk.b + h * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(dkb + key0 * sdk.t + col) = pack_bf16(dk_acc[n][0], dk_acc[n][1]);
    *reinterpret_cast<uint32_t*>(dkb + key1 * sdk.t + col) = pack_bf16(dk_acc[n][2], dk_acc[n][3]);
    *reinterpret_cast<uint32_t*>(dvb + key0 * sdv.t + col) = pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<uint32_t*>(dvb + key1 * sdv.t + col) = pack_bf16(dv_acc[n][2], dv_acc[n][3]);
  }
}

__global__ void __launch_bounds__(BF16_THREADS)
    dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                   int t_len, float sm_scale, Strides sq, Strides sk, Strides sv, Strides sdo,
                   Strides sdq) {
  __shared__ __align__(16) uint16_t k_s[BK * SK];   // bf16 bits, [key][d]
  __shared__ __align__(16) uint16_t kt_s[HD * SK];  // [d][key]
  __shared__ __align__(16) uint16_t v_s[BK * SK];   // [key][d]
  __shared__ int kseg_s[BK];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const int* segb = seg + static_cast<long long>(b) * t_len;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * t_len;

  uint32_t qf[4][4], dof[4][4];  // A fragments of this warp's 16 rows of Q and dO
  load_a_rows(qf, q + b * sq.b + h * sq.h, sq.t, r0, c);
  load_a_rows(dof, dout + b * sdo.b + h * sdo.h, sdo.t, r0, c);
  const int seg0 = segb[r0], seg1 = segb[r1];
  const float lse0 = lse[row0 + r0], lse1 = lse[row0 + r1];
  const float di0 = di[row0 + r0], di1 = di[row0 + r1];

  float dq_acc[8][4];  // [16 queries x 64] as 8 C tiles over d
#pragma unroll
  for (int n = 0; n < 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  for (int kt = 0; kt < t_len; kt += BK) {
    __syncthreads();
    stage_tile(k_s, kt_s, kb, sk.t, kt, tid, BF16_THREADS);
    stage_tile(v_s, nullptr, vb, sv.t, kt, tid, BF16_THREADS);
    if (tid < BK) kseg_s[tid] = segb[kt + tid];
    __syncthreads();

    // S = Q K^T and dP = dO V^T, [16 queries x 64 keys] as 8 C tiles
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint16_t* kp = &k_s[(n * 8 + g) * SK + ks * 16 + 2 * c];
        const uint16_t* vp = &v_s[(n * 8 + g) * SK + ks * 16 + 2 * c];
        const uint32_t kb_[2] = {ld32(kp), ld32(kp + 8)};
        const uint32_t vb_[2] = {ld32(vp), ld32(vp + 8)};
        mma_bf16(s[n], qf[ks], kb_);
        mma_bf16(dp[n], dof[ks], vb_);
      }
    }
    // dS into dp; element e of tile n is key n * 8 + 2c + e
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ksg = kseg_s[n * 8 + 2 * c + e];
        const float p0 = ksg == seg0 ? __expf(s[n][e] * sm_scale - lse0) : 0.f;
        const float p1 = ksg == seg1 ? __expf(s[n][2 + e] * sm_scale - lse1) : 0.f;
        dp[n][e] = p0 * (dp[n][e] - di0) * sm_scale;
        dp[n][2 + e] = p1 * (dp[n][2 + e] - di1) * sm_scale;
      }
    }
    // dQ += dS K over the tile's keys 16j..16j+15
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t dsf[4];
      c_to_a(dsf, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint16_t* kp = &kt_s[(n * 8 + g) * SK + j * 16 + 2 * c];
        const uint32_t kb_[2] = {ld32(kp), ld32(kp + 8)};
        mma_bf16(dq_acc[n], dsf, kb_);
      }
    }
  }

  __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(dqb + r0 * sdq.t + col) = pack_bf16(dq_acc[n][0], dq_acc[n][1]);
    *reinterpret_cast<uint32_t*>(dqb + r1 * sdq.t + col) = pack_bf16(dq_acc[n][2], dq_acc[n][3]);
  }
}

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

// q, k, v, dout: [batch, heads, t_len, 64] f32 (is_bf16 = 0) or bf16 (1);
// dk, dv (dQ: dq) of the same shape and type; each addressed through its
// element strides (strides[3 * i .. 3 * i + 2] = batch, head and token
// strides of q, k, v, dout, dq, dk, dv in turn; d contiguous, rows 16-byte
// aligned); seg int32 [batch, t_len], lse and di f32 [batch, heads, t_len],
// all contiguous; t_len a multiple of 64. Each returns its launch's
// cudaError_t.
extern "C" int kirag_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                             const int* seg, const float* lse, const float* di,
                                             const void* dout, void* dk, void* dv, int is_bf16,
                                             int batch, int heads, int t_len, float sm_scale,
                                             const long long* strides, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(t_len / BK, heads, batch);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), sdo = strides_at(strides, 3),
                sdk = strides_at(strides, 5), sdv = strides_at(strides, 6);
  if (is_bf16) {
    dkv_bf16_kernel<<<grid, BF16_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, lse, di,
        static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), t_len, sm_scale, sq, sk, sv, sdo, sdk, sdv);
  } else {
    dkv_f32_kernel<<<grid, F32_THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, lse, di, static_cast<const float*>(dout),
        static_cast<float*>(dk), static_cast<float*>(dv), t_len, sm_scale, sq, sk, sv, sdo,
        sdk, sdv);
  }
  return cudaGetLastError();
}

extern "C" int kirag_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                            const int* seg, const float* lse, const float* di,
                                            const void* dout, void* dq, int is_bf16, int batch,
                                            int heads, int t_len, float sm_scale,
                                            const long long* strides, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(t_len / BQ, heads, batch);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), sdo = strides_at(strides, 3),
                sdq = strides_at(strides, 4);
  if (is_bf16) {
    dq_bf16_kernel<<<grid, BF16_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, lse, di,
        static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dq), t_len,
        sm_scale, sq, sk, sv, sdo, sdq);
  } else {
    dq_f32_kernel<<<grid, F32_THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, lse, di, static_cast<const float*>(dout),
        static_cast<float*>(dq), t_len, sm_scale, sq, sk, sv, sdo, sdq);
  }
  return cudaGetLastError();
}
