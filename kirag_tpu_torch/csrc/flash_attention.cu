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
// T = 128..512) the operations, 4 * B * H * T^2 * 64, against the dense bf16
// tensor-core rate: 137 GFLOP per call at T = 512, 0.14 ms at 989 TFLOP/s,
// while q, k, v and out are 0.54 GB, 0.16 ms at 3.35 TB/s. The [T, T] scores
// never reach device memory.
//
// What the design does about it (simple first, no wgmma/TMA yet):
// - bf16: one block of 4 warps per (64-query tile, head, sequence); each warp
//   keeps its 16 query rows in registers as mma.sync m16n8k16 A fragments.
//   Keys and values stream through shared memory in tiles of 64 (V stored
//   transposed, so its B fragments are single 32-bit loads). Q.K^T and P.V
//   run on the tensor cores with f32 accumulators; the S accumulators are
//   re-packed in registers as the A operand of P.V. Online softmax: the
//   row maximum and sum are kept per thread and combined across the 4 lanes
//   of a row with shuffles.
// - f32: the same tiling, one thread per query row, f32 FMAs on the CUDA
//   cores (no TF32), so the card can hold it against the plain version at
//   a tight tolerance.
// - A key tile wholly in another segment gives logits of -inf: the running
//   maximum stays -inf and is replaced by 0 for the exponentials, so
//   exp(-inf - 0) = 0 and no NaN appears (the reference's finite mask value
//   and l == 0 guards serve the same purpose).
// - Inputs are read through element strides (d contiguous), so q, k and v
//   can be views into the fused QKV projection's [B, T, 3 * H * 64] output,
//   and the output can be written as [B, T, H, 64] for the next projection.
// - Shared memory is static and below 48 KB (19 KB bf16, 33 KB f32), so no
//   opt-in is needed.
// - For training, each row's m + log(l) is written to lse (the reference
//   keeps l and m); the backward kernels (flash_attention_bwd.cu) recompute
//   the probabilities from it. At inference lse is null and nothing changes.
#include "flash_attention.cuh"

namespace {

using namespace kirag_flash;

constexpr int F32_THREADS = BQ;

// Fragment layouts: flash_attention.cuh.
__global__ void __launch_bounds__(BF16_THREADS)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int t_len,
                      float sm_scale, Strides sq, Strides sk, Strides sv, Strides so) {
  __shared__ __align__(16) uint16_t k_s[BK * SK];   // bf16 bits, [key][d]
  __shared__ __align__(16) uint16_t vt_s[HD * SK];  // bf16 bits, [d][key]
  __shared__ int kseg_s[BK];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const int* segb = seg + static_cast<long long>(b) * t_len;

  uint32_t qf[4][4];  // A fragments of this warp's 16 query rows, per 16-column step
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int col = ks * 16 + 2 * c;
    qf[ks][0] = ld32(qb + r0 * sq.t + col);
    qf[ks][1] = ld32(qb + r1 * sq.t + col);
    qf[ks][2] = ld32(qb + r0 * sq.t + col + 8);
    qf[ks][3] = ld32(qb + r1 * sq.t + col + 8);
  }
  const int seg0 = segb[r0], seg1 = segb[r1];

  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running maxima of rows r0, r1
  float l0 = 0.f, l1 = 0.f;                      // this thread's part of the running sums
  float o[8][4];                                 // out[16 x 64] as 8 C tiles over d
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int kt = 0; kt < t_len; kt += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * HD / 8; i += BF16_THREADS) {
      {  // K: 16-byte vectors, neighbouring threads on neighbouring vectors of a row
        const int key = i / 8, d0 = (i % 8) * 8;
        *reinterpret_cast<uint4*>(&k_s[key * SK + d0]) =
            *reinterpret_cast<const uint4*>(kb + (kt + key) * sk.t + d0);
      }
      {  // V, transposed: neighbouring threads on neighbouring keys of a column
        const int key = i % BK, d0 = (i / BK) * 8;
        const uint4 raw = *reinterpret_cast<const uint4*>(vb + (kt + key) * sv.t + d0);
        const uint16_t* e = reinterpret_cast<const uint16_t*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) vt_s[(d0 + j) * SK + key] = e[j];
      }
    }
    if (tid < BK) kseg_s[tid] = segb[kt + tid];
    __syncthreads();

    float s[8][4];  // S[16 x 64] = Q K^T as 8 C tiles over keys
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint16_t* kp = &k_s[(n * 8 + g) * SK + ks * 16 + 2 * c];
        const uint32_t bf[2] = {ld32(kp), ld32(kp + 8)};
        mma_bf16(s[n], qf[ks], bf);
      }
    }

    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ksg = kseg_s[n * 8 + 2 * c + e];
        s[n][e] = ksg == seg0 ? s[n][e] * sm_scale : -CUDART_INF_F;
        s[n][2 + e] = ksg == seg1 ? s[n][2 + e] * sm_scale : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, row_max4(mx0)), mn1 = fmaxf(m1, row_max4(mx1));
    // a row that has seen no key of its segment yet keeps a maximum of -inf;
    // 0 stands in for it, so every exponential below is exp(-inf) = 0
    const float mu0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float mu1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float alpha0 = __expf(m0 - mu0), alpha1 = __expf(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
      s[n][0] = __expf(s[n][0] - mu0);
      s[n][1] = __expf(s[n][1] - mu0);
      s[n][2] = __expf(s[n][2] - mu1);
      s[n][3] = __expf(s[n][3] - mu1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // O += P V: the C tiles 2j, 2j+1 of S are the A fragment of keys 16j..16j+15
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pf[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint16_t* vp = &vt_s[(n * 8 + g) * SK + j * 16 + 2 * c];
        const uint32_t bf[2] = {ld32(vp), ld32(vp + 8)};
        mma_bf16(o[n], pf, bf);
      }
    }
  }

  const float sum0 = row_sum4(l0), sum1 = row_sum4(l1);
  const float inv0 = sum0 > 0.f ? 1.f / sum0 : 0.f, inv1 = sum1 > 0.f ? 1.f / sum1 : 0.f;
  __nv_bfloat16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(ob + r0 * so.t + col) = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(ob + r1 * so.t + col) = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  if (lse != nullptr && c == 0) {  // the backward's residual: m + log(l) per row
    float* lb = lse + (static_cast<long long>(b) * gridDim.y + h) * t_len;
    lb[r0] = m0 + logf(sum0);
    lb[r1] = m1 + logf(sum1);
  }
}

constexpr int SUB = 16;  // keys per online-softmax step of the f32 kernel

__global__ void __launch_bounds__(F32_THREADS)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     float* __restrict__ out, float* __restrict__ lse, int t_len,
                     float sm_scale, Strides sq, Strides sk, Strides sv, Strides so) {
  __shared__ __align__(16) float4 k_s[BK * HD / 4];  // [key][d / 4]
  __shared__ __align__(16) float4 v_s[BK * HD / 4];
  __shared__ int kseg_s[BK];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r = blockIdx.x * BQ + tid;  // this thread's query row
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int* segb = seg + static_cast<long long>(b) * t_len;

  float qr[HD];
  const float4* qp = reinterpret_cast<const float4*>(q + b * sq.b + h * sq.h + r * sq.t);
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 x = qp[i];
    qr[4 * i] = x.x;
    qr[4 * i + 1] = x.y;
    qr[4 * i + 2] = x.z;
    qr[4 * i + 3] = x.w;
  }
  const int my_seg = segb[r];
  float m = -CUDART_INF_F, l = 0.f, acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  for (int kt = 0; kt < t_len; kt += BK) {
    __syncthreads();
    for (int i = tid; i < BK * HD / 4; i += F32_THREADS) {
      const int key = i / (HD / 4), c4 = i % (HD / 4);
      k_s[i] = reinterpret_cast<const float4*>(kb + (kt + key) * sk.t)[c4];
      v_s[i] = reinterpret_cast<const float4*>(vb + (kt + key) * sv.t)[c4];
    }
    kseg_s[tid] = segb[kt + tid];
    __syncthreads();

    for (int j0 = 0; j0 < BK; j0 += SUB) {
      float s[SUB];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float4* kr = &k_s[(j0 + jj) * (HD / 4)];
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < HD / 4; ++i) {
          const float4 x = kr[i];
          dot = fmaf(qr[4 * i], x.x, dot);
          dot = fmaf(qr[4 * i + 1], x.y, dot);
          dot = fmaf(qr[4 * i + 2], x.z, dot);
          dot = fmaf(qr[4 * i + 3], x.w, dot);
        }
        s[jj] = kseg_s[j0 + jj] == my_seg ? dot * sm_scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[jj]);
      }
      const float mn = fmaxf(m, mx);
      const float mu = mn == -CUDART_INF_F ? 0.f : mn;  // as in the bf16 kernel
      const float alpha = expf(m - mu);
      m = mn;
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = expf(s[jj] - mu);
        l += p;
        const float4* vr = &v_s[(j0 + jj) * (HD / 4)];
#pragma unroll
        for (int i = 0; i < HD / 4; ++i) {
          const float4 x = vr[i];
          acc[4 * i] = fmaf(p, x.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(p, x.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, x.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, x.w, acc[4 * i + 3]);
        }
      }
    }
  }

  const float inv = l > 0.f ? 1.f / l : 0.f;
  float4* op = reinterpret_cast<float4*>(out + b * so.b + h * so.h + r * so.t);
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    op[i] = make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv, acc[4 * i + 2] * inv,
                        acc[4 * i + 3] * inv);
  }
  if (lse != nullptr) lse[(static_cast<long long>(b) * gridDim.y + h) * t_len + r] = m + logf(l);
}

}  // namespace

// q, k, v, out: [batch, heads, t_len, 64] f32 (is_bf16 = 0) or bf16 (1), each
// addressed through its element strides (strides[3 * i .. 3 * i + 2] = batch,
// head and token strides of q, k, v, out in turn; d contiguous, rows 16-byte
// aligned); seg int32 [batch, t_len] contiguous; t_len a multiple of 64.
// lse, f32 [batch, heads, t_len] contiguous, receives each row's m + log(l)
// (the log of its softmax denominator, in units of sm_scale * q . k) for the
// backward kernels; null at inference. Returns the launch's cudaError_t.
extern "C" int kirag_flash_attention(const void* q, const void* k, const void* v,
                                     const int* seg, void* out, float* lse, int is_bf16,
                                     int batch, int heads, int t_len, float sm_scale,
                                     const long long* strides, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(t_len / BQ, heads, batch);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), so = strides_at(strides, 3);
  if (is_bf16) {
    flash_bf16_kernel<<<grid, BF16_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, static_cast<__nv_bfloat16*>(out), lse,
        t_len, sm_scale, sq, sk, sv, so);
  } else {
    flash_f32_kernel<<<grid, F32_THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, static_cast<float*>(out), lse, t_len, sm_scale,
        sq, sk, sv, so);
  }
  return cudaGetLastError();
}
