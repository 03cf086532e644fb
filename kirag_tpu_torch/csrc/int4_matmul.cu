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
// high nibble: signed integers in [-7, 7] (linear int4), or, with a codebook,
// unsigned indices into 16 f32 values rounded to bf16 (NF4). Each block's
// partial sum is f32, multiplied by its scale in f32 and added into an f32
// accumulator, as the reference does; the output is x's dtype.
//
// What bounds it on the H100: the bytes. A decode step of Llama-3-8B at NF4
// reads 3.75 GB of packed weights and 0.47 GB of scales, 1.26 ms at
// 3.35 TB/s, against 2 * rows * in * out operations that take a fraction of
// that at rows <= 32. The dequantized weights never reach device memory.
//
// What the design does about it (simple first; no wgmma, TMA or fusion yet):
// - Each thread owns 8 adjacent output columns and reads them as one 8-byte
//   load per packed row, so a warp reads 256 contiguous bytes of a row and a
//   block of 128 threads covers 1024 columns. Sixteen packed rows' loads are
//   issued together before their arithmetic, so each thread keeps 128 bytes
//   of weights in flight: at 1-4 rows the kernel waits on load latency, and
//   fewer, deeper batches of loads shorten each thread's chain of waits.
// - The nibbles are decoded in registers (sign extension by shifts, or the
//   codebook from shared memory) and multiplied into f32 FMAs on the CUDA
//   cores; x's values come through the read-only cache, where every lane of
//   a warp reads the same address.
// - Rows are taken 1, 2 or 4 at a time (the third grid dimension walks the
//   tiles of 4 rows), which bounds the registers a thread needs.
// - The input rows are split across blocks along the second grid dimension
//   (whole 64-row scale blocks each), because k/v_proj have only one block of
//   columns and down_proj a 14,336-long reduction. Each split writes its f32
//   sums to a workspace and a second kernel adds the splits in order: the
//   result is the same on every run (no atomics).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 8;                     // output columns per thread
constexpr int BLOCK_COLS = THREADS * COLS;  // output columns per block
constexpr int SUB = 32;                     // packed rows per scale block (64 input rows)
constexpr int UNROLL = 16;                  // packed rows whose loads are issued together
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 8 values of one row of x as f32 (16-byte aligned reads).
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = bf16_lo(a.x);
  v[1] = bf16_hi(a.x);
  v[2] = bf16_lo(a.y);
  v[3] = bf16_hi(a.y);
  v[4] = bf16_lo(a.z);
  v[5] = bf16_hi(a.z);
  v[6] = bf16_lo(a.w);
  v[7] = bf16_hi(a.w);
}

__device__ __forceinline__ void load_x(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
  v[5] = b.y;
  v[6] = b.z;
  v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// The two weights of one packed byte: low nibble (even input row), high
// nibble (odd input row).
template <bool NF4>
__device__ __forceinline__ void decode(uint32_t byte, const float* cb, float& lo, float& hi) {
  if (NF4) {
    lo = cb[byte & 15u];
    hi = cb[byte >> 4];
  } else {  // signed nibbles: shift to the top of an int32, shift back arithmetically
    lo = static_cast<float>(static_cast<int32_t>(byte << 28) >> 28);
    hi = static_cast<float>(static_cast<int32_t>(byte << 24) >> 28);
  }
}

template <typename T, int BT, bool NF4>
__global__ void __launch_bounds__(THREADS)
    int4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                       const float* __restrict__ scales, const float* __restrict__ codebook,
                       T* __restrict__ out, float* __restrict__ partial, int rows, int half,
                       int out_dim, int n_split) {
  __shared__ float cb[16];
  if (NF4) {
    // the reference rounds each looked-up value to bf16
    if (threadIdx.x < 16) {
      cb[threadIdx.x] = __bfloat162float(__float2bfloat16_rn(codebook[threadIdx.x]));
    }
    __syncthreads();
  }
  const int col = blockIdx.x * BLOCK_COLS + threadIdx.x * COLS;
  if (col >= out_dim) return;
  const int n_blocks = half / SUB;
  const int s_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * n_blocks / n_split);
  const int s_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * n_blocks / n_split);
  const int r0 = blockIdx.z * BT;
  const T* xr[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) {  // rows past the end read the last row; never written
    xr[r] = x + static_cast<int64_t>(min(r0 + r, rows - 1)) * (2 * half);
  }

  float acc[BT][COLS];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

  for (int s = s_begin; s < s_end; ++s) {
    float part[BT][COLS];
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) part[r][c] = 0.f;

    for (int i0 = s * SUB; i0 < (s + 1) * SUB; i0 += UNROLL) {
      uint2 w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uint8_t* row = packed + static_cast<int64_t>(i0 + u) * out_dim;
        w[u] = __ldg(reinterpret_cast<const uint2*>(row + col));
      }
      float xv[BT][2 * UNROLL];
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int k = 0; k < 2 * UNROLL; k += 8) load_x(xr[r] + 2 * i0 + k, xv[r] + k);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const uint32_t byte = ((c < 4 ? w[u].x : w[u].y) >> (8 * (c & 3))) & 0xffu;
          float lo, hi;
          decode<NF4>(byte, cb, lo, hi);
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            part[r][c] = fmaf(xv[r][2 * u], lo, part[r][c]);
            part[r][c] = fmaf(xv[r][2 * u + 1], hi, part[r][c]);
          }
        }
      }
    }
    const float* srow = scales + static_cast<int64_t>(s) * out_dim;
    const float4* sp = reinterpret_cast<const float4*>(srow + col);
    const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
    const float sc[COLS] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(part[r][c], sc[c]));  // the reference's order
      }
  }

#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int row = r0 + r;
    if (row >= rows) break;
    if (n_split == 1) {
      store8(out + static_cast<int64_t>(row) * out_dim + col, acc[r]);
    } else {
      store8(partial + (static_cast<int64_t>(blockIdx.y) * rows + row) * out_dim + col, acc[r]);
    }
  }
}

// out[i] = sum over the splits, in split order, of partial[split, i].
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_splits_kernel(const float* __restrict__ partial, T* __restrict__ out, int64_t n,
                         int n_split) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * REDUCE_THREADS + threadIdx.x) * 4;
  if (i >= n) return;
  float4 sum = __ldg(reinterpret_cast<const float4*>(partial + i));
  for (int s = 1; s < n_split; ++s) {
    const float4 p = __ldg(reinterpret_cast<const float4*>(partial + s * n + i));
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  store4(out + i, sum);
}

template <typename T, int BT, bool NF4>
cudaError_t launch(const T* x, const uint8_t* packed, const float* scales, const float* codebook,
                   T* out, float* partial, int rows, int half, int out_dim, int n_split,
                   cudaStream_t stream) {
  const dim3 grid((out_dim + BLOCK_COLS - 1) / BLOCK_COLS, n_split, (rows + BT - 1) / BT);
  int4_matmul_kernel<T, BT, NF4><<<grid, THREADS, 0, stream>>>(x, packed, scales, codebook, out,
                                                               partial, rows, half, out_dim,
                                                               n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int64_t n = static_cast<int64_t>(rows) * out_dim;
  const int64_t blocks = (n / 4 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  reduce_splits_kernel<T><<<static_cast<unsigned>(blocks), REDUCE_THREADS, 0, stream>>>(
      partial, out, n, n_split);
  return cudaGetLastError();
}

template <typename T, bool NF4>
cudaError_t launch_rows(const void* x, const uint8_t* packed, const float* scales,
                        const float* codebook, void* out, float* partial, int rows, int half,
                        int out_dim, int n_split, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (rows == 1) {
    return launch<T, 1, NF4>(xt, packed, scales, codebook, ot, partial, rows, half, out_dim,
                             n_split, stream);
  }
  if (rows == 2) {
    return launch<T, 2, NF4>(xt, packed, scales, codebook, ot, partial, rows, half, out_dim,
                             n_split, stream);
  }
  return launch<T, 4, NF4>(xt, packed, scales, codebook, ot, partial, rows, half, out_dim,
                           n_split, stream);
}

}  // namespace

// x [rows, 2 * half] contiguous, bf16 (x_bf16 = 1) or f32 (0); packed uint8
// [half, out_dim]; scales f32 [half / 32, out_dim]; codebook f32 [16] for NF4
// or null for linear int4; out [rows, out_dim] in x's dtype; partial f32
// [n_split, rows, out_dim] when n_split > 1 (else unused). half must be a
// multiple of 32, out_dim of 8, and 1 <= n_split <= half / 32; every pointer
// 16-byte aligned. Returns the launches' cudaError_t.
extern "C" int kirag_int4_matmul(const void* x, int x_bf16, const uint8_t* packed,
                                 const float* scales, const float* codebook, void* out,
                                 float* partial, int rows, int half, int out_dim, int n_split,
                                 void* stream) {
  if (rows < 1 || half < SUB || half % SUB != 0 || out_dim < COLS || out_dim % COLS != 0 ||
      n_split < 1 || n_split > half / SUB || (n_split > 1 && partial == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return codebook ? launch_rows<__nv_bfloat16, true>(x, packed, scales, codebook, out, partial,
                                                       rows, half, out_dim, n_split, s)
                    : launch_rows<__nv_bfloat16, false>(x, packed, scales, codebook, out, partial,
                                                        rows, half, out_dim, n_split, s);
  }
  return codebook ? launch_rows<float, true>(x, packed, scales, codebook, out, partial, rows,
                                             half, out_dim, n_split, s)
                  : launch_rows<float, false>(x, packed, scales, codebook, out, partial, rows,
                                              half, out_dim, n_split, s);
}
