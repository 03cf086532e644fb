// copy_groups: copy each query's selected 128-score groups out of a
// [C, Q, per * 128] f32 score array.
//
// Two TPU kernels of kirag_tpu/ops/pallas_exact.py have this function, and
// each has its entry point here:
//   kirag_score_gather (K7b) replaces _score_gather_kernel (impl="single"):
//       src = score_gmax's chunk-major scores [C, Q, chunk], idx = the
//       selected group ids, per = chunk / 128 groups a chunk;
//   kirag_cap_assemble (K8) replaces _cap_assemble_kernel (select="capdom"
//       with KIRAG_CAPDOM_ASSEMBLY=pallas): src = stream_capture's capture
//       [C, Q, b * 128], idx = flat capture positions, per = b.
// out[q, j, :] = src[idx / per, q, (idx % per) * 128 : + 128], zeros for an
// index outside [0, C * per) (the reference kernels' one-hot sums give 0
// there). The values are copied, so they are bitwise the source's. The
// indices are int32 or int64 [Q, k], read where they lie (element (q, j) at
// q * sq + j * sk: a slice or a transposed view of a sort's output too), so
// the caller makes no cast and no copy.
//
// What bounds it on the H100: the launch and two dependent memory trips,
// not bytes. It reads and writes 4 * Q * k * 128 bytes each (1.6 MB at
// Q = 32, k = 100: 0.0010 ms at 3.35 TB/s), well under a launch's few
// microseconds. Each (query, slot) pair is a chain: its index, then its group,
// then the store. The TPU kernels streamed the whole source once through a
// one-hot product; the card reads only the selected groups.
//
// What the design does about it: one launch a call, whatever the index
// type or layout. A warp copies one (query, slot) pair: every lane reads the
// pair's index (one load for the warp) and 16 bytes of its 512-byte group
// on the non-coherent path (the source is read-only here). kernels.exact.
// copy_plan gives the block its warps so that Q = 8 (800 pairs) still
// spreads over the 132 SMs; the launch refuses a geometry that does not
// cover its call exactly. Measured on the H100 (PERF.md §6) and dropped:
// several pairs a warp with all their group reads issued before the first
// store (no faster at any copy the port makes, k = 100, Q = 8-256), an
// L1::no_allocate hint on the group reads (up to 2 us a call) and handing
// the index out by shuffle (0.3 us). The stores stay
// plain: the caller's selection reads the output straight after, from L2.
// TMA, wgmma and clusters do nothing for a scattered copy of 512-byte
// pieces.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int LANES = 128;
constexpr int MAX_WARPS_PER_BLOCK = 8;  // kernels.exact.COPY_WARPS_PER_BLOCK's largest

__device__ __forceinline__ float4 load_nc(const float* p) {
  float4 v;
  asm("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// Warp w copies pair w of the flattened [Q, k] order; pairs is Q * k,
// n_groups C * per (both below 2^31, checked at launch).
template <typename Idx>
__global__ void copy_groups_kernel(const float* __restrict__ src, const Idx* __restrict__ idx,
                                   float* __restrict__ out, int n_q, int k, int64_t sq,
                                   int64_t sk, int per, int n_groups, int pairs) {
  const int p = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (p >= pairs) return;  // the whole warp: a ragged last block
  const int lane = threadIdx.x % 32;
  const int64_t i = static_cast<int64_t>(idx[(p / k) * sq + (p % k) * sk]);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i >= 0 && i < n_groups) {
    const int g = static_cast<int>(i);
    const int64_t row = static_cast<int64_t>(g / per) * n_q + p / k;  // [C, Q] row
    v = load_nc(src + (row * per + g % per) * LANES + 4 * lane);
  }
  reinterpret_cast<float4*>(out + static_cast<int64_t>(p) * LANES)[lane] = v;
}

// The plan (warps_per_block, blocks) must cover the call's Q * k pairs, one
// a warp, with no block left empty; anything else is refused.
template <typename Idx>
cudaError_t launch(const float* src, const Idx* idx, int64_t sq, int64_t sk, float* out,
                   int n_c, int n_q, int k, int per, int warps_per_block, int blocks,
                   cudaStream_t stream) {
  const int64_t pairs = static_cast<int64_t>(n_q) * k;
  const int64_t n_groups = static_cast<int64_t>(n_c) * per;
  if (n_c < 1 || n_q < 1 || k < 1 || per < 1 || sq < 0 || sk < 0 || warps_per_block < 1 ||
      warps_per_block > MAX_WARPS_PER_BLOCK || blocks < 1 ||
      pairs > INT_MAX - warps_per_block || n_groups > INT_MAX ||
      static_cast<int64_t>(blocks) * warps_per_block < pairs ||
      static_cast<int64_t>(blocks - 1) * warps_per_block >= pairs) {
    return cudaErrorInvalidValue;
  }
  copy_groups_kernel<Idx><<<blocks, warps_per_block * 32, 0, stream>>>(
      src, idx, out, n_q, k, sq, sk, per, static_cast<int>(n_groups), static_cast<int>(pairs));
  return cudaGetLastError();
}

cudaError_t launch_any(const float* src, const void* idx, int idx_bytes, int64_t sq, int64_t sk,
                       float* out, int n_c, int n_q, int k, int per, int warps_per_block,
                       int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (idx_bytes) {
    case 4:
      return launch(src, static_cast<const int32_t*>(idx), sq, sk, out, n_c, n_q, k, per,
                    warps_per_block, blocks, s);
    case 8:
      return launch(src, static_cast<const int64_t*>(idx), sq, sk, out, n_c, n_q, k, per,
                    warps_per_block, blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// src f32 [n_c, n_q, per * 128]; idx [n_q, k] of idx_bytes 4 (int32) or 8
// (int64), element (q, j) at q * sq + j * sk; out f32 [n_q, k, 128]; the plan
// (warps_per_block, blocks) of kernels.exact.copy_plan. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a plan that misses the call, an
// index width other than 4 or 8, or more than 2^31 pairs or groups).
extern "C" int kirag_score_gather(const float* scores, const void* gsel, int idx_bytes,
                                  long long sq, long long sk, float* cand, int n_c, int n_q,
                                  int k, int groups_per_chunk, int warps_per_block, int blocks,
                                  void* stream) {
  return launch_any(scores, gsel, idx_bytes, sq, sk, cand, n_c, n_q, k, groups_per_chunk,
                    warps_per_block, blocks, stream);
}

extern "C" int kirag_cap_assemble(const float* capture, const void* cpos, int idx_bytes,
                                  long long sq, long long sk, float* cand, int n_c, int n_q,
                                  int k, int b, int warps_per_block, int blocks, void* stream) {
  return launch_any(capture, cpos, idx_bytes, sq, sk, cand, n_c, n_q, k, b, warps_per_block,
                    blocks, stream);
}
