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
// there). The values are copied, so they are bitwise the source's.
//
// What bounds it on the H100: bytes. It reads and writes 4 * Q * k * 128
// bytes each (200 KB at Q = 32, k = 100); the TPU kernels streamed the whole
// source once through a one-hot product, which the card does not need: it
// reads only the selected groups.
//
// What the design does about it: one warp per (query, slot), each lane
// copying one 16-byte vector, so a group is one coalesced 512-byte read and
// one 512-byte write.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int WARPS = 8;  // (query, slot) pairs per block

__global__ void __launch_bounds__(WARPS * 32)
    copy_groups_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                       float* __restrict__ out, int n_c, int n_q, int k, int per) {
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (pair >= static_cast<int64_t>(n_q) * k) return;
  const int lane = threadIdx.x % 32;
  const int q = static_cast<int>(pair / k);
  const int64_t i = idx[pair];
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i >= 0 && i < static_cast<int64_t>(n_c) * per) {
    const int64_t row = (i / per) * n_q + q;  // [C, Q] row of the source
    v = reinterpret_cast<const float4*>(src + (row * per + i % per) * LANES)[lane];
  }
  reinterpret_cast<float4*>(out + pair * LANES)[lane] = v;
}

cudaError_t launch(const float* src, const int* idx, float* out, int n_c, int n_q, int k,
                   int per, cudaStream_t stream) {
  const int64_t pairs = static_cast<int64_t>(n_q) * k;
  const int64_t blocks = (pairs + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  copy_groups_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(
      src, idx, out, n_c, n_q, k, per);
  return cudaGetLastError();
}

}  // namespace

// src f32 [n_c, n_q, per * 128]; idx int32 [n_q, k]; out f32 [n_q, k, 128].
// Returns the launch's cudaError_t.
extern "C" int kirag_score_gather(const float* scores, const int* gsel, float* cand, int n_c,
                                  int n_q, int k, int groups_per_chunk, void* stream) {
  return launch(scores, gsel, cand, n_c, n_q, k, groups_per_chunk,
                static_cast<cudaStream_t>(stream));
}

extern "C" int kirag_cap_assemble(const float* capture, const int* cpos, float* cand, int n_c,
                                  int n_q, int k, int b, void* stream) {
  return launch(capture, cpos, cand, n_c, n_q, k, b, static_cast<cudaStream_t>(stream));
}
