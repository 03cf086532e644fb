// window_merge: the running top-br group window of select="merge".
//
// Replaces the window logic of the TPU kernel
// kirag_tpu/ops/pallas_exact.py::_merge_kernel. That kernel scored each chunk
// and peeled its top-bc groups itself; here stream_capture (K1) does that
// part, since its per-chunk outputs (gids, capmax, resid, capture, with the
// same capture budget bc) are exactly what _merge_kernel peels, and this
// kernel then sweeps the chunks in order, one warp per query:
//   chunk 0 fills slots 0..bc-1 with its captured groups; the other slots
//     are empty (key -inf, gid -(slot + 1), no scores); lost[0] = resid[0];
//   each later chunk c: peel the window's bc worst slots (ascending key,
//     ties to the lower slot: _worstb_ids), rank the 2 bc union of those
//     and the chunk's bc new groups by (key desc, gid asc), keep the top bc,
//     and write the j-th surviving new group into the j-th ejected slot;
//     lost[c] = max(resid[c], the largest key that did not survive);
//   at the end, sort the window by gid ascending (empty slots get the gid
//     total_groups + slot, keys are clamped to FIN_MIN) and copy each slot's
//     128 captured scores out of the capture, zeros for an empty slot.
// The window always holds the top br of the groups captured so far under that
// strict order; the caller's exactness rule is kth key > lost (every chunk).
//
// What bounds it on the H100: latency. Per query it reads C * bc keys and
// gids and C residuals, and copies br * 128 scores (at 21M rows, C = 1283,
// bc = 8, br = 104: 82 KB and 53 KB), so the bytes take microseconds; the
// chunk sweep is sequential, about bc warp-wide argmin reductions over the
// br window keys a chunk.
//
// What the design does about it: the window (keys, gids, capture positions)
// lives in shared memory, one warp per query, several warps a block; only
// positions move during the sweep, and the payload is copied once at the
// end (the TPU kernel blended the [br, 128] payload at every chunk). The
// whole card's queries run at once, each sweep in order; a faster sweep
// (merging with a sorted window, or splitting the chunks across warps) is
// later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float FIN_MIN = -1e30f;
constexpr size_t MAX_SMEM = 200 * 1024;

// shared memory of one warp's window: wkey, wgid, wpos, posr [br];
// peel [bc]; v2, g2, surv [2 bc]
__host__ __device__ inline size_t warp_bytes(int br, int bc) {
  return (static_cast<size_t>(4) * br + bc + 3 * 2 * bc) * 4;
}

__global__ void window_merge_kernel(const int* __restrict__ gids,
                                    const float* __restrict__ capmax,
                                    const float* __restrict__ resid,
                                    const float* __restrict__ capture, float* __restrict__ win,
                                    float* __restrict__ wkey_out, int* __restrict__ wgid_out,
                                    float* __restrict__ lost, int n_c, int bc, int n_q, int br,
                                    int total_groups) {
  extern __shared__ __align__(16) int smem_i[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * (blockDim.x / 32) + warp;
  if (q >= n_q) return;  // whole warps leave; nothing below syncs the block
  int* base = smem_i + warp * (warp_bytes(br, bc) / 4);
  float* wkey = reinterpret_cast<float*>(base);
  int* wgid = base + br;
  int* wpos = base + 2 * br;   // flat [C, bc] capture position, -1 when empty
  int* posr = base + 3 * br;   // the final order's positions
  int* peel = base + 4 * br;
  float* v2 = reinterpret_cast<float*>(peel + bc);
  int* g2 = peel + 3 * bc;
  int* surv = peel + 5 * bc;

  for (int s = lane; s < br; s += 32) {
    const bool filled = s < bc;
    const int64_t o = static_cast<int64_t>(s) * n_q + q;  // chunk 0, slot s
    wkey[s] = filled ? capmax[o] : -CUDART_INF_F;
    wgid[s] = filled ? gids[o] : -(s + 1);
    wpos[s] = filled ? s : -1;
  }
  if (lane == 0) lost[q] = resid[q];
  __syncwarp();

  for (int c = 1; c < n_c; ++c) {
    for (int j = lane; j < bc; j += 32) {
      const int64_t o = (static_cast<int64_t>(c) * bc + j) * n_q + q;
      v2[bc + j] = capmax[o];
      g2[bc + j] = gids[o];
    }
    // peel the bc worst slots; a peeled slot reads +inf until it is
    // written back below (every live key is below +inf)
    for (int j = 0; j < bc; ++j) {
      float bv = CUDART_INF_F;
      int bs = br;
      for (int s = lane; s < br; s += 32) {
        const float v = wkey[s];
        if (v < bv || (v == bv && s < bs)) {
          bv = v;
          bs = s;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
        const int os = __shfl_xor_sync(FULL_MASK, bs, o);
        if (ov < bv || (ov == bv && os < bs)) {
          bv = ov;
          bs = os;
        }
      }
      if (lane == 0) {
        peel[j] = bs;
        v2[j] = bv;
        g2[j] = wgid[bs];
        wkey[bs] = CUDART_INF_F;
      }
      __syncwarp();
    }
    // the top bc of the union under (key desc, gid asc); gids are distinct
    for (int i = lane; i < 2 * bc; i += 32) {
      const float vi = v2[i];
      const int gi = g2[i];
      int rank = 0;
      for (int j = 0; j < 2 * bc; ++j) {
        const float vj = v2[j];
        rank += (vj > vi) || (vj == vi && g2[j] < gi);
      }
      surv[i] = rank < bc;
    }
    __syncwarp();
    if (lane == 0) {
      float ej = -CUDART_INF_F;
      int n = 0;
      for (int j = 0; j < bc; ++j) {
        const int s = peel[j];
        if (surv[j]) {
          wkey[s] = v2[j];
          continue;
        }
        ej = fmaxf(ej, v2[j]);
        while (!surv[bc + n]) ++n;  // as many new groups survive as old ones leave
        wkey[s] = v2[bc + n];
        wgid[s] = g2[bc + n];
        wpos[s] = c * bc + n;
        ++n;
      }
      for (int j = 0; j < bc; ++j) {
        if (!surv[bc + j]) ej = fmaxf(ej, v2[bc + j]);
      }
      const int64_t o = static_cast<int64_t>(c) * n_q + q;
      lost[o] = fmaxf(resid[o], ej);
    }
    __syncwarp();
  }

  // sort by gid (empty slots after every group, in slot order); gids unique
  for (int s = lane; s < br; s += 32) {
    const int gs = wgid[s] < 0 ? total_groups + s : wgid[s];
    int rank = 0;
    for (int t = 0; t < br; ++t) {
      const int gt = wgid[t] < 0 ? total_groups + t : wgid[t];
      rank += gt < gs;
    }
    const int64_t o = static_cast<int64_t>(q) * br + rank;
    wkey_out[o] = fmaxf(wkey[s], FIN_MIN);
    wgid_out[o] = gs;
    posr[rank] = wpos[s];
  }
  __syncwarp();
  for (int r = 0; r < br; ++r) {
    const int p = posr[r];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p >= 0) {
      const int64_t row = static_cast<int64_t>(p / bc) * n_q + q;  // [C, Q] capture row
      v = reinterpret_cast<const float4*>(capture + (row * bc + p % bc) * LANES)[lane];
    }
    reinterpret_cast<float4*>(win + (static_cast<int64_t>(q) * br + r) * LANES)[lane] = v;
  }
}

}  // namespace

// K1's capdom outputs gids int32 [n_c, bc, n_q], capmax f32 [n_c, bc, n_q],
// resid f32 [n_c, 1, n_q], capture f32 [n_c, n_q, bc * 128]; outputs win f32
// [n_q, br, 128], wkey f32 [n_q, br], wgid int32 [n_q, br], lost f32
// [n_c, 1, n_q]. Returns the launch's cudaError_t (cudaErrorInvalidValue
// when one query's window does not fit in shared memory).
extern "C" int kirag_window_merge(const int* gids, const float* capmax, const float* resid,
                                  const float* capture, float* win, float* wkey, int* wgid,
                                  float* lost, int n_c, int bc, int n_q, int br,
                                  int total_groups, void* stream) {
  const size_t per_warp = warp_bytes(br, bc);
  if (bc < 1 || br < bc || per_warp > MAX_SMEM) return cudaErrorInvalidValue;
  int warps = 4;
  while (warps > 1 && warps * per_warp > MAX_SMEM / 2) warps /= 2;
  const size_t smem = warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      window_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const int blocks = (n_q + warps - 1) / warps;
  window_merge_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      gids, capmax, resid, capture, win, wkey, wgid, lost, n_c, bc, n_q, br, total_groups);
  return cudaGetLastError();
}
