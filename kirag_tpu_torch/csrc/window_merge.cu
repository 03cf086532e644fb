// window_merge: the running top-br group window of select="merge".
//
// Replaces the window logic of the TPU kernel
// kirag_tpu/ops/pallas_exact.py::_merge_kernel. That kernel scored each chunk
// and peeled its top-bc groups itself; here stream_capture (K1) does that
// part, since its per-chunk outputs (gids, capmax, resid, capture, with the
// same capture budget bc) are exactly what _merge_kernel peels. The function
// is the reference's chunk-by-chunk merge:
//   chunk 0 fills slots 0..bc-1 with its captured groups; the other slots
//     are empty (key -inf, gid -(slot + 1), no scores); lost[0] = resid[0];
//   each later chunk c: peel the window's bc worst slots (ascending key,
//     ties to the lower slot), rank the 2 bc union of those and the chunk's
//     bc new groups by (key desc, gid asc), keep the top bc, and write the
//     j-th surviving new group into the j-th ejected slot; lost[c] =
//     max(resid[c], the largest key that did not survive);
//   at the end, sort the window by gid ascending (empty slots get the gid
//     total_groups + slot, keys are clamped to FIN_MIN) and copy each slot's
//     128 captured scores out of the capture, zeros for an empty slot.
//
// What bounds it on the H100: not bytes. Per query it reads C * bc keys and
// gids and C residuals and copies br * 128 scores (at 21M rows, C = 1283,
// bc = 8, br = 104: 82 KB and 53 KB), so the bytes take microseconds; done
// chunk by chunk, the merge is a chain of C dependent steps. Cut into
// segments (below), a query's steps share one SM and its instruction issue
// bounds them.
//
// What the design does about it: the chain is cut into segments whose
// windows compose. Write the order (key desc, gid asc) as >-, an empty slot s
// as the item (-inf, -(s + 1)). Unless the peel's slot order decides a tie
// (below), the window after chunk c is the top br under >- of chunk 0's
// window (its groups and the empty slots) and every group captured in chunks
// 1..c, and lost[c] the key of the best item that the top br of (window before
// c) + (chunk c) leaves out. Top-br composes, so one block a query and a warp
// a segment of the chunks 1..C-1:
//   A. each warp takes its segment's top br (warp 0 from chunk 0's window,
//      the others from an empty list);
//   B. a scan over the warps (log2 S rounds, each warp merging its list with
//      the one 2^r warps before it) gives each the window at its end; a warp
//      copies its left neighbour's, the window at its own segment's start;
//   C. each warp replays its segment from there, a step a chunk, and writes
//      lost.
// Windows are lists in shared memory sorted by >-, an item's order one
// 64-bit key (the key's bits ordered as unsigned, -0 as +0, then INT_MAX -
// gid), with its key and capture position beside it. A step whose new groups
// all lose to the list's worst item is a ballot (and a warp max for lost);
// otherwise the winners are ranked by shuffles and placed by a binary
// search, and only the items from the best winner's place down move, in
// place, 32 at a time from the bottom. The next chunks' keys and gids are
// loaded ahead in registers.
//
// Ties. The reference peels by (key, slot), not by >-, so where the bc-th
// worst key of the window is tied across the peel's edge and a tied real
// group is pushed out, the slot layout (which the lists do not keep) picks
// which one goes. The replay flags such a step, and a flagged query runs the
// reference's steps one chunk at a time in warp 0 (slots, the peel's argmins,
// the rank of the 2 bc union), as does every query when bc > 32 (at most a
// few chunks then: bc is 2 k / C). That form skips a chunk whose new groups
// all lose to the window's worst item too. Empty slots need no such care:
// the peel takes them from the lowest slot, which is >-'s order among them,
// and an empty slot is its own item.
//
// At the end the block sorts the window by gid and copies the payload once.
#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float FIN_MIN = -1e30f;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, all a block may have
constexpr int MAX_SEGMENTS = 32;     // a warp a segment, one block a query
constexpr int MAX_LANE_BC = 32;      // the segmented form: a chunk's groups one a lane
constexpr int NONE_GID = INT_MAX;    // phase A's filler: below every group and empty slot
constexpr int PREFETCH = 4;          // chunks loaded ahead of the step
constexpr int HEAD_BYTES = 4 * (4 + MAX_SEGMENTS);  // flags; each warp's current list
constexpr int WINNER_BYTES = 32 * 20;               // a step's winners: order, key, pos, place

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }
// a warp's two lists (order u64, key f32, pos i32 each) and its winners
__host__ __device__ inline size_t warp_bytes(int br) {
  return 32 * static_cast<size_t>(br) + WINNER_BYTES;
}
// the reference's steps (warp 0): wkey, wgid, wpos [br], peel [bc], v2, g2, surv [2 bc],
// survivors [bc]
__host__ __device__ inline size_t seq_bytes(int br, int bc) { return 4 * (3 * br + 8 * bc); }
__host__ __device__ inline size_t smem_bytes(int br, int bc, int segments) {
  const size_t region = max(segments * warp_bytes(br), seq_bytes(br, bc));
  return HEAD_BYTES + round16(4 * static_cast<size_t>(br)) + region;
}

// floats as unsigned ints in the same order (also for redux.sync's max)
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float order_value(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
// a >- b  <=>  order(a) > order(b)  (-0 and +0 tie, as float compares say)
__device__ __forceinline__ uint64_t order(float k, int g) {
  return static_cast<uint64_t>(order_key(k == 0.f ? 0.f : k)) << 32 |
         static_cast<uint32_t>(INT_MAX - static_cast<int64_t>(g));
}
__device__ __forceinline__ int gid_of(uint64_t o) {
  return static_cast<int>(INT_MAX - static_cast<int64_t>(static_cast<uint32_t>(o)));
}
__device__ __forceinline__ bool beats(float ka, int ga, float kb, int gb) {
  return ka > kb || (ka == kb && ga < gb);
}

// A window list in shared memory: br items sorted by >-, the best first.
struct List {
  uint64_t* ord;
  float* key;
  int* pos;  // flat [C, bc] capture position, -1 for an empty slot
  __device__ List(char* base, int br)
      : ord(reinterpret_cast<uint64_t*>(base)),
        key(reinterpret_cast<float*>(base + 8 * br)),
        pos(reinterpret_cast<int*>(base + 12 * br)) {}
  __device__ void put(int i, uint64_t o, float k, int p) const {
    ord[i] = o;
    key[i] = k;
    pos[i] = p;
  }
  // how many of the first n items beat order o: they are a prefix
  __device__ int beaten_by(uint64_t o, int n) const {
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (ord[mid] > o) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    return lo;
  }
};

// What a step needs of the list: its worst item, and whether the peel's edge
// (the bc-th worst key, kstar) is a tie that holds a real group (a finite
// key, or a real -inf group behind the empty slots).
struct Edge {
  uint64_t worst;
  float kstar;
  bool tied;
  __device__ Edge(const List& w, int br, int bc) {
    worst = w.ord[br - 1];
    kstar = w.key[br - bc];
    tied = br > bc && w.key[br - bc - 1] == kstar &&
           (kstar != -CUDART_INF_F || gid_of(worst) >= 0);
  }
};

// A step's winners, by rank: order, key, capture position, place.
struct Winners {
  uint64_t* ord;
  float* key;
  int* pos;
  int* place;
  __device__ explicit Winners(char* base)
      : ord(reinterpret_cast<uint64_t*>(base)),
        key(reinterpret_cast<float*>(base + 256)),
        pos(reinterpret_cast<int*>(base + 384)),
        place(reinterpret_cast<int*>(base + 512)) {}
};

// One chunk's step over the list, in place. Lane j < bc holds new group j
// (order no, key nk, capture position np); the other lanes hold NONE. The
// items from `filled` on are NONE (phase A's start), so they never move.
// Returns the key of the best item left out (the merged list's item br);
// sets `flag` when the step may differ from the reference's peel (kReplay).
template <bool kReplay>
__device__ __forceinline__ float merge_step(const List& w, Edge& edge, const Winners& win,
                                            uint64_t no, float nk, int np, int br, int bc,
                                            int& filled, bool& flag) {
  const int lane = threadIdx.x % 32;
  const bool cand = no > edge.worst;
  const unsigned mask = __ballot_sync(FULL_MASK, cand);
  if (mask == 0) {  // every new group is left out: item br is the best of them
    return kReplay ? order_value(__reduce_max_sync(FULL_MASK, order_key(nk))) : 0.f;
  }
  // the winners: rank among themselves, the items that beat them, the first
  // place that moves
  int rank = 0;
  for (unsigned m = mask; m; m &= m - 1) rank += __shfl_sync(FULL_MASK, no, __ffs(m) - 1) > no;
  // the worst does not beat a winner, and nor does NONE
  const int beaten = cand ? w.beaten_by(no, min(filled, br - 1)) : br;
  const int first = static_cast<int>(__reduce_min_sync(FULL_MASK, beaten));
  if (cand) {
    win.ord[rank] = no;
    win.key[rank] = nk;
    win.pos[rank] = np;
    win.place[rank] = beaten;  // items beaten: rank order is place order
  }
  __syncwarp();
  const int n_win = __popc(mask);
  // items first .. filled-1 move down by the winners placed at or above
  // them, 32 at a time from the bottom (a target is never below its source)
  float out = 0.f;
  bool at_br = false, pushed_tie = false;
  for (int top = filled; top > first; top -= 32) {
    const int i = top - 32 + lane;
    const bool live = i >= first;
    uint64_t o = 0;
    float k = 0.f;
    int p = 0, to = 0;
    if (live) {
      o = w.ord[i];
      k = w.key[i];
      p = w.pos[i];
      to = i;
      for (int j = 0; j < n_win; ++j) to += win.place[j] <= i;
    }
    __syncwarp();
    if (live) {
      if (to < br) {
        w.put(to, o, k, p);
      } else {
        if (to == br) out = k, at_br = true;
        pushed_tie |= k == edge.kstar;
      }
    }
    __syncwarp();
  }
  if (cand) {
    const int to = beaten + rank;
    if (to < br) {
      w.put(to, no, nk, np);
    } else if (to == br) {
      out = nk, at_br = true;
    }
  }
  if (kReplay) {
    flag |= edge.tied && __any_sync(FULL_MASK, pushed_tie);
    out = __shfl_sync(FULL_MASK, out, __ffs(__ballot_sync(FULL_MASK, at_br)) - 1);
  }
  __syncwarp();
  filled = min(br, filled + n_win);
  edge = Edge(w, br, bc);
  return out;
}

// Sweep chunks [c_lo, c_hi) through merge_step, the keys and gids of the
// next PREFETCH chunks in flight; the list's first `filled` items are not
// NONE. kReplay: write lost[c] and flag steps.
template <bool kReplay>
__device__ void sweep(const List& w, const Winners& win, const int* __restrict__ gids,
                      const float* __restrict__ capmax, const float* __restrict__ resid,
                      float* __restrict__ lost, int c_lo, int c_hi, int bc, int n_q, int q,
                      int br, int filled, bool& flag) {
  const int lane = threadIdx.x % 32;
  Edge edge(w, br, bc);
  float kb[PREFETCH], rb[PREFETCH];
  int gb[PREFETCH];
  auto load = [&](int c, float& k, int& g, float& r) {
    k = -CUDART_INF_F;
    g = NONE_GID;
    r = 0.f;
    if (c < c_hi) {
      if (lane < bc) {
        const int64_t o = (static_cast<int64_t>(c) * bc + lane) * n_q + q;
        k = capmax[o];
        g = gids[o];
      }
      if (kReplay) r = resid[static_cast<int64_t>(c) * n_q + q];
    }
  };
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u) load(c_lo + u, kb[u], gb[u], rb[u]);
  for (int c0 = c_lo; c0 < c_hi; c0 += PREFETCH) {
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int c = c0 + u;
      if (c >= c_hi) break;
      const float nk = kb[u], r = rb[u];
      const int ng = gb[u];
      load(c + PREFETCH, kb[u], gb[u], rb[u]);
      const float out = merge_step<kReplay>(w, edge, win, order(nk, ng), nk, c * bc + lane,
                                            br, bc, filled, flag);
      if (kReplay && lane == 0) lost[static_cast<int64_t>(c) * n_q + q] = fmaxf(r, out);
    }
  }
}

// dst = the top br of the sorted lists a and b.
__device__ void merge_lists(const List& a, const List& b, const List& dst, int br) {
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < br; i += 32) {
    const uint64_t oa = a.ord[i], ob = b.ord[i];
    const int ta = i + b.beaten_by(oa, br);
    const int tb = i + a.beaten_by(ob, br);
    if (ta < br) dst.put(ta, oa, a.key[i], a.pos[i]);
    if (tb < br) dst.put(tb, ob, b.key[i], b.pos[i]);
  }
  __syncwarp();
}

__device__ void copy_list(const List& src, const List& dst, int br) {
  for (int i = threadIdx.x % 32; i < br; i += 32) dst.put(i, src.ord[i], src.key[i], src.pos[i]);
  __syncwarp();
}

// Chunk 0's window as a sorted list: its groups with a finite key, then the
// empty slots br-1 .. bc, then its groups with key -inf.
__device__ void first_window(const List& dst, const int* __restrict__ gids,
                             const float* __restrict__ capmax, int bc, int n_q, int q, int br) {
  const int lane = threadIdx.x % 32;
  float k = -CUDART_INF_F;
  int g = NONE_GID;
  if (lane < bc) {
    k = capmax[static_cast<int64_t>(lane) * n_q + q];
    g = gids[static_cast<int64_t>(lane) * n_q + q];
  }
  const uint64_t o = order(k, g);
  int rank = 0;
  for (int j = 0; j < bc; ++j) rank += __shfl_sync(FULL_MASK, o, j) > o;
  const int n_fin = __popc(__ballot_sync(FULL_MASK, lane < bc && k > -CUDART_INF_F));
  if (lane < bc) dst.put(k > -CUDART_INF_F ? rank : rank + br - bc, o, k, lane);
  for (int s = bc + lane; s < br; s += 32) {
    dst.put(n_fin + br - 1 - s, order(-CUDART_INF_F, -(s + 1)), -CUDART_INF_F, -1);
  }
  __syncwarp();
}

// The reference's steps, one chunk at a time, by one warp (this kernel's
// first form), with the window in slots at `base`; a chunk whose new
// groups all lose to the window's worst item changes nothing. When bc <= 32
// the next chunks' keys and gids are loaded ahead, one a lane.
__device__ void reference_steps(int* base, const int* __restrict__ gids,
                                const float* __restrict__ capmax,
                                const float* __restrict__ resid, float* __restrict__ lost,
                                int n_c, int bc, int n_q, int q, int br) {
  const int lane = threadIdx.x % 32;
  float* wkey = reinterpret_cast<float*>(base);
  int* wgid = base + br;
  int* wpos = base + 2 * br;
  int* peel = base + 3 * br;
  float* v2 = reinterpret_cast<float*>(peel + bc);
  int* g2 = peel + 3 * bc;
  int* surv = peel + 5 * bc;
  int* survivors = peel + 7 * bc;
  for (int s = lane; s < br; s += 32) {
    const bool filled = s < bc;
    const int64_t o = static_cast<int64_t>(s) * n_q + q;  // chunk 0, slot s
    wkey[s] = filled ? capmax[o] : -CUDART_INF_F;
    wgid[s] = filled ? gids[o] : -(s + 1);
    wpos[s] = filled ? s : -1;
  }
  if (lane == 0) lost[q] = resid[q];
  __syncwarp();
  float wk;  // the item every other one beats
  int wg;
  auto find_worst = [&]() {
    wk = CUDART_INF_F;
    wg = INT_MIN;
    for (int s = lane; s < br; s += 32) {
      if (beats(wk, wg, wkey[s], wgid[s])) wk = wkey[s], wg = wgid[s];
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ok = __shfl_xor_sync(FULL_MASK, wk, o);
      const int og = __shfl_xor_sync(FULL_MASK, wg, o);
      if (beats(wk, wg, ok, og)) wk = ok, wg = og;
    }
  };
  // chunk c, its groups in v2[bc ..), g2[bc ..) and its residual r
  auto step = [&](int c, float r) {
    bool enters = false;
    float best = -CUDART_INF_F;
    for (int j = lane; j < bc; j += 32) {
      enters |= beats(v2[bc + j], g2[bc + j], wk, wg);
      best = fmaxf(best, v2[bc + j]);
    }
    const int64_t oc = static_cast<int64_t>(c) * n_q + q;
    if (!__any_sync(FULL_MASK, enters)) {  // the peeled slots all survive
      best = order_value(__reduce_max_sync(FULL_MASK, order_key(best)));
      if (lane == 0) lost[oc] = fmaxf(r, best);
      return;
    }
    // peel the bc worst slots (ascending key, -0 as +0, ties to the lower
    // slot: the least of key order << 32 | slot); a peeled slot reads +inf
    // until it is written back below (every live key is below +inf)
    for (int j = 0; j < bc; ++j) {
      uint64_t least = ~uint64_t{0};
      for (int s = lane; s < br; s += 32) {
        const float v = wkey[s];
        const uint64_t key_slot = static_cast<uint64_t>(order_key(v == 0.f ? 0.f : v)) << 32 | s;
        if (key_slot < least) least = key_slot;
      }
      const unsigned hi = __reduce_min_sync(FULL_MASK, static_cast<unsigned>(least >> 32));
      const int bs = static_cast<int>(__reduce_min_sync(
          FULL_MASK, static_cast<unsigned>(least >> 32) == hi ? static_cast<unsigned>(least)
                                                               : ~0u));
      if (lane == 0) {
        peel[j] = bs;
        v2[j] = wkey[bs];
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
      for (int j = 0; j < 2 * bc; ++j) rank += beats(v2[j], g2[j], vi, gi);
      surv[i] = rank < bc;
    }
    __syncwarp();
    // the j-th ejected slot (peel order) takes the j-th surviving new group:
    // the survivors listed in order, then each ejected slot's rank among
    // the ejected (as many new groups survive as old ones leave)
    const unsigned below = (1u << lane) - 1;
    for (int j0 = 0, n = 0; j0 < bc; j0 += 32) {
      const bool sv = j0 + lane < bc && surv[bc + j0 + lane];
      const unsigned m = __ballot_sync(FULL_MASK, sv);
      if (sv) survivors[n + __popc(m & below)] = j0 + lane;
      n += __popc(m);
    }
    __syncwarp();
    float ej = -CUDART_INF_F;  // the best key left out
    for (int j0 = 0, n = 0; j0 < bc; j0 += 32) {
      const int j = j0 + lane;
      const bool out = j < bc && !surv[j];
      const unsigned m = __ballot_sync(FULL_MASK, out);
      if (j < bc) {
        const int s = peel[j];
        if (out) {
          const int t = survivors[n + __popc(m & below)];
          ej = fmaxf(ej, v2[j]);
          wkey[s] = v2[bc + t];
          wgid[s] = g2[bc + t];
          wpos[s] = c * bc + t;
        } else {
          wkey[s] = v2[j];
        }
        if (!surv[bc + j]) ej = fmaxf(ej, v2[bc + j]);
      }
      n += __popc(m);
    }
    ej = order_value(__reduce_max_sync(FULL_MASK, order_key(ej)));
    if (lane == 0) lost[oc] = fmaxf(r, ej);
    __syncwarp();
    find_worst();
  };
  find_worst();
  if (bc > 32) {
    for (int c = 1; c < n_c; ++c) {
      __syncwarp();
      for (int j = lane; j < bc; j += 32) {
        const int64_t o = (static_cast<int64_t>(c) * bc + j) * n_q + q;
        v2[bc + j] = capmax[o];
        g2[bc + j] = gids[o];
      }
      __syncwarp();
      step(c, resid[static_cast<int64_t>(c) * n_q + q]);
    }
    return;
  }
  float kb[PREFETCH], rb[PREFETCH];
  int gb[PREFETCH];
  auto load = [&](int c, float& k, int& g, float& r) {
    k = 0.f;
    g = 0;
    r = 0.f;
    if (c < n_c) {
      if (lane < bc) {
        const int64_t o = (static_cast<int64_t>(c) * bc + lane) * n_q + q;
        k = capmax[o];
        g = gids[o];
      }
      r = resid[static_cast<int64_t>(c) * n_q + q];
    }
  };
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u) load(1 + u, kb[u], gb[u], rb[u]);
  for (int c0 = 1; c0 < n_c; c0 += PREFETCH) {
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int c = c0 + u;
      if (c >= n_c) break;
      __syncwarp();
      if (lane < bc) {
        v2[bc + lane] = kb[u];
        g2[bc + lane] = gb[u];
      }
      const float r = rb[u];
      load(c + PREFETCH, kb[u], gb[u], rb[u]);
      __syncwarp();
      step(c, r);
    }
  }
}

__global__ void __launch_bounds__(MAX_SEGMENTS * 32)
    window_merge_kernel(const int* __restrict__ gids, const float* __restrict__ capmax,
                        const float* __restrict__ resid, const float* __restrict__ capture,
                        float* __restrict__ win, float* __restrict__ wkey_out,
                        int* __restrict__ wgid_out, float* __restrict__ lost,
                        int* __restrict__ paths, int n_c, int bc, int n_q, int br,
                        int total_groups) {
  extern __shared__ __align__(16) char smem_raw[];
  const int q = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_seg = blockDim.x / 32;
  int* head = reinterpret_cast<int*>(smem_raw);  // [0]: the reference's steps; [4 + w]: w's list
  int* posr = reinterpret_cast<int*>(smem_raw + HEAD_BYTES);  // the final order's positions
  char* region = smem_raw + HEAD_BYTES + round16(4 * static_cast<size_t>(br));
  auto list_of = [&](int w, int which) {
    return List(region + w * warp_bytes(br) + which * 16 * static_cast<size_t>(br), br);
  };
  const Winners winners(region + warp * warp_bytes(br) + 32 * static_cast<size_t>(br));
  const bool segmented = bc <= MAX_LANE_BC;
  if (threadIdx.x == 0) head[0] = !segmented;
  if (threadIdx.x < MAX_SEGMENTS) head[4 + threadIdx.x] = 0;
  if (segmented) {
    // segment `warp` of the chunks 1 .. n_c - 1
    const int c_lo = 1 + static_cast<int>(static_cast<int64_t>(warp) * (n_c - 1) / n_seg);
    const int c_hi = 1 + static_cast<int>(static_cast<int64_t>(warp + 1) * (n_c - 1) / n_seg);
    bool flag = false;
    // A: the segment's top br (warp 0: with chunk 0's window) in list 0
    const List mine = list_of(warp, 0);
    if (warp == 0) {
      first_window(mine, gids, capmax, bc, n_q, q, br);
    } else {
      for (int i = lane; i < br; i += 32) {
        mine.put(i, order(-CUDART_INF_F, NONE_GID), -CUDART_INF_F, -1);
      }
      __syncwarp();
    }
    sweep<false>(mine, winners, gids, capmax, resid, lost, c_lo, c_hi, bc, n_q, q, br,
                 warp == 0 ? br : 0, flag);
    // B: the window after each segment, by an inclusive scan of the warps' lists
    for (int span = 1; span < n_seg; span *= 2) {
      __syncthreads();
      const int cur = head[4 + warp];
      if (warp >= span) {
        merge_lists(list_of(warp - span, head[4 + warp - span]), list_of(warp, cur),
                    list_of(warp, 1 - cur), br);
      }
      __syncthreads();
      if (warp >= span && lane == 0) head[4 + warp] = 1 - cur;
    }
    __syncthreads();
    // the window at the segment's start: the left neighbour's end (warp 0:
    // chunk 0's window again), in the warp's other list
    const List start = list_of(warp, 1 - head[4 + warp]);
    if (warp == 0) {
      first_window(start, gids, capmax, bc, n_q, q, br);
    } else {
      copy_list(list_of(warp - 1, head[4 + warp - 1]), start, br);
    }
    __syncthreads();
    // C: the replay, writing lost
    sweep<true>(start, winners, gids, capmax, resid, lost, c_lo, c_hi, bc, n_q, q, br, br,
                flag);
    if (warp == 0 && lane == 0) lost[q] = resid[q];
    if (lane == 0 && flag) head[0] = 1;
  }
  __syncthreads();
  const bool reference = head[0] != 0;
  if (paths != nullptr && threadIdx.x == 0) paths[q] = reference;
  if (reference) {
    if (warp == 0) {
      reference_steps(reinterpret_cast<int*>(region), gids, capmax, resid, lost, n_c, bc, n_q,
                      q, br);
    }
    __syncthreads();
  }
  // the window sorted by gid (empty slot s: total_groups + s); gids are unique
  const int* sgid = reinterpret_cast<const int*>(region) + br;  // the reference's slots
  const List fin = list_of(n_seg - 1, 1 - head[4 + n_seg - 1]);  // the last replay's list
  auto sorted_gid = [&](int s) {
    const int g = reference ? sgid[s] : gid_of(fin.ord[s]);
    return g < 0 ? total_groups - g - 1 : g;
  };
  for (int s = threadIdx.x; s < br; s += blockDim.x) {
    const int gs = sorted_gid(s);
    int rank = 0;
    for (int t = 0; t < br; ++t) rank += sorted_gid(t) < gs;
    const int64_t o = static_cast<int64_t>(q) * br + rank;
    const float k = reference ? reinterpret_cast<const float*>(region)[s] : fin.key[s];
    wkey_out[o] = fmaxf(k, FIN_MIN);
    wgid_out[o] = gs;
    posr[rank] = reference ? sgid[br + s] : fin.pos[s];
  }
  __syncthreads();
  for (int r = warp; r < br; r += n_seg) {
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
// [n_c, 1, n_q]; paths int32 [n_q] (or null): 1 where the query took the
// reference's steps. `segments` warps a query (kernels.exact.merge_segments):
// 1 .. 32 and at most max(1, n_c - 1), 1 when bc > 32. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for another segment count, or when the
// lists do not fit in shared memory).
extern "C" int kirag_window_merge(const int* gids, const float* capmax, const float* resid,
                                  const float* capture, float* win, float* wkey, int* wgid,
                                  float* lost, int n_c, int bc, int n_q, int br,
                                  int total_groups, int segments, int* paths, void* stream) {
  if (bc < 1 || br < bc || n_c < 1 || n_q < 1 || segments < 1 || segments > MAX_SEGMENTS ||
      segments > max(1, n_c - 1) || (bc > MAX_LANE_BC && segments != 1)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(br, bc, segments);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  window_merge_kernel<<<n_q, segments * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      gids, capmax, resid, capture, win, wkey, wgid, lost, paths, n_c, bc, n_q, br,
      total_groups);
  return cudaGetLastError();
}
