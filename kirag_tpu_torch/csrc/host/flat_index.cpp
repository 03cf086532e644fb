// CPU flat exact-search index: the host-side counterpart of the device
// search (kirag_tpu_torch/index/indexer.py) and a replacement for FAISS's
// IndexFlatIP/IndexFlatL2 on machines without an accelerator.
//
// Design: row-major float32 matrix, blocked scoring (queries x row-blocks)
// with OpenMP across queries, per-query bounded min-heap for top-k, exact
// FAISS-style tie-breaking (lower row index wins on equal score).
//
// C ABI (ctypes-friendly): create/free/add/search/ntotal/save/load. Built at
// first use by kirag_tpu_torch.kernels.build.build_host.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct FlatIndex {
  int64_t dim = 0;
  int metric = 0;  // 0 = inner product, 1 = squared L2
  std::vector<float> data;   // [n, dim] row-major
  std::vector<float> sqnorm; // per-row squared norms (L2 metric)

  int64_t rows() const { return dim ? static_cast<int64_t>(data.size()) / dim : 0; }
};

// (score, index) ordering: better = higher score, ties -> lower index.
struct Entry {
  float score;
  int64_t index;
};
struct WorseFirst {
  bool operator()(const Entry& a, const Entry& b) const {
    if (a.score != b.score) return a.score > b.score;  // keep worst on top
    return a.index < b.index;                          // higher index is worse
  }
};

void search_row(const FlatIndex& ix, const float* q, int64_t k,
                float* out_scores, int64_t* out_indices) {
  const int64_t n = ix.rows();
  const int64_t d = ix.dim;
  const int64_t keep = std::min(k, n);
  std::priority_queue<Entry, std::vector<Entry>, WorseFirst> heap;

  constexpr int64_t kBlock = 4096;
  std::vector<float> scores(kBlock);
  for (int64_t start = 0; start < n; start += kBlock) {
    const int64_t len = std::min(kBlock, n - start);
    // blocked dot products; the inner loop vectorizes under -O3
    for (int64_t r = 0; r < len; ++r) {
      const float* row = ix.data.data() + (start + r) * d;
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
      int64_t c = 0;
      for (; c + 4 <= d; c += 4) {
        acc0 += q[c] * row[c];
        acc1 += q[c + 1] * row[c + 1];
        acc2 += q[c + 2] * row[c + 2];
        acc3 += q[c + 3] * row[c + 3];
      }
      float acc = acc0 + acc1 + acc2 + acc3;
      for (; c < d; ++c) acc += q[c] * row[c];
      scores[r] = acc;
    }
    if (ix.metric == 1) {
      float qsq = 0.f;
      for (int64_t c = 0; c < d; ++c) qsq += q[c] * q[c];
      for (int64_t r = 0; r < len; ++r) {
        // ||q - x||^2 = ||q||^2 - 2 q.x + ||x||^2; rank by NEGATED distance
        scores[r] = -(qsq - 2.f * scores[r] + ix.sqnorm[start + r]);
      }
    }
    for (int64_t r = 0; r < len; ++r) {
      Entry e{scores[r], start + r};
      if (static_cast<int64_t>(heap.size()) < keep) {
        heap.push(e);
      } else {
        const Entry& worst = heap.top();
        const bool better = e.score > worst.score ||
                            (e.score == worst.score && e.index < worst.index);
        if (better) {
          heap.pop();
          heap.push(e);
        }
      }
    }
  }

  std::vector<Entry> sorted(heap.size());
  for (int64_t i = static_cast<int64_t>(heap.size()) - 1; i >= 0; --i) {
    sorted[i] = heap.top();
    heap.pop();
  }
  for (int64_t i = 0; i < keep; ++i) {
    out_scores[i] = ix.metric == 1 ? -sorted[i].score : sorted[i].score;
    out_indices[i] = sorted[i].index;
  }
  for (int64_t i = keep; i < k; ++i) {  // k > n padding
    out_scores[i] = ix.metric == 1 ? 3.4e38f : -3.4e38f;
    out_indices[i] = -1;
  }
}

constexpr uint64_t kMagic = 0x4b49524147464c41ull;  // "KIRAGFLA"

}  // namespace

extern "C" {

void* flat_index_create(int64_t dim, int metric) {
  auto* ix = new FlatIndex();
  ix->dim = dim;
  ix->metric = metric;
  return ix;
}

void flat_index_free(void* handle) { delete static_cast<FlatIndex*>(handle); }

int64_t flat_index_ntotal(void* handle) {
  return static_cast<FlatIndex*>(handle)->rows();
}

void flat_index_add(void* handle, const float* vectors, int64_t n) {
  auto* ix = static_cast<FlatIndex*>(handle);
  ix->data.insert(ix->data.end(), vectors, vectors + n * ix->dim);
  if (ix->metric == 1) {
    for (int64_t r = 0; r < n; ++r) {
      const float* row = vectors + r * ix->dim;
      float s = 0.f;
      for (int64_t c = 0; c < ix->dim; ++c) s += row[c] * row[c];
      ix->sqnorm.push_back(s);
    }
  }
}

void flat_index_search(void* handle, const float* queries, int64_t nq, int64_t k,
                       float* out_scores, int64_t* out_indices) {
  auto* ix = static_cast<FlatIndex*>(handle);
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (int64_t qi = 0; qi < nq; ++qi) {
    search_row(*ix, queries + qi * ix->dim, k,
               out_scores + qi * k, out_indices + qi * k);
  }
}

int flat_index_save(void* handle, const char* path) {
  auto* ix = static_cast<FlatIndex*>(handle);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const uint64_t magic = kMagic;
  const int64_t n = ix->rows();
  std::fwrite(&magic, sizeof(magic), 1, f);
  std::fwrite(&ix->dim, sizeof(ix->dim), 1, f);
  std::fwrite(&ix->metric, sizeof(ix->metric), 1, f);
  std::fwrite(&n, sizeof(n), 1, f);
  std::fwrite(ix->data.data(), sizeof(float), ix->data.size(), f);
  std::fclose(f);
  return 0;
}

void* flat_index_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  uint64_t magic = 0;
  int64_t dim = 0, n = 0;
  int metric = 0;
  if (std::fread(&magic, sizeof(magic), 1, f) != 1 || magic != kMagic) {
    std::fclose(f);
    return nullptr;
  }
  if (std::fread(&dim, sizeof(dim), 1, f) != 1 ||
      std::fread(&metric, sizeof(metric), 1, f) != 1 ||
      std::fread(&n, sizeof(n), 1, f) != 1) {
    std::fclose(f);
    return nullptr;
  }
  auto* ix = new FlatIndex();
  ix->dim = dim;
  ix->metric = metric;
  ix->data.resize(n * dim);
  if (std::fread(ix->data.data(), sizeof(float), ix->data.size(), f) != ix->data.size()) {
    std::fclose(f);
    delete ix;
    return nullptr;
  }
  std::fclose(f);
  if (metric == 1) {
    ix->sqnorm.resize(n);
    for (int64_t r = 0; r < n; ++r) {
      const float* row = ix->data.data() + r * dim;
      float s = 0.f;
      for (int64_t c = 0; c < dim; ++c) s += row[c] * row[c];
      ix->sqnorm[r] = s;
    }
  }
  return ix;
}

}  // extern "C"
