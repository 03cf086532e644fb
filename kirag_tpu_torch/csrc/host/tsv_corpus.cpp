// Native DPR-TSV corpus parser: the data-loader hot path at 21M-row scale.
//
// Replaces the Python line loop of kirag_tpu_torch/data/corpus.py::
// load_psg_data for the `id \t text \t title` psgs_w100.tsv format.
// Python-object parsing of 21M rows costs
// minutes and ~10GB of dict/str overhead; this parser returns three packed
// byte blobs (id/text/title) + int64 offset arrays, which the Python side
// wraps in lazy dict views (no per-row PyObjects until accessed).
//
// Exact behavioral parity with the Python loader, pinned by tests:
//   - skip the header row (the first parsed row)
//   - line.strip() before splitting on '\t' — strips the SINGLE-BYTE Python
//     str whitespace set (ASCII space/\t/\n/\r/\f/\v plus \x1c-\x1f). Known
//     limitation vs Python: multi-byte UTF-8 whitespace (U+00A0, U+0085,
//     U+2000...) at line edges is NOT stripped; DPR psgs_w100 contains none,
//     and tests/test_torch_native.py pins the byte-identical contract on the
//     covered set.
//   - universal newlines: lines end at '\n', "\r\n", or a lone '\r'
//     (matching Python text-mode iteration)
//   - rows with < 3 tab-separated fields are skipped
//   - fields beyond the third are ignored (the third ends at the next tab)
//   - clean(): drop ONE leading and ONE trailing ASCII-punctuation char,
//     then replace doubled quotes "" with "
//
// Built at first use by kirag_tpu_torch.kernels.build.build_host (g++ -O3
// -march=native -fPIC -shared -fopenmp -std=c++17), loaded through ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline bool is_space(unsigned char c) {
  // Python str.strip()'s single-byte whitespace: ASCII ws + FS/GS/RS/US
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v' || (c >= 0x1c && c <= 0x1f);
}

inline bool is_punct(unsigned char c) {
  // Python string.punctuation: !"#$%&'()*+,-./:;<=>?@[\]^_`{|}~
  static const bool table[256] = {};
  static bool init = false;
  static bool t[256];
  if (!init) {
    const char* p = "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~";
    std::memset(t, 0, sizeof(t));
    for (; *p; ++p) t[(unsigned char)*p] = true;
    init = true;
  }
  (void)table;
  return t[c];
}

// clean(): strip one punct char each end, collapse "" -> " (bulk appends:
// rows without doubled quotes cost one memcpy)
void clean_into(const char* s, size_t len, std::string* out) {
  if (len > 0 && is_punct((unsigned char)s[0])) {
    ++s;
    --len;
  }
  if (len > 0 && is_punct((unsigned char)s[len - 1])) --len;
  size_t seg = 0;
  for (size_t i = 0; i + 1 < len; ++i) {
    if (s[i] == '"' && s[i + 1] == '"') {
      out->append(s + seg, i + 1 - seg);  // keep ONE quote
      ++i;                                 // skip the second
      seg = i + 1;
    }
  }
  out->append(s + seg, len - seg);
}

struct Field {
  const char* p;
  size_t len;
};

struct Parsed {
  std::string ids, texts, titles;            // packed blobs
  std::vector<int64_t> id_off, text_off, title_off;  // n+1 offsets each
};

struct Handle {
  std::string ids, texts, titles;
  std::vector<int64_t> id_off, text_off, title_off;
  int64_t rows = 0;
};

// parse [begin, end) of the file buffer into out; rows_seen counts ALL parsed
// rows (for header skipping decided by the caller)
void parse_range(const char* begin, const char* end, Parsed* out) {
  out->id_off.push_back(0);
  out->text_off.push_back(0);
  out->title_off.push_back(0);
  const char* line = begin;
  while (line < end) {
    // universal newlines: break at '\n' or lone '\r' (a following '\n' is
    // consumed with it, so "\r\n" counts once) — Python text-mode parity
    const char* nl_n = (const char*)memchr(line, '\n', end - line);
    const char* scan_end = nl_n ? nl_n : end;
    const char* nl_r =
        (const char*)memchr(line, '\r', (size_t)(scan_end - line));
    const char* nl = nl_r ? nl_r : nl_n;
    const char* line_end = nl ? nl : end;
    // strip ASCII whitespace both ends
    const char* a = line;
    const char* b = line_end;
    while (a < b && is_space((unsigned char)*a)) ++a;
    while (b > a && is_space((unsigned char)b[-1])) --b;
    // split on '\t': need >= 3 fields; 3rd field ends at next tab or end
    Field f[3];
    int nf = 0;
    const char* s = a;
    while (s <= b && nf < 3) {
      const char* tab = (const char*)memchr(s, '\t', b - s);
      const char* fe = (nf == 2 || !tab) ? (nf == 2 && tab ? tab : b) : tab;
      if (nf == 2) fe = tab ? tab : b;
      f[nf].p = s;
      f[nf].len = (size_t)(fe - s);
      ++nf;
      if (!tab) break;
      s = tab + 1;
    }
    if (nf >= 3) {
      out->ids.append(f[0].p, f[0].len);
      clean_into(f[1].p, f[1].len, &out->texts);
      clean_into(f[2].p, f[2].len, &out->titles);
      out->id_off.push_back((int64_t)out->ids.size());
      out->text_off.push_back((int64_t)out->texts.size());
      out->title_off.push_back((int64_t)out->titles.size());
    }
    if (!nl) break;
    line = nl + 1;
    if (*nl == '\r' && line < end && *line == '\n') ++line;  // "\r\n"
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle (nullptr on error). Skips the header row.
void* tsv_corpus_load(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  std::fseek(fp, 0, SEEK_END);
  long fsize = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::vector<char> buf((size_t)fsize);
  if (fsize > 0 && std::fread(buf.data(), 1, (size_t)fsize, fp) !=
                       (size_t)fsize) {
    std::fclose(fp);
    return nullptr;
  }
  std::fclose(fp);

  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  // split the buffer at line boundaries
  std::vector<const char*> starts(nthreads + 1);
  starts[0] = buf.data();
  starts[nthreads] = buf.data() + buf.size();
  for (int t = 1; t < nthreads; ++t) {
    const char* guess = buf.data() + buf.size() * t / nthreads;
    const char* nl = (const char*)memchr(
        guess, '\n', (size_t)(buf.data() + buf.size() - guess));
    starts[t] = nl ? nl + 1 : buf.data() + buf.size();
  }
  std::vector<Parsed> parts(nthreads);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int t = 0; t < nthreads; ++t) {
    if (starts[t] < starts[t + 1]) parse_range(starts[t], starts[t + 1], &parts[t]);
  }

  Handle* h = new Handle();
  int nonempty = 0, only = -1;
  for (int t = 0; t < (int)parts.size(); ++t) {
    if (parts[t].id_off.size() > 1) {
      ++nonempty;
      only = t;
    }
  }
  if (nonempty == 1) {
    // single-part fast path (1-thread hosts): MOVE the blobs; offsets start
    // at the post-header row and index absolutely into the moved blob
    Parsed& part = parts[only];
    int64_t nrows = (int64_t)part.id_off.size() - 1;
    h->ids = std::move(part.ids);
    h->texts = std::move(part.texts);
    h->titles = std::move(part.titles);
    h->id_off.assign(part.id_off.begin() + 1, part.id_off.end());
    h->text_off.assign(part.text_off.begin() + 1, part.text_off.end());
    h->title_off.assign(part.title_off.begin() + 1, part.title_off.end());
    h->rows = nrows - 1;
    if (h->rows < 0) h->rows = 0;
    return h;
  }
  // concatenate parts with BULK copies, skipping the first parsed row
  // overall (header): per-part one memcpy per blob + one offset rebase
  int64_t total_rows = 0, tid = 0, ttext = 0, ttitle = 0;
  bool first = true;
  for (auto& part : parts) {
    int64_t nrows = part.id_off.size() ? (int64_t)part.id_off.size() - 1 : 0;
    int64_t from = (first && nrows > 0) ? 1 : 0;
    if (nrows > 0) first = false;
    total_rows += nrows - from;
    tid += (int64_t)part.ids.size() - (nrows ? part.id_off[from] : 0);
    ttext += (int64_t)part.texts.size() - (nrows ? part.text_off[from] : 0);
    ttitle += (int64_t)part.titles.size() - (nrows ? part.title_off[from] : 0);
  }
  h->ids.reserve((size_t)tid);
  h->texts.reserve((size_t)ttext);
  h->titles.reserve((size_t)ttitle);
  h->id_off.reserve((size_t)total_rows + 1);
  h->text_off.reserve((size_t)total_rows + 1);
  h->title_off.reserve((size_t)total_rows + 1);
  h->id_off.push_back(0);
  h->text_off.push_back(0);
  h->title_off.push_back(0);

  first = true;
  for (auto& part : parts) {
    int64_t nrows = part.id_off.size() ? (int64_t)part.id_off.size() - 1 : 0;
    if (nrows == 0) continue;
    int64_t from = first ? 1 : 0;
    first = false;
    if (from >= nrows) continue;
    const int64_t id_base = (int64_t)h->ids.size() - part.id_off[from];
    const int64_t text_base = (int64_t)h->texts.size() - part.text_off[from];
    const int64_t title_base =
        (int64_t)h->titles.size() - part.title_off[from];
    h->ids.append(part.ids, (size_t)part.id_off[from], std::string::npos);
    h->texts.append(part.texts, (size_t)part.text_off[from],
                    std::string::npos);
    h->titles.append(part.titles, (size_t)part.title_off[from],
                     std::string::npos);
    for (int64_t r = from + 1; r <= nrows; ++r) {
      h->id_off.push_back(part.id_off[r] + id_base);
      h->text_off.push_back(part.text_off[r] + text_base);
      h->title_off.push_back(part.title_off[r] + title_base);
    }
    h->rows += nrows - from;
  }
  return h;
}

int64_t tsv_corpus_rows(void* handle) {
  return ((Handle*)handle)->rows;
}

// copies the n+1 offsets for each field into caller buffers
void tsv_corpus_offsets(void* handle, int64_t* id_off, int64_t* text_off,
                        int64_t* title_off) {
  Handle* h = (Handle*)handle;
  std::memcpy(id_off, h->id_off.data(), h->id_off.size() * sizeof(int64_t));
  std::memcpy(text_off, h->text_off.data(),
              h->text_off.size() * sizeof(int64_t));
  std::memcpy(title_off, h->title_off.data(),
              h->title_off.size() * sizeof(int64_t));
}

int64_t tsv_corpus_blob_size(void* handle, int field) {
  Handle* h = (Handle*)handle;
  switch (field) {
    case 0:
      return (int64_t)h->ids.size();
    case 1:
      return (int64_t)h->texts.size();
    default:
      return (int64_t)h->titles.size();
  }
}

void tsv_corpus_blob(void* handle, int field, char* out) {
  Handle* h = (Handle*)handle;
  const std::string& s =
      field == 0 ? h->ids : (field == 1 ? h->texts : h->titles);
  std::memcpy(out, s.data(), s.size());
}

void tsv_corpus_free(void* handle) {
  delete (Handle*)handle;
}

}  // extern "C"
