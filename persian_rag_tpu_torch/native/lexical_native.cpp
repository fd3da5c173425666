// Native lexical-index builder: whitespace tokenization, vocabulary
// construction, document frequencies, and Okapi BM25 per-(doc, term)
// contribution precompute into padded-ELL arrays, loaded through ctypes by
// persian_rag_tpu_torch/native/__init__.py (g++ at first use, into the
// build/ tree).
//
// A copy of the JAX package's builder (persian_rag_tpu/native/
// lexical_native.cpp) with one change: the idf comes from the caller
// (bm25_fill_ell). The caller computes it with numpy's log, in the Python
// builder's loop, so the two builders agree bit for bit: std::log and
// numpy's log may part in the last bit (each is within an ulp, not always
// the same one).
//
// Contract notes:
// * Tokens are byte-exact whitespace splits of the UTF-8 input
//   (Python str.split() semantics over ASCII whitespace; the caller
//   re-joins str.split()'s tokens on single spaces).
// * Vocabulary ids are assigned in first-occurrence order over the
//   corpus scan, matching the Python builder, so ELL arrays are
//   bit-identical between backends.
// * BM25 math matches rank_bm25.BM25Okapi: contribution
//   idf * tf*(k1+1)/(tf + k1*(1-b+b*dl/avgdl)), in double, in the Python
//   builder's order, then rounded to float.
//
// Build: g++ -O2 -ffp-contract=off -shared -fPIC -std=c++17
//        lexical_native.cpp -o liblexical.so

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Bm25Handle {
  std::unordered_map<std::string, int32_t> vocab;
  std::vector<std::string> terms;              // id -> term
  std::vector<std::vector<std::pair<int32_t, int32_t>>> doc_tfs;  // (id, tf)
  std::vector<int64_t> doc_freq;               // per term id
  std::vector<int64_t> doc_lens;               // per doc
  int64_t ell_width = 0;
  double avgdl = 0.0;
  double k1 = 1.5, b = 0.75;
};

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

// Split [begin, end) on ASCII whitespace, invoking fn(token_view).
template <typename Fn>
void for_each_token(const char* begin, const char* end, Fn fn) {
  const char* p = begin;
  while (p < end) {
    while (p < end && is_space(*p)) ++p;
    const char* start = p;
    while (p < end && !is_space(*p)) ++p;
    if (p > start) fn(std::string_view(start, p - start));
  }
}

}  // namespace

extern "C" {

// Count a BM25 corpus of n_docs documents packed into one UTF-8 buffer:
// vocabulary, document frequencies, per-doc (term, tf) in first-occurrence
// order, lengths and avgdl. doc_offsets has n_docs+1 entries (byte offsets
// into buffer).
void* bm25_build(const char* buffer, const int64_t* doc_offsets,
                 int64_t n_docs, double k1, double b) {
  auto* h = new Bm25Handle();
  h->k1 = k1;
  h->b = b;

  std::vector<int64_t>& doc_lens = h->doc_lens;
  doc_lens.assign(n_docs, 0);
  std::vector<int64_t>& doc_freq = h->doc_freq;
  // per-doc term counts, reusing a scratch map keyed by term id
  std::unordered_map<int32_t, int32_t> tf_scratch;
  int64_t total_len = 0;

  std::vector<std::vector<std::pair<int32_t, int32_t>>>& doc_tfs = h->doc_tfs;
  doc_tfs.resize(n_docs);

  for (int64_t d = 0; d < n_docs; ++d) {
    const char* begin = buffer + doc_offsets[d];
    const char* end = buffer + doc_offsets[d + 1];
    tf_scratch.clear();
    std::vector<int32_t> order;  // first-occurrence order of term ids
    for_each_token(begin, end, [&](std::string_view tok) {
      ++doc_lens[d];
      auto it = h->vocab.find(std::string(tok));
      int32_t id;
      if (it == h->vocab.end()) {
        id = static_cast<int32_t>(h->terms.size());
        h->vocab.emplace(std::string(tok), id);
        h->terms.emplace_back(tok);
        doc_freq.push_back(0);
      } else {
        id = it->second;
      }
      auto [tf_it, inserted] = tf_scratch.try_emplace(id, 0);
      if (inserted) order.push_back(id);
      ++tf_it->second;
    });
    total_len += doc_lens[d];
    auto& tfs = doc_tfs[d];
    tfs.reserve(order.size());
    for (int32_t id : order) {
      tfs.emplace_back(id, tf_scratch[id]);
      ++doc_freq[id];
    }
    if (static_cast<int64_t>(order.size()) > h->ell_width)
      h->ell_width = static_cast<int64_t>(order.size());
  }
  if (h->ell_width == 0) h->ell_width = 1;
  h->avgdl = n_docs ? static_cast<double>(total_len) / n_docs : 0.0;
  return h;
}

int64_t bm25_ell_width(void* handle) {
  return static_cast<Bm25Handle*>(handle)->ell_width;
}

int64_t bm25_vocab_size(void* handle) {
  return static_cast<int64_t>(static_cast<Bm25Handle*>(handle)->terms.size());
}

double bm25_avgdl(void* handle) {
  return static_cast<Bm25Handle*>(handle)->avgdl;
}

// Export each term's document frequency (term id == position).
void bm25_export_df(void* handle, int64_t* df_out) {
  auto* h = static_cast<Bm25Handle*>(handle);
  std::memcpy(df_out, h->doc_freq.data(),
              h->doc_freq.size() * sizeof(int64_t));
}

// Fill caller-allocated (n_docs x ell_width) arrays with the contributions
// under idf (one double a term id); ids padded with -1, vals with 0.
void bm25_fill_ell(void* handle, const double* idf, int32_t* ids_out,
                   float* vals_out) {
  auto* h = static_cast<Bm25Handle*>(handle);
  const int64_t L = h->ell_width;
  const double k1 = h->k1, b = h->b;
  for (size_t d = 0; d < h->doc_tfs.size(); ++d) {
    int32_t* ids = ids_out + d * L;
    float* vals = vals_out + d * L;
    const double denom_norm =
        k1 * (1.0 - b + b * h->doc_lens[d] / (h->avgdl > 0 ? h->avgdl : 1e-12));
    int64_t i = 0;
    for (auto [id, tf] : h->doc_tfs[d]) {
      const double contrib = idf[id] * tf * (k1 + 1.0) / (tf + denom_norm);
      ids[i] = id;
      vals[i] = static_cast<float>(contrib);
      ++i;
    }
    for (; i < L; ++i) {
      ids[i] = -1;
      vals[i] = 0.0f;
    }
  }
}

// Total bytes of all vocabulary terms concatenated (for export).
int64_t bm25_vocab_bytes(void* handle) {
  auto* h = static_cast<Bm25Handle*>(handle);
  int64_t total = 0;
  for (const auto& t : h->terms) total += static_cast<int64_t>(t.size());
  return total;
}

// Export vocab as a concatenated UTF-8 buffer + (vocab_size+1) offsets;
// term id == position.
void bm25_export_vocab(void* handle, char* buf_out, int64_t* offsets_out) {
  auto* h = static_cast<Bm25Handle*>(handle);
  int64_t pos = 0;
  int64_t i = 0;
  for (const auto& t : h->terms) {
    offsets_out[i++] = pos;
    std::memcpy(buf_out + pos, t.data(), t.size());
    pos += static_cast<int64_t>(t.size());
  }
  offsets_out[i] = pos;
}

void bm25_free(void* handle) { delete static_cast<Bm25Handle*>(handle); }

}  // extern "C"
