// Native SentencePiece unigram encoder: normalization + Viterbi + batching.
//
// C++ core for the host-side tokenization hot loop, replacing the role of
// fairseq2n's C++ sentencepiece binding (reference import sites:
// sonar/inference_pipelines/text.py:13-14). Three layers:
//
//   1. Normalization: the model's precompiled charsmap (darts-clone
//      double-array trie, sentencepiece normalizer.cc semantics) or
//      identity, followed by the whitespace phase (remove_extra /
//      dummy-prefix / U+2581 escaping). Byte-level, bit-identical to the
//      Python implementation in sonar_tpu_torch/tokenizers/{charsmap,spm}.py for
//      valid-UTF-8 replacement blobs (which is what real models ship).
//      Models whose normalizer needs NFKC (no charsmap) normalize in
//      Python and enter here pre-normalized.
//   2. Viterbi segmentation over a byte trie of the vocabulary — O(1) per
//      extension byte instead of a fresh hash per (start, end) substring.
//      Results are bit-identical to the pure-Python DP
//      (sonar_tpu_torch/tokenizers/spm.py::_viterbi): same relaxation order,
//      same strict-greater tie rule, same unk/byte-fallback handling.
//   3. A batch entry point with an internal thread pool: one ctypes call
//      tokenizes thousands of strings with the GIL released; output is a
//      packed id array + offsets (allocated here, freed by the caller via
//      spm_free_*).
//
// Exposed via a plain C ABI for ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC spm.cpp -o _sonar_native.so

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Vocabulary byte trie
// ---------------------------------------------------------------------------

struct TrieBuildNode {
  std::map<uint8_t, int32_t> children;
  int32_t term_id = -1;
  float term_score = 0.0f;
};

struct SpmModel {
  // Flattened byte trie over encodable pieces. Node 0 is the root and has a
  // dense 256-entry child table (hot: every Viterbi start passes through
  // it); other nodes use a sorted edge range.
  std::vector<int32_t> root_child;           // [256]
  std::vector<int32_t> first_edge, n_edges;  // per node
  std::vector<uint8_t> edge_label;
  std::vector<int32_t> edge_target;
  std::vector<int32_t> term_id;    // per node, -1 when not a piece end
  std::vector<float> term_score;

  int32_t unk_id = 0;
  float unk_score = -1e9f;
  int32_t byte_ids[256];
  bool byte_fallback = false;

  // Normalizer (optional, spm_set_normalizer).
  bool has_normalizer = false;
  bool has_charsmap = false;
  bool remove_extra_ws = true;
  bool add_dummy_prefix = true;
  bool escape_ws = true;
  std::vector<uint32_t> cm_units;   // darts-clone trie
  std::vector<uint8_t> cm_repl;     // \0-separated replacement blob
};

// Byte offsets of UTF-8 character starts (plus end sentinel).
inline void char_starts(const uint8_t* s, int len, std::vector<int32_t>& out) {
  out.clear();
  for (int i = 0; i < len; ++i) {
    if ((s[i] & 0xC0) != 0x80) out.push_back(i);
  }
  out.push_back(len);
}

inline int32_t trie_child(const SpmModel& m, int32_t node, uint8_t c) {
  if (node == 0) return m.root_child[c];
  int32_t lo = m.first_edge[node], hi = lo + m.n_edges[node];
  while (lo < hi) {  // binary search over the sorted edge labels
    int32_t mid = (lo + hi) / 2;
    uint8_t l = m.edge_label[mid];
    if (l == c) return m.edge_target[mid];
    if (l < c)
      lo = mid + 1;
    else
      hi = mid;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// Charsmap (darts-clone) normalization — mirrors tokenizers/charsmap.py
// ---------------------------------------------------------------------------

inline uint32_t darts_offset(uint32_t unit) {
  return (unit >> 10) << ((unit & (1u << 9)) >> 6);
}

// Longest key matching data[pos:]; -> (match_len, value) or (0, -1).
inline void darts_longest(const std::vector<uint32_t>& units,
                          const uint8_t* data, int n, int pos,
                          int* best_len, int32_t* best_val) {
  *best_len = 0;
  *best_val = -1;
  uint32_t node = 0;
  uint32_t unit = units[0];
  for (int i = pos; i < n; ++i) {
    uint8_t c = data[i];
    node ^= darts_offset(unit) ^ c;
    if (node >= units.size()) break;
    unit = units[node];
    if ((unit & 0x800000FFu) != c) break;  // label mismatch (or leaf unit)
    if ((unit >> 8) & 1u) {                // has_leaf
      // Bounds-check the leaf read: a malformed blob must degrade to
      // "no match", not read out of bounds (the header-only validation in
      // spm_set_normalizer cannot rule this out).
      uint32_t leaf_idx = node ^ darts_offset(unit);
      if (leaf_idx >= units.size()) break;
      uint32_t leaf = units[leaf_idx];
      *best_len = i - pos + 1;
      *best_val = static_cast<int32_t>(leaf & 0x7FFFFFFFu);
    }
  }
}

// Full normalization: charsmap rewrite (when present) + whitespace phase.
// Exactly SentencePieceModel.normalize() for charsmap/identity models.
void normalize_bytes(const SpmModel& m, const uint8_t* data, int n,
                     std::string& out) {
  thread_local std::string tmp;
  const uint8_t* src = data;
  int src_len = n;
  if (m.has_charsmap) {
    tmp.clear();
    int i = 0;
    while (i < n) {
      int len;
      int32_t val;
      darts_longest(m.cm_units, data, n, i, &len, &val);
      if (len > 0) {
        // replacement = cm_repl[val .. next \0); out-of-range offsets
        // (malformed blob) degrade to an empty replacement
        size_t v = static_cast<size_t>(val);
        if (v < m.cm_repl.size()) {
          size_t end = v;
          while (end < m.cm_repl.size() && m.cm_repl[end] != 0) ++end;
          tmp.append(reinterpret_cast<const char*>(m.cm_repl.data()) + v,
                     end - v);
        }
        i += len;
      } else {
        int step = 1;
        uint8_t first = data[i];
        if (first >= 0xF0)
          step = 4;
        else if (first >= 0xE0)
          step = 3;
        else if (first >= 0xC0)
          step = 2;
        if (i + step > n) step = n - i;
        tmp.append(reinterpret_cast<const char*>(data) + i, step);
        i += step;
      }
    }
    src = reinterpret_cast<const uint8_t*>(tmp.data());
    src_len = static_cast<int>(tmp.size());
  }

  out.clear();
  if (m.remove_extra_ws) {
    // " ".join(x for x in text.split(" ") if x): collapse 0x20 runs,
    // strip leading/trailing. 0x20 never occurs inside multi-byte UTF-8.
    int i = 0;
    while (i < src_len && src[i] == ' ') ++i;
    bool pending_space = false;
    for (; i < src_len; ++i) {
      if (src[i] == ' ') {
        pending_space = true;
      } else {
        if (pending_space) out.push_back(' ');
        pending_space = false;
        out.push_back(static_cast<char>(src[i]));
      }
    }
  } else {
    out.assign(reinterpret_cast<const char*>(src), src_len);
  }
  if (out.empty()) return;
  if (m.add_dummy_prefix) out.insert(out.begin(), ' ');
  if (m.escape_ws) {
    thread_local std::string esc;
    esc.clear();
    esc.reserve(out.size() + 16);
    for (char ch : out) {
      if (ch == ' ')
        esc += "\xE2\x96\x81";  // U+2581
      else
        esc.push_back(ch);
    }
    out.swap(esc);
  }
}

// ---------------------------------------------------------------------------
// Viterbi
// ---------------------------------------------------------------------------

// Viterbi-encode normalized UTF-8 bytes into `ids` (appended).
void viterbi_encode(const SpmModel& m, const uint8_t* text, int text_len,
                    std::vector<int32_t>& ids) {
  if (text_len == 0) return;
  thread_local std::vector<int32_t> starts;
  char_starts(text, text_len, starts);
  const int n = static_cast<int>(starts.size()) - 1;  // chars

  constexpr double NEG = -1e18;
  thread_local std::vector<double> best;
  thread_local std::vector<int32_t> back_pos;
  thread_local std::vector<int32_t> back_id;
  best.assign(n + 1, NEG);
  back_pos.assign(n + 1, -1);
  back_id.assign(n + 1, -1);
  best[0] = 0.0;

  for (int i = 0; i < n; ++i) {
    if (best[i] <= NEG) continue;
    const double bi = best[i];
    bool found = false;
    // Walk the vocab trie byte-by-byte; relax at char boundaries with a
    // terminal. Identical relaxation order to the Python DP (j ascending
    // for fixed i), and ">" keeps first-winner ties identical.
    int32_t node = 0;
    int b = starts[i];
    for (int ci = i; ci < n; ++ci) {
      const int e = starts[ci + 1];
      for (; b < e; ++b) {
        node = trie_child(m, node, text[b]);
        if (node < 0) goto advance;
      }
      if (m.term_id[node] >= 0) {
        found = true;
        const double cand = bi + m.term_score[node];
        if (cand > best[ci + 1]) {
          best[ci + 1] = cand;
          back_pos[ci + 1] = i;
          back_id[ci + 1] = m.term_id[node];
        }
      }
    }
  advance:
    if (!found || best[i + 1] <= NEG) {
      const double cand = bi + m.unk_score;
      if (cand > best[i + 1]) {
        best[i + 1] = cand;
        back_pos[i + 1] = i;
        back_id[i + 1] = -1;  // unk / byte-fallback marker
      }
    }
  }

  // Backtrack (collect reversed), then emit forward.
  thread_local std::vector<int32_t> rev;
  rev.clear();
  int pos = n;
  while (pos > 0) {
    const int i = back_pos[pos];
    const int32_t id = back_id[pos];
    if (id == -1) {
      if (m.byte_fallback) {
        for (int b2 = starts[pos] - 1; b2 >= starts[i]; --b2)
          rev.push_back(m.byte_ids[text[b2]]);
      } else {
        rev.push_back(m.unk_id);
      }
    } else {
      rev.push_back(id);
    }
    pos = i;
  }
  const size_t base = ids.size();
  ids.resize(base + rev.size());
  for (size_t k = 0; k < rev.size(); ++k)
    ids[base + k] = rev[rev.size() - 1 - k];
}

}  // namespace

extern "C" {

SpmModel* spm_create(const char* const* pieces, const int32_t* ids,
                     const float* scores, int32_t n, int32_t unk_id,
                     float unk_score, const int32_t* byte_ids) {
  auto* m = new SpmModel();
  m->unk_id = unk_id;
  m->unk_score = unk_score;

  // Build the byte trie (first piece string wins on duplicates, matching
  // the Python _seg_index setdefault semantics — callers pass id-sorted
  // pieces).
  std::vector<TrieBuildNode> nodes(1);
  for (int32_t i = 0; i < n; ++i) {
    const char* p = pieces[i];
    const size_t len = std::strlen(p);
    int32_t cur = 0;
    for (size_t k = 0; k < len; ++k) {
      uint8_t c = static_cast<uint8_t>(p[k]);
      auto it = nodes[cur].children.find(c);
      if (it == nodes[cur].children.end()) {
        nodes.emplace_back();
        int32_t nxt = static_cast<int32_t>(nodes.size()) - 1;
        nodes[cur].children.emplace(c, nxt);
        cur = nxt;
      } else {
        cur = it->second;
      }
    }
    if (nodes[cur].term_id < 0) {
      nodes[cur].term_id = ids[i];
      nodes[cur].term_score = scores[i];
    }
  }
  const size_t nn = nodes.size();
  m->first_edge.resize(nn);
  m->n_edges.resize(nn);
  m->term_id.resize(nn);
  m->term_score.resize(nn);
  m->root_child.assign(256, -1);
  for (size_t v = 0; v < nn; ++v) {
    m->first_edge[v] = static_cast<int32_t>(m->edge_label.size());
    m->n_edges[v] = static_cast<int32_t>(nodes[v].children.size());
    for (const auto& kv : nodes[v].children) {  // std::map: sorted labels
      m->edge_label.push_back(kv.first);
      m->edge_target.push_back(kv.second);
      if (v == 0) m->root_child[kv.first] = kv.second;
    }
    m->term_id[v] = nodes[v].term_id;
    m->term_score[v] = nodes[v].term_score;
  }

  bool any_byte = false;
  for (int b = 0; b < 256; ++b) {
    m->byte_ids[b] = byte_ids ? byte_ids[b] : -1;
    any_byte |= (m->byte_ids[b] >= 0);
  }
  m->byte_fallback = any_byte;
  return m;
}

// Install the normalizer. flags: 1=remove_extra_whitespaces,
// 2=add_dummy_prefix, 4=escape_whitespaces. charsmap may be NULL/empty
// (identity + whitespace phase). Returns 0, or -1 on a malformed blob.
int32_t spm_set_normalizer(SpmModel* m, const uint8_t* charsmap,
                           int64_t charsmap_len, int32_t flags) {
  m->remove_extra_ws = (flags & 1) != 0;
  m->add_dummy_prefix = (flags & 2) != 0;
  m->escape_ws = (flags & 4) != 0;
  m->has_charsmap = false;
  m->cm_units.clear();
  m->cm_repl.clear();
  if (charsmap && charsmap_len > 0) {
    if (charsmap_len < 4) return -1;
    uint32_t trie_size;
    std::memcpy(&trie_size, charsmap, 4);
    if (4 + static_cast<int64_t>(trie_size) > charsmap_len ||
        trie_size % 4 != 0 || trie_size == 0)
      return -1;
    m->cm_units.resize(trie_size / 4);
    std::memcpy(m->cm_units.data(), charsmap + 4, trie_size);
    m->cm_repl.assign(charsmap + 4 + trie_size, charsmap + charsmap_len);
    m->cm_repl.push_back(0);  // guard: replacement scan always terminates
    m->has_charsmap = true;
  }
  m->has_normalizer = true;
  return 0;
}

void spm_destroy(SpmModel* m) { delete m; }

// Normalize only (testing seam). Returns bytes written, or -1 if out is too
// small, or -2 if no normalizer is installed.
int32_t spm_normalize(const SpmModel* m, const char* text, int32_t text_len,
                      char* out, int32_t max_out) {
  if (!m->has_normalizer) return -2;
  thread_local std::string norm;
  normalize_bytes(*m, reinterpret_cast<const uint8_t*>(text), text_len, norm);
  if (static_cast<int32_t>(norm.size()) > max_out) return -1;
  std::memcpy(out, norm.data(), norm.size());
  return static_cast<int32_t>(norm.size());
}

// Viterbi-encode `text` (normalized UTF-8). Returns the number of ids
// written, or -1 if out buffer too small.
int32_t spm_encode(const SpmModel* m, const char* text, int32_t text_len,
                   int32_t* out, int32_t max_out) {
  thread_local std::vector<int32_t> ids;
  ids.clear();
  viterbi_encode(*m, reinterpret_cast<const uint8_t*>(text), text_len, ids);
  if (static_cast<int32_t>(ids.size()) > max_out) return -1;
  std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int32_t>(ids.size());
}

void spm_free_ids(int32_t* p) { std::free(p); }
void spm_free_offsets(int64_t* p) { std::free(p); }

// Batch encode: n strings packed in `data` with byte `offsets` [n+1].
// do_normalize=1 runs the installed normalizer first (requires
// spm_set_normalizer); 0 expects pre-normalized input. Spawns up to
// n_threads workers (the caller holds no GIL during this call). On success
// returns 0 and sets *out_ids (packed) + *out_offsets ([n+1], int64); the
// caller frees both via spm_free_*. Returns -2 when normalization was
// requested but not installed.
int32_t spm_encode_batch(const SpmModel* m, const uint8_t* data,
                         const int64_t* offsets, int32_t n,
                         int32_t do_normalize, int32_t n_threads,
                         int32_t** out_ids, int64_t** out_offsets) {
  if (do_normalize && !m->has_normalizer) return -2;
  std::vector<std::vector<int32_t>> results(n);

  auto work = [&](int32_t lo, int32_t hi) {
    thread_local std::string norm;
    for (int32_t idx = lo; idx < hi; ++idx) {
      const uint8_t* s = data + offsets[idx];
      const int len = static_cast<int>(offsets[idx + 1] - offsets[idx]);
      if (do_normalize) {
        normalize_bytes(*m, s, len, norm);
        viterbi_encode(*m, reinterpret_cast<const uint8_t*>(norm.data()),
                       static_cast<int>(norm.size()), results[idx]);
      } else {
        viterbi_encode(*m, s, len, results[idx]);
      }
    }
  };

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int nt = n_threads < 1 ? 1 : (n_threads > hw ? hw : n_threads);
  constexpr int32_t kChunk = 64;
  if (nt <= 1 || n <= kChunk) {
    work(0, n);
  } else {
    std::atomic<int32_t> next(0);
    auto runner = [&]() {
      while (true) {
        int32_t lo = next.fetch_add(kChunk);
        if (lo >= n) return;
        int32_t hi = lo + kChunk < n ? lo + kChunk : n;
        work(lo, hi);
      }
    };
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(runner);
    for (auto& t : threads) t.join();
  }

  int64_t total = 0;
  for (const auto& r : results) total += static_cast<int64_t>(r.size());
  auto* ids = static_cast<int32_t*>(std::malloc(
      (total > 0 ? total : 1) * sizeof(int32_t)));
  auto* offs = static_cast<int64_t*>(std::malloc((n + 1) * sizeof(int64_t)));
  if (!ids || !offs) {
    std::free(ids);
    std::free(offs);
    return -1;
  }
  int64_t pos = 0;
  offs[0] = 0;
  for (int32_t i = 0; i < n; ++i) {
    std::memcpy(ids + pos, results[i].data(),
                results[i].size() * sizeof(int32_t));
    pos += static_cast<int64_t>(results[i].size());
    offs[i + 1] = pos;
  }
  *out_ids = ids;
  *out_offsets = offs;
  return 0;
}

}  // extern "C"
