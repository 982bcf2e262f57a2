// Native host loader of digat_tpu_torch: the port's own copy of
// digat_tpu/native/loader.cpp, with the same C ABI and the same results.
//
// C ABI (consumed via ctypes, digat_tpu_torch/native/bindings.py) covering
// the three host-side hot paths of the port's data preparation
// (digat_tpu_torch/data/{sag,corpus,tokenize}.py) at MIND scale:
//
//   * expand_graph  - per-news BFS expansion of the semantic-augmented news
//     graph (semantics of the reference's generate_news_graph,
//     construct_SAG.py:449-485: hop 0 takes all M neighbors, deeper hops
//     stop at cos < threshold or M-1 neighbors, revisits add edges only);
//
//   * behaviors parsing - tokenizes behaviors.tsv rows (history ids,
//     clicked/non-clicked impressions) against the news-ID dictionary in a
//     single pass, two-call protocol (count, then fill) so Python owns all
//     allocations;
//
//   * GloVe text parsing - multithreaded mmap parse of a `word f0 .. fD`
//     embedding file (the reference feeds the 5.3 GB glove.840B.300d.txt
//     through torchtext, MIND_corpus.py:89-108). Keeps the reference's
//     exactly-(dim+1)-single-space-fields acceptance rule; lines whose
//     float fields fail to parse are skipped (the plain Python version
//     raises there - only reachable on malformed files).
//
// Build (bindings.py, at first use, into digat_tpu_torch/_build/):
//   g++ -O2 -std=c++17 -pthread -shared -fPIC -o <lib>.so loader.cpp

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// BFS graph expansion
// ---------------------------------------------------------------------------
// nbr_idx / nbr_cos: flat neighbor lists, row r spans
//   [offsets[r], offsets[r+1]) — neighbors of news index r in rank order.
// Outputs (caller-allocated, zero-initialized):
//   node_id [news_num, node_num] int32, graph [news_num, node_num,
//   node_num] uint8, mask [news_num, node_num] uint8.
// Row 0 (<PAD>) is skipped except mask[0,0]=1, matching the reference.
void expand_graph(const int32_t* nbr_idx, const float* nbr_cos,
                  const int64_t* offsets, int64_t news_num, int32_t top_m,
                  int32_t hops, int32_t node_num, float threshold,
                  int32_t* node_id, uint8_t* graph, uint8_t* mask) {
  std::vector<int32_t> depths(node_num);
  std::unordered_map<int32_t, int32_t> pos;
  for (int64_t i = 0; i < news_num; ++i) {
    mask[i * node_num] = 1;
  }
  for (int64_t i = 1; i < news_num; ++i) {
    int32_t* nid = node_id + i * node_num;
    uint8_t* g = graph + i * node_num * node_num;
    uint8_t* m = mask + i * node_num;
    nid[0] = static_cast<int32_t>(i);
    pos.clear();
    pos[static_cast<int32_t>(i)] = 0;
    std::fill(depths.begin(), depths.end(), 0);
    int32_t head = 0, rear = 1;
    while (head < rear) {
      if (depths[head] == hops) {
        ++head;
        continue;
      }
      const int32_t cur = nid[head];
      const int64_t beg = offsets[cur], end = offsets[cur + 1];
      for (int64_t k = beg; k < end; ++k) {
        const int64_t index = k - beg;
        if (depths[head] > 0 &&
            (nbr_cos[k] < threshold || index == top_m - 1)) {
          break;
        }
        const int32_t nbr = nbr_idx[k];
        auto it = pos.find(nbr);
        if (it == pos.end()) {
          nid[rear] = nbr;
          m[rear] = 1;
          pos[nbr] = rear;
          g[head * node_num + rear] = 1;
          g[rear * node_num + head] = 1;
          depths[rear] = depths[head] + 1;
          ++rear;
        } else {
          const int32_t p = it->second;
          g[head * node_num + p] = 1;
          g[p * node_num + head] = 1;
        }
      }
      ++head;
    }
  }
}

// ---------------------------------------------------------------------------
// behaviors.tsv parsing
// ---------------------------------------------------------------------------
// The news dictionary arrives as a concatenated '\n'-separated key buffer in
// index order (index 0 = <PAD>, never matched). Parsing state lives in a
// handle so the count pass and the fill pass read the file once each.

struct BehaviorData {
  std::vector<int32_t> history_flat;
  std::vector<int64_t> history_offsets{0};
  std::vector<int32_t> clicks_flat;
  std::vector<int64_t> clicks_offsets{0};
  std::vector<int32_t> nonclicks_flat;
  std::vector<int64_t> nonclicks_offsets{0};
  std::vector<int32_t> cand_flat;       // all impressions, file order
  std::vector<int8_t> label_flat;       // parallel labels (-1 = unlabeled)
  std::vector<int64_t> cand_offsets{0};
  int64_t rows = 0;
  bool ok = false;
  std::string error;
};

static int32_t lookup(const std::unordered_map<std::string_view, int32_t>& map,
                      std::string_view key) {
  auto it = map.find(key);
  return it == map.end() ? -1 : it->second;
}

void* parse_behaviors(const char* path, const char* keys, int64_t keys_len,
                      int64_t num_keys) {
  auto* d = new BehaviorData();
  std::unordered_map<std::string_view, int32_t> map;
  map.reserve(static_cast<size_t>(num_keys) * 2);
  {
    std::string_view buf(keys, static_cast<size_t>(keys_len));
    size_t start = 0;
    int32_t idx = 0;
    while (start <= buf.size() && idx < num_keys) {
      size_t nl = buf.find('\n', start);
      if (nl == std::string_view::npos) nl = buf.size();
      map[buf.substr(start, nl - start)] = idx++;
      start = nl + 1;
    }
  }

  FILE* f = std::fopen(path, "rb");
  if (!f) {
    d->error = "cannot open file";
    return d;
  }
  std::string line;
  line.reserve(1 << 16);
  int ch;
  auto process = [&](const std::string& ln) {
    if (ln.empty()) return;
    // split into 5 tab fields: imp_id, user, time, history, impressions
    size_t f0 = ln.find('\t');
    size_t f1 = ln.find('\t', f0 + 1);
    size_t f2 = ln.find('\t', f1 + 1);
    size_t f3 = ln.find('\t', f2 + 1);
    if (f3 == std::string::npos) return;
    std::string_view history(ln.data() + f2 + 1, f3 - f2 - 1);
    std::string_view imps(ln.data() + f3 + 1, ln.size() - f3 - 1);
    // history: space-separated news ids
    size_t s = 0;
    while (s < history.size()) {
      size_t e = history.find(' ', s);
      if (e == std::string_view::npos) e = history.size();
      if (e > s) {
        int32_t idx = lookup(map, history.substr(s, e - s));
        if (idx >= 0) d->history_flat.push_back(idx);
      }
      s = e + 1;
    }
    d->history_offsets.push_back(static_cast<int64_t>(d->history_flat.size()));
    // impressions: id-0 / id-1 / bare id (unlabeled MIND-large test)
    s = 0;
    while (s < imps.size()) {
      size_t e = imps.find(' ', s);
      if (e == std::string_view::npos) e = imps.size();
      if (e > s) {
        std::string_view tok = imps.substr(s, e - s);
        int8_t label = -1;
        if (tok.size() > 2 && tok[tok.size() - 2] == '-') {
          char c = tok.back();
          if (c == '0' || c == '1') {
            label = static_cast<int8_t>(c - '0');
            tok = tok.substr(0, tok.size() - 2);
          }
        }
        int32_t idx = lookup(map, tok);
        if (idx >= 0) {
          d->cand_flat.push_back(idx);
          d->label_flat.push_back(label);
          if (label == 1) d->clicks_flat.push_back(idx);
          else if (label == 0) d->nonclicks_flat.push_back(idx);
        }
      }
      s = e + 1;
    }
    d->cand_offsets.push_back(static_cast<int64_t>(d->cand_flat.size()));
    d->clicks_offsets.push_back(static_cast<int64_t>(d->clicks_flat.size()));
    d->nonclicks_offsets.push_back(
        static_cast<int64_t>(d->nonclicks_flat.size()));
    ++d->rows;
  };
  while ((ch = std::fgetc(f)) != EOF) {
    if (ch == '\n') {
      if (!line.empty() && line.back() == '\r') line.pop_back();
      process(line);
      line.clear();
    } else {
      line.push_back(static_cast<char>(ch));
    }
  }
  if (!line.empty()) process(line);
  std::fclose(f);
  d->ok = true;
  return d;
}

void behaviors_sizes(void* handle, int64_t* out) {
  auto* d = static_cast<BehaviorData*>(handle);
  out[0] = d->rows;
  out[1] = static_cast<int64_t>(d->history_flat.size());
  out[2] = static_cast<int64_t>(d->clicks_flat.size());
  out[3] = static_cast<int64_t>(d->nonclicks_flat.size());
  out[4] = static_cast<int64_t>(d->cand_flat.size());
  out[5] = d->ok ? 1 : 0;
}

void behaviors_fill(void* handle, int32_t* history_flat,
                    int64_t* history_offsets, int32_t* clicks_flat,
                    int64_t* clicks_offsets, int32_t* nonclicks_flat,
                    int64_t* nonclicks_offsets, int32_t* cand_flat,
                    int8_t* label_flat, int64_t* cand_offsets) {
  auto* d = static_cast<BehaviorData*>(handle);
  auto copy = [](auto& vec, auto* dst) {
    std::memcpy(dst, vec.data(), vec.size() * sizeof(vec[0]));
  };
  copy(d->history_flat, history_flat);
  copy(d->history_offsets, history_offsets);
  copy(d->clicks_flat, clicks_flat);
  copy(d->clicks_offsets, clicks_offsets);
  copy(d->nonclicks_flat, nonclicks_flat);
  copy(d->nonclicks_offsets, nonclicks_offsets);
  copy(d->cand_flat, cand_flat);
  copy(d->label_flat, label_flat);
  copy(d->cand_offsets, cand_offsets);
}

void behaviors_free(void* handle) {
  delete static_cast<BehaviorData*>(handle);
}

// ---------------------------------------------------------------------------
// GloVe text parsing
// ---------------------------------------------------------------------------
// Accepted lines match the plain Python version on well-formed files:
// rstrip trailing whitespace, split on single ' ', keep only lines with
// exactly dim+1 fields; field 0 is the word (may legally contain tabs / be
// empty), the rest parse as doubles and narrow to float32 (numpy's
// strtod-then-cast path; overflowing literals like 1e999 clamp to +/-inf,
// same as numpy). Words are returned '\n'-terminated in row order.
// Known divergences on MALFORMED lines only (exercised in
// tests/test_torch_native.py): (a) the rstrip set is ASCII whitespace,
// so a line ending in Unicode whitespace (e.g. NBSP) is rejected here but
// stripped-and-accepted by Python's str.rstrip(); (b) a dim+1-field line
// whose numeric field does not parse is skipped here, where the Python
// path raises ValueError from np.asarray.

struct GloveChunk {
  std::vector<char> words;
  std::vector<float> vecs;
  int64_t rows = 0;
};

struct GloveData {
  std::vector<char> words;
  std::vector<float> vecs;
  int64_t rows = 0;
  bool ok = false;
};

static void parse_glove_chunk(const char* beg, const char* end, int32_t dim,
                              GloveChunk* out) {
  std::vector<double> tmp(static_cast<size_t>(dim));
  const char* p = beg;
  while (p < end) {
    const char* nl =
        static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* e = nl ? nl : end;
    // Python str.rstrip() default whitespace set
    while (e > p && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r' ||
                     e[-1] == '\v' || e[-1] == '\f')) {
      --e;
    }
    int32_t spaces = 0;
    for (const char* q = p; q < e; ++q) spaces += (*q == ' ');
    if (spaces == dim && dim > 0) {
      const char* sp =
          static_cast<const char*>(memchr(p, ' ', static_cast<size_t>(e - p)));
      const char* fs = sp + 1;
      bool good = true;
      for (int32_t k = 0; k < dim; ++k) {
        const char* fe =
            (k == dim - 1)
                ? e
                : static_cast<const char*>(
                      memchr(fs, ' ', static_cast<size_t>(e - fs)));
        const char* vs = fs;
        if (vs < fe && *vs == '+') ++vs;  // from_chars rejects leading '+'
        double v = 0.0;
        auto res = std::from_chars(vs, fe, v);
        if (res.ec == std::errc::result_out_of_range && res.ptr == fe) {
          // out-of-range literal: match numpy/strtod (+/-HUGE_VAL on
          // overflow like 1e999, 0/denormal on underflow like 1e-999)
          std::string buf(vs, fe);
          v = strtod(buf.c_str(), nullptr);
        } else if (res.ec != std::errc() || res.ptr != fe) {
          good = false;
          break;
        }
        tmp[static_cast<size_t>(k)] = v;
        fs = fe + 1;
      }
      if (good) {
        out->words.insert(out->words.end(), p, sp);
        out->words.push_back('\n');
        for (int32_t k = 0; k < dim; ++k) {
          out->vecs.push_back(static_cast<float>(tmp[static_cast<size_t>(k)]));
        }
        ++out->rows;
      }
    }
    p = nl ? nl + 1 : end;
  }
}

void* parse_glove(const char* path, int32_t dim) {
  auto* d = new GloveData();
  int fd = open(path, O_RDONLY);
  if (fd < 0) return d;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return d;
  }
  if (st.st_size == 0) {
    close(fd);
    d->ok = true;
    return d;
  }
  const size_t size = static_cast<size_t>(st.st_size);
  void* map = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return d;
  madvise(map, size, MADV_SEQUENTIAL);
  const char* base = static_cast<const char*>(map);

  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (size < (1u << 20)) nt = 1;
  std::vector<const char*> bounds{base};
  for (unsigned t = 1; t < nt; ++t) {
    const char* guess = base + size / nt * t;
    if (guess < bounds.back()) guess = bounds.back();
    const char* nl = static_cast<const char*>(
        memchr(guess, '\n', static_cast<size_t>(base + size - guess)));
    bounds.push_back(nl ? nl + 1 : base + size);
  }
  bounds.push_back(base + size);

  std::vector<GloveChunk> chunks(nt);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (unsigned t = 0; t < nt; ++t) {
    threads.emplace_back(parse_glove_chunk, bounds[t], bounds[t + 1], dim,
                         &chunks[t]);
  }
  for (auto& th : threads) th.join();

  size_t wtot = 0, vtot = 0;
  for (auto& c : chunks) {
    wtot += c.words.size();
    vtot += c.vecs.size();
  }
  d->words.reserve(wtot);
  d->vecs.reserve(vtot);
  for (auto& c : chunks) {
    d->words.insert(d->words.end(), c.words.begin(), c.words.end());
    d->vecs.insert(d->vecs.end(), c.vecs.begin(), c.vecs.end());
    d->rows += c.rows;
  }
  munmap(map, size);
  d->ok = true;
  return d;
}

void glove_sizes(void* handle, int64_t* out) {
  auto* d = static_cast<GloveData*>(handle);
  out[0] = d->rows;
  out[1] = static_cast<int64_t>(d->words.size());
  out[2] = d->ok ? 1 : 0;
}

void glove_fill(void* handle, uint8_t* words, float* vecs) {
  auto* d = static_cast<GloveData*>(handle);
  std::memcpy(words, d->words.data(), d->words.size());
  std::memcpy(vecs, d->vecs.data(), d->vecs.size() * sizeof(float));
}

void glove_free(void* handle) {
  delete static_cast<GloveData*>(handle);
}

}  // extern "C"
