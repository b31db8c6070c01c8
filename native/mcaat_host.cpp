// mcaat_host — native host-side runtime for mcaat_tpu.
//
// Framework split: device compute (k-mer counting, graph build,
// batched traversal) runs under JAX/XLA; this library provides the native
// host runtime around it, replacing the reference's C++ machinery where it
// is host-bound:
//   * FASTQ/FASTA (incl. gzip) streaming parser with direct 2-bit packing
//     into the padded read matrix the device kernels consume (replaces
//     kseqpp + megahit SequenceLibCollection; reference src/reads.cpp:3-18,
//     src/sdbg_build.cpp:59-115).
//   * bounded multicycle enumeration (the per-start-node Johnson-style
//     lock/relax DFS of reference src/cycle_finder.cpp:140-243) over the
//     framework's [N,4] adjacency arrays.
//
// C ABI only (consumed via ctypes). Build: `make -C native`.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// FASTQ/FASTA parsing
// ---------------------------------------------------------------------------

// base -> 2-bit code; non-ACGT maps to T(3), matching the reference's
// lookup coding (src/reads.cpp:44-53).
static uint8_t g_code_lut[256];
static bool g_lut_init = false;

static void init_lut() {
  if (g_lut_init) return;
  memset(g_code_lut, 3, sizeof(g_code_lut));
  g_code_lut[(int)'A'] = 0; g_code_lut[(int)'a'] = 0;
  g_code_lut[(int)'C'] = 1; g_code_lut[(int)'c'] = 1;
  g_code_lut[(int)'G'] = 2; g_code_lut[(int)'g'] = 2;
  g_code_lut[(int)'T'] = 3; g_code_lut[(int)'t'] = 3;
  g_lut_init = true;
}

struct ParsedReads {
  std::vector<std::vector<uint8_t>> seqs;
  int32_t max_len = 0;
};

// Streaming line reader over gzFile (works for plain files too).
struct LineReader {
  gzFile f;
  std::vector<char> buf;
  size_t pos = 0, len = 0;
  bool eof = false;
  explicit LineReader(gzFile f_) : f(f_), buf(1 << 20) {}
  bool fill() {
    if (eof) return false;
    int n = gzread(f, buf.data(), (unsigned)buf.size());
    if (n <= 0) { eof = true; return false; }
    pos = 0; len = (size_t)n;
    return true;
  }
  // Appends the next line (without newline) to out; returns false on EOF.
  bool getline(std::string& out) {
    out.clear();
    for (;;) {
      if (pos >= len && !fill()) return !out.empty();
      size_t start = pos;
      while (pos < len && buf[pos] != '\n') pos++;
      out.append(&buf[start], pos - start);
      if (pos < len) { pos++;  // skip newline
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
    }
  }
};

static ParsedReads* parse_file(const char* path) {
  init_lut();
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  auto* pr = new ParsedReads();
  LineReader lr(f);
  std::string line;
  if (!lr.getline(line)) { gzclose(f); return pr; }
  if (!line.empty() && line[0] == '>') {
    // FASTA: sequences may span lines
    std::vector<uint8_t> cur;
    while (lr.getline(line)) {
      if (!line.empty() && line[0] == '>') {
        if (!cur.empty()) {
          pr->max_len = std::max(pr->max_len, (int32_t)cur.size());
          pr->seqs.push_back(std::move(cur));
          cur.clear();
        }
      } else {
        for (char c : line) cur.push_back(g_code_lut[(uint8_t)c]);
      }
    }
    if (!cur.empty()) {
      pr->max_len = std::max(pr->max_len, (int32_t)cur.size());
      pr->seqs.push_back(std::move(cur));
    }
  } else if (!line.empty() && line[0] == '@') {
    // FASTQ: 4-line records; we are at the first header
    std::string seq, plus, qual;
    for (;;) {
      if (!lr.getline(seq)) break;
      std::vector<uint8_t> cur(seq.size());
      for (size_t i = 0; i < seq.size(); ++i) cur[i] = g_code_lut[(uint8_t)seq[i]];
      pr->max_len = std::max(pr->max_len, (int32_t)cur.size());
      pr->seqs.push_back(std::move(cur));
      if (!lr.getline(plus)) break;
      if (!lr.getline(qual)) break;
      if (!lr.getline(line)) break;  // next header
    }
  }
  gzclose(f);
  return pr;
}

// Parse into a dense padded matrix. Returns 0 on success.
// Caller frees *codes_out and *lengths_out with mcaat_free.
int mcaat_parse_fastx(const char* path, uint8_t** codes_out,
                      int32_t** lengths_out, int64_t* n_reads_out,
                      int32_t* max_len_out) {
  ParsedReads* pr = parse_file(path);
  if (!pr) return 1;
  int64_t n = (int64_t)pr->seqs.size();
  int32_t m = pr->max_len;
  uint8_t* codes = (uint8_t*)calloc((size_t)(n * (int64_t)m + 1), 1);
  int32_t* lengths = (int32_t*)malloc(sizeof(int32_t) * (size_t)(n + 1));
  for (int64_t i = 0; i < n; ++i) {
    const auto& s = pr->seqs[(size_t)i];
    lengths[i] = (int32_t)s.size();
    memcpy(codes + i * m, s.data(), s.size());
  }
  *codes_out = codes;
  *lengths_out = lengths;
  *n_reads_out = n;
  *max_len_out = m;
  delete pr;
  return 0;
}

void mcaat_free(void* p) { free(p); }

// Pack a [rows, L] 2-bit code matrix to [rows, lp] bytes, 4 bases/byte
// LSB-first (bit layout of kmer/count.py::pack_codes_host). The numpy
// formulation makes 6+ full-size passes; this is one streaming pass.
void mcaat_pack_codes(const uint8_t* codes, int64_t rows, int64_t L,
                      int64_t lp, uint8_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* src = codes + r * L;
    uint8_t* dst = out + r * lp;
    int64_t full = L / 4;
    if (full > lp) full = lp;
    for (int64_t i = 0; i < full; ++i) {
      const uint8_t* s = src + i * 4;
      dst[i] = (uint8_t)(s[0] | (s[1] << 2) | (s[2] << 4) | (s[3] << 6));
    }
    if (full < lp) {
      uint8_t b = 0;
      int sh = 0;
      for (int64_t j = full * 4; j < L; ++j, sh += 2) b |= (uint8_t)(src[j] << sh);
      dst[full] = b;
      for (int64_t i = full + 1; i < lp; ++i) dst[i] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// SCC split (iterative Tarjan; reference src/spacer_ordering.cpp:3-76)
// ---------------------------------------------------------------------------
// Result-identical fast path for ordering.find_strongly_connected_components
// (which stays as the fallback): roots ascend over valid nodes, neighbors
// in CSR slot order, a component is emitted when its head finishes,
// single-node components are dropped. order_out receives node ids in
// stack-pop order concatenated per component (the Python version's exact
// intra-component order); sizes_out[c] the emitted component's size. Both
// caller-allocated with capacity n. Returns the emitted component count.
// The pure-Python fallback is much slower on large condensed regions.
int64_t mcaat_scc(const int64_t* indptr, const int64_t* indices,
                  int64_t n, const uint8_t* valid,
                  int64_t* order_out, int64_t* sizes_out) {
  std::vector<int64_t> index_map(n, -1), lowlink(n, 0);
  std::vector<uint8_t> on_stack(n, 0);
  std::vector<int64_t> tstack;
  std::vector<std::pair<int64_t, int64_t>> work;  // (node, neighbor cursor)
  int64_t counter = 0, n_comp = 0, out_pos = 0;
  for (int64_t root = 0; root < n; ++root) {
    if (!valid[root] || index_map[root] >= 0) continue;
    index_map[root] = lowlink[root] = counter++;
    tstack.push_back(root);
    on_stack[root] = 1;
    work.clear();
    work.emplace_back(root, indptr[root]);
    while (!work.empty()) {
      int64_t node = work.back().first;
      int64_t i = work.back().second;
      int64_t end = indptr[node + 1];
      bool advanced = false;
      while (i < end) {
        int64_t nb = indices[i];
        ++i;
        if (index_map[nb] < 0) {
          work.back().second = i;
          index_map[nb] = lowlink[nb] = counter++;
          tstack.push_back(nb);
          on_stack[nb] = 1;
          work.emplace_back(nb, indptr[nb]);
          advanced = true;
          break;
        } else if (on_stack[nb]) {
          if (index_map[nb] < lowlink[node]) lowlink[node] = index_map[nb];
        }
      }
      if (advanced) continue;
      work.pop_back();
      if (lowlink[node] == index_map[node]) {
        int64_t sz = 0;
        for (;;) {
          int64_t w = tstack.back();
          tstack.pop_back();
          on_stack[w] = 0;
          order_out[out_pos + sz] = w;
          ++sz;
          if (w == node) break;
        }
        if (sz > 1) {  // single-node components overwrite in place
          sizes_out[n_comp++] = sz;
          out_pos += sz;
        }
      }
      if (!work.empty()) {
        int64_t parent = work.back().first;
        if (lowlink[node] < lowlink[parent]) lowlink[parent] = lowlink[node];
      }
    }
  }
  return n_comp;
}

// ---------------------------------------------------------------------------
// Bounded multicycle enumeration (reference src/cycle_finder.cpp:140-243)
// ---------------------------------------------------------------------------

struct CycleSink {
  std::vector<int64_t> flat;     // concatenated cycle node ids
  std::vector<int64_t> offsets;  // cycle i = flat[offsets[i]..offsets[i+1])
  std::vector<int64_t> starts;   // start node per result group
  std::vector<int64_t> group_offsets;  // group g = cycles[group_offsets[g]..)
};

struct Enumerator {
  const int32_t* out;   // [N,4]
  const int32_t* in;    // [N,4]
  const uint8_t* valid; // [N]
  const int32_t* mult;  // [N]
  int64_t n;
  int min_len, max_len;
  std::vector<uint8_t> visited;

  Enumerator(const int32_t* out_, const int32_t* in_, const uint8_t* valid_,
             const int32_t* mult_, int64_t n_, int min_len_, int max_len_)
      : out(out_), in(in_), valid(valid_), mult(mult_), n(n_),
        min_len(min_len_), max_len(max_len_), visited((size_t)n_, 0) {}

  // admissible neighbors, ascending (deterministic) — background check of
  // reference src/cycle_finder.cpp:40-52 (global visited, mult ratio <=
  // 500, no self edge back to the expanding node, validity).
  void neighbors(const int32_t* adj, int64_t node, int64_t start_mult,
                 std::vector<int64_t>& res) const {
    res.clear();
    if (!valid[node]) return;
    for (int j = 0; j < 4; ++j) {
      int64_t nb = adj[node * 4 + j];
      if (nb < 0 || !valid[nb] || visited[nb]) continue;
      if (start_mult / (int64_t)mult[nb] > 500) continue;
      if (nb == node) continue;
      res.push_back(nb);
    }
    std::sort(res.begin(), res.end());
  }

  // Faithful FindCycle (see mcaat_tpu/cycles/finder.py for the semantics
  // discussion; >=500 cycles aborts the start node cleanly).
  void find_cycles_from(int64_t start, CycleSink& sink) {
    const int64_t start_mult = mult[start];
    std::vector<int64_t> path{start};
    std::unordered_map<int64_t, int> lock{{start, 0}};
    std::vector<std::vector<int64_t>> stack(1);
    neighbors(out, start, start_mult, stack[0]);
    std::vector<int> backtrack{max_len};
    std::vector<std::vector<int64_t>> cycles;
    long steps = 0;

    while (!stack.empty()) {
      if (++steps > 10000000L) break;
      auto& nbrs = stack.back();
      bool advanced = false;
      for (size_t pos = 0; pos < nbrs.size(); ++pos) {
        int64_t nb = nbrs[pos];
        if (nb == start) {
          backtrack.back() = 1;
          if ((int)path.size() > min_len) {
            cycles.push_back(path);
            if ((int)cycles.size() >= 500) {  // tangle: abort, empty group
              cycles.clear();
              record(start, cycles, sink);
              return;
            }
          }
        } else {
          auto it = lock.find(nb);
          int lk = (it == lock.end()) ? max_len : it->second;
          if ((int)path.size() < lk) {
            nbrs.erase(nbrs.begin() + (long)pos);
            path.push_back(nb);
            backtrack.push_back(max_len);
            lock[nb] = (int)path.size();
            stack.emplace_back();
            neighbors(out, nb, start_mult, stack.back());
            advanced = true;
            break;
          }
        }
      }
      if (advanced) continue;
      stack.pop_back();
      int64_t v = path.back();
      path.pop_back();
      int bl = backtrack.back();
      backtrack.pop_back();
      if (!backtrack.empty()) backtrack.back() = std::min(backtrack.back(), bl);
      if (bl < max_len) {
        // Johnson-style bounded unblocking through incoming edges
        std::vector<std::pair<int, int64_t>> relax{{bl, v}};
        std::unordered_set<int64_t> path_set(path.begin(), path.end());
        std::vector<int64_t> incs;
        while (!relax.empty()) {
          auto [rbl, u] = relax.back();
          relax.pop_back();
          auto it = lock.find(u);
          int lk = (it == lock.end()) ? max_len : it->second;
          if (lk < max_len - rbl + 1) {
            lock[u] = max_len - rbl + 1;
            neighbors(in, u, start_mult, incs);
            for (int64_t w : incs)
              if (!path_set.count(w)) relax.push_back({rbl + 1, w});
          }
        }
      }
    }

    for (const auto& c : cycles)
      for (int64_t node : c) visited[(size_t)node] = 1;
    record(start, cycles, sink);
  }

  // Record a result group (possibly empty — the reference stores empty
  // cycle lists for processed start nodes, src/cycle_finder.cpp:479).
  void record(int64_t start, const std::vector<std::vector<int64_t>>& cycles,
              CycleSink& sink) {
    sink.starts.push_back(start);
    sink.group_offsets.push_back((int64_t)sink.offsets.size());
    for (const auto& c : cycles) {
      sink.offsets.push_back((int64_t)sink.flat.size());
      sink.flat.insert(sink.flat.end(), c.begin(), c.end());
    }
  }
};

// Enumerate cycles for start nodes given in processing order.
// Returns an opaque handle queried by the accessors below.
void* mcaat_enumerate_cycles(const int32_t* out, const int32_t* in,
                             const uint8_t* valid, const int32_t* mult,
                             int64_t n, const int64_t* start_nodes,
                             int64_t n_starts, int min_len, int max_len) {
  auto* sink = new CycleSink();
  Enumerator e(out, in, valid, mult, n, min_len, max_len);
  for (int64_t i = 0; i < n_starts; ++i) {
    int64_t s = start_nodes[i];
    if (e.visited[(size_t)s]) continue;
    e.find_cycles_from(s, *sink);
  }
  sink->offsets.push_back((int64_t)sink->flat.size());
  sink->group_offsets.push_back((int64_t)sink->offsets.size() - 1);
  return sink;
}

int64_t mcaat_sink_n_groups(void* h) {
  return (int64_t)((CycleSink*)h)->starts.size();
}
int64_t mcaat_sink_n_cycles(void* h) {
  return (int64_t)((CycleSink*)h)->offsets.size() - 1;
}
int64_t mcaat_sink_flat_size(void* h) {
  return (int64_t)((CycleSink*)h)->flat.size();
}
void mcaat_sink_copy(void* h, int64_t* starts, int64_t* group_offsets,
                     int64_t* offsets, int64_t* flat) {
  auto* s = (CycleSink*)h;
  memcpy(starts, s->starts.data(), s->starts.size() * 8);
  memcpy(group_offsets, s->group_offsets.data(), s->group_offsets.size() * 8);
  memcpy(offsets, s->offsets.data(), s->offsets.size() * 8);
  memcpy(flat, s->flat.data(), s->flat.size() * 8);
}
void mcaat_sink_free(void* h) { delete (CycleSink*)h; }

// ---------------------------------------------------------------------------
// Partial-order-alignment consensus (replaces vendored spoa, SURVEY N2.2-N7;
// reference spoa::AlignmentEngine::Create(kNW, 3, -5, -3) + AddAlignment +
// GenerateConsensus at src/phage_curator.cpp:385-396).
//
// Result-identical port of the Python fallback (mcaat_tpu/poa.py):
// progressive POA, NW over the DAG's Kahn order, consensus = max-weight
// path. Tie-breaking (pred iteration order, strict ">" updates, first-max
// consensus end) matches the Python line for line so the parity test can
// assert byte equality.
// ---------------------------------------------------------------------------

struct PoaGraph {
  int match, mismatch, gap;
  std::vector<char> bases;
  std::map<std::pair<int, int>, int> edges;
  std::vector<std::vector<int>> in_edges;  // insertion order (Python list)

  static constexpr long long NEG = -(1LL << 60);

  PoaGraph(int ma, int mi, int ga) : match(ma), mismatch(mi), gap(ga) {}

  int add_node(char b) {
    bases.push_back(b);
    in_edges.emplace_back();
    return (int)bases.size() - 1;
  }

  void add_edge(int u, int v, int w = 1) {
    auto key = std::make_pair(u, v);
    auto it = edges.find(key);
    if (it == edges.end()) {
      edges[key] = w;
      in_edges[v].push_back(u);
    } else {
      it->second += w;
    }
  }

  std::vector<int> topo_order() const {
    int n = (int)bases.size();
    std::vector<int> indeg(n, 0);
    std::vector<std::vector<int>> out_adj(n);
    for (const auto& kv : edges) {
      indeg[kv.first.second]++;
      out_adj[kv.first.first].push_back(kv.first.second);
    }
    std::vector<int> stack;
    for (int i = 0; i < n; ++i)
      if (indeg[i] == 0) stack.push_back(i);
    std::sort(stack.rbegin(), stack.rend());  // == sorted(..., reverse=True)
    std::vector<int> order;
    while (!stack.empty()) {
      int u = stack.back();
      stack.pop_back();
      order.push_back(u);
      std::vector<int> outs = out_adj[u];
      std::sort(outs.rbegin(), outs.rend());
      for (int v : outs) {
        if (--indeg[v] == 0) stack.push_back(v);
      }
    }
    return order;
  }

  // alignment steps: (node, pos), -1 for gap on either side
  void align(const std::string& seq, std::vector<std::pair<int, int>>& path) {
    std::vector<int> order = topo_order();
    int n = (int)order.size(), m = (int)seq.size();
    std::vector<int> rank(bases.size(), 0);
    for (int r = 0; r < n; ++r) rank[order[r]] = r;

    std::vector<std::vector<long long>> dp(n + 1,
                                           std::vector<long long>(m + 1, NEG));
    struct Bt {
      int pr, pj, node, pos;
      bool set;
    };
    std::vector<std::vector<Bt>> bt(n + 1,
                                    std::vector<Bt>(m + 1, {0, 0, -1, -1, false}));
    dp[0][0] = 0;
    for (int j = 1; j <= m; ++j) {
      dp[0][j] = dp[0][j - 1] + gap;
      bt[0][j] = {0, j - 1, -1, j - 1, true};
    }
    std::vector<int> preds;
    for (int r = 0; r < n; ++r) {
      int node = order[r];
      preds.clear();
      for (int p : in_edges[node]) preds.push_back(rank[p] + 1);
      if (preds.empty()) preds.push_back(0);
      for (int j = 0; j <= m; ++j) {
        long long best = NEG;
        Bt best_bt = {0, 0, -1, -1, false};
        for (int pr : preds) {
          if (j > 0 && dp[pr][j - 1] != NEG) {
            long long s = dp[pr][j - 1] +
                          (seq[(size_t)j - 1] == bases[node] ? match : mismatch);
            if (s > best) {
              best = s;
              best_bt = {pr, j - 1, node, j - 1, true};
            }
          }
          if (dp[pr][j] != NEG) {
            long long s = dp[pr][j] + gap;
            if (s > best) {
              best = s;
              best_bt = {pr, j, node, -1, true};
            }
          }
        }
        if (j > 0 && dp[r + 1][j - 1] != NEG) {
          long long s = dp[r + 1][j - 1] + gap;
          if (s > best) {
            best = s;
            best_bt = {r + 1, j - 1, -1, j - 1, true};
          }
        }
        if (best > dp[r + 1][j]) {
          dp[r + 1][j] = best;
          bt[r + 1][j] = best_bt;
        }
      }
    }

    std::vector<bool> has_out(bases.size(), false);
    for (const auto& kv : edges) has_out[kv.first.first] = true;
    int end_r = 0;
    long long end_score = dp[0][m];
    for (int r = 0; r < n; ++r) {
      if (!has_out[order[r]] && dp[r + 1][m] > end_score) {
        end_score = dp[r + 1][m];
        end_r = r + 1;
      }
    }
    path.clear();
    int r = end_r, j = m;
    while (!(r == 0 && j == 0)) {
      const Bt& step = bt[r][j];
      if (!step.set) break;
      path.push_back({step.node, step.pos});
      r = step.pr;
      j = step.pj;
    }
    std::reverse(path.begin(), path.end());
  }

  void add_sequence(const std::string& seq) {
    if (seq.empty()) return;
    if (bases.empty()) {
      int prev = -1;
      for (char ch : seq) {
        int node = add_node(ch);
        if (prev >= 0) add_edge(prev, node);
        prev = node;
      }
      return;
    }
    std::vector<std::pair<int, int>> alignment;
    align(seq, alignment);
    int prev = -1;
    for (const auto& np : alignment) {
      int node = np.first, pos = np.second;
      if (pos < 0) continue;  // graph node skipped
      char ch = seq[(size_t)pos];
      int cur;
      if (node >= 0 && bases[(size_t)node] == ch) {
        cur = node;
      } else {
        cur = add_node(ch);
      }
      if (prev >= 0) add_edge(prev, cur);
      prev = cur;
    }
  }

  std::string consensus() const {
    if (bases.empty()) return "";
    std::vector<int> order = topo_order();
    std::vector<long long> score(bases.size(), 0);
    std::vector<int> back(bases.size(), -1);
    for (int node : order) {
      for (int p : in_edges[node]) {
        long long s = score[p] + edges.at({p, node});
        if (s > score[node]) {
          score[node] = s;
          back[node] = p;
        }
      }
    }
    int end = order[0];
    long long best = score[order[0]];
    for (int node : order) {  // first max in order (Python max())
      if (score[node] > best) {
        best = score[node];
        end = node;
      }
    }
    std::string out;
    for (int cur = end; cur >= 0; cur = back[cur]) out.push_back(bases[cur]);
    std::reverse(out.begin(), out.end());
    return out;
  }
};

// buf: concatenated sequences; offsets: [n_seqs+1] byte offsets into buf.
// On success *out is a malloc'd consensus string of *out_len bytes (free
// with mcaat_free). Returns 0.
int mcaat_poa_consensus(const char* buf, const int64_t* offsets,
                        int64_t n_seqs, int match, int mismatch, int gap,
                        char** out, int64_t* out_len) {
  PoaGraph g(match, mismatch, gap);
  for (int64_t i = 0; i < n_seqs; ++i) {
    std::string s(buf + offsets[i], (size_t)(offsets[i + 1] - offsets[i]));
    g.add_sequence(s);
  }
  std::string cons = n_seqs > 0 ? g.consensus() : std::string();
  *out_len = (int64_t)cons.size();
  *out = (char*)malloc(cons.size() + 1);
  if (!*out) return 1;
  memcpy(*out, cons.data(), cons.size());
  (*out)[cons.size()] = 0;
  return 0;
}

// Reproduce the reference's unordered_map<string,int> ITERATION ORDER for
// the analyzer's common-kmer candidate lists (reference
// include/post_processing.h:50-63): with nested candidates (e.g. "T" and
// "TA" both common), the reference's spacer trim picks the FIRST match in
// map iteration order and reconstruct_repeat appends prefixes.back() —
// both hash-order artifacts. Exact report parity therefore requires
// replaying that order with the same libstdc++ container this library is
// compiled against. Input: the unique keys in first-seen order (duplicate
// operator[] hits never move a node, so the multiset collapses to this);
// output: order_out[i] = input index of the i-th key in map iteration
// order. Returns the key count.
int64_t mcaat_umap_order(const char* buf, const int64_t* offsets,
                         int64_t n_keys, int64_t* order_out) {
  std::unordered_map<std::string, int64_t> m;
  for (int64_t i = 0; i < n_keys; ++i) {
    std::string k(buf + offsets[i], (size_t)(offsets[i + 1] - offsets[i]));
    m.emplace(std::move(k), i);  // same insertion schedule as count[kmer]++
  }
  int64_t j = 0;
  for (const auto& p : m) order_out[j++] = p.second;
  return j;
}

// Bound the library's OpenMP parallelism (the packer's parallel-for) to
// the CLI's --threads, like the reference's omp_set_num_threads in
// src/main.cpp:292-294. No-op for n <= 0 or non-OpenMP builds.
void mcaat_set_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

// The compiler version this library was built with, and its OpenMP
// version (_OPENMP, a yyyymm date) or 0 for a single-threaded build.
const char* mcaat_compiler_version() { return __VERSION__; }

int mcaat_openmp_version() {
#ifdef _OPENMP
  return _OPENMP;
#else
  return 0;
#endif
}

}  // extern "C"
