// Mock of megahit's SDBG (succinct de Bruijn graph) query API, backed by a
// flat-array graph dump produced by mcaat_tpu (mcaat_tpu/io/export.py
// write_graph_dump). The megahit submodule is empty in this snapshot, so the
// reference's L4/L5 sources (cycle_finder.cpp, spacer_ordering.cpp,
// tmp_utils.cpp, reads.cpp, post_processing.h, ...) are compiled against THIS
// header for the true-parity harness: both the reference algorithms and the
// JAX pipeline then see the exact same graph, and their reports can be
// compared end to end (tests/test_reference_parity.py).
//
// API surface = exactly the methods mcaat consumes (SURVEY.md §2.2-N2).
// Semantics notes:
//  * Edge{Out,In}degree count neighbors whose TARGET is still a valid edge —
//    required for CycleFinder::RecursiveReduction (src/cycle_finder.cpp:357-369)
//    to propagate up dead chains (a parent must become outdegree-0 once its
//    only child is invalidated). Same model as mcaat_tpu.graph.dbg.
//  * {Out,In}comingEdges write exactly the valid-target neighbors (count ==
//    Edge{Out,In}degree) and return that count, or -1 when the queried node
//    itself is invalid. This is forced by the call sites: the reference
//    allocates the buffer with size EdgeOutdegree and loops i < outdegree
//    over it (src/spacer_ordering.cpp:19-26, src/cycle_finder.cpp:298-320) —
//    an unfiltered buffer would overflow/under-read there.
//  * GetLabel fills codes 1-4 (A=1..T=4): label[i] == "ACGT"[seq[i]-1]
//    (src/filters.cpp:8-15 decodes it exactly that way).
//  * IndexBinarySearch takes codes 1-4 in label order and returns the node id
//    (== rank in the sorted k-mer table) or -1.
#ifndef MOCK_SDBG_SDBG_H
#define MOCK_SDBG_SDBG_H

#include <cmath>  // the real megahit header chain provides log2/ceil
                  // transitively; cycle_finder.cpp:414 relies on it
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

using std::ceil;   // reference calls them unqualified under
using std::log2;   // "using namespace std" (settings.h:19)

class SDBG {
 public:
  static const uint64_t kNullID = static_cast<uint64_t>(-1);

  SDBG() = default;

  // Loads the mcaat_tpu graph dump (little-endian):
  //   char[8]  magic "MCAATDBG"
  //   int64    k
  //   int64    N
  //   int64[N] kmers   (sorted, 2-bit packed big-endian, A=0..T=3)
  //   int32[N] mult
  //   int32[4N] out    (out[4v+b] = id of v·b's suffix k-mer, -1 = absent)
  //   int32[4N] in     (in[4v+b]  = id of b·v's prefix k-mer, -1 = absent)
  //   uint8[N] valid
  bool LoadFromFile(const char *path) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return false;
    char magic[8];
    if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "MCAATDBG", 8)) {
      std::fclose(f);
      return false;
    }
    int64_t k64 = 0, n64 = 0;
    if (std::fread(&k64, 8, 1, f) != 1 || std::fread(&n64, 8, 1, f) != 1) {
      std::fclose(f);
      return false;
    }
    k_ = static_cast<uint32_t>(k64);
    n_ = static_cast<size_t>(n64);
    kmers_.resize(n_);
    mult_.resize(n_);
    out_.resize(4 * n_);
    in_.resize(4 * n_);
    valid_.resize(n_);
    bool ok = std::fread(kmers_.data(), 8, n_, f) == n_ &&
              std::fread(mult_.data(), 4, n_, f) == n_ &&
              std::fread(out_.data(), 4, 4 * n_, f) == 4 * n_ &&
              std::fread(in_.data(), 4, 4 * n_, f) == 4 * n_ &&
              std::fread(valid_.data(), 1, n_, f) == n_;
    std::fclose(f);
    if (!ok) throw std::runtime_error("truncated graph dump: " + std::string(path));
    return true;
  }

  size_t size() const { return n_; }
  uint32_t k() const { return k_; }

  bool IsValidEdge(uint64_t id) const { return id < n_ && valid_[id]; }
  void SetInvalidEdge(uint64_t id) {
    if (id < n_) valid_[id] = 0;
  }
  void SetValidEdge(uint64_t id) {
    if (id < n_) valid_[id] = 1;
  }

  int EdgeMultiplicity(uint64_t id) const {
    return id < n_ ? mult_[id] : 0;
  }

  int EdgeOutdegree(uint64_t id) const { return degree_(out_, id); }
  int EdgeIndegree(uint64_t id) const { return degree_(in_, id); }
  bool EdgeOutdegreeZero(uint64_t id) const { return EdgeOutdegree(id) == 0; }

  // Fill up to 4 valid out/in neighbors; -1 if the node is invalid/oob.
  int OutgoingEdges(uint64_t id, uint64_t *buf) const {
    return neighbors_(out_, id, buf);
  }
  int IncomingEdges(uint64_t id, uint64_t *buf) const {
    return neighbors_(in_, id, buf);
  }

  uint32_t GetLabel(uint64_t id, uint8_t *seq) const {
    if (id >= n_) return 0;
    uint64_t km = static_cast<uint64_t>(kmers_[id]);
    for (int i = static_cast<int>(k_) - 1; i >= 0; --i) {
      seq[i] = static_cast<uint8_t>((km & 3) + 1);  // codes 1-4
      km >>= 2;
    }
    return k_;
  }

  int64_t IndexBinarySearch(const uint8_t *seq) const {
    uint64_t km = 0;
    for (uint32_t i = 0; i < k_; ++i) {
      km = (km << 2) | static_cast<uint64_t>(seq[i] - 1);
    }
    int64_t key = static_cast<int64_t>(km);
    size_t lo = 0, hi = n_;
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (kmers_[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < n_ && kmers_[lo] == key) return static_cast<int64_t>(lo);
    return -1;
  }

  // Only consumed by the DEBUG-path phage curator (src/phage_curator.cpp:261);
  // provided for completeness: the unique valid successor when out-degree is
  // exactly 1 and that successor's in-degree is exactly 1, else kNullID.
  uint64_t NextSimplePathEdge(uint64_t id) const {
    if (!IsValidEdge(id) || EdgeOutdegree(id) != 1) return kNullID;
    uint64_t nbrs[4];
    int n = OutgoingEdges(id, nbrs);
    for (int i = 0; i < n; ++i) {
      if (IsValidEdge(nbrs[i])) {
        return EdgeIndegree(nbrs[i]) == 1 ? nbrs[i] : kNullID;
      }
    }
    return kNullID;
  }

 private:
  int degree_(const std::vector<int32_t> &adj, uint64_t id) const {
    if (id >= n_ || !valid_[id]) return 0;
    int d = 0;
    for (int b = 0; b < 4; ++b) {
      int32_t v = adj[4 * id + b];
      if (v >= 0 && valid_[static_cast<size_t>(v)]) ++d;
    }
    return d;
  }

  int neighbors_(const std::vector<int32_t> &adj, uint64_t id,
                 uint64_t *buf) const {
    if (id >= n_ || !valid_[id]) return -1;
    int n = 0;
    for (int b = 0; b < 4; ++b) {
      int32_t v = adj[4 * id + b];
      if (v >= 0 && valid_[static_cast<size_t>(v)])
        buf[n++] = static_cast<uint64_t>(v);
    }
    return n;
  }

  uint32_t k_ = 0;
  size_t n_ = 0;
  std::vector<int64_t> kmers_;
  std::vector<int32_t> mult_;
  std::vector<int32_t> out_;
  std::vector<int32_t> in_;
  std::vector<uint8_t> valid_;
};

#endif  // MOCK_SDBG_SDBG_H
