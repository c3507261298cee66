// paramugsy_tpu native runtime kernels.
//
// The reference keeps its hot coordinate/alignment paths in C++
// (lib/m_translate/m_translate.cc — the production rewrite of the OCaml
// translate; lib/profiles_lib/* streaming parsers).  This library plays the
// same role here: the host-side work that is not worth
// a device round trip — batched Needleman-Wunsch gap extension with
// traceback, and the column-walk helpers — implemented natively and loaded
// through ctypes (no pybind11 dependency).
//
// Build: make -C native   (produces libpm_native.so)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr uint8_t DIAG = 0;
constexpr uint8_t UP = 1;    // consumes ref (gap in query row)
constexpr uint8_t LEFT = 2;  // consumes query (gap in ref row)
constexpr int32_t NEG = -100000000;

// One pair's DP + traceback. dirs is a caller-provided (S+1)*(S+1) scratch.
// Emits gap runs as triples (side, start, end) with side 0=ref-gap (LEFT
// columns), 1=query-gap (UP columns); 1-indexed alignment columns.
// Returns number of columns; run count via *n_runs.
int32_t nw_one(const int8_t* a, int32_t an, const int8_t* b, int32_t bn,
               int32_t match, int32_t mismatch, int32_t gap,
               uint8_t* dirs, int32_t S1,
               int32_t* runs, int32_t max_runs, int32_t* n_runs) {
  // dp rows
  std::vector<int32_t> prev(S1), cur(S1);
  for (int32_t j = 0; j <= bn; ++j) prev[j] = gap * j;
  for (int32_t j = 0; j <= bn; ++j) dirs[j] = LEFT;
  dirs[0] = DIAG;
  for (int32_t i = 1; i <= an; ++i) {
    uint8_t* drow = dirs + (size_t)i * S1;
    cur[0] = gap * i;
    drow[0] = UP;
    const int8_t ai = a[i - 1];
    for (int32_t j = 1; j <= bn; ++j) {
      int32_t diag = prev[j - 1] + (ai == b[j - 1] ? match : mismatch);
      int32_t up = prev[j] + gap;
      int32_t left = cur[j - 1] + gap;
      int32_t best = diag;
      uint8_t d = DIAG;
      if (up > best) { best = up; d = UP; }
      if (left > best) { best = left; d = LEFT; }
      cur[j] = best;
      drow[j] = d;
    }
    std::swap(prev, cur);
  }
  // traceback from (an, bn)
  int32_t i = an, j = bn;
  // collect columns reversed
  std::vector<uint8_t> cols;
  cols.reserve(an + bn);
  while (i > 0 || j > 0) {
    uint8_t d;
    if (i == 0) d = LEFT;
    else if (j == 0) d = UP;
    else d = dirs[(size_t)i * S1 + j];
    cols.push_back(d);
    if (d == DIAG) { --i; --j; }
    else if (d == UP) { --i; }
    else { --j; }
  }
  std::reverse(cols.begin(), cols.end());
  int32_t n = (int32_t)cols.size();
  // extract runs
  int32_t nr = 0;
  int32_t start = -1;
  uint8_t kind = DIAG;
  for (int32_t c = 0; c <= n; ++c) {
    uint8_t k = (c < n) ? cols[c] : DIAG;
    if (k != kind) {
      if (kind != DIAG && nr < max_runs) {
        runs[nr * 3 + 0] = (kind == LEFT) ? 0 : 1;
        runs[nr * 3 + 1] = start + 1;
        runs[nr * 3 + 2] = c;
        ++nr;
      }
      if (k != DIAG) start = c;
      kind = k;
    }
  }
  *n_runs = nr;
  return n;
}

}  // namespace

extern "C" {

// Batched NW alignment with traceback.
//   a, b:        [batch, stride] int8 code arrays
//   a_len,b_len: [batch] segment lengths (<= stride)
//   out_cols:    [batch] alignment column counts
//   out_runs:    [batch, max_runs, 3] (side, start, end) gap runs
//   out_nruns:   [batch] run counts
// Returns 0 on success, -1 if any pair overflowed max_runs.
int pm_nw_align_batch(const int8_t* a, const int32_t* a_len,
                      const int8_t* b, const int32_t* b_len,
                      int32_t batch, int32_t stride,
                      int32_t match, int32_t mismatch, int32_t gap,
                      int32_t* out_cols, int32_t* out_runs,
                      int32_t* out_nruns, int32_t max_runs) {
  const int32_t S1 = stride + 1;
  int overflow = 0;
#if defined(_OPENMP)
#pragma omp parallel
#endif
  {
    std::vector<uint8_t> dirs((size_t)S1 * S1);
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 16)
#endif
    for (int32_t p = 0; p < batch; ++p) {
      int32_t nr = 0;
      out_cols[p] = nw_one(a + (size_t)p * stride, a_len[p],
                           b + (size_t)p * stride, b_len[p],
                           match, mismatch, gap,
                           dirs.data(), S1,
                           out_runs + (size_t)p * max_runs * 3, max_runs, &nr);
      out_nruns[p] = nr;
      if (nr >= max_runs) overflow = 1;
    }
  }
  return overflow ? -1 : 0;
}

int pm_version() { return 4; }

// Batched inter-anchor segment alignment straight from the FULL genome
// code arrays: callers pass segment boundary arrays instead of slicing
// 20k+ tiny NumPy views per pair (the Python marshalling dominated the
// host tail wall; see BENCH_NOTES round 3).
//   ref/qry:      full int8 code arrays (qry strand-local)
//   r0,r1,q0,q1:  int64 [n] 0-based half-open slices [r0,r1) x [q0,q1)
//   cap:          segments with max side length > cap are NOT aligned;
//                 out_cols[i] = -1 so the caller can route them to the
//                 device wavefront engine.
//   out_runs:     [n, max_runs, 3] (side, start, end) gap runs; a segment
//                 overflowing max_runs gets out_cols[i] = -2 (caller
//                 realigns just that one).
// Returns the number of segments that actually ran the DP (degenerate
// empty-side / 1-vs-1 shortcuts and -1/-2 marked segments excluded), so
// the caller's engine accounting counts real work only.
int pm_nw_segments(const int8_t* ref, const int8_t* qry,
                   const int64_t* r0, const int64_t* r1,
                   const int64_t* q0, const int64_t* q1,
                   int32_t n, int32_t cap,
                   int32_t match, int32_t mismatch, int32_t gap,
                   int32_t* out_cols, int32_t* out_runs,
                   int32_t* out_nruns, int32_t max_runs) {
  int32_t n_dp = 0;
#if defined(_OPENMP)
#pragma omp parallel reduction(+ : n_dp)
#endif
  {
    std::vector<uint8_t> dirs;
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 64)
#endif
    for (int32_t t = 0; t < n; ++t) {
      const int64_t la = r1[t] - r0[t];
      const int64_t lb = q1[t] - q0[t];
      int32_t* runs = out_runs + (size_t)t * max_runs * 3;
      out_nruns[t] = 0;
      if (la <= 0 && lb <= 0) {
        out_cols[t] = 0;
        continue;
      }
      if (la <= 0) {  // pure ref gap
        if (max_runs >= 1) {
          runs[0] = 0; runs[1] = 1; runs[2] = (int32_t)lb;
          out_nruns[t] = 1;
        }
        out_cols[t] = (int32_t)lb;
        continue;
      }
      if (lb <= 0) {  // pure query gap
        if (max_runs >= 1) {
          runs[0] = 1; runs[1] = 1; runs[2] = (int32_t)la;
          out_nruns[t] = 1;
        }
        out_cols[t] = (int32_t)la;
        continue;
      }
      if (la == 1 && lb == 1 && mismatch >= 2 * gap) {
        out_cols[t] = 1;  // single (mis)match column beats two gaps
        continue;
      }
      if (la > cap || lb > cap) {
        out_cols[t] = -1;  // too long: device engine's job
        continue;
      }
      const int32_t S1 = (int32_t)lb + 1;
      if (dirs.size() < (size_t)(la + 1) * S1) dirs.resize((size_t)(la + 1) * S1);
      int32_t nr = 0;
      out_cols[t] = nw_one(ref + r0[t], (int32_t)la, qry + q0[t], (int32_t)lb,
                           match, mismatch, gap, dirs.data(), S1,
                           runs, max_runs, &nr);
      out_nruns[t] = nr;
      if (nr >= max_runs) out_cols[t] = -2;  // run overflow: redo solo
      else ++n_dp;
    }
  }
  return n_dp;
}

// Exact O(C^2) cluster-chaining DP (the host tail of the mgaps role).
// Inputs are cluster summaries sorted by (rstart, qstart); semantics are
// identical to ops/chaining.chain_clusters's NumPy loop: predecessor j of
// i must precede it on both axes, with gaps <= max_join_gap and diagonal
// drift <= max_join_diagdiff; link score = score[j] - drift, taken only
// when positive (first argmax wins ties, matching np.argmax).
void pm_chain_clusters(const int64_t* rs, const int64_t* re,
                       const int64_t* qs, const int64_t* qe,
                       const int64_t* w, int32_t C,
                       int64_t max_join_gap, int64_t max_join_diagdiff,
                       int64_t* score, int64_t* parent) {
  for (int32_t i = 0; i < C; ++i) {
    score[i] = w[i];
    parent[i] = -1;
  }
  for (int32_t i = 1; i < C; ++i) {
    int64_t best = -1;
    int32_t best_j = -1;
    for (int32_t j = 0; j < i; ++j) {
      if (re[j] >= rs[i] || qe[j] >= qs[i]) continue;
      int64_t gap_r = rs[i] - re[j];
      int64_t gap_q = qs[i] - qe[j];
      int64_t g = gap_r > gap_q ? gap_r : gap_q;
      if (g > max_join_gap) continue;
      int64_t dd = gap_r - gap_q;
      if (dd < 0) dd = -dd;
      if (dd > max_join_diagdiff) continue;
      int64_t cand = score[j] - dd;
      if (cand > best) {
        best = cand;
        best_j = j;
      }
    }
    if (best_j >= 0 && best > 0) {
      score[i] = w[i] + best;
      parent[i] = best_j;
    }
  }
}

// Traceback over the device wavefront's packed direction buffer
// (paramugsy_tpu/ops/wavefront.py).
//   dirs:   [steps16, batch, width] int32; step d (1-based) of pair p lane
//           w is bits 2*((d-1)%16) of dirs[(d-1)/16][p][w].
//   a_len/b_len: [n_pairs] segment lengths (n_pairs <= batch).
//   out_cols:  [n_pairs] alignment column counts
//   out_runs:  [n_pairs, max_runs, 3] (side, start, end); side 0 = ref gap
//              (LEFT columns), 1 = query gap (UP columns); 1-indexed.
//   out_nruns: [n_pairs]
// Returns 0, or -1 if any pair overflowed max_runs.
int pm_wavefront_traceback(const int32_t* dirs, int32_t steps16, int32_t batch,
                           int32_t width, const int32_t* a_len,
                           const int32_t* b_len, int32_t n_pairs,
                           int32_t* out_cols, int32_t* out_runs,
                           int32_t* out_nruns, int32_t max_runs) {
  const int32_t half = width / 2;
  int overflow = 0;
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (int32_t p = 0; p < n_pairs; ++p) {
    int32_t i = a_len[p], j = b_len[p];
    std::vector<uint8_t> cols;
    cols.reserve(i + j);
    while (i > 0 || j > 0) {
      uint8_t d;
      if (i == 0) {
        d = LEFT;
      } else if (j == 0) {
        d = UP;
      } else {
        int32_t w = j - i + half;
        if (w <= 0) {
          d = UP;
        } else if (w >= width - 1) {
          d = LEFT;
        } else {
          int32_t s = i + j - 1;  // 0-based step index
          int32_t word =
              dirs[((size_t)(s >> 4) * batch + p) * width + w];
          d = (word >> (2 * (s & 15))) & 3;
        }
      }
      cols.push_back(d);
      if (d == DIAG) { --i; --j; }
      else if (d == UP) { --i; }
      else { --j; }
    }
    std::reverse(cols.begin(), cols.end());
    int32_t n = (int32_t)cols.size();
    int32_t nr = 0, start = -1;
    uint8_t kind = DIAG;
    int32_t* runs = out_runs + (size_t)p * max_runs * 3;
    for (int32_t c = 0; c <= n; ++c) {
      uint8_t k = (c < n) ? cols[c] : DIAG;
      if (k != kind) {
        if (kind != DIAG && nr < max_runs) {
          runs[nr * 3 + 0] = (kind == LEFT) ? 0 : 1;
          runs[nr * 3 + 1] = start + 1;
          runs[nr * 3 + 2] = c;
          ++nr;
        }
        if (k != DIAG) start = c;
        kind = k;
      }
    }
    out_cols[p] = n;
    out_nruns[p] = nr;
    if (nr >= max_runs) overflow = 1;
  }
  return overflow ? -1 : 0;
}

}  // extern "C"

extern "C" {

// Banded global alignment of one pair (band layout identical to the
// Pallas kernel: lane w of row i is column j = i + w - W/2).  Emits gap
// runs like pm_nw_align_batch.  dirs scratch is allocated internally.
// Returns columns, or -1 on run overflow.
int32_t pm_banded_align(const int8_t* a, int32_t an, const int8_t* b,
                        int32_t bn, int32_t width, int32_t match,
                        int32_t mismatch, int32_t gap, int32_t* runs,
                        int32_t max_runs, int32_t* n_runs) {
  const int32_t half = width / 2;
  std::vector<int32_t> prev(width), cur(width);
  std::vector<uint8_t> dirs((size_t)an * width);
  for (int32_t w = 0; w < width; ++w) {
    int32_t j0 = w - half;
    prev[w] = (j0 >= 0 && j0 <= bn) ? gap * j0 : NEG;
  }
  for (int32_t i = 1; i <= an; ++i) {
    uint8_t* drow = dirs.data() + (size_t)(i - 1) * width;
    const int8_t ai = a[i - 1];
    int32_t best_chain = NEG;  // running max of (cand[v] - gap*j(v))
    for (int32_t w = 0; w < width; ++w) {
      int32_t j = i + w - half;
      bool valid = (j >= 1 && j <= bn);
      int32_t diag_term = NEG, up_term = NEG;
      if (valid || j == 0) {
        int32_t sub = (j >= 1 && j <= bn && b[j - 1] == ai) ? match : mismatch;
        diag_term = prev[w] + sub;
        up_term = (w < width - 1) ? prev[w + 1] + gap : NEG;
      }
      int32_t cand = std::max(diag_term, up_term);
      if (j == 0) cand = std::max(cand, gap * i);
      if (!valid && j != 0) cand = NEG;
      int32_t u = cand - gap * j;
      if (u > best_chain) best_chain = u;
      int32_t dp = valid ? best_chain + gap * j : (j == 0 ? gap * i : NEG);
      uint8_t d = LEFT;
      if (dp == up_term) d = UP;
      if (dp == diag_term) d = DIAG;
      drow[w] = d;
      cur[w] = dp;
    }
    std::swap(prev, cur);
  }
  // traceback
  int32_t i = an, j = bn;
  std::vector<uint8_t> cols;
  cols.reserve(an + bn);
  while (i > 0 || j > 0) {
    uint8_t d;
    if (i == 0) d = LEFT;
    else if (j == 0) d = UP;
    else {
      int32_t w = j - i + half;
      if (w < 0) d = UP;
      else if (w >= width) d = LEFT;
      else d = dirs[(size_t)(i - 1) * width + w];
    }
    cols.push_back(d);
    if (d == DIAG) { --i; --j; }
    else if (d == UP) { --i; }
    else { --j; }
  }
  std::reverse(cols.begin(), cols.end());
  int32_t n = (int32_t)cols.size();
  int32_t nr = 0;
  int32_t start = -1;
  uint8_t kind = DIAG;
  for (int32_t c = 0; c <= n; ++c) {
    uint8_t kk = (c < n) ? cols[c] : DIAG;
    if (kk != kind) {
      if (kind != DIAG && nr < max_runs) {
        runs[nr * 3 + 0] = (kind == LEFT) ? 0 : 1;
        runs[nr * 3 + 1] = start + 1;
        runs[nr * 3 + 2] = c;
        ++nr;
      }
      if (kk != DIAG) start = c;
      kind = kk;
    }
  }
  *n_runs = nr;
  if (nr >= max_runs) return -1;
  return n;
}

}  // extern "C"
