// Exact glocal DP with affine indels — native implementation of the host
// aligner core (mirrors mapper_tpu/align/dp.py::_forward_dp/_traceback, which
// mirrors the reference's PathAligner; see dp.py for the semantics citations).
//
// This is the runtime's hot host path: the sequential engine's extend step and
// the batch engine's traceback finalization.  The Python implementation is the
// semantic oracle; tests assert block-for-block equality.
//
// mapper_local_align_batch additionally runs the FULL local_align semantics
// (straight_alignment -> SkipHighAmbiguity -> path_align -> justify ->
// new_sequence_alignment penalty accounting; dp.py::local_align) natively for
// a batch of independent problems, OpenMP-parallel.  Float parity notes:
//   - block penalties replicate numpy's pairwise summation exactly
//     (pairwise_sum below == numpy pairwise_sum_DOUBLE, PW_BLOCKSIZE=128);
//   - the 16x16 penalty table is built with the same operation order as
//     AlignmentParameters.base_penalty (fnr = (pc-1)/3.0 first, then amb*fnr);
//   - the build uses -ffp-contract=off so a+b*c never fuses.
//
// Build: g++ -O3 -march=native -ffp-contract=off [-fopenmp] -shared -fPIC
//        dp.cpp -o libmapperdp.so
// Binding: ctypes (mapper_tpu/native/__init__.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <array>
#include <limits>
#include <map>
#include <set>
#include <string>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr double DISALLOWED = 1000000.0;

struct Params {
  double mutation;
  double ambiguity;
  double ins_start;
  double ins_ext;
  double del_start;
  double del_ext;
  double unaligned;
  double starting_ins_start;
};

inline int popcount4(uint8_t x) { return __builtin_popcount(x & 0xF); }

inline bool can_match(uint8_t a, uint8_t b) { return (a & b) != 0; }

inline bool fully_ambiguous(uint8_t a) { return (a & 0xF) == 0xF; }

// 16x16 per-base penalty table, bit-identical to
// AlignmentParameters.base_penalty: fnr computed first ((pc-1)/3.0 as its own
// double), then ambiguity * fnr — the operation order matters for parity.
struct PenaltyTable {
  double t[16][16];
  explicit PenaltyTable(const Params& p) {
    for (int q = 0; q < 16; q++) {
      for (int w = 0; w < 16; w++) {
        if ((q & w) != 0) {
          const int pc = popcount4(static_cast<uint8_t>(q | w));
          const double fnr = static_cast<double>(pc >= 1 ? pc - 1 : 0) / 3.0;
          t[q][w] = p.ambiguity * fnr;
        } else {
          t[q][w] = p.mutation;
        }
      }
    }
  }
};

// numpy's pairwise_sum_DOUBLE for contiguous doubles (PW_BLOCKSIZE = 128).
double pairwise_sum(const double* a, long n) {
  if (n < 8) {
    double res = 0.0;
    for (long i = 0; i < n; i++) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r0 = a[0], r1 = a[1], r2 = a[2], r3 = a[3];
    double r4 = a[4], r5 = a[5], r6 = a[6], r7 = a[7];
    long i;
    for (i = 8; i < n - (n % 8); i += 8) {
      r0 += a[i + 0];
      r1 += a[i + 1];
      r2 += a[i + 2];
      r3 += a[i + 3];
      r4 += a[i + 4];
      r5 += a[i + 5];
      r6 += a[i + 6];
      r7 += a[i + 7];
    }
    double res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7));
    for (; i < n; i++) res += a[i];
    return res;
  }
  long n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

struct DpScratch {
  std::vector<double> best, insx, insy;
  std::vector<uint8_t> rev_q, rev_w;
  std::vector<double> pens;
  std::vector<int> wlo, whi;  // per-row written column range (banded init)
  // per-query-code window rows (see dp_fill_traceback): penalties, match
  // masks, content-allow masks, plus an all-ones row
  std::vector<double> penrow, arow, crow, ones;
};

// Fills the DP tables and runs the traceback (the body of mapper_dp_align;
// see that entry's comment for semantics).  Blocks are emitted goal-to-start.
int dp_fill_traceback(const uint8_t* q, int n, const uint8_t* w, int m,
                      const Params& p, const PenaltyTable& tbl, int may_extend,
                      double max_ins_ext,
                      double max_interesting, int32_t* out_blocks,
                      int max_blocks, double* out_goal_penalty,
                      DpScratch& scratch) {
  const int stride = m + 1;
  const size_t cells = static_cast<size_t>(n + 1) * stride;
  // Band-only initialization: the full-rectangle memset dominated the DP's
  // runtime at production budgets (~740 KB per 150x200 call), so cells are
  // written only where the band touches them; per-row written ranges
  // (scratch.wlo/whi, plus column 0) gate every read outside the fill loop —
  // unwritten cells read as DISALLOWED, exactly the value the full
  // initialization gave them.
  if (scratch.best.size() < cells) {
    scratch.best.resize(cells);
    scratch.insx.resize(cells);
    scratch.insy.resize(cells);
  }
  if (scratch.wlo.size() < static_cast<size_t>(n + 1)) {
    scratch.wlo.resize(n + 1);
    scratch.whi.resize(n + 1);
  }
  std::vector<int>& wlo = scratch.wlo;
  std::vector<int>& whi = scratch.whi;
  std::vector<double>& best = scratch.best;
  std::vector<double>& insx = scratch.insx;
  std::vector<double>& insy = scratch.insy;
  auto B = [&](int x, int y) -> double& { return best[static_cast<size_t>(x) * stride + y]; };
  auto IX = [&](int x, int y) -> double& { return insx[static_cast<size_t>(x) * stride + y]; };
  auto IY = [&](int x, int y) -> double& { return insy[static_cast<size_t>(x) * stride + y]; };

  const double ins_open = p.ins_start + p.ins_ext;
  const double del_open = p.del_start + p.del_ext;

  const int init_ins_count =
      may_extend ? static_cast<int>(max_ins_ext / p.del_ext) : 0;
  const int init_limit = std::min(init_ins_count, n + 1);
  // column-0 node values (PathAligner.java:120-150; the may_extend loop of
  // the reference overwrites the no-indel zeros for 1 <= i < limit,
  // java:141-150,523-538)
  auto col0_B = [&](int x) -> double {
    if (x == 0) return 0.0;
    if (may_extend && x < init_limit) return x * p.unaligned;
    if (m < n && x <= n - m) return 0.0;
    return DISALLOWED;
  };

  // initial nodes, row 0 in full (read by row 1 across its whole band);
  // (0,0) is a zero start node in both the m>=n and m<n regimes
  for (int j = 0; j <= m; j++) {
    B(0, j) = ((m >= n && j <= m - n) || j == 0) ? 0.0 : DISALLOWED;
    IX(0, j) = (m >= n && j <= m - n && may_extend) ? p.starting_ins_start
                                                    : DISALLOWED;
    IY(0, j) = DISALLOWED;
  }
  wlo[0] = 0;
  whi[0] = m;

  // Budget band: without contig-edge tails (may_extend), any path whose net
  // diagonal shift leaves the no-indel start range [min(0,m-n), max(0,m-n)]
  // by s bases pays at least indel_start + indel_ext*s, so cells beyond the
  // affordable shift can never be on an accepted path and may stay
  // DISALLOWED (their initialized value) — identical results, ~3x fewer
  // cells at default budgets.  may_extend windows (rare) keep the full
  // rectangle: unaligned-tail steps move off-diagonal at p.unaligned/base.
  int lo_span = n + m + 1, hi_span = n + m + 1;
  if (!may_extend) {
    const double eps_budget = max_interesting + 0.000001;
    const double ins0 = std::min(p.ins_start, p.starting_ins_start);
    const double span_cap = static_cast<double>(n + m + 1);
    if (p.ins_ext > 0) {
      const double k = (eps_budget - ins0) / p.ins_ext;
      lo_span = k < 0 ? 0 : static_cast<int>(std::min(k, span_cap));
    }
    if (p.del_ext > 0) {
      const double k = (eps_budget - p.del_start) / p.del_ext;
      hi_span = k < 0 ? 0 : static_cast<int>(std::min(k, span_cap));
    }
  }
  const int slack_lo = std::min(0, m - n);
  const int slack_hi = std::max(0, m - n);

  // Per-query-code window rows: the window w is fixed across DP rows, so the
  // per-cell penalty-table gathers (t[qc][w[y-1]]) — which blocked
  // vectorization of the overlay and insX passes — are hoisted into rows
  // built once per (problem, code).  Same table values added in the same
  // order: results are bit-identical.
  //   pr[c][y]  = tbl.t[c][w[y-1]]          (y in 1..m)
  //   ar[c][y]  = can_match(c, w[y-1])      (1.0/0.0)
  //   cr[c][y]  = insX/del "content allows a new indel here" term for code c
  //               at window position y (pr==0 | amb(c) | amb(w[y-1]) -> 0);
  //               cr[c][m+1] = 1 sentinel (the y==m insX case skips the term)
  const int prow_stride = m + 2;
  if (scratch.penrow.size() < static_cast<size_t>(16) * prow_stride) {
    scratch.penrow.resize(static_cast<size_t>(16) * prow_stride);
    scratch.arow.resize(static_cast<size_t>(16) * prow_stride);
    scratch.crow.resize(static_cast<size_t>(16) * prow_stride);
  }
  if (scratch.ones.size() < static_cast<size_t>(prow_stride))
    scratch.ones.assign(prow_stride, 1.0);
  uint8_t built[16] = {0};
  auto rows_of = [&](uint8_t code) -> int {
    const int c = code & 0xF;
    if (!built[c]) {
      double* pr = &scratch.penrow[static_cast<size_t>(c) * prow_stride];
      double* ar = &scratch.arow[static_cast<size_t>(c) * prow_stride];
      double* cr = &scratch.crow[static_cast<size_t>(c) * prow_stride];
      const double* t = tbl.t[c];
      const bool amb_c = fully_ambiguous(static_cast<uint8_t>(c));
      for (int y = 1; y <= m; y++) {
        const uint8_t wy = w[y - 1];
        const double np = t[wy & 0xF];
        pr[y] = np;
        ar[y] = can_match(static_cast<uint8_t>(c), wy) ? 1.0 : 0.0;
        cr[y] = (np == 0.0 || amb_c || fully_ambiguous(wy)) ? 0.0 : 1.0;
      }
      cr[m + 1] = 1.0;
      built[c] = 1;
    }
    return c;
  };

  // Vectorization split: insX and the diagonal overlay have no dependency
  // along y, so they fill as branch-free passes the compiler can SIMD; only
  // the best/insY pair carries the sequential y recurrence.  Same operations
  // per cell in the same order — values are bit-identical to the fused loop.
  for (int x = 1; x <= n; x++) {
    const uint8_t qc = q[x - 1];
    int y_lo = 1, y_hi = m;
    if (!may_extend) {
      y_lo = std::max(1, x + slack_lo - lo_span);
      y_hi = std::min(m, x + slack_hi + hi_span);
    }
    // column 0 + the one-cell margins around this row's band; successive
    // bands move right by at most one column per row, so row x+1's reads of
    // row x stay inside [y_lo-1, y_hi+1] + column 0
    B(x, 0) = col0_B(x);
    IX(x, 0) = DISALLOWED;
    IY(x, 0) = DISALLOWED;
    if (y_lo >= 2) {
      B(x, y_lo - 1) = DISALLOWED;
      IX(x, y_lo - 1) = DISALLOWED;
      IY(x, y_lo - 1) = DISALLOWED;
    }
    if (y_hi < m) {
      B(x, y_hi + 1) = DISALLOWED;
      IX(x, y_hi + 1) = DISALLOWED;
      IY(x, y_hi + 1) = DISALLOWED;
    }
    wlo[x] = y_lo >= 2 ? y_lo - 1 : 0;
    whi[x] = y_hi < m ? y_hi + 1 : m;
    if (y_hi < y_lo) continue;

    const double* prev_best = &best[(size_t)(x - 1) * stride];
    const double* prev_insx = &insx[(size_t)(x - 1) * stride];
    double* row_best = &best[(size_t)x * stride];
    double* row_insx = &insx[(size_t)x * stride];
    double* row_insy = &insy[(size_t)x * stride];
    const int cq = rows_of(qc);
    const double* pr_q =
        &scratch.penrow[static_cast<size_t>(cq) * prow_stride];
    const double* ar_q = &scratch.arow[static_cast<size_t>(cq) * prow_stride];
    const uint8_t qnext = x < n ? q[x] : 0;
    // del "new" content term: disabled entirely at x == n (java:661)
    const double* cr_qn =
        x < n ? &scratch.crow[static_cast<size_t>(rows_of(qnext)) * prow_stride]
              : scratch.ones.data();
    const bool have_qprev = x >= 2;
    // insX "new" match term: w[y-1] must match q[x-2]; no constraint at x < 2
    const double* ar_qp =
        have_qprev
            ? &scratch.arow[static_cast<size_t>(rows_of(q[x - 2])) * prow_stride]
            : scratch.ones.data();
    // insX "new" content term at position y reads w[y] (cr index y+1);
    // cr[m+1] = 1 covers the y == m skip
    const double* cr_q = &scratch.crow[static_cast<size_t>(cq) * prow_stride];

    // insX pass (PathAligner.computeUpdated, java:591-637)
    for (int y = y_lo; y <= y_hi; y++) {
      const bool new_allowed = (ar_qp[y] != 0.0) & (cr_q[y + 1] != 0.0);
      const double new_ins = new_allowed ? prev_best[y] + ins_open : DISALLOWED;
      const double ext_ins = prev_insx[y] + p.ins_ext;
      row_insx[y] = std::min(new_ins, ext_ins);
    }
    if (y_hi == m && may_extend) row_insx[m] = prev_best[m] + p.unaligned;

    // overlay pass, pre-minned with insX: min(min(a, b), c) == min(min_ab, c)
    // exactly, so hoisting this min out of the carried loop below keeps
    // values bit-identical while shortening the loop's dependency chain
    for (int y = y_lo; y <= y_hi; y++) {
      row_best[y] = std::min(prev_best[y - 1] + pr_q[y], row_insx[y]);
    }

    // sequential best/insY recurrence (java:639-676); row_best holds
    // min(overlay, insX) coming in and the final best going out
    double b_prev = row_best[y_lo - 1];
    double iy_prev = row_insy[y_lo - 1];
    for (int y = y_lo; y <= y_hi; y++) {
      const bool del_allowed =
          (y < 2 || ar_q[y - 1] != 0.0) && (cr_qn[y] != 0.0);
      const double new_del = del_allowed ? b_prev + del_open : DISALLOWED;
      const double iy = std::min(new_del, iy_prev + p.del_ext);
      const double b = std::min(row_best[y], iy);
      row_insy[y] = iy;
      row_best[y] = b;
      b_prev = b;
      iy_prev = iy;
    }
  }

  // guarded reads: unwritten cells are DISALLOWED by construction
  auto Bg = [&](int x, int y) -> double {
    return (y == 0 || (y >= wlo[x] && y <= whi[x])) ? B(x, y) : DISALLOWED;
  };
  auto IXg = [&](int x, int y) -> double {
    return (y == 0 || (y >= wlo[x] && y <= whi[x])) ? IX(x, y) : DISALLOWED;
  };
  auto IYg = [&](int x, int y) -> double {
    return (y == 0 || (y >= wlo[x] && y <= whi[x])) ? IY(x, y) : DISALLOWED;
  };

  // goal: min over y of best[n][y]; tie -> smallest y
  int goal_y = 0;
  double goal = Bg(n, 0);
  for (int y = 1; y <= m; y++) {
    const double v = Bg(n, y);
    if (v < goal) {
      goal = v;
      goal_y = y;
    }
  }
  *out_goal_penalty = goal;
  if (goal > max_interesting + 0.000001) return -1;

  // traceback (PathAligner.java:195-264 adapted: contig-edge unaligned steps
  // produce no blocks, matching dp.py::_traceback)
  int i = n, j = goal_y;
  int nb = 0;
  auto emit = [&](int sa, int sb, int la, int lb) -> bool {
    if (nb >= max_blocks) return false;
    int32_t* row = out_blocks + static_cast<size_t>(nb) * 4;
    row[0] = sa; row[1] = sb; row[2] = la; row[3] = lb;
    nb++;
    return true;
  };

  while (i != 0 && j == m && may_extend && Bg(i, j) == IXg(i, j) &&
         IXg(i, j) == Bg(i - 1, j) + p.unaligned) {
    i -= 1;
  }
  while (i != 0 && j != 0) {
    const double b = Bg(i, j);
    if (b == IXg(i, j) && !(j == m && may_extend)) {
      const int old_i = i;
      i -= 1;
      while (i != 0) {
        const double other_new = Bg(i, j) + ins_open;
        const double other_ext = IXg(i, j) + p.ins_ext;
        if (other_new < other_ext) break;
        i -= 1;
      }
      if (!emit(i, j, old_i - i, 0)) return -2;
    } else if (b == IXg(i, j) && j == m && may_extend) {
      i -= 1;  // unaligned trailing step: no block
    } else if (b == IYg(i, j)) {
      const int old_j = j;
      j -= 1;
      while (j != 0) {
        const double other_new = Bg(i, j) + del_open;
        const double other_ext = IYg(i, j) + p.del_ext;
        if (other_new < other_ext) break;
        j -= 1;
      }
      if (!emit(i, j, 0, old_j - j)) return -2;
    } else {
      const int old_i = i, old_j = j;
      i -= 1;
      j -= 1;
      while (i != 0 && j != 0) {
        if (Bg(i, j) == IXg(i, j) || Bg(i, j) == IYg(i, j)) break;
        i -= 1;
        j -= 1;
      }
      if (!emit(i, j, old_i - i, old_j - j)) return -2;
    }
  }
  // blocks were emitted goal-to-start; callers reverse
  return nb;
}

// ---------------------------------------------------------------------------
// Full local_align (dp.py::local_align) for one problem, local coordinates.
// Mirrors, in order: straight_alignment + new_sequence_alignment accounting,
// the confident-offset early decisions, SkipHighAmbiguity, path_align
// (choose_search_reverse, DP, block mirroring, justify, leading-removable
// drop, penalty accounting, final rounding check), and the straight-vs-gapped
// tie rules.  Returns: -1 none, 0 straight, 1 gapped, -2 caller must fall
// back to the Python path (block overflow).

struct Block {
  int sa, sb, la, lb;
};

inline bool can_remove_block(const Block& b, long r_start_abs) {
  if (b.la <= 0 && b.lb <= 0) return true;
  if ((b.sa <= 0 && b.la <= 0) || (r_start_abs + b.sb <= 0 && b.lb <= 0)) return true;
  return false;
}

// Pre-DP state of one local_align problem (the straight check + early
// decisions + search-direction choice, split out so the batch entry can
// group the surviving DP fills by geometry — see dp_fill_x4 below).
struct PreState {
  const uint8_t* q;
  const uint8_t* w;
  int qn, wn;
  long r_start_abs;
  int pred_local;
  double rate;
  // straight results
  int qs, qe, rs, re;
  bool have_straight;
  double straight_aligned, straight_total, simple_pen;
  double max_interesting, max_ins_budget, max_interesting_g;
  bool search_reverse, may_extend;
  std::vector<uint8_t> own_q, own_w;  // reversed inputs when search_reverse
};

constexpr int PRE_NEED_DP = -100;

inline int emit_straight_blocks(const PreState& st, int32_t* blocks_out,
                                double* total_out, double* aligned_out) {
  blocks_out[0] = st.qs;
  blocks_out[1] = st.rs;
  blocks_out[2] = st.qe - st.qs;
  blocks_out[3] = st.re - st.rs;
  *total_out = st.straight_total;
  *aligned_out = st.straight_aligned;
  return 0;
}

// Everything before the DP fill.  Returns PRE_NEED_DP when the gapped DP
// must run (st fully populated, dq/dw owned when reversed), otherwise the
// final status (-1 none, 0 straight emitted).
int local_align_pre(const uint8_t* q, int qn, const uint8_t* w, int wn,
                    long r_start_abs, int pred_local, bool at_ref_start,
                    bool at_ref_end, bool confident, double rate,
                    const Params& p, const PenaltyTable& tbl, PreState& st,
                    int32_t* blocks_out, double* total_out,
                    double* aligned_out, DpScratch& scratch) {
  if (qn == 0 || wn == 0) return -1;
  st.q = q;
  st.w = w;
  st.qn = qn;
  st.wn = wn;
  st.r_start_abs = r_start_abs;
  st.pred_local = pred_local;
  st.rate = rate;
  const double max_interesting = qn * rate;
  st.max_interesting = max_interesting;

  // --- straight_alignment (StraightAligner.straightAlignment, java:73-94) ---
  int qs = 0, qe = qn, rs = 0, re = wn;
  const int off = pred_local;
  if (qs + off > rs) rs = qs + off; else qs = rs - off;
  if (qe + off < re) re = qe + off; else qe = re - off;
  st.qs = qs; st.qe = qe; st.rs = rs; st.re = re;
  const bool have_straight = qe > qs;
  st.have_straight = have_straight;
  double straight_aligned = 0.0, straight_total = 0.0;
  if (have_straight) {
    const int len = qe - qs;
    scratch.pens.resize(len);
    for (int i = 0; i < len; i++)
      scratch.pens[i] = tbl.t[q[qs + i] & 0xF][w[rs + i] & 0xF];
    straight_aligned = pairwise_sum(scratch.pens.data(), len);
    straight_total = straight_aligned + (qn - len) * p.unaligned;
  }
  st.straight_aligned = straight_aligned;
  st.straight_total = straight_total;
  const double simple_pen = have_straight
                                ? straight_aligned
                                : std::numeric_limits<double>::infinity();
  st.simple_pen = simple_pen;

  if (have_straight && simple_pen <= 0.0)
    return emit_straight_blocks(st, blocks_out, total_out, aligned_out);

  const double indel_penalty = std::min(p.starting_ins_start + p.ins_ext,
                                        p.del_start + p.del_ext);
  const double max_ins_budget = max_interesting - p.ins_start;
  const double max_del_budget = max_interesting - p.del_start;
  st.max_ins_budget = max_ins_budget;
  if (confident && have_straight) {
    if (simple_pen <= indel_penalty ||
        (max_ins_budget <= 0.0 && max_del_budget <= 0.0)) {
      if (simple_pen <= max_interesting)
        return emit_straight_blocks(st, blocks_out, total_out, aligned_out);
      return -1;
    }
    if (indel_penalty > max_interesting) return -1;
  }

  // --- SkipHighAmbiguity (java:13-27) ---
  int num_amb = 0;
  for (int i = 0; i < wn; i++)
    if (popcount4(w[i]) != 1) num_amb++;
  if (num_amb >= wn / 4) {
    // no gapped search: straight decides alone
    if (have_straight && simple_pen <= max_interesting)
      return emit_straight_blocks(st, blocks_out, total_out, aligned_out);
    return -1;
  }

  double gap_rate = rate;
  if (have_straight) {
    const double sr = simple_pen / qn;
    if (sr < rate) gap_rate = sr;
  }
  st.max_interesting_g = qn * gap_rate;

  // --- path_align: search direction (chooseSearchReverse, java:17-53) ---
  const int diagonal = -pred_local;
  const int ov_start = std::max(0, -pred_local);
  const int ov_end = std::min(qn, wn - pred_local);
  const int overlap_length = std::max(0, ov_end - ov_start);
  long n_mismatch = 0, n_valid = 0, sum_mismatch = 0, sum_valid = 0;
  for (int i = 0; i < overlap_length; i++) {
    const int j = i - diagonal;
    if (j < 0 || j >= wn) continue;
    n_valid++;
    sum_valid += i;
    if ((q[i] & w[j] & 0xF) == 0) {
      n_mismatch++;
      sum_mismatch += i;
    }
  }
  const long n_match = n_valid - n_mismatch;
  bool search_reverse = true;
  if (n_mismatch > 1 && n_match > 1) {
    const long sum_match = sum_valid - sum_mismatch;
    search_reverse = (sum_mismatch / n_mismatch) > (sum_match / n_match);
  }
  st.search_reverse = search_reverse;
  st.may_extend = search_reverse ? at_ref_start : at_ref_end;
  if (search_reverse) {
    st.own_q.resize(qn);
    st.own_w.resize(wn);
    for (int i = 0; i < qn; i++) st.own_q[i] = q[qn - 1 - i];
    for (int i = 0; i < wn; i++) st.own_w[i] = w[wn - 1 - i];
  }
  return PRE_NEED_DP;
}

// Everything after the DP fill: section building, justify, penalties, and
// the straight-vs-gapped tie rules.  `nb` is dp_fill_traceback's return for
// this problem (raw goal-to-start blocks already in blocks_out).
int local_align_post(const PreState& st, int nb, const Params& p,
                     const PenaltyTable& tbl, int32_t* blocks_out,
                     int max_blocks, double* total_out, double* aligned_out,
                     DpScratch& scratch) {
  const uint8_t* q = st.q;
  const uint8_t* w = st.w;
  const int qn = st.qn;
  const int wn = st.wn;
  const double max_interesting = st.max_interesting;
  const double max_interesting_g = st.max_interesting_g;
  const bool have_straight = st.have_straight;
  const double simple_pen = st.simple_pen;
  const bool search_reverse = st.search_reverse;
  bool has_gapped = false;
  double gapped_aligned = 0.0, gapped_total = 0.0;
  int gapped_nb = 0;
  std::vector<Block> sections;

  {
    if (nb == -2) return -2;
    if (nb > 0) {
      sections.clear();
      sections.reserve(nb);
      if (search_reverse) {
        // native emits goal->start in reversed coords == start->goal forward
        for (int b = 0; b < nb; b++) {
          const int32_t* row = blocks_out + static_cast<size_t>(b) * 4;
          sections.push_back(Block{qn - (row[0] + row[2]), wn - (row[1] + row[3]),
                                   row[2], row[3]});
        }
      } else {
        for (int b = nb - 1; b >= 0; b--) {
          const int32_t* row = blocks_out + static_cast<size_t>(b) * 4;
          sections.push_back(Block{row[0], row[1], row[2], row[3]});
        }
      }

      // --- justify (PathAligner.justify, java:307-352; dp.py::_justify) ---
      int i = 1;
      while (i < static_cast<int>(sections.size()) - 1) {
        while (true) {
          Block& left = sections[i - 1];
          Block& middle = sections[i];
          Block& right = sections[i + 1];
          if ((middle.la > 0) == (middle.lb > 0)) break;  // not an indel
          if (left.la == 0 || left.lb == 0) break;
          if (right.la == 0 || right.lb == 0) break;
          if (middle.la > 0) {
            // insertion: shift across matching A chars
            if (q[left.sa + left.la - 1] != q[middle.sa + middle.la - 1]) break;
          } else {
            // deletion: shift across matching B chars
            if (w[left.sb + left.lb - 1] != w[middle.sb + middle.lb - 1]) break;
          }
          left.la -= 1;
          left.lb -= 1;
          middle.sa -= 1;
          middle.sb -= 1;
          right.sa -= 1;
          right.sb -= 1;
          right.la += 1;
          right.lb += 1;
        }
        i += 1;
      }
      // drop removable leading sections (PathAligner.canRemoveSection)
      size_t first = 0;
      while (first < sections.size() &&
             can_remove_block(sections[first], st.r_start_abs))
        first++;
      if (first > 0) sections.erase(sections.begin(), sections.begin() + first);

      if (!sections.empty()) {
        // --- new_sequence_alignment (AlignmentParameters.java:73-95) ---
        double total = 0.0;
        long aligned_len = 0;
        for (const Block& b : sections) {
          double bp;
          if (b.la == b.lb) {
            scratch.pens.resize(b.la);
            for (int x = 0; x < b.la; x++)
              scratch.pens[x] = tbl.t[q[b.sa + x] & 0xF][w[b.sb + x] & 0xF];
            bp = pairwise_sum(scratch.pens.data(), b.la);
          } else if (b.la > 0) {
            bp = p.ins_start + p.ins_ext * b.la;
          } else {
            bp = p.del_start + p.del_ext * b.lb;
          }
          total += bp;
          aligned_len += b.la;
        }
        const bool starting_free =
            p.starting_ins_start == 0.0 && p.ins_start != 0.0;
        if (starting_free && sections.front().lb == 0) total -= p.ins_start;
        const double aligned_pen = total;
        const double total_pen = total + (qn - aligned_len) * p.unaligned;
        // final rounding-error check (PathAligner.java:286-291)
        if (!(aligned_pen > max_interesting_g + 0.000001)) {
          has_gapped = true;
          gapped_aligned = aligned_pen;
          gapped_total = total_pen;
          gapped_nb = static_cast<int>(sections.size());
        }
      }
    }
  }

  // --- straight-vs-gapped tie rules (dp.py::local_align tail) ---
  if (!has_gapped || (have_straight && gapped_aligned >= simple_pen)) {
    if (have_straight && simple_pen <= max_interesting)
      return emit_straight_blocks(st, blocks_out, total_out, aligned_out);
  }
  if (!has_gapped) return -1;
  if (gapped_nb > max_blocks) return -2;
  for (int b = 0; b < gapped_nb; b++) {
    int32_t* row = blocks_out + static_cast<size_t>(b) * 4;
    row[0] = sections[b].sa;
    row[1] = sections[b].sb;
    row[2] = sections[b].la;
    row[3] = sections[b].lb;
  }
  *total_out = gapped_total;
  *aligned_out = gapped_aligned;
  return gapped_nb;  // >= 1 means gapped with this many blocks
}

// ---------------------------------------------------------------------------
// Four-lane DP fill: four problems with IDENTICAL geometry (n, m, may_extend,
// budgets — the banded-fill shape depends only on those, never on the
// predicted offset or the sequence content) run in lane-interleaved state
// arrays, so every fill pass — including the loop-carried best/insY
// recurrence, whose dependency is along y while lanes stay independent —
// vectorizes 4-wide.  Values are bit-identical to dp_fill_traceback lane by
// lane: same adds and mins in the same order, just four problems at once.
// The traceback runs per lane on the strided state.

struct DpScratch4 {
  std::vector<double> best, insx, insy;          // cells * 4, lane-minor
  std::vector<int> wlo, whi;
  std::vector<double> penrow, arow, crow;        // [lane][code][y]
  std::vector<int64_t> wcodes;                   // interleaved window codes
};

void dp_fill_x4(const uint8_t* const qs[4], int n, const uint8_t* const ws[4],
                int m, const Params& p, const PenaltyTable& tbl,
                int may_extend, double max_ins_ext, double max_interesting,
                int32_t* const blocks_out[4], int max_blocks,
                int nb_out[4], double goal_out[4], DpScratch4& s) {
  const int stride = m + 1;
  const size_t cells = static_cast<size_t>(n + 1) * stride * 4;
  if (s.best.size() < cells) {
    s.best.resize(cells);
    s.insx.resize(cells);
    s.insy.resize(cells);
  }
  if (s.wlo.size() < static_cast<size_t>(n + 1)) {
    s.wlo.resize(n + 1);
    s.whi.resize(n + 1);
  }
  std::vector<int>& wlo = s.wlo;
  std::vector<int>& whi = s.whi;
  double* best = s.best.data();
  double* insx = s.insx.data();
  double* insy = s.insy.data();
  auto idx = [&](int x, int y) -> size_t {
    return (static_cast<size_t>(x) * stride + y) * 4;
  };

  const double ins_open = p.ins_start + p.ins_ext;
  const double del_open = p.del_start + p.del_ext;
  const int init_ins_count =
      may_extend ? static_cast<int>(max_ins_ext / p.del_ext) : 0;
  const int init_limit = std::min(init_ins_count, n + 1);
  auto col0_B = [&](int x) -> double {
    if (x == 0) return 0.0;
    if (may_extend && x < init_limit) return x * p.unaligned;
    if (m < n && x <= n - m) return 0.0;
    return DISALLOWED;
  };

  for (int j = 0; j <= m; j++) {
    const double b0 = ((m >= n && j <= m - n) || j == 0) ? 0.0 : DISALLOWED;
    const double ix0 = (m >= n && j <= m - n && may_extend)
                           ? p.starting_ins_start
                           : DISALLOWED;
    for (int l = 0; l < 4; l++) {
      best[idx(0, j) + l] = b0;
      insx[idx(0, j) + l] = ix0;
      insy[idx(0, j) + l] = DISALLOWED;
    }
  }
  wlo[0] = 0;
  whi[0] = m;

  int lo_span = n + m + 1, hi_span = n + m + 1;
  if (!may_extend) {
    const double eps_budget = max_interesting + 0.000001;
    const double ins0 = std::min(p.ins_start, p.starting_ins_start);
    const double span_cap = static_cast<double>(n + m + 1);
    if (p.ins_ext > 0) {
      const double k = (eps_budget - ins0) / p.ins_ext;
      lo_span = k < 0 ? 0 : static_cast<int>(std::min(k, span_cap));
    }
    if (p.del_ext > 0) {
      const double k = (eps_budget - p.del_start) / p.del_ext;
      hi_span = k < 0 ? 0 : static_cast<int>(std::min(k, span_cap));
    }
  }
  const int slack_lo = std::min(0, m - n);
  const int slack_hi = std::max(0, m - n);

  // per-lane per-code window rows (same trick as the scalar fill); slot 16
  // of lane 0 is an all-ones row (so the "no constraint" cases gather from
  // the same base arrays as the real rows)
  const int prow_stride = m + 2;
  const size_t lane_rows = static_cast<size_t>(16) * prow_stride;
  const size_t ones_off = 4 * lane_rows;
  if (s.penrow.size() < 4 * lane_rows + prow_stride) {
    s.penrow.resize(4 * lane_rows + prow_stride);
    s.arow.resize(4 * lane_rows + prow_stride);
    s.crow.resize(4 * lane_rows + prow_stride);
  }
  for (int y = 0; y < prow_stride; y++) {
    s.arow[ones_off + y] = 1.0;
    s.crow[ones_off + y] = 1.0;
  }
  const double* ones_row = &s.arow[ones_off];
  uint8_t built[4][16] = {};
#if defined(__AVX2__)
  // interleaved window codes: wi[y*4+l] = w_l[y-1] (y in 1..m) — the mask
  // terms (can-match, ambiguity, zero-penalty) all derive from these with
  // integer vector ops, replacing four of the five per-y gathers
  if (s.wcodes.size() < static_cast<size_t>(prow_stride) * 4)
    s.wcodes.resize(static_cast<size_t>(prow_stride) * 4);
  int64_t* wi = s.wcodes.data();
  for (int l = 0; l < 4; l++) {
    wi[0 * 4 + l] = 0;
    for (int y = 1; y <= m; y++) wi[y * 4 + l] = ws[l][y - 1] & 0xF;
    wi[(m + 1) * 4 + l] = 0;
  }
#endif
  auto rows_of = [&](int l, uint8_t code) -> size_t {
    const int c = code & 0xF;
    const size_t base = l * lane_rows + static_cast<size_t>(c) * prow_stride;
    if (!built[l][c]) {
      double* pr = &s.penrow[base];
      double* ar = &s.arow[base];
      double* cr = &s.crow[base];
      const double* t = tbl.t[c];
      const bool amb_c = fully_ambiguous(static_cast<uint8_t>(c));
      const uint8_t* w = ws[l];
      for (int y = 1; y <= m; y++) {
        const uint8_t wy = w[y - 1];
        const double np = t[wy & 0xF];
        pr[y] = np;
        ar[y] = can_match(static_cast<uint8_t>(c), wy) ? 1.0 : 0.0;
        cr[y] = (np == 0.0 || amb_c || fully_ambiguous(wy)) ? 0.0 : 1.0;
      }
      cr[m + 1] = 1.0;
      built[l][c] = 1;
    }
    return base;
  };

  for (int x = 1; x <= n; x++) {
    int y_lo = 1, y_hi = m;
    if (!may_extend) {
      y_lo = std::max(1, x + slack_lo - lo_span);
      y_hi = std::min(m, x + slack_hi + hi_span);
    }
    const double c0 = col0_B(x);
    for (int l = 0; l < 4; l++) {
      best[idx(x, 0) + l] = c0;
      insx[idx(x, 0) + l] = DISALLOWED;
      insy[idx(x, 0) + l] = DISALLOWED;
    }
    if (y_lo >= 2)
      for (int l = 0; l < 4; l++) {
        best[idx(x, y_lo - 1) + l] = DISALLOWED;
        insx[idx(x, y_lo - 1) + l] = DISALLOWED;
        insy[idx(x, y_lo - 1) + l] = DISALLOWED;
      }
    if (y_hi < m)
      for (int l = 0; l < 4; l++) {
        best[idx(x, y_hi + 1) + l] = DISALLOWED;
        insx[idx(x, y_hi + 1) + l] = DISALLOWED;
        insy[idx(x, y_hi + 1) + l] = DISALLOWED;
      }
    wlo[x] = y_lo >= 2 ? y_lo - 1 : 0;
    whi[x] = y_hi < m ? y_hi + 1 : m;
    if (y_hi < y_lo) continue;

    // per-lane row offsets into the shared row stores (gather indices)
    const bool have_qprev = x >= 2;
    const bool have_qnext = x < n;
    int64_t off_pr[4], off_arq[4], off_crq[4], off_crn[4], off_arp[4];
    for (int l = 0; l < 4; l++) {
      const uint8_t qc = qs[l][x - 1];
      const size_t base = rows_of(l, qc);
      off_pr[l] = static_cast<int64_t>(base);
      off_arq[l] = static_cast<int64_t>(base);
      off_crq[l] = static_cast<int64_t>(base);
      off_crn[l] = static_cast<int64_t>(
          have_qnext ? rows_of(l, qs[l][x]) : ones_off);
      off_arp[l] = static_cast<int64_t>(
          have_qprev ? rows_of(l, qs[l][x - 2]) : ones_off);
    }
    const double* penrow_base = s.penrow.data();
    const double* arow_base = s.arow.data();
    const double* crow_base = s.crow.data();

    const double* __restrict prev_best = &best[idx(x - 1, 0)];
    const double* __restrict prev_insx = &insx[idx(x - 1, 0)];
    double* __restrict row_best = &best[idx(x, 0)];
    double* __restrict row_insx = &insx[idx(x, 0)];
    double* __restrict row_insy = &insy[idx(x, 0)];

#if defined(__AVX2__)
    // Masks derive from the interleaved window codes with integer vector
    // ops (no gathers):
    //   can_match(c, w)     = (c & w) != 0
    //   fully_ambiguous(w)  = w == 0xF
    //   np(c, w) == 0.0     = (can_match && (popcount4(c|w) == 1 || amb==0))
    //                         || (!can_match && mutation==0)
    //   content-allow(c, w) = !(np == 0 || fully_ambiguous(c) || f.a.(w))
    // The only remaining gather is the overlay's penalty value, cached so
    // each gathered vector serves both the overlay (at y) and the insX
    // content term (at y+1).
    const __m256i v_off_pr = _mm256_loadu_si256((const __m256i*)off_pr);
    const __m256d v_zero = _mm256_setzero_pd();
    const __m256d v_dis = _mm256_set1_pd(DISALLOWED);
    const __m256d v_ins_open = _mm256_set1_pd(ins_open);
    const __m256d v_ins_ext = _mm256_set1_pd(p.ins_ext);
    const __m256d v_del_open = _mm256_set1_pd(del_open);
    const __m256d v_del_ext = _mm256_set1_pd(p.del_ext);
    const __m256i vi_zero = _mm256_setzero_si256();
    const __m256i vi_f = _mm256_set1_epi64x(0xF);
    const bool amb_zero = p.ambiguity == 0.0;
    const bool mut_zero = p.mutation == 0.0;
    const __m256i v_true = _mm256_set1_epi64x(-1);
    const __m256i v_qc = _mm256_set_epi64x(
        qs[3][x - 1] & 0xF, qs[2][x - 1] & 0xF, qs[1][x - 1] & 0xF,
        qs[0][x - 1] & 0xF);
    const __m256i v_qn =
        have_qnext ? _mm256_set_epi64x(qs[3][x] & 0xF, qs[2][x] & 0xF,
                                       qs[1][x] & 0xF, qs[0][x] & 0xF)
                   : vi_zero;
    const __m256i v_qp =
        have_qprev ? _mm256_set_epi64x(qs[3][x - 2] & 0xF, qs[2][x - 2] & 0xF,
                                       qs[1][x - 2] & 0xF, qs[0][x - 2] & 0xF)
                   : vi_zero;
    // per-lane fully-ambiguous flags for qc / qnext
    const __m256i amb_qc = _mm256_cmpeq_epi64(v_qc, vi_f);
    const __m256i amb_qn = _mm256_cmpeq_epi64(v_qn, vi_f);

    auto popcount4_v = [&](__m256i v) {
      __m256i c = _mm256_and_si256(v, _mm256_set1_epi64x(1));
      c = _mm256_add_epi64(
          c, _mm256_and_si256(_mm256_srli_epi64(v, 1), _mm256_set1_epi64x(1)));
      c = _mm256_add_epi64(
          c, _mm256_and_si256(_mm256_srli_epi64(v, 2), _mm256_set1_epi64x(1)));
      c = _mm256_add_epi64(
          c, _mm256_and_si256(_mm256_srli_epi64(v, 3), _mm256_set1_epi64x(1)));
      return c;
    };
    // content-allow mask for code-vector vc (with its amb flags) against
    // window codes vw: true when a NEW indel may open next to this pair
    auto content_allow = [&](__m256i vc, __m256i vamb_c, __m256i vw) {
      const __m256i cm =
          _mm256_xor_si256(_mm256_cmpeq_epi64(_mm256_and_si256(vc, vw), vi_zero),
                           v_true);  // can_match
      const __m256i pc1 = _mm256_cmpeq_epi64(
          popcount4_v(_mm256_or_si256(vc, vw)), _mm256_set1_epi64x(1));
      __m256i np0;  // np == 0.0
      if (amb_zero) {
        np0 = cm;
      } else {
        np0 = _mm256_and_si256(cm, pc1);
      }
      if (mut_zero) {
        np0 = _mm256_or_si256(np0, _mm256_xor_si256(cm, v_true));
      }
      const __m256i amb_w = _mm256_cmpeq_epi64(vw, vi_f);
      const __m256i blocked =
          _mm256_or_si256(np0, _mm256_or_si256(vamb_c, amb_w));
      return _mm256_xor_si256(blocked, v_true);  // as int64 all-ones mask
    };

    // fused insX + overlay pass: one penalty gather per y, reused for the
    // next y's insX content term
    __m256d pr_y = _mm256_i64gather_pd(
        penrow_base, _mm256_add_epi64(v_off_pr, _mm256_set1_epi64x(y_lo)), 8);
    const int y_mid = (y_hi == m) ? m - 1 : y_hi;
    int y = y_lo;
    for (; y <= y_mid; y++) {
      const __m256i w_y = _mm256_loadu_si256((const __m256i*)(wi + y * 4));
      const __m256i w_y1 =
          _mm256_loadu_si256((const __m256i*)(wi + (y + 1) * 4));
      const __m256d pr_next = _mm256_i64gather_pd(
          penrow_base, _mm256_add_epi64(v_off_pr, _mm256_set1_epi64x(y + 1)),
          8);
      // insX "new" allow: qprev must match w[y-1] (no constraint when x<2),
      // and the content term reads (qc, w[y]) via pr_next == 0 etc.
      __m256i arp_ok =
          have_qprev
              ? _mm256_xor_si256(
                    _mm256_cmpeq_epi64(_mm256_and_si256(v_qp, w_y), vi_zero),
                    v_true)
              : v_true;
      // content np uses the gathered pr_next for the np==0 test — identical
      // values to the scalar cr row (same table entries)
      const __m256i amb_w1 = _mm256_cmpeq_epi64(w_y1, vi_f);
      const __m256i np0 = _mm256_castpd_si256(
          _mm256_cmp_pd(pr_next, v_zero, _CMP_EQ_OQ));
      const __m256i blocked =
          _mm256_or_si256(np0, _mm256_or_si256(amb_qc, amb_w1));
      const __m256i allowed_i =
          _mm256_and_si256(arp_ok, _mm256_xor_si256(blocked, v_true));
      const __m256d allowed = _mm256_castsi256_pd(allowed_i);
      const __m256d pb = _mm256_loadu_pd(prev_best + y * 4);
      const __m256d new_ins =
          _mm256_blendv_pd(v_dis, _mm256_add_pd(pb, v_ins_open), allowed);
      const __m256d ext =
          _mm256_add_pd(_mm256_loadu_pd(prev_insx + y * 4), v_ins_ext);
      _mm256_storeu_pd(row_insx + y * 4, _mm256_min_pd(ext, new_ins));
      // overlay + premin at y
      const __m256d ov =
          _mm256_add_pd(_mm256_loadu_pd(prev_best + (y - 1) * 4), pr_y);
      _mm256_storeu_pd(row_best + y * 4,
                       _mm256_min_pd(_mm256_min_pd(ext, new_ins), ov));
      pr_y = pr_next;
    }
    if (y_hi == m && y <= y_hi) {  // y == m: insX has no content term
      const __m256i w_y = _mm256_loadu_si256((const __m256i*)(wi + m * 4));
      __m256i arp_ok =
          have_qprev
              ? _mm256_xor_si256(
                    _mm256_cmpeq_epi64(_mm256_and_si256(v_qp, w_y), vi_zero),
                    v_true)
              : v_true;
      const __m256d allowed = _mm256_castsi256_pd(arp_ok);
      const __m256d pb = _mm256_loadu_pd(prev_best + m * 4);
      const __m256d new_ins =
          _mm256_blendv_pd(v_dis, _mm256_add_pd(pb, v_ins_open), allowed);
      const __m256d ext =
          _mm256_add_pd(_mm256_loadu_pd(prev_insx + m * 4), v_ins_ext);
      _mm256_storeu_pd(row_insx + m * 4, _mm256_min_pd(ext, new_ins));
      const __m256d ov =
          _mm256_add_pd(_mm256_loadu_pd(prev_best + (m - 1) * 4), pr_y);
      _mm256_storeu_pd(row_best + m * 4,
                       _mm256_min_pd(_mm256_min_pd(ext, new_ins), ov));
    }
    if (y_hi == m && may_extend) {
      for (int l = 0; l < 4; l++)
        row_insx[m * 4 + l] = prev_best[m * 4 + l] + p.unaligned;
      // re-apply the premin with the overwritten insX value
      const __m256d ov =
          _mm256_add_pd(_mm256_loadu_pd(prev_best + (m - 1) * 4), pr_y);
      _mm256_storeu_pd(row_best + m * 4,
                       _mm256_min_pd(_mm256_loadu_pd(row_insx + m * 4), ov));
    }

    // sequential best/insY recurrence — carried along y, vector across lanes
    __m256d vb_prev = _mm256_loadu_pd(row_best + (y_lo - 1) * 4);
    __m256d viy_prev = _mm256_loadu_pd(row_insy + (y_lo - 1) * 4);
    int y2 = y_lo;
    for (; y2 <= y_hi; y2++) {
      const __m256i w_ym1 =
          _mm256_loadu_si256((const __m256i*)(wi + (y2 - 1) * 4));
      const __m256i w_y = _mm256_loadu_si256((const __m256i*)(wi + y2 * 4));
      __m256i arq_ok =
          (y2 >= 2)
              ? _mm256_xor_si256(
                    _mm256_cmpeq_epi64(_mm256_and_si256(v_qc, w_ym1), vi_zero),
                    v_true)
              : v_true;
      __m256i crn_ok = have_qnext ? content_allow(v_qn, amb_qn, w_y) : v_true;
      const __m256d allowed =
          _mm256_castsi256_pd(_mm256_and_si256(arq_ok, crn_ok));
      const __m256d new_del =
          _mm256_blendv_pd(v_dis, _mm256_add_pd(vb_prev, v_del_open), allowed);
      const __m256d iy =
          _mm256_min_pd(_mm256_add_pd(viy_prev, v_del_ext), new_del);
      const __m256d b = _mm256_min_pd(iy, _mm256_loadu_pd(row_best + y2 * 4));
      _mm256_storeu_pd(row_insy + y2 * 4, iy);
      _mm256_storeu_pd(row_best + y2 * 4, b);
      vb_prev = b;
      viy_prev = iy;
    }
#else
    const double* pr4[4];
    const double* arq4[4];
    const double* crq4[4];
    const double* crn4[4];
    const double* arp4[4];
    for (int l = 0; l < 4; l++) {
      pr4[l] = penrow_base + off_pr[l];
      arq4[l] = arow_base + off_arq[l];
      crq4[l] = crow_base + off_crq[l];
      crn4[l] = crow_base + off_crn[l];
      arp4[l] = arow_base + off_arp[l];
    }

    // insX pass
    for (int y = y_lo; y <= y_hi; y++) {
      for (int l = 0; l < 4; l++) {
        const bool allowed =
            (arp4[l][y] != 0.0) & (crq4[l][y + 1] != 0.0);
        const double new_ins =
            allowed ? prev_best[y * 4 + l] + ins_open : DISALLOWED;
        row_insx[y * 4 + l] =
            std::min(new_ins, prev_insx[y * 4 + l] + p.ins_ext);
      }
    }
    if (y_hi == m && may_extend)
      for (int l = 0; l < 4; l++)
        row_insx[m * 4 + l] = prev_best[m * 4 + l] + p.unaligned;

    // overlay pass, pre-minned with insX (as in the scalar fill)
    for (int y = y_lo; y <= y_hi; y++)
      for (int l = 0; l < 4; l++)
        row_best[y * 4 + l] = std::min(
            prev_best[(y - 1) * 4 + l] + pr4[l][y], row_insx[y * 4 + l]);

    // sequential best/insY recurrence — carried along y, vector across lanes
    double b_prev[4], iy_prev[4];
    for (int l = 0; l < 4; l++) {
      b_prev[l] = row_best[(y_lo - 1) * 4 + l];
      iy_prev[l] = row_insy[(y_lo - 1) * 4 + l];
    }
    int y = y_lo;
    for (; y < std::min(y_lo + 1, 2); y++) {  // peel y < 2 (y_lo >= 1)
      for (int l = 0; l < 4; l++) {
        const bool del_allowed = crn4[l][y] != 0.0;
        const double new_del =
            del_allowed ? b_prev[l] + del_open : DISALLOWED;
        const double iy = std::min(new_del, iy_prev[l] + p.del_ext);
        const double b = std::min(row_best[y * 4 + l], iy);
        row_insy[y * 4 + l] = iy;
        row_best[y * 4 + l] = b;
        b_prev[l] = b;
        iy_prev[l] = iy;
      }
    }
    for (; y <= y_hi; y++) {
      for (int l = 0; l < 4; l++) {
        const bool del_allowed =
            (arq4[l][y - 1] != 0.0) & (crn4[l][y] != 0.0);
        const double new_del =
            del_allowed ? b_prev[l] + del_open : DISALLOWED;
        const double iy = std::min(new_del, iy_prev[l] + p.del_ext);
        const double b = std::min(row_best[y * 4 + l], iy);
        row_insy[y * 4 + l] = iy;
        row_best[y * 4 + l] = b;
        b_prev[l] = b;
        iy_prev[l] = iy;
      }
    }
#endif
  }

  // per-lane goal scan + traceback (identical to the scalar fill's)
  for (int l = 0; l < 4; l++) {
    auto Bg = [&](int x, int y) -> double {
      return (y == 0 || (y >= wlo[x] && y <= whi[x])) ? best[idx(x, y) + l]
                                                      : DISALLOWED;
    };
    auto IXg = [&](int x, int y) -> double {
      return (y == 0 || (y >= wlo[x] && y <= whi[x])) ? insx[idx(x, y) + l]
                                                      : DISALLOWED;
    };
    auto IYg = [&](int x, int y) -> double {
      return (y == 0 || (y >= wlo[x] && y <= whi[x])) ? insy[idx(x, y) + l]
                                                      : DISALLOWED;
    };
    int goal_y = 0;
    double goal = Bg(n, 0);
    for (int y = 1; y <= m; y++) {
      const double v = Bg(n, y);
      if (v < goal) {
        goal = v;
        goal_y = y;
      }
    }
    goal_out[l] = goal;
    if (goal > max_interesting + 0.000001) {
      nb_out[l] = -1;
      continue;
    }
    int i = n, j = goal_y;
    int nb = 0;
    int32_t* out_blocks = blocks_out[l];
    bool overflow = false;
    auto emit = [&](int sa, int sb, int la, int lb) -> bool {
      if (nb >= max_blocks) return false;
      int32_t* row = out_blocks + static_cast<size_t>(nb) * 4;
      row[0] = sa; row[1] = sb; row[2] = la; row[3] = lb;
      nb++;
      return true;
    };
    while (i != 0 && j == m && may_extend && Bg(i, j) == IXg(i, j) &&
           IXg(i, j) == Bg(i - 1, j) + p.unaligned) {
      i -= 1;
    }
    while (i != 0 && j != 0) {
      const double b = Bg(i, j);
      if (b == IXg(i, j) && !(j == m && may_extend)) {
        const int old_i = i;
        i -= 1;
        while (i != 0) {
          const double other_new = Bg(i, j) + ins_open;
          const double other_ext = IXg(i, j) + p.ins_ext;
          if (other_new < other_ext) break;
          i -= 1;
        }
        if (!emit(i, j, old_i - i, 0)) { overflow = true; break; }
      } else if (b == IXg(i, j) && j == m && may_extend) {
        i -= 1;  // unaligned trailing step: no block
      } else if (b == IYg(i, j)) {
        const int old_j = j;
        j -= 1;
        while (j != 0) {
          const double other_new = Bg(i, j) + del_open;
          const double other_ext = IYg(i, j) + p.del_ext;
          if (other_new < other_ext) break;
          j -= 1;
        }
        if (!emit(i, j, 0, old_j - j)) { overflow = true; break; }
      } else {
        const int old_i = i, old_j = j;
        i -= 1;
        j -= 1;
        while (i != 0 && j != 0) {
          if (Bg(i, j) == IXg(i, j) || Bg(i, j) == IYg(i, j)) break;
          i -= 1;
          j -= 1;
        }
        if (!emit(i, j, old_i - i, old_j - j)) { overflow = true; break; }
      }
    }
    nb_out[l] = overflow ? -2 : nb;
  }
}

// The serial entry: pre -> scalar fill -> post (the batch entry below groups
// the fills instead).
int local_align_one(const uint8_t* q, int qn, const uint8_t* w, int wn,
                    long r_start_abs, int pred_local, bool at_ref_start,
                    bool at_ref_end, bool confident, double rate,
                    const Params& p, const PenaltyTable& tbl,
                    int32_t* blocks_out, int max_blocks, double* total_out,
                    double* aligned_out, DpScratch& scratch) {
  PreState st;
  const int pre = local_align_pre(q, qn, w, wn, r_start_abs, pred_local,
                                  at_ref_start, at_ref_end, confident, rate,
                                  p, tbl, st, blocks_out, total_out,
                                  aligned_out, scratch);
  if (pre != PRE_NEED_DP) return pre;
  const uint8_t* dq = st.search_reverse ? st.own_q.data() : q;
  const uint8_t* dw = st.search_reverse ? st.own_w.data() : w;
  double goal = 0.0;
  const int nb = dp_fill_traceback(dq, qn, dw, wn, p, tbl,
                                   st.may_extend ? 1 : 0, st.max_ins_budget,
                                   st.max_interesting_g, blocks_out,
                                   max_blocks, &goal, scratch);
  return local_align_post(st, nb, p, tbl, blocks_out, max_blocks, total_out,
                          aligned_out, scratch);
}

// ---------------------------------------------------------------------------
// Exact paired-combo driver (batch/engine.py::_align_paired_pair_exact_inner
// in C++, OpenMP across pairs — the round-5 wavefront fix for hard-PE).
//
// Scope: the NON-OVERLAP regime only.  Any combo whose inner distance goes
// negative (in the base run, a probe re-enumeration, or the replay check)
// needs the overlap join/split + duplicationBonus/overlapMultiplier algebra
// (QueryMatch_Aligner.java:274-405,464-520) and the whole pair bails to the
// Python oracle (status PYBAIL).  Everything else — the budget re-allocation
// loop (java:207-239), spacing penalty (java:530-546), the tightening
// MaxErrorRate + Max_PenaltySpan collection (java:35-54,71-92), and the
// batch engine's offset-invariance gate (alt probes, pair_inputs_replay,
// rows_reproduce, re-enumeration compare) — is replicated float-for-float;
// the Python driver is the differential-test oracle
// (tests/test_native_pair_driver.py).

namespace pairdrv {

constexpr int64_t kIntMax = 2147483647;  // candidates._INT_MAX

struct CompRes {
  int8_t kind;  // -1 none, 0 some
  double total = 0.0, aligned = 0.0;
  std::vector<Block> blocks;  // absolute sb
};

struct Choice {
  double spacing, total;
  int64_t inner;
  const CompRes* comp[2];
  uint8_t s[2];
  int32_t ref[2];
};

struct Override {
  int ci;
  int64_t row;
  int64_t alt;
};

struct AlignState {
  double cur_rate;
  double best_pen = 2147483647.0;  // float(2**31 - 1)
  std::vector<Choice> good;
};

struct PairCtx {
  const uint8_t* fwd[2];
  std::vector<uint8_t> rc[2];
  int len[2];
  int64_t total_len;
  double expected, dev;
  const int64_t* crow0;
  const int64_t* crow1;
  int64_t ncombos;
  const int64_t* row_off;
  const int32_t* row_ref;
  const uint8_t* row_rev;
  const uint8_t* concat;
  const int64_t* ref_starts;
  const int64_t* ref_lens;
  const Params* p;
  const PenaltyTable* tbl;
  double R, span;
  std::map<std::array<uint64_t, 3>, CompRes> memo;
  DpScratch* scratch;
  std::vector<int32_t> blkbuf;
  bool bail = false;

  const uint8_t* codes(int ci, bool s) const {
    return s ? rc[ci].data() : fwd[ci];
  }

  double dru(double a, double b) const {  // divide_round_up
    double r = a / b;
    if (r * b < a) r = std::nextafter(r, std::numeric_limits<double>::infinity());
    return r;
  }

  double spacing_pen(double inner) const {  // _compute_spacing_penalty
    if (inner < 0.0 && inner > -static_cast<double>(total_len)) return 0.0;
    return std::trunc(std::fabs(inner - expected) / dev);
  }

  struct MateRef {
    bool s;
    int32_t ref;
    int64_t off;
    int64_t row;
  };

  MateRef mate_ref(int64_t c, int ci, const std::vector<Override>& ov) const {
    MateRef m;
    m.row = (ci == 0 ? crow0 : crow1)[c];
    m.s = (row_rev[m.row] != 0) != (ci == 1);
    m.ref = row_ref[m.row];
    m.off = row_off[m.row];
    for (const Override& o : ov)
      if (o.ci == ci && o.row == m.row) {
        m.off = o.alt;
        break;
      }
    return m;
  }

  // QueryMatch.get_total_distance_between_components under overrides
  // (candidates.py:790-803 == engine.py::combo_inner)
  int64_t combo_inner(int64_t c, const std::vector<Override>& ov) const {
    const MateRef m0 = mate_ref(c, 0, ov);
    const MateRef m1 = mate_ref(c, 1, ov);
    if (m0.ref != m1.ref) return kIntMax;
    const int64_t L = ref_lens[m0.ref];
    const int64_t s0 = std::max<int64_t>(0, m0.off);
    const int64_t e0 = std::min<int64_t>(m0.off + len[0], L);
    const int64_t s1 = std::max<int64_t>(0, m1.off);
    const int64_t e1 = std::min<int64_t>(m1.off + len[1], L);
    return m0.s ? (s0 - e1) : (s1 - e0);
  }

  // query_aligner._align_match (memoized) -> dp.py::local_align
  const CompRes& align_match(int ci, bool s, int32_t ref, int64_t off, double rate) {
    uint64_t rate_bits;
    std::memcpy(&rate_bits, &rate, 8);
    const std::array<uint64_t, 3> key = {
        static_cast<uint64_t>((ci << 1) | (s ? 1 : 0)),
        (static_cast<uint64_t>(static_cast<uint32_t>(ref)) << 32) |
            static_cast<uint32_t>(static_cast<int32_t>(off)),
        rate_bits};
    auto it = memo.find(key);
    if (it != memo.end()) return it->second;
    CompRes res;
    res.kind = -1;
    const int qn = len[ci];
    const double mi = qn * rate;
    const int max_indel = static_cast<int>(
        std::max(0.0, (mi - p->del_start) / p->del_ext));
    const int64_t L = ref_lens[ref];
    const int64_t rs = std::max<int64_t>(0, off - max_indel);
    const int64_t re = std::min<int64_t>(off + qn + max_indel, L);
    if (re > rs) {
      const int wn = static_cast<int>(re - rs);
      if (blkbuf.size() < static_cast<size_t>(qn + wn + 4) * 4)
        blkbuf.resize(static_cast<size_t>(qn + wn + 4) * 4);
      double tot = 0.0, al = 0.0;
      const int st = local_align_one(
          codes(ci, s), qn, concat + ref_starts[ref] + rs, wn, rs,
          static_cast<int>(off - rs), rs == 0, re == L, /*confident=*/true,
          rate, *p, *tbl, blkbuf.data(), qn + wn + 4, &tot, &al, *scratch);
      if (st == -2) {
        bail = true;
      } else if (st >= 0) {
        res.kind = 0;
        res.total = tot;
        res.aligned = al;
        const int nb = st == 0 ? 1 : st;
        res.blocks.reserve(nb);
        for (int b = 0; b < nb; b++) {
          const int32_t* row = blkbuf.data() + static_cast<size_t>(b) * 4;
          res.blocks.push_back(
              Block{row[0], static_cast<int>(rs) + row[1], row[2], row[3]});
        }
      }
    }
    return memo.emplace(key, std::move(res)).first->second;
  }

  // QueryMatchAligner._do_align for one combo, non-overlap regime
  bool do_align(int64_t c, const std::vector<Override>& ov, AlignState& st,
                Choice* out) {
    const int64_t spacing_int = combo_inner(c, ov);
    const double inner = static_cast<double>(spacing_int);
    const double spag = spacing_pen(inner);
    const double max_allowed = std::nextafter(
        total_len * st.cur_rate, std::numeric_limits<double>::infinity());
    if (inner > 0.0) {
      // priority is 0 in this driver (QueryMatch(matches, 0, ...))
      if (spag > max_allowed) return false;
    }
    if (inner < 0.0) {  // overlap regime: join/split + bonus algebra
      bail = true;
      return false;
    }
    const double max_total = max_allowed - spag;
    const MateRef m[2] = {mate_ref(c, 0, ov), mate_ref(c, 1, ov)};
    const CompRes* results[2] = {nullptr, nullptr};
    bool remaining[2] = {true, true};
    double comps_pen = 0.0;
    int num_remaining = 2;
    // hint_forward_order=False -> indices [1, 0]
    static const int kIndices[2] = {1, 0};
    while (true) {
      const int64_t num_bases =
          (remaining[0] ? len[0] : 0) + (remaining[1] ? len[1] : 0);
      if (num_bases < 1) break;
      const double avg = dru(max_total - comps_pen, static_cast<double>(num_bases));
      bool found = false;
      for (int k = 0; k < 2; k++) {
        const int i = kIndices[k];
        if (!remaining[i]) continue;
        const CompRes& r = align_match(i, m[i].s, m[i].ref, m[i].off, avg);
        if (bail) return false;
        if (r.kind == 0) {
          results[i] = &r;
          remaining[i] = false;
          comps_pen += r.total;
          num_remaining--;
          found = true;
          break;
        }
      }
      if (num_remaining < 1) break;
      if (!found) return false;
    }
    const double total_used = comps_pen + spag;
    if (total_used > max_allowed) return false;
    // actual inner distance (QueryMatch_Aligner.java:261-265, forward-folded)
    int64_t actual_inner;
    if (m[0].s) {
      actual_inner = results[0]->blocks.front().sb -
                     (results[1]->blocks.back().sb + results[1]->blocks.back().lb);
    } else {
      actual_inner = results[1]->blocks.front().sb -
                     (results[0]->blocks.back().sb + results[0]->blocks.back().lb);
    }
    out->spacing = spag;
    out->total = total_used;
    out->inner = actual_inner;
    for (int ci = 0; ci < 2; ci++) {
      out->comp[ci] = results[ci];
      out->s[ci] = m[ci].s ? 1 : 0;
      out->ref[ci] = m[ci].ref;
    }
    return true;
  }

  // QueryMatchAligner.align wrapper (tightening MaxErrorRate)
  void align_combo(int64_t c, const std::vector<Override>& ov, AlignState& st) {
    Choice ch;
    if (!do_align(c, ov, st, &ch)) return;
    if (ch.total < st.best_pen) {
      st.best_pen = ch.total;
      const double new_rate = dru(ch.total + span, static_cast<double>(total_len));
      if (new_rate < st.cur_rate) st.cur_rate = new_rate;
    }
    st.good.push_back(ch);
  }

  static void comp_key_append(std::string& s, const Choice& ch, int ci) {
    // SequenceAlignment.content_key: (id(seq_b), reversed, blocks)
    s.append(reinterpret_cast<const char*>(&ch.ref[ci]), 4);
    s.push_back(static_cast<char>(ch.s[ci]));
    const auto& blocks = ch.comp[ci]->blocks;
    const uint32_t nb = static_cast<uint32_t>(blocks.size());
    s.append(reinterpret_cast<const char*>(&nb), 4);
    for (const Block& b : blocks)
      s.append(reinterpret_cast<const char*>(&b), sizeof(Block));
  }

  static std::string choice_key(const Choice& ch) {
    std::string s;
    comp_key_append(s, ch, 0);
    comp_key_append(s, ch, 1);
    return s;
  }

  // aligner.get_best_alignments (cutoff + first-wins content dedup)
  std::vector<Choice> get_best(const AlignState& st) const {
    const double max_anywhere = total_len * st.cur_rate;
    const double cutoff = std::min(st.best_pen + span, max_anywhere);
    std::vector<Choice> best;
    for (const Choice& ch : st.good)
      if (ch.total <= cutoff) best.push_back(ch);
    if (best.size() <= 1) return best;
    std::vector<std::string> seen;
    std::vector<Choice> uniq;
    for (const Choice& ch : best) {
      std::string k = choice_key(ch);
      bool dup = false;
      for (const std::string& s : seen)
        if (s == k) {
          dup = true;
          break;
        }
      if (!dup) {
        seen.push_back(std::move(k));
        uniq.push_back(ch);
      }
    }
    return uniq;
  }

  // engine.py::run(overrides)
  std::vector<Choice> run(const std::vector<Override>& ov) {
    AlignState st;
    st.cur_rate = R;
    for (int64_t c = 0; c < ncombos; c++) {
      align_combo(c, ov, st);
      if (bail) return {};
    }
    return get_best(st);
  }

  // engine.py::summarize: sorted (penalty, spacing, comps content key)
  static std::vector<std::string> summarize(const std::vector<Choice>& choices) {
    std::vector<std::string> out;
    out.reserve(choices.size());
    for (const Choice& ch : choices) {
      std::string s;
      s.append(reinterpret_cast<const char*>(&ch.total), 8);
      s.append(reinterpret_cast<const char*>(&ch.spacing), 8);
      s += choice_key(ch);
      out.push_back(std::move(s));
    }
    std::sort(out.begin(), out.end());
    return out;
  }

  bool pair_inputs_replay(const std::vector<Override>& ov) const {
    static const std::vector<Override> kNone;
    for (int64_t c = 0; c < ncombos; c++) {
      bool affected = false;
      for (const Override& o : ov)
        if ((o.ci == 0 && o.row == crow0[c]) || (o.ci == 1 && o.row == crow1[c])) {
          affected = true;
          break;
        }
      if (!affected) continue;
      const int64_t inner_base = combo_inner(c, kNone);
      const int64_t inner_alt = combo_inner(c, ov);
      if (inner_base < 0 || inner_alt < 0) return false;
      if ((inner_base > 0) != (inner_alt > 0)) return false;
      if (spacing_pen(static_cast<double>(inner_base)) !=
          spacing_pen(static_cast<double>(inner_alt)))
        return false;
    }
    return true;
  }

  static bool same_result(const CompRes& a, const CompRes& b) {
    if ((a.kind == -1) != (b.kind == -1)) return false;
    if (a.kind == -1) return true;
    // content_key equality: same (seq_a, ref) by construction, so blocks;
    // plus penalty and aligned_penalty
    if (a.total != b.total || a.aligned != b.aligned) return false;
    if (a.blocks.size() != b.blocks.size()) return false;
    for (size_t i = 0; i < a.blocks.size(); i++) {
      const Block &x = a.blocks[i], &y = b.blocks[i];
      if (x.sa != y.sa || x.sb != y.sb || x.la != y.la || x.lb != y.lb)
        return false;
    }
    return true;
  }

  bool rows_reproduce(
      const std::vector<Override>& ov,
      const std::map<std::array<uint64_t, 2>, std::vector<double>>& base_keys) {
    for (const Override& o : ov) {
      const bool s = (row_rev[o.row] != 0) != (o.ci == 1);
      const int32_t ref = row_ref[o.row];
      const int64_t voted = row_off[o.row];
      const std::array<uint64_t, 2> bk = {
          static_cast<uint64_t>((o.ci << 1) | (s ? 1 : 0)),
          (static_cast<uint64_t>(static_cast<uint32_t>(ref)) << 32) |
              static_cast<uint32_t>(static_cast<int32_t>(voted))};
      auto it = base_keys.find(bk);
      if (it == base_keys.end() || it->second.empty()) return false;
      for (double rate : it->second) {
        const CompRes& alt_res = align_match(o.ci, s, ref, o.alt, rate);
        if (bail) return false;
        uint64_t rate_bits;
        std::memcpy(&rate_bits, &rate, 8);
        const std::array<uint64_t, 3> base_key = {bk[0], bk[1], rate_bits};
        const CompRes& base_res = memo.at(base_key);
        if (!same_result(base_res, alt_res)) return false;
      }
    }
    return true;
  }
};

}  // namespace pairdrv

}  // namespace

extern "C" {

// Fills the DP tables and runs the traceback.
// q, w: 4-bit codes.  params: 8 doubles in Params order.
// may_extend: contig-edge unaligned-tail rules active (forward orientation).
// out_blocks: [max_blocks][4] = (start_a, start_b, len_a, len_b), local coords.
// Returns the number of blocks, or -1 when no goal state exists.
// out_goal_penalty receives the best goal penalty (search cost).
int mapper_dp_align(const uint8_t* q, int n, const uint8_t* w, int m,
                    const double* params_in, int may_extend,
                    double max_ins_ext, double max_interesting,
                    int32_t* out_blocks, int max_blocks,
                    double* out_goal_penalty) {
  Params p;
  std::memcpy(&p, params_in, sizeof(Params));
  const PenaltyTable tbl(p);
  DpScratch scratch;
  return dp_fill_traceback(q, n, w, m, p, tbl, may_extend, max_ins_ext,
                           max_interesting, out_blocks, max_blocks,
                           out_goal_penalty, scratch);
}

// Single-problem full local_align — the serial entry used by the sequential
// driver's per-call path (query_aligner._align_match).  Same conventions as
// the batch entry below; returns the status (-1 none, -2 python-fallback,
// 0 straight, n>=1 gapped with n blocks).
int mapper_local_align_one(const uint8_t* q, int qn, const uint8_t* w, int wn,
                           int64_t r_start_abs, int pred_local,
                           int at_ref_start, int at_ref_end, int confident,
                           double rate, const double* params_in,
                           int32_t* blocks_out, int max_blocks,
                           double* total_out, double* aligned_out) {
  Params p;
  std::memcpy(&p, params_in, sizeof(Params));
  const PenaltyTable tbl(p);
  thread_local DpScratch scratch;
  return local_align_one(q, qn, w, wn, r_start_abs, pred_local,
                         at_ref_start != 0, at_ref_end != 0, confident != 0,
                         rate, p, tbl, blocks_out, max_blocks, total_out,
                         aligned_out, scratch);
}

// Batched full local_align (dp.py::local_align semantics; see the namespace
// comment above).  Per problem i:
//   query codes qbuf[q_off[i] : q_off[i]+q_len[i]], window codes likewise,
//   r_start_abs[i] = absolute reference coordinate of the window start,
//   pred_local[i] = predicted best offset minus window start,
//   at_ref_start/at_ref_end: window touches the contig start/end,
//   confident[i]: analysis.confident_about_best_offset,
//   rates[i]: params.max_error_rate for this problem.
// Outputs per problem:
//   out_status[i]: -1 no alignment, 0 straight, 1 gapped, -2 fall back to
//                  the Python path;
//   out_nblocks[i] blocks at out_blocks[i*max_blocks_per*4 ...], local
//   coordinates, start->goal order; out_total/out_aligned penalties.
// Exact paired-combo driver over a batch of deferred pairs (see the pairdrv
// namespace comment).  Per pair i: mates at mate_codes[mate_off[2i..2i+1]]
// (forward 4-bit codes; reverse complements are derived via complement16),
// combos [combo_bounds[i], combo_bounds[i+1]) indexing combo_row0/row1,
// which index the full candidate-table arrays row_off/row_ref/row_rev.
// out_status[i]: 0 = ok (out_nchoices[i] choices written), 1 = sequential
// worker owns the pair (no alignments / gate tie), 2 = fall back to the
// Python driver (overlap regime, native DP bail, or output caps exceeded).
void mapper_pair_driver_batch(
    const uint8_t* concat, const int64_t* ref_starts, const int64_t* ref_lens,
    const uint8_t* mate_codes, const int64_t* mate_off, const int32_t* mate_len,
    const double* expected_inner, const double* spacing_dev,
    const int64_t* combo_bounds, const int64_t* combo_row0,
    const int64_t* combo_row1, const int64_t* row_off, const int32_t* row_ref,
    const uint8_t* row_rev, const uint8_t* complement16, int64_t npairs,
    const double* params8, double max_error_rate, double max_penalty_span,
    int32_t max_choices, int32_t max_blocks_out, int8_t* out_status,
    int32_t* out_nchoices, double* out_spacing, double* out_total,
    int64_t* out_inner, uint8_t* out_comp_s, int32_t* out_comp_ref,
    double* out_comp_total, double* out_comp_aligned, int32_t* out_comp_nb,
    int32_t* out_blocks) {
  Params p;
  std::memcpy(&p, params8, sizeof(Params));
  const PenaltyTable tbl(p);
#pragma omp parallel
  {
    DpScratch scratch;
#pragma omp for schedule(dynamic, 1)
    for (int64_t i = 0; i < npairs; i++) {
      pairdrv::PairCtx ctx;
      for (int ci = 0; ci < 2; ci++) {
        const int n = mate_len[2 * i + ci];
        ctx.fwd[ci] = mate_codes + mate_off[2 * i + ci];
        ctx.len[ci] = n;
        ctx.rc[ci].resize(n);
        for (int b = 0; b < n; b++)
          ctx.rc[ci][b] = complement16[ctx.fwd[ci][n - 1 - b] & 0xF];
      }
      ctx.total_len = ctx.len[0] + ctx.len[1];
      ctx.expected = expected_inner[i];
      ctx.dev = spacing_dev[i];
      ctx.crow0 = combo_row0 + combo_bounds[i];
      ctx.crow1 = combo_row1 + combo_bounds[i];
      ctx.ncombos = combo_bounds[i + 1] - combo_bounds[i];
      ctx.row_off = row_off;
      ctx.row_ref = row_ref;
      ctx.row_rev = row_rev;
      ctx.concat = concat;
      ctx.ref_starts = ref_starts;
      ctx.ref_lens = ref_lens;
      ctx.p = &p;
      ctx.tbl = &tbl;
      ctx.R = max_error_rate;
      ctx.span = max_penalty_span;
      ctx.scratch = &scratch;

      out_nchoices[i] = 0;
      std::vector<pairdrv::Choice> best = ctx.run({});
      if (ctx.bail) {
        out_status[i] = 2;
        continue;
      }
      if (best.empty()) {
        out_status[i] = 1;  // mate-rescue paths: sequential worker decides
        continue;
      }

      // offset-invariance gate (engine.py:857-995)
      std::set<std::pair<int, int64_t>> probes;
      for (const pairdrv::Choice& ch : best) {
        for (int ci = 0; ci < 2; ci++) {
          const auto& blocks = ch.comp[ci]->blocks;
          bool has_indel = false;
          for (const Block& b : blocks)
            if (b.la != b.lb) {
              has_indel = true;
              break;
            }
          if (!has_indel) continue;
          for (const Block& b : blocks)
            if (b.la == b.lb && b.la > 0)
              probes.insert({ci, static_cast<int64_t>(b.sb) - b.sa});
        }
      }
      bool worker_owns = false;
      if (!probes.empty()) {
        const int64_t budget = static_cast<int64_t>(std::max(
            0.0, (ctx.total_len * ctx.R - p.del_start) / p.del_ext));
        const std::vector<std::string> base_summary = pairdrv::PairCtx::summarize(best);
        // memo keys recorded by the base run, per (seq_a, ref, voted offset)
        std::map<std::array<uint64_t, 2>, std::vector<double>> base_keys;
        for (const auto& kv : ctx.memo) {
          double rate;
          std::memcpy(&rate, &kv.first[2], 8);
          base_keys[{kv.first[0], kv.first[1]}].push_back(rate);
        }
        for (const auto& probe : probes) {
          const int ci = probe.first;
          const int64_t alt = probe.second;
          std::vector<pairdrv::Override> ov;
          for (int64_t c = 0; c < ctx.ncombos; c++) {
            const int64_t r = (ci == 0 ? ctx.crow0 : ctx.crow1)[c];
            const int64_t off = row_off[r];
            if (off == alt || std::llabs(off - alt) > budget) continue;
            bool dup = false;
            for (const pairdrv::Override& o : ov)
              if (o.ci == ci && o.row == r) {
                dup = true;
                break;
              }
            if (!dup) ov.push_back(pairdrv::Override{ci, r, alt});
          }
          if (ov.empty()) continue;
          if (ctx.pair_inputs_replay(ov) && ctx.rows_reproduce(ov, base_keys)) {
            if (ctx.bail) break;
            continue;  // lockstep replay: full enumeration unchanged
          }
          if (ctx.bail) break;
          const std::vector<pairdrv::Choice> alt_best = ctx.run(ov);
          if (ctx.bail) break;
          if (pairdrv::PairCtx::summarize(alt_best) != base_summary) {
            worker_owns = true;  // sequential worker owns the tie
            break;
          }
        }
      }
      if (ctx.bail) {
        out_status[i] = 2;
        continue;
      }
      if (worker_owns) {
        out_status[i] = 1;
        continue;
      }
      if (static_cast<int32_t>(best.size()) > max_choices) {
        out_status[i] = 2;
        continue;
      }
      bool overflow = false;
      for (size_t j = 0; j < best.size() && !overflow; j++)
        for (int ci = 0; ci < 2; ci++)
          if (static_cast<int32_t>(best[j].comp[ci]->blocks.size()) >
              max_blocks_out)
            overflow = true;
      if (overflow) {
        out_status[i] = 2;
        continue;
      }
      for (size_t j = 0; j < best.size(); j++) {
        const pairdrv::Choice& ch = best[j];
        const int64_t gi = i * max_choices + static_cast<int64_t>(j);
        out_spacing[gi] = ch.spacing;
        out_total[gi] = ch.total;
        out_inner[gi] = ch.inner;
        for (int ci = 0; ci < 2; ci++) {
          const int64_t gc = gi * 2 + ci;
          out_comp_s[gc] = ch.s[ci];
          out_comp_ref[gc] = ch.ref[ci];
          out_comp_total[gc] = ch.comp[ci]->total;
          out_comp_aligned[gc] = ch.comp[ci]->aligned;
          const auto& blocks = ch.comp[ci]->blocks;
          out_comp_nb[gc] = static_cast<int32_t>(blocks.size());
          int32_t* dst = out_blocks + gc * max_blocks_out * 4;
          for (size_t b = 0; b < blocks.size(); b++) {
            dst[b * 4 + 0] = blocks[b].sa;
            dst[b * 4 + 1] = blocks[b].sb;
            dst[b * 4 + 2] = blocks[b].la;
            dst[b * 4 + 3] = blocks[b].lb;
          }
        }
      }
      out_nchoices[i] = static_cast<int32_t>(best.size());
      out_status[i] = 0;
    }
  }
}

void mapper_local_align_batch(
    const uint8_t* qbuf, const int64_t* q_off, const int32_t* q_len,
    const uint8_t* wbuf, const int64_t* w_off, const int32_t* w_len,
    const int64_t* r_start_abs, const int32_t* pred_local,
    const uint8_t* at_ref_start, const uint8_t* at_ref_end,
    const uint8_t* confident, const double* rates, int k,
    const double* params_in, int8_t* out_status, int32_t* out_nblocks,
    int32_t* out_blocks, int32_t max_blocks_per, double* out_total,
    double* out_aligned) {
  Params p;
  std::memcpy(&p, params_in, sizeof(Params));
  const PenaltyTable tbl(p);
  // Default-on (MAPPER_TPU_SIMD_WAVE=0 reverts to the per-problem scalar
  // loop): the four-lane grouped fill with AVX2 intrinsics — one cached
  // penalty gather per y, every mask derived from interleaved window codes
  // with integer vector ops — measures 66 vs 117 ms per 3042-problem
  // hard-SE wave (BENCH.md "SIMD wave").  Auto-vectorization alone made it
  // SLOWER (273 ms): the per-lane row pointers defeat GCC's SLP, which is
  // why the AVX2 block exists.  Byte-identity vs the scalar path is pinned
  // by test_simd_wave_batch_matches_scalar.
  const char* env = getenv("MAPPER_TPU_SIMD_WAVE");
#if defined(__AVX2__)
  const bool use_x4 = !(env && env[0] == '0');
#else
  const bool use_x4 = env && env[0] == '1';
#endif

  auto write_status = [&](int i, int r) {
    if (r == -1 || r == -2) {
      out_status[i] = static_cast<int8_t>(r);
      out_nblocks[i] = 0;
    } else if (r == 0) {
      out_status[i] = 0;
      out_nblocks[i] = 1;
    } else {
      out_status[i] = 1;
      out_nblocks[i] = r;
    }
  };
  auto blocks_of = [&](int i) -> int32_t* {
    return out_blocks + static_cast<size_t>(i) * max_blocks_per * 4;
  };

  if (!use_x4) {
#pragma omp parallel
    {
      DpScratch scratch;
#pragma omp for schedule(dynamic, 8)
      for (int i = 0; i < k; i++) {
        const int r = local_align_one(
            qbuf + q_off[i], q_len[i], wbuf + w_off[i], w_len[i],
            r_start_abs[i], pred_local[i], at_ref_start[i] != 0,
            at_ref_end[i] != 0, confident[i] != 0, rates[i], p, tbl,
            blocks_of(i), max_blocks_per, &out_total[i], &out_aligned[i],
            scratch);
        write_status(i, r);
      }
    }
    return;
  }

  // stage 1: pre per problem (straight check, early exits, search direction)
  std::vector<PreState> states(k);
  std::vector<int8_t> need_dp(k, 0);
#pragma omp parallel
  {
    DpScratch scratch;
#pragma omp for schedule(dynamic, 16)
    for (int i = 0; i < k; i++) {
      const int r = local_align_pre(
          qbuf + q_off[i], q_len[i], wbuf + w_off[i], w_len[i],
          r_start_abs[i], pred_local[i], at_ref_start[i] != 0,
          at_ref_end[i] != 0, confident[i] != 0, rates[i], p, tbl, states[i],
          blocks_of(i), &out_total[i], &out_aligned[i], scratch);
      if (r == PRE_NEED_DP) {
        need_dp[i] = 1;
      } else {
        write_status(i, r);
      }
    }
  }

  // stage 2: group DP fills by exact geometry — the banded fill's shape
  // depends only on (n, m, may_extend, budgets), so same-key problems run
  // four-at-a-time in SIMD lanes with bit-identical per-lane values
  struct Key {
    int qn, wn;
    bool may_extend;
    uint64_t ins_bits, mig_bits;
    bool operator<(const Key& o) const {
      if (qn != o.qn) return qn < o.qn;
      if (wn != o.wn) return wn < o.wn;
      if (may_extend != o.may_extend) return may_extend < o.may_extend;
      if (ins_bits != o.ins_bits) return ins_bits < o.ins_bits;
      return mig_bits < o.mig_bits;
    }
  };
  std::map<Key, std::vector<int>> groups;
  for (int i = 0; i < k; i++) {
    if (!need_dp[i]) continue;
    const PreState& st = states[i];
    Key key;
    key.qn = st.qn;
    key.wn = st.wn;
    key.may_extend = st.may_extend;
    std::memcpy(&key.ins_bits, &st.max_ins_budget, 8);
    std::memcpy(&key.mig_bits, &st.max_interesting_g, 8);
    groups[key].push_back(i);
  }
  struct WorkItem {
    int idx[4];
    int n;
  };
  std::vector<WorkItem> items;
  for (auto& kv : groups) {
    const std::vector<int>& g = kv.second;
    size_t pos = 0;
    while (pos + 4 <= g.size()) {
      items.push_back(WorkItem{{g[pos], g[pos + 1], g[pos + 2], g[pos + 3]}, 4});
      pos += 4;
    }
    while (pos < g.size()) {
      items.push_back(WorkItem{{g[pos], 0, 0, 0}, 1});
      pos++;
    }
  }

  // stage 3: grouped fills + per-problem post
  const int num_items = static_cast<int>(items.size());
#pragma omp parallel
  {
    DpScratch scratch;
    DpScratch4 s4;
#pragma omp for schedule(dynamic, 1)
    for (int it = 0; it < num_items; it++) {
      const WorkItem& wi = items[it];
      if (wi.n == 4) {
        const uint8_t* qs4[4];
        const uint8_t* ws4[4];
        int32_t* b4[4];
        for (int l = 0; l < 4; l++) {
          const PreState& st = states[wi.idx[l]];
          qs4[l] = st.search_reverse ? st.own_q.data()
                                     : qbuf + q_off[wi.idx[l]];
          ws4[l] = st.search_reverse ? st.own_w.data()
                                     : wbuf + w_off[wi.idx[l]];
          b4[l] = blocks_of(wi.idx[l]);
        }
        const PreState& st0 = states[wi.idx[0]];
        int nb4[4];
        double goal4[4];
        dp_fill_x4(qs4, st0.qn, ws4, st0.wn, p, tbl,
                   st0.may_extend ? 1 : 0, st0.max_ins_budget,
                   st0.max_interesting_g, b4, max_blocks_per, nb4, goal4, s4);
        for (int l = 0; l < 4; l++) {
          const int i = wi.idx[l];
          const int r = local_align_post(states[i], nb4[l], p, tbl,
                                         blocks_of(i), max_blocks_per,
                                         &out_total[i], &out_aligned[i],
                                         scratch);
          write_status(i, r);
        }
      } else {
        const int i = wi.idx[0];
        const PreState& st = states[i];
        const uint8_t* dq =
            st.search_reverse ? st.own_q.data() : qbuf + q_off[i];
        const uint8_t* dw =
            st.search_reverse ? st.own_w.data() : wbuf + w_off[i];
        double goal = 0.0;
        const int nb = dp_fill_traceback(
            dq, st.qn, dw, st.wn, p, tbl, st.may_extend ? 1 : 0,
            st.max_ins_budget, st.max_interesting_g, blocks_of(i),
            max_blocks_per, &goal, scratch);
        const int r = local_align_post(st, nb, p, tbl, blocks_of(i),
                                       max_blocks_per, &out_total[i],
                                       &out_aligned[i], scratch);
        write_status(i, r);
      }
    }
  }
}

}  // extern "C"
