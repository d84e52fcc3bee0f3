// Native fast paths for vbcs_tpu (C++17, no external deps).
//
// Performance-critical host-side routines, mirroring the roles the
// reference implements with specialized Julia (SURVEY.md §2.3, §2.9):
//
//  * dp_partition — the DynamicTotalChunker split-point DP
//    (ChainPartitioners' optimal partitioner; O(nnz + n*W*R) with the
//    last-occurrence sliding-window counters described in
//    vbcs_tpu/plan/dynamic.py).  Covers every 1-D cost model via
//    per-width alpha/beta/gamma tables and separable rank-R 2-D models
//    via weighted group counters.
//
//  * pack_1dvbc — the two-pass CSC -> 1D-VBC converter (reference
//    src/constructors_1DVBC.jl:9-92): pass 1 counts distinct rows per
//    stripe with a last-seen histogram, pass 2 merges column lists into
//    zero-filled w-wide blocks.
//
// Exposed with C linkage for ctypes.  All indices are int64, 0-based.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>
#include <algorithm>
#include <array>
#include <functional>

extern "C" {

// Optimal split-point DP.
//
//   n            number of columns
//   num_groups   distinct-count granularity (rows for 1-D, row-blocks
//                for 2-D models)
//   pos[n+1]     CSC column pointers
//   grp[nnz]     group id per nonzero (row id, or row-block id)
//   W            max stripe width
//   R            number of weighted counters (1 for 1-D models)
//   alpha_tab[W]     per-width fixed stripe cost
//   beta_tabs[R*W]   per-width per-distinct-group cost, R major
//   gamma_tab[W]     per-width per-nonzero cost (may be null)
//   weights[R*num_groups] counter weights (may be null => unit, R=1)
//   delta_tab[W]     per-width per-EXCESS-8-block-group cost (may be
//                    null; charges max(ceil(distinct/8) - 1, 0) — the
//                    v3 kernel's multi-group scan/straddle machinery;
//                    only meaningful with unit weights, R = 1)
//   out_spl[n+1] resulting split points (0-based), out_len the count+1
//
// Tie-break: narrowest stripe wins (first minimum over widths 1..W).
void dp_partition(int64_t n, int64_t num_groups, const int64_t* pos,
                  const int64_t* grp, int64_t W, int64_t R,
                  const double* alpha_tab, const double* beta_tabs,
                  const double* gamma_tab, const double* weights,
                  const double* delta_tab,
                  int64_t* out_spl, int64_t* out_len) {
  std::vector<int64_t> lst(static_cast<size_t>(num_groups > 0 ? num_groups : 1),
                           -1);
  // cnt[r][c]: weight of groups whose last occurrence is column c
  std::vector<double> cnt(static_cast<size_t>(R * n), 0.0);
  std::vector<double> opt(static_cast<size_t>(n + 1),
                          std::numeric_limits<double>::infinity());
  std::vector<int64_t> prev(static_cast<size_t>(n + 1), 0);
  std::vector<double> win(static_cast<size_t>(R * W), 0.0);
  opt[0] = 0.0;

  for (int64_t jp = 1; jp <= n; ++jp) {
    const int64_t c = jp - 1;
    for (int64_t q = pos[c]; q < pos[c + 1]; ++q) {
      const int64_t g = grp[q];
      const int64_t old = lst[g];
      for (int64_t r = 0; r < R; ++r) {
        const double wgt = weights ? weights[r * num_groups + g] : 1.0;
        if (old >= 0) cnt[r * n + old] -= wgt;
        cnt[r * n + c] += wgt;
      }
      lst[g] = c;
    }
    const int64_t W_eff = W < jp ? W : jp;
    // suffix sums over the window, widths 1..W_eff
    double best = std::numeric_limits<double>::infinity();
    int64_t best_j = jp - 1;
    for (int64_t r = 0; r < R; ++r) win[r * W] = 0.0;  // scratch slot
    double acc[8 > 1 ? 8 : 1];  // small-R fast path storage
    std::vector<double> accv;
    double* a;
    if (R <= 8) {
      a = acc;
    } else {
      accv.assign(static_cast<size_t>(R), 0.0);
      a = accv.data();
    }
    for (int64_t r = 0; r < R; ++r) a[r] = 0.0;
    for (int64_t wdt = 1; wdt <= W_eff; ++wdt) {
      const int64_t j = jp - wdt;
      for (int64_t r = 0; r < R; ++r) a[r] += cnt[r * n + j];
      // stripe cost accumulated FIRST, opt[j] added LAST — the exact
      // float-addition order of the NumPy oracle's
      // ``opt[j] + cost_fn(...)`` (integer-valued tables masked the
      // difference; the fitted time model's fractional tables exposed
      // tie flips between the two orders)
      double stripe = alpha_tab[wdt - 1];
      for (int64_t r = 0; r < R; ++r)
        stripe += a[r] * beta_tabs[r * W + wdt - 1];
      if (gamma_tab)
        stripe += gamma_tab[wdt - 1] * static_cast<double>(pos[jp] - pos[j]);
      if (delta_tab) {
        const int64_t nb = static_cast<int64_t>(a[0] + 0.5);
        const int64_t excess = (nb + 7) / 8 - 1;
        if (excess > 0)
          stripe += delta_tab[wdt - 1] * static_cast<double>(excess);
      }
      const double cost = opt[j] + stripe;
      if (cost < best) {
        best = cost;
        best_j = j;
      }
    }
    opt[jp] = best;
    prev[jp] = best_j;
  }

  // backtrack
  std::vector<int64_t> rev;
  int64_t j = n;
  rev.push_back(j);
  while (j > 0) {
    j = prev[j];
    rev.push_back(j);
  }
  const int64_t len = static_cast<int64_t>(rev.size());
  for (int64_t i = 0; i < len; ++i) out_spl[i] = rev[len - 1 - i];
  *out_len = len;
}

// Pass 1 of CSC -> 1D-VBC: count distinct rows per stripe.
//   spl[L+1] column partition; out pos[L+1], ofs[L+1] (0-based, pos[0]=0)
void pack_1dvbc_count(int64_t m, int64_t n, const int64_t* pos,
                      const int64_t* idx, int64_t L, const int64_t* spl,
                      int64_t* out_pos, int64_t* out_ofs) {
  std::vector<int64_t> hst(static_cast<size_t>(m > 0 ? m : 1), -1);
  out_pos[0] = 0;
  out_ofs[0] = 0;
  for (int64_t l = 0; l < L; ++l) {
    const int64_t j0 = spl[l], j1 = spl[l + 1];
    int64_t blocks = 0;
    for (int64_t q = pos[j0]; q < pos[j1]; ++q) {
      const int64_t i = idx[q];
      if (hst[i] < l) {
        ++blocks;
        hst[i] = l;
      }
    }
    out_pos[l + 1] = out_pos[l] + blocks;
    out_ofs[l + 1] = out_ofs[l] + blocks * (j1 - j0);
  }
}

// Pass 2: w-way merge of each stripe's column lists into blocks
// (float64 values).  out_idx sized pos[L], out_val sized ofs[L], both
// preallocated; out_val must be zero-initialized by the caller.
void pack_1dvbc_fill(int64_t m, int64_t n, const int64_t* pos,
                     const int64_t* idx, const double* val, int64_t L,
                     const int64_t* spl, const int64_t* bpos,
                     const int64_t* bofs, int64_t* out_idx,
                     double* out_val) {
  std::vector<int64_t> cur(64);
  for (int64_t l = 0; l < L; ++l) {
    const int64_t j0 = spl[l], j1 = spl[l + 1];
    const int64_t w = j1 - j0;
    if (w == 1) {
      int64_t Q = bpos[l], q = bofs[l];
      for (int64_t p = pos[j0]; p < pos[j0 + 1]; ++p) {
        out_idx[Q++] = idx[p];
        out_val[q++] = val[p];
      }
      continue;
    }
    if (static_cast<int64_t>(cur.size()) < w) cur.resize(w);
    for (int64_t d = 0; d < w; ++d) cur[d] = pos[j0 + d];
    int64_t Q = bpos[l], q = bofs[l];
    for (;;) {
      int64_t i = std::numeric_limits<int64_t>::max();
      for (int64_t d = 0; d < w; ++d)
        if (cur[d] < pos[j0 + d + 1] && idx[cur[d]] < i) i = idx[cur[d]];
      if (i == std::numeric_limits<int64_t>::max()) break;
      for (int64_t d = 0; d < w; ++d) {
        if (cur[d] < pos[j0 + d + 1] && idx[cur[d]] == i) {
          out_val[q] = val[cur[d]];
          ++cur[d];
        }  // else leave the zero fill
        ++q;
      }
      out_idx[Q++] = i;
    }
  }
}

// Chunk planning for the Pallas stream packer (pallas_trspmv2
// _pack_class): pack stripes' 8-block groups into chunks of at most NG
// groups / NS stripe slots, splitting oversize stripes across chunks
// (straddle).  Direct port of the Python loop; outputs are identical.
// piece_* sized >= S + total_groups/NG + 2; straddle/nslots sized the
// same (chunk count + 1 <= piece count).  Returns the piece count and
// writes the chunk count to out_nchunks.
void stream_chunk_plan(int64_t S, const int64_t* ngr, int64_t NGc,
                       int64_t NSc, int64_t* piece_i, int64_t* piece_g0,
                       int64_t* piece_g1, int64_t* piece_chunk,
                       int64_t* straddle, int64_t* nslots,
                       int64_t* out_npieces, int64_t* out_nchunks) {
  int64_t g_in_chunk = 0, s_in_chunk = 0, chunk = 0, np = 0;
  for (int64_t i = 0; i < S; ++i) {
    int64_t left = ngr[i] > 1 ? ngr[i] : 1;
    int64_t g0 = 0;
    if (s_in_chunk >= NSc || g_in_chunk >= NGc) {
      straddle[chunk] = 0;
      nslots[chunk] = s_in_chunk;
      ++chunk;
      g_in_chunk = 0;
      s_in_chunk = 0;
    }
    while (left > 0) {
      int64_t room = NGc - g_in_chunk;
      int64_t take = room < left ? room : left;
      piece_i[np] = i;
      piece_g0[np] = g0;
      piece_g1[np] = g0 + take;
      piece_chunk[np] = chunk;
      ++np;
      g_in_chunk += take;
      g0 += take;
      left -= take;
      if (left > 0) {
        straddle[chunk] = 1;
        nslots[chunk] = s_in_chunk;
        ++chunk;
        g_in_chunk = 0;
        s_in_chunk = 0;
      }
    }
    ++s_in_chunk;
  }
  straddle[chunk] = 0;
  nslots[chunk] = s_in_chunk;
  *out_npieces = np;
  *out_nchunks = chunk + 1;
}

}  // extern "C"

extern "C" {

// Greedy overlap chunker (reference OverlapChunker(rho, w_max)): a
// column joins the current stripe when |rows(c) & rows(c0)| >=
// rho * max(|rows(c)|, |rows(c0)|) against the stripe's leading column.
// Writes split points; returns count via out_len.
void overlap_chunk(int64_t n, const int64_t* pos, const int64_t* idx,
                   double rho, int64_t w_max, int64_t* out_spl,
                   int64_t* out_len) {
  int64_t count = 0;
  out_spl[count++] = 0;
  if (n == 0) {
    *out_len = count;
    return;
  }
  int64_t c0 = 0;
  for (int64_t c = 1; c < n; ++c) {
    const int64_t width = c - c0;
    bool ok = false;
    if (width < w_max) {
      const int64_t a0 = pos[c0], a1 = pos[c0 + 1];
      const int64_t b0 = pos[c], b1 = pos[c + 1];
      const int64_t la = a1 - a0, lb = b1 - b0;
      const int64_t denom = la > lb ? la : lb;
      if (denom == 0) {
        ok = true;  // two empty columns always merge
      } else {
        int64_t i = a0, j = b0, inter = 0;
        while (i < a1 && j < b1) {
          if (idx[i] < idx[j]) ++i;
          else if (idx[i] > idx[j]) ++j;
          else { ++inter; ++i; ++j; }
        }
        ok = static_cast<double>(inter) >= rho * static_cast<double>(denom);
      }
    }
    if (!ok) {
      out_spl[count++] = c;
      c0 = c;
    }
  }
  out_spl[count++] = n;
  *out_len = count;
}

}  // extern "C"

extern "C" {

// Joint A-table matcher for the v3 stream packer (pallas_trspmv3
// _match_joint): assign each 8-block group's blocks to distinct
// sublanes such that every x-layout mode's per-window A-table cells
// (window, sublane, lane-offset) are consistent.  Exact port of the
// Python oracle — identical outputs, including DFS order, retry
// rotation, duplication hints and reflow decisions.
//
//   M <= 2 modes; tables/win_tiles/nwin_v/sub_assign/win_assign are
//   caller-allocated and pre-filled (-1 / -1 / 0 / 0 / 0).  Failed
//   stripes (reflow requests) are appended to `failed` (may contain
//   duplicates; caller dedups).  MJ_W == MAX_NWIN == 7.
static const int MJ_W = 7;

void match_joint(int64_t T, int64_t nv, int64_t M, int64_t nblk,
                 const int64_t* vreg_of_blk, const uint8_t* real,
                 const int64_t* hs_a, const int64_t* tile_a,
                 const int64_t* lo_a, const int64_t* stripe_of_grp,
                 int64_t* sub_assign, int64_t* win_assign,
                 int64_t* win_tiles, int16_t* tables, int64_t* nwin_v,
                 int64_t* failed, int64_t* n_failed) {
  const int64_t ngrp = nblk / 8;
  const int64_t nvreg = T * nv;
  *n_failed = 0;
  // group -> vreg (blocks of a group share one vreg); groups are laid
  // out vreg-major, so boundaries come from a counting pass
  std::vector<int64_t> vstart(static_cast<size_t>(nvreg) + 1, 0);
  {
    std::vector<int64_t> cnt(static_cast<size_t>(nvreg) + 1, 0);
    for (int64_t g = 0; g < ngrp; ++g) ++cnt[vreg_of_blk[g * 8] + 1];
    for (int64_t v = 0; v < nvreg; ++v) cnt[v + 1] += cnt[v];
    for (int64_t v = 0; v <= nvreg; ++v) vstart[v] = cnt[v];
  }

  struct Opt { int si; int j[2]; };
  struct Cand {
    int nopts;
    int64_t hs[2], tb[2], lob[2];
    long starve[2];
    int b;
    int ofirst;
  };
  std::vector<Opt> optpool;
  std::vector<Cand> cands;
  std::vector<int64_t> order;

  for (int64_t v = 0; v < nvreg; ++v) {
    const int64_t g0 = vstart[v], g1 = vstart[v + 1];
    if (g0 >= g1) continue;
    int64_t dup_hints[2][MJ_W];
    int ndup[2] = {0, 0};
    int shuffles = 0;
    int16_t* tabs[2] = {nullptr, nullptr};
    int64_t* wts[2] = {nullptr, nullptr};
    int nw[2] = {0, 0};
    for (int retry = 0; retry < MJ_W + 4; ++retry) {
      for (int mo = 0; mo < M; ++mo) {
        tabs[mo] = tables + (static_cast<int64_t>(mo) * nvreg + v) * MJ_W * 1024;
        std::fill(tabs[mo], tabs[mo] + MJ_W * 1024, static_cast<int16_t>(-1));
        wts[mo] = win_tiles + (static_cast<int64_t>(mo) * nvreg + v) * MJ_W;
        std::fill(wts[mo], wts[mo] + MJ_W, static_cast<int64_t>(-1));
        nw[mo] = 0;
        for (int h = 0; h < ndup[mo]; ++h)
          if (nw[mo] < MJ_W) wts[mo][nw[mo]++] = dup_hints[mo][h];
      }
      bool vreg_ok = true;
      int hard_mo = -1;
      int64_t hard_tb = -1;
      const int len = static_cast<int>(g1 - g0);
      order.resize(len);
      for (int k = 0; k < len; ++k) order[k] = g0 + k;
      if (shuffles > 0) {  // deterministic rotated restarts
        const int r = (shuffles * 37) % (len > 1 ? len : 1);
        std::rotate(order.begin(), order.begin() + r, order.end());
        std::reverse(order.begin(), order.end());
      }
      for (int gi = 0; gi < len; ++gi) {
        const int64_t g = order[gi];
        int reals[8], nre = 0;
        for (int b = 0; b < 8; ++b)
          if (real[g * 8 + b]) reals[nre++] = b;
        if (nre == 0) continue;
        // ensure a window exists for every block tile, per mode
        for (int mo = 0; mo < M && vreg_ok; ++mo) {
          for (int ri = 0; ri < nre; ++ri) {
            const int64_t tb = tile_a[mo * nblk + g * 8 + reals[ri]];
            bool found = false;
            for (int j = 0; j < nw[mo]; ++j)
              if (wts[mo][j] == tb) { found = true; break; }
            if (!found) {
              if (nw[mo] >= MJ_W) { vreg_ok = false; break; }
              wts[mo][nw[mo]++] = tb;
            }
          }
        }
        if (!vreg_ok) break;
        // candidate (si, window-per-mode) options per block
        optpool.clear();
        cands.clear();
        for (int ri = 0; ri < nre; ++ri) {
          const int b = reals[ri];
          Cand c;
          c.b = b;
          c.starve[0] = c.starve[1] = 0;
          for (int mo = 0; mo < M; ++mo) {
            c.hs[mo] = hs_a[mo * nblk + g * 8 + b];
            c.tb[mo] = tile_a[mo * nblk + g * 8 + b];
            c.lob[mo] = lo_a[mo * nblk + g * 8 + b];
          }
          c.ofirst = static_cast<int>(optpool.size());
          int nopts = 0;
          for (int si = 0; si < 8; ++si) {
            int js[2][MJ_W], njs[2] = {0, 0};
            for (int mo = 0; mo < M; ++mo) {
              for (int j = 0; j < nw[mo]; ++j) {
                if (wts[mo][j] == c.tb[mo]) {
                  const int16_t cell = tabs[mo][j * 1024 + si * 128 + c.lob[mo]];
                  if (cell == -1 || cell == c.hs[mo]) js[mo][njs[mo]++] = j;
                }
              }
              c.starve[mo] += njs[mo];
            }
            bool allok = true;
            for (int mo = 0; mo < M; ++mo)
              if (njs[mo] == 0) allok = false;
            if (!allok) continue;
            if (M == 1) {
              for (int a = 0; a < njs[0]; ++a) {
                optpool.push_back({si, {js[0][a], 0}});
                ++nopts;
              }
            } else {
              for (int a = 0; a < njs[0]; ++a)
                for (int bb = 0; bb < njs[1]; ++bb) {
                  optpool.push_back({si, {js[0][a], js[1][bb]}});
                  ++nopts;
                }
            }
          }
          c.nopts = nopts;
          cands.push_back(c);
        }
        std::stable_sort(cands.begin(), cands.end(),
                         [](const Cand& a, const Cand& b) {
                           return a.nopts < b.nopts;
                         });
        int used = 0;
        struct Choice { int si; int combo[2]; };
        Choice chosen[8];
        long budget = 4000;
        const int ncand = static_cast<int>(cands.size());
        // recursive DFS, identical visit order to the Python oracle
        std::function<bool(int)> dfs;
        auto dfs_impl = [&](int k, auto&& self) -> bool {
          if (k == ncand) return true;
          if (--budget <= 0) return false;
          const Cand& c = cands[k];
          for (int o = 0; o < c.nopts; ++o) {
            const Opt& op = optpool[c.ofirst + o];
            const int si = op.si;
            if (used & (1 << si)) continue;
            struct W { int mo, j; int64_t lob; };
            W wrote[2];
            int nwrote = 0;
            bool ok = true;
            for (int mo = 0; mo < M; ++mo) {
              const int j = op.j[mo];
              const int16_t cell = tabs[mo][j * 1024 + si * 128 + c.lob[mo]];
              if (cell != -1 && cell != c.hs[mo]) { ok = false; break; }
              if (cell == -1) {
                tabs[mo][j * 1024 + si * 128 + c.lob[mo]] =
                    static_cast<int16_t>(c.hs[mo]);
                wrote[nwrote++] = {mo, j, c.lob[mo]};
              }
            }
            if (!ok) {
              for (int wix = 0; wix < nwrote; ++wix)
                tabs[wrote[wix].mo][wrote[wix].j * 1024 + si * 128 +
                                    wrote[wix].lob] = -1;
              continue;
            }
            used |= 1 << si;
            chosen[c.b] = {si, {op.j[0], op.j[1]}};
            if (self(k + 1, self)) return true;
            used &= ~(1 << si);
            for (int wix = 0; wix < nwrote; ++wix)
              tabs[wrote[wix].mo][wrote[wix].j * 1024 + si * 128 +
                                  wrote[wix].lob] = -1;
          }
          return false;
        };
        if (!dfs_impl(0, dfs_impl)) {
          vreg_ok = false;
          // duplicate the most-starved mode's tile for the hardest block
          const Cand& c0 = cands[0];
          hard_mo = 0;
          for (int mo = 1; mo < M; ++mo)
            if (c0.starve[mo] < c0.starve[hard_mo]) hard_mo = mo;
          hard_tb = c0.tb[hard_mo];
          break;
        }
        int freev[8], nf = 0;
        for (int si = 0; si < 8; ++si)
          if (!(used & (1 << si))) freev[nf++] = si;
        int fi = 0;
        for (int b = 0; b < 8; ++b) {
          const int64_t blk = g * 8 + b;
          if (real[blk]) {
            sub_assign[blk] = chosen[b].si;
            for (int mo = 0; mo < M; ++mo)
              win_assign[mo * nblk + blk] = chosen[b].combo[mo];
          } else {
            sub_assign[blk] = freev[fi++];
          }
        }
      }
      if (vreg_ok) {
        for (int mo = 0; mo < M; ++mo)
          nwin_v[mo * nvreg + v] = nw[mo] > 1 ? nw[mo] : 1;
        break;
      }
      if (hard_mo >= 0 && shuffles == 0 && ndup[hard_mo] < MJ_W - 1) {
        dup_hints[hard_mo][ndup[hard_mo]++] = hard_tb;
        continue;
      }
      ++shuffles;
      if (shuffles <= 3) continue;
      // out of retry room: mark this vreg's stripes for reflow
      if (stripe_of_grp) {
        for (int64_t g = g0; g < g1; ++g)
          failed[(*n_failed)++] = stripe_of_grp[g];
      }
      for (int mo = 0; mo < M; ++mo)
        nwin_v[mo * nvreg + v] = nw[mo] > 1 ? nw[mo] : 1;
      break;
    }
  }
}

}  // extern "C"

extern "C" {

// Clos 3-take routing for windowed_gather.pack_clos: per 1024-element
// output segment, route each needed source element through (spread
// row, lane, collect row) stages over <= max_w aligned source windows.
// Exact port of the Python loop (same window order, registration
// order, row choices).  planes [nseg, max_w, 8, 128] int32 and
// xtiles [nseg, max_w] int32 are caller-zeroed; nwin [nseg].
// out_ok = 0 when any segment cannot route (caller returns None).
void clos_route(int64_t nseg, const int64_t* seg_vals,
                const uint8_t* seg_mask, int64_t max_w, int32_t* planes,
                int32_t* xtiles, int64_t* nwin_out, int64_t* out_ok) {
  *out_ok = 1;
  const int MW = static_cast<int>(max_w);
  // per-window state (fixed capacity 8 windows max)
  struct Win {
    int64_t tile;
    int16_t A0[8][128];
    int16_t L1[8][128];
    // registrations per lo: (hi, r) pairs in append order
    uint8_t reg_cnt[128];
    int8_t reg_hi[128][8];
    int8_t reg_r[128][8];
  };
  std::vector<Win> wins(static_cast<size_t>(MW));
  int8_t A2[8][128];
  int8_t WID[8][128];

  for (int64_t v = 0; v < nseg; ++v) {
    const int64_t* vals = seg_vals + v * 1024;
    const uint8_t* msk = seg_mask + v * 1024;
    int nwin = 0;
    std::memset(A2, 0, sizeof(A2));
    std::memset(WID, 0, sizeof(WID));
    bool ok = true;
    for (int l = 0; l < 128 && ok; ++l) {
      // per-column used map: used_key[wi][r] = hi*128+lo or -1
      int16_t used_key[8][8];
      for (int wi = 0; wi < nwin; ++wi)
        for (int r = 0; r < 8; ++r) used_key[wi][r] = -1;
      for (int s = 0; s < 8; ++s) {
        const int e = l * 8 + s;
        if (!msk[e]) continue;
        const int64_t tgt = vals[e];
        const int64_t tile = tgt >> 10;
        const int hi = static_cast<int>((tgt >> 7) & 7);
        const int lo = static_cast<int>(tgt & 127);
        const int16_t key = static_cast<int16_t>(hi * 128 + lo);
        bool placed = false;
        for (int wi = 0; wi < nwin && !placed; ++wi) {
          Win& W = wins[wi];
          if (W.tile != tile) continue;
          // reuse a registration not yet used in this column
          for (int q = 0; q < W.reg_cnt[lo]; ++q) {
            if (W.reg_hi[lo][q] != hi) continue;
            const int r = W.reg_r[lo][q];
            const int16_t uk = used_key[wi][r];
            if (uk != -1 && uk != key) continue;
            if (W.L1[r][l] == -1 || W.L1[r][l] == lo) {
              W.L1[r][l] = static_cast<int16_t>(lo);
              A2[s][l] = static_cast<int8_t>(r);
              WID[s][l] = static_cast<int8_t>(wi);
              used_key[wi][r] = key;
              placed = true;
              break;
            }
          }
          if (placed) break;
          // new registration in a free row
          for (int r = 0; r < 8; ++r) {
            const int16_t uk = used_key[wi][r];
            if (uk != -1 && uk != key) continue;
            if ((W.A0[r][lo] == -1 || W.A0[r][lo] == hi) &&
                (W.L1[r][l] == -1 || W.L1[r][l] == lo)) {
              W.A0[r][lo] = static_cast<int16_t>(hi);
              W.L1[r][l] = static_cast<int16_t>(lo);
              const int q = W.reg_cnt[lo]++;
              W.reg_hi[lo][q] = static_cast<int8_t>(hi);
              W.reg_r[lo][q] = static_cast<int8_t>(r);
              A2[s][l] = static_cast<int8_t>(r);
              WID[s][l] = static_cast<int8_t>(wi);
              used_key[wi][r] = key;
              placed = true;
              break;
            }
          }
          if (placed) break;
        }
        if (!placed) {
          if (nwin >= MW) {
            ok = false;
            break;
          }
          Win& W = wins[nwin];
          W.tile = tile;
          std::memset(W.A0, 0xff, sizeof(W.A0));  // -1
          std::memset(W.L1, 0xff, sizeof(W.L1));
          std::memset(W.reg_cnt, 0, sizeof(W.reg_cnt));
          W.A0[0][lo] = static_cast<int16_t>(hi);
          W.L1[0][l] = static_cast<int16_t>(lo);
          W.reg_cnt[lo] = 1;
          W.reg_hi[lo][0] = static_cast<int8_t>(hi);
          W.reg_r[lo][0] = 0;
          A2[s][l] = 0;
          WID[s][l] = static_cast<int8_t>(nwin);
          used_key[nwin][0] = key;
          // rows 1..7 of the new window start unused this column
          for (int r = 1; r < 8; ++r) used_key[nwin][r] = -1;
          ++nwin;
        }
      }
    }
    if (!ok) {
      *out_ok = 0;
      return;
    }
    if (nwin == 0) {
      Win& W = wins[0];
      W.tile = 0;
      std::memset(W.A0, 0xff, sizeof(W.A0));
      std::memset(W.L1, 0xff, sizeof(W.L1));
      nwin = 1;
    }
    nwin_out[v] = nwin;
    int32_t* pv = planes + v * MW * 1024;
    for (int wi = 0; wi < nwin; ++wi) {
      const Win& W = wins[wi];
      for (int r = 0; r < 8; ++r) {
        for (int l = 0; l < 128; ++l) {
          int32_t a0 = W.A0[r][l] > 0 ? W.A0[r][l] : 0;
          int32_t l1 = W.L1[r][l] > 0 ? W.L1[r][l] : 0;
          int32_t p = a0 | (l1 << 3);
          if (wi == 0)
            p |= (static_cast<int32_t>(A2[r][l]) << 10) |
                 (static_cast<int32_t>(WID[r][l]) << 13);
          pv[wi * 1024 + r * 128 + l] = p;
        }
      }
      xtiles[v * MW + wi] = static_cast<int32_t>(W.tile);
    }
    for (int wi = nwin; wi < MW; ++wi)
      xtiles[v * MW + wi] = static_cast<int32_t>(wins[0].tile);
  }
}

}  // extern "C"
