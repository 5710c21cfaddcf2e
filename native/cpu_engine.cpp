// Single-thread CPU query engine over the rowbowt sorted tables.
//
// Two roles: (a) the honest CPU baseline for bench.py's vs_baseline ratios
// (equivalent work to the reference's query loops, one read at a time:
// rb_align count/locate /root/reference/src/rb_align.cpp:162-193, rb_markers
// genotyping /root/reference/src/rb_markers.cpp:357-428), and (b) a
// host-side fallback engine for environments without an accelerator.

#include <algorithm>
#include <cstdint>

namespace {
using i64 = int64_t;
using u64 = uint64_t;

constexpr u64 NIB_LOW64 = 0x1111111111111111ULL;

inline i64 run_of(const i64* rs, i64 R, i64 i) {
  return (i64)(std::upper_bound(rs, rs + R, i) - rs) - 1;
}

inline i64 rank(const i64* rs, i64 R, const i64* occ, const i64* F,
                const uint8_t* head, i64 n, i64 i, i64 c) {
  if (i >= n) return F[c + 1] - F[c];
  i64 r = run_of(rs, R, i);
  i64 v = occ[c * R + r];
  if (head[r] == (uint8_t)c) v += i - rs[r];
  return v;
}

inline u64 nibcnt(u64 w, u64 pat) {
  u64 x = w ^ pat;
  u64 t = x | (x >> 1) | (x >> 2) | (x >> 3);
  return (u64)__builtin_popcountll(~t & NIB_LOW64);
}

// Two-level fused-block tables (BigIndex layout; 128- or 256-symbol rows).
struct Fb2 {
  const int32_t* fb2;
  const i64* base;
  const i64* F;
  i64 per_blk, n, block, lanes;

  inline i64 rank(i64 i, i64 c) const {
    if (i >= n) return F[c + 1] - F[c];
    i64 blk = i / block;
    const int32_t* row = fb2 + blk * lanes;
    i64 v = row[c];
    u64 pat = (u64)c * NIB_LOW64;
    const u64* w = (const u64*)(row + 8);
    i64 off = i - blk * block;
    i64 full = off >> 4;
    for (i64 t = 0; t < full; ++t) v += (i64)nibcnt(w[t], pat);
    i64 k = off & 15;
    if (k) {
      u64 mask = (1ULL << (4 * k)) - 1;
      v += (i64)nibcnt(w[full] | ~mask, pat & mask);
    }
    return v + base[(blk / per_blk) * 8 + c];
  }

  inline int sym(i64 i) const {
    i64 blk = i / block;
    i64 off = i - blk * block;
    const u64* w = (const u64*)(fb2 + blk * lanes + 8);
    return (int)((w[off >> 4] >> ((off & 15) * 4)) & 15);
  }

  // LF: returns false on empty (range set to (1,0))
  inline bool lf(i64& lo, i64& hi, i64 c, i64 A) const {
    if (c < 0 || c >= A) { lo = 1; hi = 0; return false; }
    i64 before = rank(lo, c);
    i64 inside = rank(hi + 1, c) - before;
    if (inside <= 0) { lo = 1; hi = 0; return false; }
    lo = F[c] + before;
    hi = lo + inside - 1;
    return true;
  }
};

inline i64 csr_count(const i64* ma_row, i64 M, i64 lo, i64 hi) {
  const i64* a = std::lower_bound(ma_row, ma_row + M, lo);
  const i64* b = std::lower_bound(ma_row, ma_row + M, hi + 1);
  return (i64)(b - a);
}
}  // namespace

extern "C" {

// Batched count queries.  qcodes: int16 [nq, stride] right-aligned (pad=-1).
// Returns ranges in out_lo/out_hi with the (1,0) empty encoding.
void rbt_cpu_count(const i64* run_start, i64 R, const i64* occ_flat,
                   const i64* F, i64 A, const uint8_t* run_head, i64 n,
                   const int16_t* qcodes, const int32_t* qlens, i64 nq,
                   i64 stride, i64* out_lo, i64* out_hi) {
  for (i64 q = 0; q < nq; ++q) {
    i64 lo = 0, hi = n - 1;
    const int16_t* row = qcodes + q * stride;
    i64 m = qlens[q];
    for (i64 j = 0; j < m && lo <= hi; ++j) {
      i64 c = row[stride - 1 - j];
      if (c < 0 || c >= A) { lo = 1; hi = 0; break; }
      i64 before = rank(run_start, R, occ_flat, F, run_head, n, lo, c);
      i64 inside =
          rank(run_start, R, occ_flat, F, run_head, n, hi + 1, c) - before;
      if (inside <= 0) { lo = 1; hi = 0; break; }
      lo = F[c] + before;
      hi = lo + inside - 1;
    }
    out_lo[q] = lo;
    out_hi[q] = hi;
  }
}

// Batched count over the two-level tables at ANY row size (the 256-symbol
// giant layout included) — rbt_cpu_count_fb2 hardcodes 128-symbol rows.
void rbt_cpu_count_fb2g(const int32_t* fb2, i64 per_blk, i64 block, i64 lanes,
                        const i64* base, const i64* Fc, i64 A, i64 n,
                        const int16_t* qcodes, const int32_t* qlens, i64 nq,
                        i64 stride, i64* out_lo, i64* out_hi) {
  Fb2 T{fb2, base, Fc, per_blk, n, block, lanes};
  for (i64 q = 0; q < nq; ++q) {
    i64 lo = 0, hi = n - 1;
    const int16_t* row = qcodes + q * stride;
    i64 m = qlens[q];
    for (i64 j = 0; j < m && lo <= hi; ++j) {
      if (!T.lf(lo, hi, row[stride - 1 - j], A)) break;
    }
    out_lo[q] = lo;
    out_hi[q] = hi;
  }
}

// Toehold locate over the two-level tables + O(R) run-space aids — the
// rb_align -s workload (find_range_w_toehold + locs_at, rowbowt.hpp:167-184,
// 613-621) one read at a time.  max_hits phi-walk per read; locs order is
// toehold first then the phi chain (toehold_sa.hpp:37-49).
void rbt_cpu_locate_fb2(const int32_t* fb2, i64 per_blk, i64 block, i64 lanes,
                        const i64* base, const i64* Fc, i64 A, i64 n,
                        const i64* run_start, i64 R, const i64* samples_last,
                        const i64* cruns_keys, const i64* pred_pos, i64 Rp,
                        const i64* phi_at, const int16_t* qcodes,
                        const int32_t* qlens, i64 nq, i64 stride,
                        i64 max_hits, i64* out_lo, i64* out_hi, i64* out_k,
                        i64* out_locs, i64* out_cnt) {
  Fb2 T{fb2, base, Fc, per_blk, n, block, lanes};
  auto phi = [&](i64 i) -> i64 {
    i64 rk = (i64)(std::upper_bound(pred_pos, pred_pos + Rp, i) - pred_pos) - 1;
    return (phi_at[rk] + (i - pred_pos[rk])) % n;
  };
  i64 k0 = (samples_last[R - 1] + 1) % n;
  for (i64 q = 0; q < nq; ++q) {
    i64 lo = 0, hi = n - 1, k = k0;
    const int16_t* row = qcodes + q * stride;
    i64 m = qlens[q];
    for (i64 j = 0; j < m && lo <= hi; ++j) {
      i64 c = row[stride - 1 - j];
      i64 old_hi = hi;
      if (!T.lf(lo, hi, c, A)) break;
      // LF_w_loc toehold rule (rowbowt.hpp:553-573)
      if (T.sym(old_hi) == (int)c) {
        k = (k == 0) ? n - 1 : k - 1;
      } else {
        i64 r = run_of(run_start, R, old_hi);
        i64 key = c * R + r;
        const i64* it = std::upper_bound(cruns_keys, cruns_keys + R, key);
        i64 rr = *(it - 1) - c * R;
        k = samples_last[rr];
      }
    }
    if (hi < lo) { lo = 1; hi = 0; k = 0; }
    out_lo[q] = lo;
    out_hi[q] = hi;
    out_k[q] = k;
    i64 cnt = (hi >= lo) ? std::min(hi - lo + 1, max_hits) : 0;
    out_cnt[q] = cnt;
    i64 cur = k;
    for (i64 t = 0; t < max_hits; ++t) {
      if (t > 0 && t < cnt) cur = phi(cur);
      out_locs[q * max_hits + t] = (t < cnt) ? cur : -1;
    }
  }
}

// Windowed marker queries — the rb_align -m / find_range_w_markers workload
// (rowbowt.hpp:292-339): probe the marker CSR every wsize characters when
// the range is small enough; a failed full-read search clears everything.
// Outputs the final range + TOTAL collected marker-entry count per read.
void rbt_cpu_markers_fb2(const int32_t* fb2, i64 per_blk, i64 block,
                         i64 lanes, const i64* base, const i64* Fc, i64 A,
                         i64 n, const i64* ma_row, i64 M,
                         const int16_t* qcodes, const int32_t* qlens, i64 nq,
                         i64 stride, i64 wsize, i64 max_range, i64* out_lo,
                         i64* out_hi, i64* out_mcnt) {
  Fb2 T{fb2, base, Fc, per_blk, n, block, lanes};
  for (i64 q = 0; q < nq; ++q) {
    const int16_t* row = qcodes + q * stride;
    i64 m = qlens[q];
    i64 lo = 0, hi = n - 1, mcnt = 0, window_ei = m;
    bool failed = (m < wsize);
    for (i64 j = 0; j < m && !failed; ++j) {
      i64 c = row[stride - 1 - j];
      if (!T.lf(lo, hi, c, A)) { failed = true; mcnt = 0; break; }
      if (window_ei - (m - j) >= wsize) {  // rowbowt.hpp:314-324
        if (hi - lo + 1 <= max_range) mcnt += csr_count(ma_row, M, lo, hi);
        window_ei = m - j;
      }
    }
    if (!failed && hi >= lo && (m - 1) % wsize != 0) {  // final re-query
      if (hi - lo + 1 <= max_range) mcnt += csr_count(ma_row, M, lo, hi);
    }
    out_lo[q] = failed ? 1 : lo;
    out_hi[q] = failed ? 0 : hi;
    out_mcnt[q] = mcnt;
  }
}

// Greedy-seeding marker genotyping — the rb_markers production workload
// (get_markers_greedy_seeding, rowbowt.hpp:406-482, no-ftab variant; the
// caller passes fwd and revcomp lanes like rb_markers.cpp:396-400).
// Outputs per read: seed count and total probed marker entries.
void rbt_cpu_greedy_fb2(const int32_t* fb2, i64 per_blk, i64 block, i64 lanes,
                        const i64* base, const i64* Fc, i64 A, i64 n,
                        const i64* ma_row, i64 M, const int16_t* qcodes,
                        const int32_t* qlens, i64 nq, i64 stride, i64 wsize,
                        i64 max_range, i64* out_ns, i64* out_mcnt) {
  Fb2 T{fb2, base, Fc, per_blk, n, block, lanes};
  for (i64 q = 0; q < nq; ++q) {
    const int16_t* row = qcodes + q * stride;
    i64 m = qlens[q];
    i64 lo = 0, hi = n - 1, plo = 0, phi_ = n - 1;
    i64 seed_ei = m, window_ei = m, ns = 0, mcnt = 0;
    for (i64 i = 0; i < m; ++i) {
      i64 c = row[stride - 1 - i];
      i64 nlo = lo, nhi = hi;
      bool ok = T.lf(nlo, nhi, c, A);
      if (ok) {
        if (window_ei - (m - i - 1) >= wsize) {  // rowbowt.hpp:472-478
          if (nhi - nlo + 1 <= max_range)
            mcnt += csr_count(ma_row, M, nlo, nhi);
          window_ei = m - i - 1;
        }
        lo = plo = nlo;
        hi = phi_ = nhi;
      } else {
        if (seed_ei - (m - i) >= wsize) {  // seed-final probe (rowbowt.hpp:448)
          if (phi_ - plo + 1 <= max_range)
            mcnt += csr_count(ma_row, M, plo, phi_);
        }
        ++ns;
        lo = plo = 0;
        hi = phi_ = n - 1;
        seed_ei = window_ei = m - i - 1;
      }
    }
    if (hi >= lo && seed_ei - 0 >= wsize && m > 0) {
      // final emission (rowbowt.hpp:477-481); i == m here so m - i == 0
      if (hi - lo + 1 <= max_range) mcnt += csr_count(ma_row, M, lo, hi);
    }
    if (m > 0) ++ns;  // the final seed
    out_ns[q] = ns;
    out_mcnt[q] = mcnt;
  }
}
}
