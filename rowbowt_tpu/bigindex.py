"""BigIndex: the n >= 2^31 count-path index artifact.

The reference contract is u64 row indices throughout (toehold_sa.hpp:133-155);
device gathers want int32 row ids.  The two-level layout splits the difference:

  fb2   int32[nb_pad, 24] — fused-block rows (8 checkpoint lanes + 16 packed
        4-bit BWT words per 128 symbols, construct.build.build_fblock) whose
        checkpoints are SUPERBLOCK-local, so int32 never overflows;
  base  int64[n_sup, 8]   — global per-char count before each superblock.

rank(i, c) = base[superblock(i), c] + local checkpoint + in-block popcount
(ops.rank.rank_fblock2).  Only the LANES (lo/hi/i) are int64; every gather
index stays int32 up to n = 2^38.  The same arrays reshape directly into the
position-sharded multi-chip layout (parallel.sharded_dense.ShardedDenseIndex)
when n_sup == n_idx, so one artifact serves both the single-chip and the
sharded engines.

Version 2 (round 4) adds the O(R)/O(M) auxiliary tables the reference serves
at any n with u64 indices (toehold_sa.hpp:27-49,105-131, rowbowt.hpp:406-482):

  run_start u32[R], samples_last u32[R]   run-boundary SA samples — the
        .ssa/.esa role (toehold_sa.hpp:133-155) as dense sorted arrays;
  pred_pos u32[~R], phi_at u32[~R]        the phi predecessor table
        (ToeholdSA::build_phi role) as exact SA-adjacency breakpoints, for
        the run-space phi walk (ops.rank.phi_step "phi_at" branch);
  cruns_keys i32[R]                       run ids sorted by (head, id) packed
        as head*R+id — "last c-run at or before r" is ONE searchsorted (the
        toehold-postpass ltk resolve, engine/locate.py);
  ma_row u32[M], ma_val i64[M]            the marker CSR (pfbwt-f MarkerArray
        role) probed by two searchsorteds (ops.rank.markers_bounds).

All row/position values pack into u32 below n = 2^32 (every config here);
lanes stay int64 end to end (the reference's u64 contract).  Dense kval/phi1
(8 B/position) cannot exist at this scale — these tables are the r-index
proper: O(R + M) space, independent of n.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from rowbowt_tpu.alphabet import Alphabet

_SUP_SYMS_MAX = 1 << 30  # superblock symbol span: int32 checkpoints with 2x margin


def big_locate_tables(codes: np.ndarray, sa: np.ndarray,
                      isa: np.ndarray | None = None,
                      chunk: int = 1 << 26, A: int = 8) -> dict[str, np.ndarray]:
    """Run boundaries + O(R) run-space toehold/phi tables from the merged BWT
    code sequence and the full SA (any dtype; values < n).

    The phi table is built from EXACT SA-adjacency breakpoints — positions i
    where phi(i) = SA[isa(i) - 1] stops advancing by +1 — rather than from
    run-start samples.  The classic run-boundary reconstruction
    (toehold_sa.hpp:105-131, construct.build.build_toehold_tables) is exact
    for a whole-text BWT but the chunked merge's generalized document order
    breaks phi linearity at the k document-initial rows (their stored BWT
    char is the previous document's phantom, so LF is not SA[j]-1 there);
    the adjacency-breakpoint table is exact for ANY permutation, same O(R)
    size (#breakpoints ~ R + #docs).  phi(i) = phi_at[pred(i)] +
    (i - pred_pos[pred(i)]) — ops.rank.phi_step's "phi_at" branch.

    The chunked scans keep temporaries O(chunk) except the inverse SA
    (4 B/position below 2^32; pass `isa` to share it with the marker build).

    Conventions otherwise match construct.build.build_index: samples_last is
    (SA[run_end] + n - 1) % n — the text position of the row's BWT char, the
    value the reference stores (y-1 with 0 -> n-1, toehold_sa.hpp:133-155).
    """
    n = int(codes.shape[0])
    parts = [np.zeros(1, dtype=np.int64)]
    for lo in range(1, n, chunk):
        hi = min(lo + chunk, n)
        d = np.flatnonzero(codes[lo:hi] != codes[lo - 1:hi - 1])
        parts.append(d + lo)
    run_start = np.concatenate(parts)
    R = int(run_start.shape[0])
    run_head = codes[run_start].astype(np.uint8)
    run_end = np.empty(R, dtype=np.int64)
    run_end[:-1] = run_start[1:] - 1
    run_end[-1] = n - 1

    pos_dt = np.uint32 if n < (1 << 32) else np.int64
    sl = (sa[run_end].astype(np.int64) + n - 1) % n
    keys = run_head.astype(np.int64) * R + np.arange(R, dtype=np.int64)
    order = np.argsort(run_head, kind="stable")
    ck = keys[order]
    # dtype must cover the QUERY ceiling (c*R + r goes up to A*R - 1 in
    # traj_resolve_toehold), not just ck[-1]: a c with no runs still probes
    key_dt = np.int32 if A * R < (1 << 31) else np.int64

    if isa is None:
        isa = np.empty(n, dtype=pos_dt)
        isa[np.asarray(sa)] = np.arange(n, dtype=pos_dt)
    bp_parts, val_parts = [], []
    prev_tail = None  # phi value at the last position of the previous chunk
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        j = isa[lo:hi].astype(np.int64)
        ph = np.asarray(sa)[(j - 1) % n].astype(np.int64)  # phi(i), i in [lo,hi)
        d = np.flatnonzero(np.diff(ph) != 1) + 1
        first_breaks = (lo == 0) or (ph[0] != prev_tail + 1)
        if first_breaks:
            d = np.concatenate(([0], d))
        bp_parts.append(d + lo)
        val_parts.append(ph[d])
        prev_tail = int(ph[-1])
    pred_pos = np.concatenate(bp_parts)
    phi_at = np.concatenate(val_parts)
    return {
        "run_start": run_start.astype(pos_dt),
        "run_head": run_head,
        "samples_last": sl.astype(pos_dt),
        "pred_pos": pred_pos.astype(pos_dt),
        "phi_at": phi_at.astype(pos_dt),
        "cruns_keys": ck.astype(key_dt),
    }


def big_marker_tables(sa: np.ndarray, marker_tpos: np.ndarray,
                      marker_packed: np.ndarray, wsize: int, n: int,
                      isa: np.ndarray | None = None):
    """Marker CSR (ma_row sorted, ma_val) from the full SA: BWT row i carries
    marker m iff SA[i] in [t-w+1, t] (the variant lies within the first w
    characters of the suffix — same rule as construct.build.build_index).

    Builds the full inverse SA once (4 B/position below 2^32) — at pangenome
    scale that is one 9.6 GB transient, well under host RAM, and far cheaper
    than per-position membership probes over the 2.4G-element SA."""
    pos_dt = np.uint32 if n < (1 << 32) else np.int64
    lo_p = np.maximum(marker_tpos.astype(np.int64) - wsize + 1, 0)
    span = marker_tpos - lo_p + 1
    off = np.repeat(np.cumsum(span) - span, span)
    flat = np.arange(off.shape[0], dtype=np.int64) - off
    ps = np.repeat(lo_p, span) + flat
    vals = np.repeat(marker_packed, span)
    if isa is None:
        isa = np.empty(n, dtype=pos_dt)
        isa[np.asarray(sa)] = np.arange(n, dtype=pos_dt)
    rows = isa[ps].astype(np.int64)
    srt = np.lexsort((vals, rows))
    return rows[srt].astype(pos_dt), vals[srt]


def marker_nibble_rank(ma_row: np.ndarray, n: int) -> np.ndarray | None:
    """ONE-gather ma_start1: int32[n/64 + 1, 16] fused 64-byte rows of
    [entries-before-block ckpt | 8 packed u32 words of per-row 4-bit entry
    counts | 7 pad] per 64 BWT rows — the same 64B/16-lane row shape as the
    fb2_64 rank table (1 B/row; 2.4 GB at n=2.4G).

    ms_at(i) = ckpt + SWAR nibble-SUM of counts below i's offset — the same
    one-transaction profile as the fblock rank rows (ops.rank.rank_fblock),
    replacing the 9-gather bucketed search in the marker engines' LF loops.

    Returns None when any row holds > 15 entries (callers fall back to the
    bucketed bound) — at wsize=10 that needs 16+ variants within one window,
    absent from any real panel."""
    M = int(ma_row.shape[0])
    if M >= (1 << 31):
        return None  # int32 checkpoint lanes
    nb = (n + 63) >> 6
    rows64 = np.zeros((nb + 1, 16), dtype=np.int32)
    if M:
        ur, cnt = np.unique(np.asarray(ma_row), return_counts=True)
        if int(cnt.max()) > 15:
            return None
        words = np.zeros(nb * 8, dtype=np.uint32)
        np.add.at(words, (ur >> 3).astype(np.int64),
                  cnt.astype(np.uint32) << ((ur.astype(np.uint32) & 7) * 4))
        rows64[:nb, 1:9] = words.reshape(nb, 8).view(np.int32)
        del words
        # exclusive cumulative entries before each 64-row block
        bounds = np.minimum(np.arange(nb + 1, dtype=np.int64) << 6, n)
        ck = np.searchsorted(np.asarray(ma_row),
                             bounds.astype(ma_row.dtype), side="left")
        assert int(ck[-1]) == M
        rows64[:, 0] = ck.astype(np.int32)
    return rows64


_PHI_POS = 480  # positions per 64B phi row: [ckpt i32 | 15 u32 bit words]


def phi_pack_tables(pred_pos: np.ndarray, phi_at: np.ndarray, n: int):
    """ONE-gather phi predecessor rank: (rows int32[nb, 16], delta).

    The SA-adjacency breakpoint table (big_locate_tables) makes phi piecewise
    i + const; a hop therefore needs only (a) the rank of i among the sorted
    breakpoint positions and (b) that breakpoint's constant.  The positions
    pack into a bitmap with fused checkpoints — 64-byte/16-lane rows of
    [#breakpoints-before-row | 15 u32 words of per-position bits] per 480
    text positions (0.13 B/position; same transaction profile as the fb2_64
    rank rows) — so rank(i) is one row gather + a VPU popcount, and
    phi(i) = (i + delta[rank-1]) mod n is one more element gather.  Replaces
    the bucketed binary search's 1 + iters + 2 dependent gathers per hop
    (ops.rank.phi_step's "phi_rows" branch vs its "phi_at" branch).

    delta[r] = (phi_at[r] - pred_pos[r]) mod n, stored u32 below n = 2^32
    and int64 beyond (the >= 2^32 regime keeps R small in any repetitive
    panel, so the wider lanes cost little).  Requires #breakpoints < 2^31
    (int32 checkpoint lanes).
    """
    Rp = int(pred_pos.shape[0])
    assert Rp < (1 << 31), "int32 phi checkpoint lanes"
    nb = n // _PHI_POS + 1
    rows = np.zeros((nb + 1, 16), dtype=np.int32)
    p = np.asarray(pred_pos).astype(np.int64)
    words = np.zeros(nb * 15, dtype=np.uint32)
    np.bitwise_or.at(words, p // _PHI_POS * 15 + (p % _PHI_POS) // 32,
                     np.uint32(1) << (p % 32).astype(np.uint32))
    rows[:nb, 1:] = words.reshape(nb, 15).view(np.int32)
    del words
    # breakpoints strictly before each row's first position
    bounds = np.arange(nb + 1, dtype=np.int64) * _PHI_POS
    rows[:, 0] = np.searchsorted(p, bounds, side="left").astype(np.int32)
    dd = np.uint32 if n < (1 << 32) else np.int64
    delta = ((np.asarray(phi_at).astype(np.int64) - p) % n).astype(dd)
    return rows, delta


def marker_buckets(ma_row: np.ndarray, n: int, target_seg: int = 32):
    """Bucket table for the marker-CSR lower bound: off[b] = first entry in
    row bucket b (span 2^shift rows).  Cuts markers_bounds' dependent chain
    from log2(M) (~27 at M=72M) to 1 bucket gather + ceil(log2(max segment))
    binary-search gathers (~8) — the window probes sit INSIDE the LF loop, so
    this chain length is the big marker engines' throughput (measured 8.7k ->
    see BASELINE.md).  Returns (off u32/i64[nbuck+1], (shift, iters))."""
    M = int(ma_row.shape[0])
    if M == 0:
        return np.zeros(2, dtype=np.uint32), (62, 1)
    # bucket span targeting ~target_seg entries per bucket
    shift = int(np.clip(round(np.log2(max(n, 2) / M * target_seg)), 6, 30))
    nbuck = (n >> shift) + 1
    bounds = (np.arange(nbuck + 1, dtype=np.int64) << shift)
    off = np.searchsorted(ma_row, np.minimum(bounds, np.iinfo(ma_row.dtype).max
                                             ).astype(ma_row.dtype),
                          side="left")
    max_seg = int(np.diff(off).max())
    iters = max(1, int(np.ceil(np.log2(max_seg + 1))))
    dt = np.uint32 if M < (1 << 32) else np.int64
    return off.astype(dt), (shift, iters)


_MRP_SHIFT = 16  # run-pack max bucket span: in-bucket start deltas fit u16


def marker_run_pack(ma_row: np.ndarray, n: int):
    """Run-table marker rank: ma_start1[i] in THREE dependent gather levels.

    Marker rows are runs of consecutive BWT rows (the suffixes starting
    inside one variant window agree across near-identical haplotypes, so
    they occupy contiguous row ranges).  Measured on the 10^10/513-doc
    panel: M = 100M CSR entries collapse to 383k runs of uniform per-row
    multiplicity (mean length 260, mult <= 3) — so rank over the CSR needs
    only the run containing (or preceding) i:

      rank(i) = cum[j] + mult[j] * clip(i - start[j], 0, len[j]),
      j = last run with start <= i

    Tables (~8 MB at M=100M, vs 800 MB ma_row + the 1+iters-deep bucketed
    search, ops.rank.bucketed_lower_bound, or the O(n)-bytes nibble rows):

      off   u32[(n>>shift)+2]  bucket directory over row space
      sd16  i32[ceil(K/32),16] run-start low 16 bits, 32 u16 per 64B row
      rec   i64[K, 2]          [start | cum + (len<<32) + (mult<<56)]

    j resolves as off[b] + (count of in-bucket starts <= i) - 1: one off
    gather, a STATIC `nrows` parallel 64B sd16 row gathers + VPU SWAR
    compare-count, one 16B rec gather (ops.rank._ms_runs).  The bucket
    shift adapts to the run density — the largest shift <= 16 whose worst
    bucket segment fits 4 sd16 rows (short-run panels like an 8-doc text,
    mean run ~5 rows, need shift 12; the 513-doc panel's 260-row runs fit
    shift 16).  Low-16-bit comparison stays exact for any shift <= 16:
    in-bucket starts share all bits >= shift.  Returns
    (off, sd16, rec, (shift, nrows)) or None when the structure doesn't
    fit (mult > 127, len >= 2^24, M >= 2^32, or off table > 2^27 entries).
    """
    M = int(ma_row.shape[0])
    if M == 0 or M >= (1 << 32):
        return None
    mr = np.asarray(ma_row).astype(np.int64)
    first = np.r_[True, mr[1:] != mr[:-1]]  # ma_row is sorted
    pos = np.flatnonzero(first)
    ur = mr[pos]
    cnt = np.diff(np.r_[pos, M])
    if cnt.max(initial=0) > 127:
        return None
    same = (np.diff(ur) == 1) & (cnt[1:] == cnt[:-1])
    sidx = np.r_[0, np.flatnonzero(~same) + 1]
    starts = ur[sidx]
    K = int(starts.shape[0])
    if K >= (1 << 31):  # int32 rec gather indices
        return None
    lens = np.diff(np.r_[sidx, ur.shape[0]]).astype(np.int64)  # rows per run
    if lens.max(initial=0) >= (1 << 24):
        return None
    mult = cnt[sidx].astype(np.int64)
    centry = lens * mult
    cum = np.concatenate(([0], np.cumsum(centry)))[:-1]
    assert cum[-1] + centry[-1] == M
    rec = np.empty((K, 2), np.int64)
    rec[:, 0] = starts
    rec[:, 1] = cum | (lens << 32) | (mult << 56)
    for shift in range(_MRP_SHIFT, 5, -2):
        if (n >> shift) >= (1 << 27):  # off table ceiling (512 MB u32)
            return None
        nbuck = (n >> shift) + 1
        off = np.searchsorted(
            starts, np.arange(nbuck + 1, dtype=np.int64) << shift,
            side="left")
        maxseg = int(np.diff(off).max(initial=0))
        nrows = max(1, (maxseg - 1) // 32 + 2)  # segments straddle row bounds
        if nrows <= 4:
            break
    else:
        return None
    Kp = -(-K // 32) * 32
    sd16 = np.full(Kp, 0xFFFF, np.uint16)
    sd16[:K] = (starts & 0xFFFF).astype(np.uint16)
    sd16 = sd16.reshape(-1, 32).view(np.uint32).view(np.int32)  # [Kp/32, 16]
    return off.astype(np.uint32), sd16, rec, (shift, nrows)


@dataclasses.dataclass
class BigIndex:
    fb2: np.ndarray  # int32[nb_pad, 24]
    base: np.ndarray  # int64[n_sup, 8]
    F: np.ndarray  # int64[A+1]
    n: int
    A: int
    per_blk: int  # fb rows per superblock
    alpha: Alphabet
    prefix: str | None = None  # load dir; enables the fb2_64 repack cache
    # v2 optional components (see module docstring)
    run_start: np.ndarray | None = None
    run_head: np.ndarray | None = None
    samples_last: np.ndarray | None = None
    pred_pos: np.ndarray | None = None
    phi_at: np.ndarray | None = None
    cruns_keys: np.ndarray | None = None
    ma_row: np.ndarray | None = None
    ma_val: np.ndarray | None = None
    ma_wsize: int = 0
    doc_starts: np.ndarray | None = None
    doc_names: list[str] | None = None

    @property
    def n_sup(self) -> int:
        return self.base.shape[0]

    @property
    def R(self) -> int:
        return 0 if self.run_start is None else int(self.run_start.shape[0])

    @property
    def has_locate(self) -> bool:
        return self.samples_last is not None

    @property
    def has_markers(self) -> bool:
        return self.ma_row is not None

    def attach_locate(self, codes: np.ndarray, sa: np.ndarray,
                      isa: np.ndarray | None = None) -> None:
        for k, v in big_locate_tables(codes, sa, isa=isa, A=self.A).items():
            setattr(self, k, v)

    def _ma_cnt64(self) -> np.ndarray | None:
        """The nibble-count marker rank rows, disk-cached next to the
        artifact (like the fb2_64 repack); None on >15-entry rows.

        OPT-IN via RBT_MA_NIB=1; the run-pack rank or the bucketed bound
        (marker_buckets) is the default big marker path.  The nibble kernel
        stays correct and tested; which of them is faster on the GPU is not
        measured yet."""
        if not os.environ.get("RBT_MA_NIB"):
            return None
        cache = (os.path.join(self.prefix, "ma_cnt64.npy")
                 if self.prefix else None)
        if cache and os.path.exists(cache):
            return np.load(cache, mmap_mode="r")
        nib = marker_nibble_rank(self.ma_row, self.n)
        if nib is not None and cache:
            np.save(cache, nib)
        return nib

    def _ma_runpack(self):
        """The run-pack marker-rank tables (marker_run_pack), disk-cached
        next to the artifact; None when the run structure doesn't fit."""
        cache = (os.path.join(self.prefix, "ma_runpack.npz")
                 if self.prefix else None)
        if cache and os.path.exists(cache):
            z = np.load(cache)
            if "shift" in z.files:  # pre-adaptive-shift caches recompute
                if z["nrows"].item() == 0:
                    return None
                return (z["off"], z["sd16"], z["rec"],
                        (int(z["shift"].item()), int(z["nrows"].item())))
        rp = marker_run_pack(self.ma_row, self.n)
        if cache:
            if rp is None:
                np.savez(cache, shift=np.int64(0), nrows=np.int64(0))
            else:
                off, sd16, rec, (shift, nrows) = rp
                np.savez(cache, off=off, sd16=sd16, rec=rec,
                         shift=np.int64(shift), nrows=np.int64(nrows))
        return rp

    def _phi_pack(self):
        """The bitmap-rank phi tables (phi_pack_tables), disk-cached next to
        the artifact like the fb2_64 repack; (None, None) when the breakpoint
        count exceeds int32 checkpoints."""
        if int(self.pred_pos.shape[0]) >= (1 << 31):
            return None, None
        rc = (os.path.join(self.prefix, "phi_rows.npy")
              if self.prefix else None)
        dc = (os.path.join(self.prefix, "phi_delta.npy")
              if self.prefix else None)
        if rc and os.path.exists(rc) and os.path.exists(dc):
            return np.load(rc, mmap_mode="r"), np.load(dc, mmap_mode="r")
        pr, pd = phi_pack_tables(self.pred_pos, self.phi_at, self.n)
        if rc:
            np.save(rc, pr)
            np.save(dc, pd)
        return pr, pd

    def attach_markers(self, sa: np.ndarray, marker_tpos, marker_packed,
                       wsize: int, isa: np.ndarray | None = None) -> None:
        self.ma_row, self.ma_val = big_marker_tables(
            sa, np.asarray(marker_tpos, dtype=np.int64),
            np.asarray(marker_packed, dtype=np.int64), wsize, self.n,
            isa=isa)
        self.ma_wsize = wsize

    @staticmethod
    def from_codes(codes: np.ndarray, alpha: Alphabet, n_sup: int | None = None,
                   ) -> "BigIndex":
        """Build straight from BWT codes (uint8, values < A <= 8): no global
        int32 table is ever materialized — per-superblock fblocks have local
        checkpoints; `base` carries the int64 offsets."""
        from rowbowt_tpu.construct.build import DENSE_BLOCK
        from rowbowt_tpu.parallel.sharded_dense import ShardedDenseIndex

        n = int(codes.shape[0])
        A = alpha.size
        if n_sup is None:
            n_sup = max(2, -(-n // _SUP_SYMS_MAX))
        fb3, base, per_blk = ShardedDenseIndex.fb3_from_codes(codes, A, n_sup)
        counts = np.zeros(A + 1, dtype=np.int64)
        counts[1:] = np.bincount(codes, minlength=A)[:A]
        F = np.cumsum(counts)
        return BigIndex(fb2=fb3.reshape(-1, fb3.shape[-1]), base=base, F=F,
                        n=n, A=A, per_blk=per_blk, alpha=alpha)

    # ---------------- serialization (.npy so mmap load works) ----------------

    _OPT = ("run_start", "run_head", "samples_last", "pred_pos",
            "phi_at", "cruns_keys", "ma_row", "ma_val", "doc_starts")

    def save(self, prefix: str) -> None:
        os.makedirs(prefix, exist_ok=True)
        np.save(os.path.join(prefix, "fb2.npy"), self.fb2)
        np.save(os.path.join(prefix, "base.npy"), self.base)
        np.save(os.path.join(prefix, "F.npy"), self.F)
        present = []
        for k in self._OPT:
            v = getattr(self, k)
            if v is not None:
                np.save(os.path.join(prefix, f"{k}.npy"), v)
                present.append(k)
        with open(os.path.join(prefix, "meta.json"), "w") as f:
            json.dump({"format": "rowbowt-tpu-bigindex", "version": 2,
                       "n": self.n, "A": self.A, "per_blk": self.per_blk,
                       "alpha_bytes": self.alpha.bytes_.tolist(),
                       "optional": present, "ma_wsize": self.ma_wsize,
                       "doc_names": self.doc_names}, f)

    @staticmethod
    def load(prefix: str, mmap: bool = True) -> "BigIndex":
        with open(os.path.join(prefix, "meta.json")) as f:
            meta = json.load(f)
        mm = "r" if mmap else None
        big = BigIndex(
            fb2=np.load(os.path.join(prefix, "fb2.npy"), mmap_mode=mm),
            base=np.load(os.path.join(prefix, "base.npy")),
            F=np.load(os.path.join(prefix, "F.npy")),
            n=int(meta["n"]), A=int(meta["A"]), per_blk=int(meta["per_blk"]),
            alpha=Alphabet(np.array(meta["alpha_bytes"], dtype=np.uint8)),
            prefix=prefix,
            ma_wsize=int(meta.get("ma_wsize", 0)),
            doc_names=meta.get("doc_names"),
        )
        for k in meta.get("optional", ()):
            setattr(big, k, np.load(os.path.join(prefix, f"{k}.npy"),
                                    mmap_mode=mm))
        return big

    @staticmethod
    def is_big_dir(path: str) -> bool:
        """True when `path` is a BigIndex directory (CLI auto-detect)."""
        meta = os.path.join(path, "meta.json")
        if not os.path.isdir(path) or not os.path.exists(meta):
            return False
        try:
            with open(meta) as f:
                return json.load(f).get("format") == "rowbowt-tpu-bigindex"
        except (json.JSONDecodeError, OSError):
            return False

    # ---------------- engine views ----------------

    def device_index(self, device=None, fb64: bool = True,
                     with_locate: bool | None = None,
                     with_markers: bool | None = None):
        """Single-chip DeviceIndex: count via ops.rank.lf_step_fblock2.

        fb64=True (default) repacks to 64-symbol/64B rows at load: a big
        index is by definition far out of cache, where the smaller row gather
        wins 1.29x (tools/fblock_probe.py part3).  Checkpoints stay
        superblock-local so the repack arithmetic is unchanged.

        with_locate / with_markers (default: whatever the artifact carries)
        add the O(R) toehold/phi tables and the O(M) marker CSR — the
        flag-gated partial load of the reference (rowbowt_io.hpp:146-189)."""
        import jax
        import jax.numpy as jnp

        from rowbowt_tpu.engine.device import DeviceIndex

        if with_locate is None:
            with_locate = self.has_locate
        if with_markers is None:
            with_markers = self.has_markers
        lanes = int(self.fb2.shape[1])
        if fb64 and lanes == 24:
            from rowbowt_tpu.construct.build import fblock_to_fb64
            key = "fb2_64"
            cache = (os.path.join(self.prefix, "fb2_64.npy")
                     if self.prefix else None)
            if cache and os.path.exists(cache):
                fb = np.load(cache, mmap_mode="r")
            else:
                fb = fblock_to_fb64(np.asarray(self.fb2), self.n)
                if cache:
                    np.save(cache, fb)
        else:
            # 40-lane rows are the 256-symbol giant layout; 24-lane the
            # 128-symbol build layout (no 64B repack requested or possible)
            key = {24: "fb2", 40: "fb2_256"}[lanes]
            fb = np.ascontiguousarray(self.fb2)
        arrs = {
            key: jnp.asarray(fb),
            "fb2_base": jnp.asarray(self.base),
            "F": jnp.asarray(self.F.astype(np.int64)),
        }
        R = 0
        pp_bs = ()
        if with_locate:
            assert self.has_locate, "artifact stores no locate tables"
            R = self.R
            # big_run_start, NOT run_start: DeviceIndex.idx_dtype keys off
            # "run_start" for the run-space engines; big lanes must be int64
            arrs["big_run_start"] = jnp.asarray(self.run_start)
            arrs["samples_last"] = jnp.asarray(self.samples_last)
            arrs["cruns_keys"] = jnp.asarray(self.cruns_keys)
            pr, pd = self._phi_pack()
            if pr is not None:
                # bitmap-rank phi: 2 dependent gathers per hop; pred_pos /
                # phi_at / pp_off stay on disk (phi_pack_tables)
                arrs["phi_rows"] = jnp.asarray(pr)
                arrs["phi_delta"] = jnp.asarray(pd)
            else:
                arrs["pred_pos"] = jnp.asarray(self.pred_pos)
                arrs["phi_at"] = jnp.asarray(self.phi_at)
                pp_off, pp_bs = marker_buckets(np.asarray(self.pred_pos),
                                               self.n)
                arrs["pp_off"] = jnp.asarray(pp_off)
        ma_bs = ()
        ma_rp = 0
        if with_markers:
            assert self.has_markers, "artifact stores no marker tables"
            arrs["ma_val"] = jnp.asarray(self.ma_val)
            rp = self._ma_runpack()
            nib = None if rp is not None else self._ma_cnt64()
            if rp is not None:
                # run-pack rank (marker_run_pack): ~8 MB of tables REPLACE
                # the device ma_row entirely — 3 dependent gather levels
                roff, sd16, rec, ma_rp = rp
                arrs["ma_roff"] = jnp.asarray(roff)
                arrs["ma_sd16"] = jnp.asarray(sd16)
                arrs["ma_rec"] = jnp.asarray(rec)
            elif nib is not None:
                arrs["ma_row"] = jnp.asarray(self.ma_row)
                arrs["ma_cnt64"] = jnp.asarray(nib)
            else:  # degenerate run structure: the bucketed bound serves
                arrs["ma_row"] = jnp.asarray(self.ma_row)
                off, ma_bs = marker_buckets(self.ma_row, self.n)
                arrs["ma_off"] = jnp.asarray(off)
        if self.doc_starts is not None:
            arrs["doc_starts"] = jnp.asarray(self.doc_starts.astype(np.int64))
        if device is not None:
            arrs = {k: jax.device_put(v, device) for k, v in arrs.items()}
        acgt = self.alpha.encode(np.frombuffer(b"ACGT", dtype=np.uint8))
        return DeviceIndex(arrays=arrs, n=self.n, R=R, A=self.A,
                           ma_wsize=self.ma_wsize,
                           ftab_k=0, acgt_codes=tuple(int(c) for c in acgt),
                           ma_bs=ma_bs, pp_bs=pp_bs, ma_rp=ma_rp)

    def sharded_index(self):
        """The position-sharded view (n_idx == n_sup shards) for mesh runs.

        The fb rank tables shard by position; the O(R) toehold/phi tables and
        the O(M) marker CSR REPLICATE (they are 20-300x smaller than the fb
        shards) — the sharded engines' `big_*` path (parallel/sharded_dense)."""
        from rowbowt_tpu.parallel.sharded_dense import ShardedDenseIndex

        bt = None
        k0 = 0
        pp_bs = ()
        if self.has_locate:
            bt = {"run_start": np.asarray(self.run_start),
                  "samples_last": np.asarray(self.samples_last),
                  "pred_pos": np.asarray(self.pred_pos),
                  "phi_at": np.asarray(self.phi_at),
                  "cruns_keys": np.asarray(self.cruns_keys)}
            bt["pp_off"], pp_bs = marker_buckets(np.asarray(self.pred_pos),
                                                 self.n)
            k0 = int((int(self.samples_last[-1]) + 1) % self.n)
        ma_bs = ()
        if self.has_markers:
            bt = bt or {}
            bt["ma_row"] = np.asarray(self.ma_row)
            bt["ma_val"] = np.asarray(self.ma_val)
            bt["ma_off"], ma_bs = marker_buckets(self.ma_row, self.n)
        return ShardedDenseIndex(
            fb3=np.ascontiguousarray(
                self.fb2.reshape(self.n_sup, self.per_blk, -1)),
            base=self.base, F=self.F.astype(np.int64), n=self.n, A=self.A,
            n_idx=self.n_sup, per_blk=self.per_blk, k0=k0,
            big_tables=bt, R=self.R, ma_wsize=self.ma_wsize, ma_bs=ma_bs,
            pp_bs=pp_bs,
        )
