"""Batched rank / LF primitives over the device tables.

Every reference hot op (SURVEY.md §3 hot-loop summary) is expressed here as
searchsorted + a constant number of gathers, vectorized over a batch of lanes:

  rle_string::rank   (rle_string.hpp:131-161) -> rank():       1 searchsorted + 2 gathers
  RowBowt::LF        (rowbowt.hpp:74-88)      -> lf_step():    2 ranks
  RowBowt::LF_w_loc  (rowbowt.hpp:553-573)    -> lf_step_w_loc(): LF + 1 gather
                                                 (dense last-c-run toehold table)
  ToeholdSA::phi     (toehold_sa.hpp:56-72)   -> phi_step():   1 searchsorted + 2 gathers

All functions take a DeviceIndex `dx` and int vectors; char code < 0 means
"absent from alphabet" and produces the empty range (1,0), matching the
reference's behavior for chars with no runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rowbowt_tpu.engine.device import DeviceIndex


def _ss(a, v, side):
    # scan_unrolled: the default 'scan' method nests a lax loop whose
    # per-iteration overhead dwarfs the gathers on this backend
    return jnp.searchsorted(a, v, side=side, method="scan_unrolled").astype(v.dtype)


def run_of(dx: DeviceIndex, i):
    """Run id containing BWT position i (i in [0, n-1])."""
    return _ss(dx.arrays["run_start"], i, "right") - 1


def rank_at_run(dx: DeviceIndex, i, c, r):
    """rank(i, c) given r = run_of(clamp(i, n-1)) precomputed.  i in [0, n]."""
    arr = dx.arrays
    R = dx.R
    csafe = jnp.maximum(c, 0)
    occ = arr["occ_flat"][csafe * R + r]
    head = arr["run_head"][r]
    v = occ + jnp.where(head == c, i - arr["run_start"][r], 0)
    total = arr["F"][csafe + 1] - arr["F"][csafe]
    v = jnp.where(i >= dx.n, total, v)
    return jnp.where(c < 0, 0, v)


def rank(dx: DeviceIndex, i, c):
    """Number of code-c chars in BWT[0:i), batched."""
    r = run_of(dx, jnp.minimum(i, dx.n - 1))
    return rank_at_run(dx, i, c, r)


_DB = 128  # dense block: symbols per occ checkpoint (construct.build.DENSE_BLOCK)
_DW = _DB // 8  # uint32 words per block


def rank_dense(dx: DeviceIndex, i, c):
    """Dense-FM rank: one checkpoint gather + one contiguous 64B block load +
    popcount.  ~8x less random device-memory traffic than the run-space
    rank."""
    arr = dx.arrays
    csafe = jnp.maximum(c, 0)
    isafe = jnp.minimum(i, dx.n - 1)
    blk = isafe >> 7
    off = isafe & (_DB - 1)
    nb = arr["bwt4"].shape[0] // _DW
    occ = arr["occ_blk_flat"][csafe * nb + blk]
    words = arr["bwt4"][blk[:, None] * _DW + jnp.arange(_DW, dtype=blk.dtype)[None, :]]
    shifts = (jnp.arange(8, dtype=jnp.uint32) * 4)[None, None, :]
    nib = ((words[:, :, None] >> shifts) & jnp.uint32(15)).astype(jnp.int32)
    pos = (jnp.arange(_DW)[:, None] * 8 + jnp.arange(8)[None, :])[None, :, :]
    hit = (nib == c[:, None, None].astype(jnp.int32)) & (pos < off[:, None, None])
    inblk = jnp.sum(hit, axis=(1, 2)).astype(occ.dtype)
    v = occ + inblk
    total = arr["F"][csafe + 1] - arr["F"][csafe]
    v = jnp.where(i >= dx.n, total, v)
    return jnp.where(c < 0, 0, v)


_FB_CKPT = 8
_FB_WORDS = _DB // 8
_FB_ROW = _FB_CKPT + _FB_WORDS
# plain int (NOT a jnp constant): a module-level jnp value would initialize
# the jax backend at import time, which breaks jax.distributed.initialize in
# multi-process launchers that import engine modules before init
_NIB_LOW = 0x11111111
_PHI_POS = 480  # positions per 64B phi bitmap row (bigindex.phi_pack_tables)


def _fb_rank_from_rows(row, off, c):
    """rank within one gathered fblock row: checkpoint select + SWAR popcount.

    row [B, 8+nw] int32 (nw packed words: 16 for the 128-sym/96B layout, 8 for
    the 64-sym/64B one), off [B] symbol offset in block, c [B] code in [0, 8).
    """
    nw = row.shape[1] - _FB_CKPT
    sel = jnp.arange(_FB_CKPT, dtype=jnp.int32)[None, :] == c[:, None].astype(jnp.int32)
    occ = jnp.sum(jnp.where(sel, row[:, :_FB_CKPT], 0), axis=1)
    words = jax.lax.bitcast_convert_type(row[:, _FB_CKPT:], jnp.uint32)
    pat = (c.astype(jnp.uint32) * _NIB_LOW)[:, None]
    x = words ^ pat
    t = x | (x >> 1) | (x >> 2) | (x >> 3)
    match = (~t) & _NIB_LOW  # bit 4j set where nibble j == c
    # word w covers symbols [8w, 8w+8); keep nibbles below off
    kn = jnp.clip(off[:, None] - 8 * jnp.arange(nw, dtype=off.dtype)[None, :], 0, 8)
    mask = jnp.where(kn >= 8, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << (4 * kn.astype(jnp.uint32))) - 1)
    inblk = jnp.sum(jax.lax.population_count(match & mask), axis=1)
    return occ + inblk.astype(occ.dtype)


def rank_fblock(dx: DeviceIndex, i, c):
    """Fused-block rank: ONE row gather (96B, checkpoint + packed symbols in
    the same memory transaction) + SWAR popcount.  i in [0, n]."""
    arr = dx.arrays
    isafe = jnp.minimum(i, dx.n - 1)
    blk = (isafe >> 7).astype(jnp.int32)
    off = isafe & (_DB - 1)
    row = arr["fblock"][blk]  # [B, 24]
    csafe = jnp.maximum(c, 0)
    v = _fb_rank_from_rows(row, off, csafe).astype(i.dtype)
    total = dx.arrays["F"][csafe + 1] - dx.arrays["F"][csafe]
    v = jnp.where(i >= dx.n, total, v)
    return jnp.where(c < 0, 0, v)


def rank_fblock64(dx: DeviceIndex, i, c):
    """64-symbol/64B-row fused-block rank — the default device layout.

    Same contract as rank_fblock, two thirds of the bytes per row gather
    though the table is LARGER (1.0 vs 0.75 B/symbol).  Row gathers pay per
    memory transaction, which is why the smaller row is the default; its
    margin on the GPU is not measured yet (tools/fblock_probe.py part3)."""
    arr = dx.arrays
    isafe = jnp.minimum(i, dx.n - 1)
    blk = (isafe >> 6).astype(jnp.int32)
    off = isafe & 63
    row = arr["fblock64"][blk]  # [B, 16]
    csafe = jnp.maximum(c, 0)
    v = _fb_rank_from_rows(row, off, csafe).astype(i.dtype)
    total = dx.arrays["F"][csafe + 1] - dx.arrays["F"][csafe]
    v = jnp.where(i >= dx.n, total, v)
    return jnp.where(c < 0, 0, v)


def lf_step_fblock64(dx: DeviceIndex, lo, hi, c):
    """Batched LF over the 64B-row fused-block table."""
    c_before = rank_fblock64(dx, lo, c)
    c_inside = rank_fblock64(dx, hi + 1, c) - c_before
    nlo = _f_onehot(dx, c).astype(lo.dtype) + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)
    one = jnp.ones((), dtype=nlo.dtype)
    zero = jnp.zeros((), dtype=nlo.dtype)
    return jnp.where(empty, one, nlo), jnp.where(empty, zero, nhi)


def rank_fblock2(dx: DeviceIndex, i, c, key: str = "fb2", shift: int = 7):
    """Two-level fused-block rank — the single-chip n >= 2^31 path.

    fb2 int32[nb_pad, 24] rows whose 8 checkpoint lanes are SUPERBLOCK-local
    (a superblock spans per_blk rows < 2^31 symbols, so int32 cannot
    overflow); fb2_base int64[n_sup, 8] carries the global count before each
    superblock (the u64 contract of toehold_sa.hpp:133-155).  Lanes i are
    int64; the row gather index is int32 (nb < 2^31 up to n = 2^38).
    rank = base[superblock_of(i), c] + local checkpoint + in-block popcount.

    (key="fb2_64", shift=6) is the 64-symbol/64B-row repack — same contract,
    half the bytes per row gather (the winning layout out of cache,
    tools/fblock_probe.py part3)."""
    arr = dx.arrays
    fb2 = arr[key]
    base = arr["fb2_base"]
    per_blk = fb2.shape[0] // base.shape[0]
    csafe = jnp.maximum(c, 0)
    isafe = jnp.minimum(i, dx.n - 1)
    blk = (isafe >> shift).astype(jnp.int32)
    off = (isafe & ((1 << shift) - 1)).astype(jnp.int32)
    row = fb2[blk]  # [B, 8+nw] int32
    v32 = _fb_rank_from_rows(row, off, csafe.astype(jnp.int32))
    sel = jnp.arange(_FB_CKPT, dtype=jnp.int32)[None, :] == (
        csafe[:, None].astype(jnp.int32))
    b = jnp.sum(jnp.where(sel, base[blk // per_blk], 0), axis=1)
    v = v32.astype(i.dtype) + b.astype(i.dtype)
    total = (arr["F"][csafe + 1] - arr["F"][csafe]).astype(i.dtype)
    v = jnp.where(i >= dx.n, total, v)
    return jnp.where(c < 0, 0, v)


def _fb2_key(dx: DeviceIndex):
    """(key, shift) of the resident two-level layout: 64-symbol/64B rows when
    repacked, 256-symbol/160B rows (the giant-config shape: 0.63 B/symbol for
    a 10^10-symbol table), else the 128-symbol/96B build rows."""
    if "fb2_64" in dx.arrays:
        return "fb2_64", 6
    if "fb2_256" in dx.arrays:
        return "fb2_256", 8
    return "fb2", 7


def lf_step_fblock2(dx: DeviceIndex, lo, hi, c):
    """Batched LF over the two-level table: int64 range arithmetic."""
    key, shift = _fb2_key(dx)
    c_before = rank_fblock2(dx, lo, c, key, shift)
    c_inside = rank_fblock2(dx, hi + 1, c, key, shift) - c_before
    nlo = _f_onehot(dx, c).astype(lo.dtype) + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)
    one = jnp.ones((), dtype=nlo.dtype)
    zero = jnp.zeros((), dtype=nlo.dtype)
    return jnp.where(empty, one, nlo), jnp.where(empty, zero, nhi)


def lf_step_fblock(dx: DeviceIndex, lo, hi, c):
    """Batched LF over the fused-block table: 2 row gathers per lane-step."""
    csafe = jnp.maximum(c, 0)
    c_before = rank_fblock(dx, lo, c)
    c_inside = rank_fblock(dx, hi + 1, c) - c_before
    nlo = _f_onehot(dx, c).astype(lo.dtype) + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)
    one = jnp.ones((), dtype=nlo.dtype)
    zero = jnp.zeros((), dtype=nlo.dtype)
    return jnp.where(empty, one, nlo), jnp.where(empty, zero, nhi)


def _f_onehot(dx: DeviceIndex, c):
    """F[c] via one-hot dot over the tiny F table — avoids a gather op."""
    F = dx.arrays["F"]
    A = dx.A
    sel = (jnp.arange(A, dtype=jnp.int32)[None, :] == c[:, None].astype(jnp.int32))
    return jnp.sum(jnp.where(sel, F[None, :A], 0), axis=1)


def rank_occ1(dx: DeviceIndex, i, c):
    """Full-positional-occ rank: exactly ONE gathered element."""
    arr = dx.arrays
    csafe = jnp.maximum(c, 0).astype(i.dtype)
    n1 = dx.n + 1
    v = arr["occ1_flat"][csafe * n1 + jnp.clip(i, 0, dx.n)]
    return jnp.where(c < 0, 0, v.astype(i.dtype))


def lf_step_occ1(dx: DeviceIndex, lo, hi, c):
    """Batched LF at 2 gathered elements per lane-step (count fast path)."""
    c_before = rank_occ1(dx, lo, c)
    c_inside = rank_occ1(dx, hi + 1, c) - c_before
    nlo = _f_onehot(dx, c).astype(lo.dtype) + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)
    one = jnp.ones((), dtype=nlo.dtype)
    zero = jnp.zeros((), dtype=nlo.dtype)
    return jnp.where(empty, one, nlo), jnp.where(empty, zero, nhi)


def lf_step_dense(dx: DeviceIndex, lo, hi, c):
    """Batched LF over the dense tables (count fast path)."""
    arr = dx.arrays
    csafe = jnp.maximum(c, 0)
    c_before = rank_dense(dx, lo, c)
    c_inside = rank_dense(dx, hi + 1, c) - c_before
    nlo = arr["F"][csafe] + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)
    one = jnp.ones((), dtype=nlo.dtype)
    zero = jnp.zeros((), dtype=nlo.dtype)
    return jnp.where(empty, one, nlo), jnp.where(empty, zero, nhi)


def lf_step_auto(dx: DeviceIndex, prefer_fb96: bool = False):
    """The LF step for the index's resident tables (one if-chain for all
    engines), in this order: fblock rows (2 row gathers + SWAR; the row
    table is 37x smaller than occ1, which cannot exist at chr scale), the
    two-level fb2 rows, occ1, the bwt4/occ_blk split, run space.  fblock64
    (64B rows) is the default DeviceIndex load layout.

    prefer_fb96=True picks the 96B rows when BOTH layouts are resident (small
    indexes keep both, engine/device.py) — for the greedy-seeding loop, whose
    LF steps interleave with marker probes and slot records.  This order and
    the thresholds behind it were chosen on other hardware; re-tuning them on
    the GPU is open (tools/fblock_probe.py measures the candidates)."""
    if prefer_fb96 and "fblock" in dx.arrays:
        return lf_step_fblock
    if "fblock64" in dx.arrays:
        return lf_step_fblock64
    if "fblock" in dx.arrays:
        return lf_step_fblock
    if "fb2" in dx.arrays or "fb2_64" in dx.arrays or "fb2_256" in dx.arrays:
        return lf_step_fblock2
    if "occ1_flat" in dx.arrays:
        return lf_step_occ1
    if dx.has_dense:
        return lf_step_dense
    return lf_step


def lf_step(dx: DeviceIndex, lo, hi, c):
    """Batched RowBowt::LF(range, c): (lo', hi') with empty ranges as (1, 0)."""
    arr = dx.arrays
    csafe = jnp.maximum(c, 0)
    c_before = rank(dx, lo, c)
    c_inside = rank(dx, hi + 1, c) - c_before
    nlo = arr["F"][csafe] + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)
    one = jnp.ones((), dtype=nlo.dtype)
    zero = jnp.zeros((), dtype=nlo.dtype)
    return jnp.where(empty, one, nlo), jnp.where(empty, zero, nhi)


def lf_step_w_loc_occ1(dx: DeviceIndex, lo, hi, c, k):
    """Toehold LF at 4 gathered elements per lane-step: occ1 ranks + the dense
    tk1 table (tk1[c,i] = (SA[j]+n-1)%n for the last j<=i with BWT[j]==c) —
    exactly the reference's samples_last[run_of(last c before hi+1)]."""
    arr = dx.arrays
    n1 = dx.n + 1
    csafe = jnp.maximum(c, 0).astype(lo.dtype)
    o_lo = arr["occ1_flat"][csafe * n1 + jnp.clip(lo, 0, dx.n)]
    o_hi1 = arr["occ1_flat"][csafe * n1 + jnp.clip(hi + 1, 0, dx.n)]
    o_hi = arr["occ1_flat"][csafe * n1 + jnp.clip(hi, 0, dx.n)]
    c_before = jnp.where(c < 0, 0, o_lo.astype(lo.dtype))
    c_inside = jnp.where(c < 0, 0, (o_hi1 - o_lo).astype(lo.dtype))
    nlo = _f_onehot(dx, c).astype(lo.dtype) + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)
    trivial = (o_hi1 - o_hi) == 1  # BWT[hi] == c
    nk = jnp.where(
        trivial,
        jnp.where(k == 0, dx.n - 1, k - 1),
        arr["tk1_flat"][csafe * dx.n + jnp.clip(hi, 0, dx.n - 1)],
    )
    one = jnp.ones((), dtype=nlo.dtype)
    zero = jnp.zeros((), dtype=nlo.dtype)
    return (
        jnp.where(empty, one, nlo),
        jnp.where(empty, zero, nhi),
        jnp.where(empty, zero, nk.astype(lo.dtype)),
    )


def lf_step_w_loc(dx: DeviceIndex, lo, hi, c, k):
    """Batched RowBowt::LF_w_loc: LF + toehold maintenance.

    Requires the dense `ltk` table: ltk[c*R + r] = samples_last of the last
    c-run at or before run r (built by construct.build when SA samples are on).
    """
    arr = dx.arrays
    R = dx.R
    csafe = jnp.maximum(c, 0)

    r_hi1 = run_of(dx, jnp.minimum(hi + 1, dx.n - 1))
    # run containing hi itself (hi+1 may start a new run)
    r_hi = r_hi1 - jnp.where(
        (hi + 1 < dx.n) & (arr["run_start"][r_hi1] == hi + 1), 1, 0
    )
    c_before = rank(dx, lo, c)
    c_at_hi1 = rank_at_run(dx, hi + 1, c, jnp.where(hi + 1 >= dx.n, r_hi, r_hi1))
    c_inside = c_at_hi1 - c_before
    nlo = arr["F"][csafe] + c_before
    nhi = nlo + c_inside - 1
    empty = (c_inside <= 0) | (c < 0)

    trivial = arr["run_head"][r_hi] == c
    nk = jnp.where(
        trivial,
        jnp.where(k == 0, dx.n - 1, k - 1),
        arr["ltk"][csafe * R + r_hi],
    )
    one = jnp.ones((), dtype=nlo.dtype)
    zero = jnp.zeros((), dtype=nlo.dtype)
    return (
        jnp.where(empty, one, nlo),
        jnp.where(empty, zero, nhi),
        jnp.where(empty, zero, nk),
    )


def phi_step(dx: DeviceIndex, i):
    """Batched ToeholdSA::phi (toehold_sa.hpp:56-72); one gather via the dense
    phi1 table when built, else predecessor searchsorted.

    The run-space tables may be stored narrow (u32 positions / i32 run ids —
    the big-index layout, bigindex.py); queries and results are cast through
    the table dtype and back, so lanes stay int64 at any n."""
    arr = dx.arrays
    if "phi1" in arr:
        return arr["phi1"][jnp.clip(i, 0, dx.n - 1)]
    if "phi_rows" in arr:
        # bitmap-rank hop (bigindex.phi_pack_tables): ONE 64B row gather
        # ([ckpt | 15 bit words] per 480 positions) + SWAR popcount gives the
        # predecessor rank, one delta gather finishes — 2 dependent gathers
        # per hop instead of the bucketed search's ~1 + iters + 2
        rows_tab = arr["phi_rows"]
        blk = (i // _PHI_POS).astype(jnp.int32)
        off = (i - blk.astype(i.dtype) * _PHI_POS).astype(jnp.int32)
        row = rows_tab[blk]  # [B, 16] int32
        ck = row[:, 0]
        words = jax.lax.bitcast_convert_type(row[:, 1:], jnp.uint32)  # [B,15]
        # count bits with local index <= off: kn bits of word jw
        kn = jnp.clip(off[:, None] + 1
                      - 32 * jnp.arange(15, dtype=jnp.int32)[None, :], 0, 32)
        mask = jnp.where(kn >= 32, jnp.uint32(0xFFFFFFFF),
                         (jnp.uint32(1) << kn.astype(jnp.uint32))
                         - jnp.uint32(1))
        inblk = jnp.sum(jax.lax.population_count(words & mask), axis=1)
        rk = (ck + inblk.astype(jnp.int32)) - 1  # pred_pos[0]==0 -> rk >= 0
        d = arr["phi_delta"][jnp.maximum(rk, 0)].astype(i.dtype)
        return (i + d) % dx.n
    if "phi_at" in arr:
        # exact SA-adjacency breakpoint table (bigindex.big_locate_tables):
        # phi is piecewise i + const; pred_pos[0] == 0 so rk >= 0 always
        pp = arr["pred_pos"]
        if "pp_off" in arr:
            # bucketed: 1 + iters gathers per hop instead of log2(R) ~ 28
            shift, iters = dx.pp_bs
            rk = bucketed_lower_bound(pp, arr["pp_off"], shift, iters,
                                      i + 1) - 1
        else:
            rk = jnp.searchsorted(pp, i.astype(pp.dtype), side="right",
                                  method="scan_unrolled").astype(i.dtype) - 1
        base = arr["phi_at"][rk].astype(i.dtype)
        return (base + (i - pp[rk].astype(i.dtype))) % dx.n
    pp = arr["pred_pos"]
    rk = jnp.searchsorted(pp, i.astype(pp.dtype), side="left",
                          method="scan_unrolled").astype(i.dtype)
    jr = jnp.where(rk == 0, dx.R - 1, rk - 1)
    j = pp[jr].astype(i.dtype)
    delta = jnp.where(j < i, i - j, i + 1)
    prev_sample = arr["samples_last"][arr["pred_to_run"][jr] - 1].astype(i.dtype)
    return (prev_sample + delta) % dx.n


def markers_bounds(dx: DeviceIndex, lo, hi):
    """(start offset, count) of the markers at BWT rows [lo, hi]: two gathers
    via the dense ma_start1 table when built, else two binary searches."""
    arr = dx.arrays
    if "ma_start1" in arr:
        ms = arr["ma_start1"]
        s = ms[jnp.clip(lo, 0, dx.n)]
        e = ms[jnp.clip(hi + 1, 0, dx.n)]
    elif "ma_rec" in arr:
        # run-pack rank (bigindex.marker_run_pack): 3 dependent gather
        # levels, ~8 MB of tables, no device ma_row
        s = _ms_runs(dx, jnp.clip(lo, 0, dx.n))
        e = _ms_runs(dx, jnp.clip(hi + 1, 0, dx.n))
    elif "ma_cnt64" in arr:
        # ONE fused-row gather per probe (bigindex.marker_nibble_rank):
        # checkpoint + SWAR nibble-sum, the chr dense path's cost profile
        s = _ms_nibble(dx, jnp.clip(lo, 0, dx.n))
        e = _ms_nibble(dx, jnp.clip(hi + 1, 0, dx.n))
    elif "ma_off" in arr:
        # bucketed lower bound (bigindex.marker_buckets): 1 bucket gather +
        # iters binary-search gathers instead of log2(M) — this chain sits
        # inside the marker engines' LF loop, so its length is throughput
        s = _ms_bucketed(dx, jnp.clip(lo, 0, dx.n))
        e = _ms_bucketed(dx, jnp.clip(hi + 1, 0, dx.n))
    else:
        mr = arr["ma_row"]  # may be u32 (big layout); cast through and back
        s = jnp.searchsorted(mr, jnp.clip(lo, 0, dx.n).astype(mr.dtype),
                             side="left", method="scan_unrolled").astype(lo.dtype)
        e = jnp.searchsorted(mr, jnp.clip(hi + 1, 0, dx.n).astype(mr.dtype),
                             side="left", method="scan_unrolled").astype(lo.dtype)
    return s, jnp.maximum(e - s, 0)


def bucketed_lower_bound(vals, off, shift: int, iters: int, q):
    """First index i with vals[i] >= q over a sorted value table, via its
    bucket table (bigindex.marker_buckets): off[b] bounds the search to q's
    2^shift-wide value bucket, then a STATIC `iters`-step branchless binary
    search (iters = ceil(log2(max segment)) at build) finishes.  1 + iters
    dependent gathers instead of log2(len(vals)) — the lever that makes
    in-loop probes of the O(M)/O(R) big tables affordable (DESIGN.md)."""
    b = jnp.clip(q >> shift, 0, off.shape[0] - 2).astype(jnp.int32)
    lo = off[b].astype(q.dtype)
    hi = off[b + 1].astype(q.dtype)
    qv = q.astype(vals.dtype)
    M1 = vals.shape[0] - 1
    # gather-index dtype must cover the table length: int32 wraps negative
    # for >= 2^31-entry tables (the nibble path refuses those; this one serves)
    mid_dt = jnp.int32 if vals.shape[0] < (1 << 31) else jnp.int64
    for _ in range(iters):
        mid = (lo + hi) >> 1
        v = vals[jnp.clip(mid, 0, M1).astype(mid_dt)]
        take = (v < qv) & (lo < hi)
        hi = jnp.where(take | (lo >= hi), hi, mid)
        lo = jnp.where(take, mid + 1, lo)
    return lo


def _ms_bucketed(dx: DeviceIndex, i):
    """ma_start1[i] (count of CSR entries with row < i) via the bucket table."""
    shift, iters = dx.ma_bs
    arr = dx.arrays
    return bucketed_lower_bound(arr["ma_row"], arr["ma_off"], shift, iters, i)


def _ms_runs(dx: DeviceIndex, i):
    """ma_start1[i] via the run-pack tables (bigindex.marker_run_pack).

    j = last marker run with start <= i resolves as off[b] + (count of
    in-bucket run starts <= i) - 1; the count reads a STATIC dx.ma_rp
    sd16 rows (64B each, 32 u16 start-deltas SWAR-packed in 16 i32 lanes,
    gathers independent of each other), then ONE 16B rec gather yields
    rank(i) = cum[j] + mult[j] * clip(i - start[j], 0, len[j]).  Runs in
    earlier buckets are handled by count == 0 -> j = off[b] - 1 (starts are
    globally sorted); j < 0 means no run precedes i -> rank 0."""
    arr = dx.arrays
    off, sd, rec = arr["ma_roff"], arr["ma_sd16"], arr["ma_rec"]
    shift, nrows = dx.ma_rp
    isafe = jnp.clip(i, 0, dx.n).astype(jnp.int64)
    b = jnp.minimum(isafe >> shift, off.shape[0] - 2).astype(jnp.int32)
    s = off[b].astype(jnp.int64)
    e = off[b + 1].astype(jnp.int64)
    qlo = (isafe & 0xFFFF).astype(jnp.int32)
    r0 = (s >> 5).astype(jnp.int32)
    nr = sd.shape[0]
    lane2 = 2 * jnp.arange(16, dtype=jnp.int64)[None, :]
    cnt = jnp.zeros(isafe.shape, jnp.int64)
    for j in range(nrows):
        w = sd[jnp.minimum(r0 + j, nr - 1)]  # [B, 16] i32 = 32 u16 deltas
        lo16 = w & 0xFFFF
        hi16 = (w >> 16) & 0xFFFF
        pos = (((r0 + j).astype(jnp.int64)) << 5)[:, None] + lane2
        in_lo = (pos >= s[:, None]) & (pos < e[:, None])
        in_hi = (pos + 1 >= s[:, None]) & (pos + 1 < e[:, None])
        ql = qlo[:, None]
        cnt = cnt + (jnp.sum(in_lo & (lo16 <= ql), axis=1)
                     + jnp.sum(in_hi & (hi16 <= ql), axis=1))
    jj = s + cnt - 1
    r = rec[jnp.clip(jj, 0, rec.shape[0] - 1).astype(jnp.int32)]  # [B, 2]
    start, packed = r[:, 0], r[:, 1]
    cum = packed & 0xFFFFFFFF
    ln = (packed >> 32) & 0xFFFFFF
    mu = (packed >> 56) & 0x7F
    rank = cum + mu * jnp.clip(isafe - start, 0, ln)
    return jnp.where(jj < 0, 0, rank).astype(i.dtype)


def _ms_nibble(dx: DeviceIndex, i):
    """ma_start1[i] via the nibble-count fused rows: one 64B/16-lane row
    gather ([ckpt | 8 words of per-row 4-bit entry counts | 7 pad] per 64 BWT
    rows) + a VPU SWAR nibble-sum of the counts below i's in-block offset."""
    tab = dx.arrays["ma_cnt64"]  # [nb+1, 16] int32 (64B rows)
    nb = tab.shape[0] - 1
    isafe = jnp.clip(i, 0, dx.n)
    blk = jnp.minimum(isafe >> 6, nb).astype(jnp.int32)
    off = (isafe - (blk.astype(i.dtype) << 6)).astype(jnp.int32)
    row = tab[blk]
    ck = row[:, 0]
    words = jax.lax.bitcast_convert_type(row[:, 1:9], jnp.uint32)  # [B, 8]
    kn = jnp.clip(off[:, None]
                  - 8 * jnp.arange(8, dtype=jnp.int32)[None, :], 0, 8)
    mask = jnp.where(kn >= 8, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << (4 * kn.astype(jnp.uint32))) - 1)
    t = words & mask
    s1 = (t & jnp.uint32(0x0F0F0F0F)) + ((t >> 4) & jnp.uint32(0x0F0F0F0F))
    per_word = (s1 * jnp.uint32(0x01010101)) >> 24  # sum of 4 bytes (<= 120)
    inblk = jnp.sum(per_word.astype(jnp.int32), axis=1)
    return (ck + inblk).astype(i.dtype)


def markers_at_range(dx: DeviceIndex, lo, hi, max_k: int):
    """Batched MarkerArray::at_range: up to max_k packed markers per lane.

    Returns (vals [B, max_k] int64, count [B]).  Lanes with empty/invalid
    ranges return count 0.  count may exceed max_k (caller sees truncation).
    """
    arr = dx.arrays
    s, cnt = markers_bounds(dx, lo, hi)
    offs = jnp.arange(max_k, dtype=s.dtype)[None, :]
    pos = jnp.minimum(s[:, None] + offs, arr["ma_val"].shape[0] - 1)
    vals = arr["ma_val"][pos]
    valid = offs < cnt[:, None]
    vals = jnp.where(valid, vals, -1)
    return vals, cnt


def doc_of(dx: DeviceIndex, i):
    """Batched DocList lookup: doc id containing text position i."""
    return _ss(dx.arrays["doc_starts"], i, "right") - 1


def kmer_codes(dx: DeviceIndex, codes):
    """Big-endian 2-bit encode of [B, k] index codes; -1 where any char isn't ACGT."""
    a, c, g, t = dx.acgt_codes
    base = jnp.full(codes.shape, -1, dtype=jnp.int32)
    for b, cc in enumerate((a, c, g, t)):
        base = jnp.where(codes == cc, b, base)
    valid = jnp.all(base >= 0, axis=-1)
    k = codes.shape[-1]
    weights = (4 ** jnp.arange(k - 1, -1, -1, dtype=jnp.int32))
    v = jnp.sum(base * weights, axis=-1)
    return jnp.where(valid, v, -1)


def ftab_lookup(dx: DeviceIndex, kcodes):
    """search_ftab: (lo, hi, hit) — misses return the full range with hit=False."""
    arr = dx.arrays
    ft = arr["ftab"]
    safe = jnp.maximum(kcodes, 0)
    lo = ft[safe, 0]
    hi = ft[safe, 1]
    hit = (kcodes >= 0) & (lo >= 0)
    zero = jnp.zeros((), dtype=lo.dtype)
    return (
        jnp.where(hit, lo, zero),
        jnp.where(hit, hi, zero + dx.n - 1),
        hit,
    )


def bwt_sym(dx: DeviceIndex, i):
    """BWT code at position i (batched) from the packed fused-block words —
    ONE gathered int32 element per lane, no checkpoint read.

    Works on every fblock-family layout (96B/64B rows, single- or two-level):
    the superblock regions of fb2/fb2_64 are contiguous multiples of the
    block size, so the global row id is just i >> shift.  Out-of-range i is
    clamped; callers mask."""
    arr = dx.arrays
    for key, shift in (("fb2_64", 6), ("fblock64", 6),
                       ("fb2_256", 8), ("fb2", 7), ("fblock", 7)):
        if key in arr:
            tab = arr[key]
            break
    else:
        raise ValueError("bwt_sym needs an fblock-family table")
    isafe = jnp.clip(i, 0, dx.n - 1)
    blk = (isafe >> shift).astype(jnp.int32)
    off = (isafe & ((1 << shift) - 1)).astype(jnp.int32)
    w = tab[blk, _FB_CKPT + (off >> 3)]
    w = jax.lax.bitcast_convert_type(w, jnp.uint32)
    return ((w >> (4 * (off & 7)).astype(jnp.uint32)) & 15).astype(jnp.int32)


def toehold_from_range(dx: DeviceIndex, lo, hi):
    """Toehold of an arbitrary search state, via the invariant k == SA[hi].

    Both cases of the reference's per-step LF_w_loc (rowbowt.hpp:553-573) keep
    k equal to SA of the range's last row (trivial: SA[hi]-1 == SA[LF(hi)];
    table: samples_last[run(j)] == SA[j]-1 == SA[new hi]), and the initial
    get_last_run_sample (toehold_sa.hpp:97-99) is SA[n-1] — the hi of the
    zero-step full range.  So any engine can run the plain 2-gather count LF
    loop and resolve the toehold of its FINAL (or any recorded) range with
    this one kval gather.  Empty ranges return 0 (rowbowt.hpp:177-180)."""
    kv = dx.arrays["kval"]
    k = kv[jnp.clip(hi, 0, dx.n - 1)].astype(lo.dtype)
    return jnp.where(hi < lo, jnp.zeros((), dtype=lo.dtype), k)
