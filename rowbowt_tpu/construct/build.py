"""Text (+markers, docs) -> RbtIndex.

Replaces rb_build + construct_and_serialize_rowbowt
(/root/reference/src/rb_build.cpp, /root/reference/include/rowbowt_io.hpp:49-89):
one pass over the suffix array produces every device table.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from rowbowt_tpu.alphabet import Alphabet
from rowbowt_tpu.construct.panel import Marker, Panel
from rowbowt_tpu.construct.sa import suffix_array
from rowbowt_tpu.index import RbtIndex, pack_marker


def bwt_from_sa(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    return text[(sa - 1) % text.shape[0]]


DENSE_BLOCK = 128  # symbols per occ checkpoint block (16 uint32 words, 64B)

# full positional occ (occ1): one elem gather per rank, 4(n+1)A bytes.
# SUPERSEDED by fblock for panel builds (fblock is 37x smaller;
# tools/fblock_probe.py compares the two); still built for RAW-input
# indexes below this size, where the per-step toehold path lf_step_w_loc_occ1
# needs occ1+tk1 (no full SA -> no kval shortcut).
OCC1_MAX_N = 128_000_000


def build_occ1(codes: np.ndarray, A: int) -> np.ndarray:
    """occ1[c, i] = count of c in BWT[0:i), i in [0, n] inclusive (no edge case)."""
    n = codes.shape[0]
    occ1 = np.zeros((A, n + 1), dtype=np.int32 if n < (1 << 31) else np.int64)
    for c in range(A):
        np.cumsum(codes == c, out=occ1[c, 1:])
    return occ1


def build_dense_tables(codes: np.ndarray, A: int):
    """4-bit packed BWT + per-block occ checkpoints (the dense path: one
    contiguous 64B block load + one checkpoint gather per rank, replacing the
    20-level binary search over run starts).  codes: int64[n] in [0, A<=16)."""
    assert A <= 16
    n = codes.shape[0]
    nb = (n + DENSE_BLOCK - 1) // DENSE_BLOCK
    padded = np.zeros(nb * DENSE_BLOCK, dtype=np.uint32)
    padded[:n] = codes.astype(np.uint32)
    # pack 8 symbols per uint32, symbol j at bits [4j, 4j+4)
    grp = padded.reshape(-1, 8)
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, :]
    bwt4 = (grp << shifts).astype(np.uint32).sum(axis=1, dtype=np.uint32)
    # occ checkpoints: occ_blk[c, b] = count of c in codes[0 : b*BLOCK].
    # (last-block padding only lands in per_block[:, nb-1], which the exclusive
    # cumsum never uses; in-block rank masks by position, so pad value is moot)
    pc = padded.reshape(nb, DENSE_BLOCK)
    per_block = np.empty((A, nb), dtype=np.int64)
    for c in range(A):
        per_block[c] = (pc == c).sum(axis=1)
    occ_blk = np.zeros((A, nb), dtype=np.int64)
    occ_blk[:, 1:] = np.cumsum(per_block, axis=1)[:, :-1]
    return bwt4, occ_blk


FB_CKPT = 8  # checkpoint lanes per fblock row (alphabet codes must fit)
FB_WORDS = DENSE_BLOCK // 8  # 16 packed uint32 words per row
FB_ROW = FB_CKPT + FB_WORDS  # 24 int32 lanes = 96 bytes per 128 symbols


def build_fblock(codes: np.ndarray, A: int) -> np.ndarray:
    """Interleaved fused-block rank table: int32[nb, 24] rows of
    [8 per-char exclusive occ checkpoints | 16 packed 4-bit BWT words].

    One row gather + SWAR popcount = rank(i, c) — the checkpoint and the
    in-block symbols ride the same memory transaction (the dense analog of
    rle_string::rank's single cache-line locality, rle_string.hpp:131-161) at
    0.75 bytes/symbol vs occ1's 4*A bytes/symbol.
    """
    assert A <= FB_CKPT, f"fblock needs A<={FB_CKPT}, got {A}"
    n = codes.shape[0]
    assert n < (1 << 31), "fblock checkpoints are int32; shard first"
    nb = (n + DENSE_BLOCK - 1) // DENSE_BLOCK
    padded = np.full(nb * DENSE_BLOCK, 15, dtype=np.uint32)  # pad nibble 15: matches no code
    padded[:n] = codes.astype(np.uint32)
    grp = padded.reshape(-1, 8)
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, :]
    words = (grp << shifts).astype(np.uint32).sum(axis=1, dtype=np.uint32)
    pc = padded.reshape(nb, DENSE_BLOCK)
    fb = np.zeros((nb, FB_ROW), dtype=np.int32)
    for c in range(A):
        per_block = (pc == c).sum(axis=1)
        fb[1:, c] = np.cumsum(per_block)[:-1]
    fb[:, FB_CKPT:] = words.reshape(nb, FB_WORDS).view(np.int32)
    return fb


FB64_BLOCK = 64
FB64_WORDS = FB64_BLOCK // 8  # 8 packed uint32 words per row
FB64_ROW = FB_CKPT + FB64_WORDS  # 16 int32 lanes = 64 bytes per 64 symbols
# Row gathers pay per memory transaction more than per byte, so the 64B
# repack is the universal device layout; the threshold is an escape hatch
# (set above any n to force the 96B rows).  Both thresholds here were chosen
# on other hardware and are open for re-tuning on the GPU
# (tools/fblock_probe.py part3 measures the layouts).
FB64_MIN_N = 0

# Below this n a DeviceIndex keeps BOTH row layouts resident (0.75 + 1.0
# B/symbol — 14 MB at n=8M): the pure LF loops (count/locate/markers) run on
# the 64B rows and the greedy-seeding loop on the 96B rows
# (lf_step_auto(prefer_fb96=True)).
FB96_KEEP_MAX_N = 32_000_000


def fblock_to_fb64(fb: np.ndarray, n: int) -> np.ndarray:
    """Repack 128-symbol/96B fblock rows into 64-symbol/64B rows.

    int32[2*nb, 16] rows of [8 exclusive occ checkpoints | 8 packed words].
    Each source row splits in two: the even child keeps the parent checkpoint;
    the odd child adds the per-char count of the first 64 symbols (SWAR nibble
    match + popcount, no unpacking).  Pure layout change -- same contract as
    build_fblock, checked row-exact in tests/test_backends.py.
    """
    nb = fb.shape[0]
    words = fb[:, FB_CKPT:].view(np.uint32)  # [nb, 16]
    lo_half = words[:, :FB64_WORDS]  # first 64 symbols of each 128-block
    fb64 = np.zeros((2 * nb, FB64_ROW), dtype=np.int32)
    low = np.uint32(0x11111111)
    for c in range(FB_CKPT):
        x = lo_half ^ (np.uint32(c) * low)
        t = x | (x >> np.uint32(1)) | (x >> np.uint32(2)) | (x >> np.uint32(3))
        half_cnt = np.bitwise_count((~t) & low).sum(axis=1, dtype=np.int32)
        fb64[0::2, c] = fb[:, c]
        fb64[1::2, c] = fb[:, c] + half_cnt
    fb64[:, FB_CKPT:] = words.reshape(2 * nb, FB64_WORDS).view(np.int32)
    return fb64


# NOTE: a run-jump LF table (J=10 chained LF steps per gathered row, with
# host-side repair of lanes leaving the single-run regime) was built and
# DELETED: its host repair round-trips made it far slower than the plain
# 2-gather LF loop while doubling the index (16 bytes/symbol).  See
# DESIGN.md "negative results".


def core_tables(codes: np.ndarray, A: int):
    """Run structure + rank tables straight from the BWT code sequence.

    Mirrors what rle_string's streaming constructor extracts (rle_string.hpp:
    44-97) as dense arrays: run starts/heads, per-run exclusive occ
    checkpoints, the F array (BWT is a permutation of the text, so F comes
    from BWT counts), and per-char run-id lists.
    """
    n = codes.shape[0]
    change = np.flatnonzero(np.diff(codes) != 0) + 1
    run_start = np.concatenate(([0], change)).astype(np.int64)
    R = run_start.shape[0]
    run_head = codes[run_start].astype(np.uint8)
    run_len = np.diff(np.append(run_start, n))

    # occ[A, R]: exclusive cumulative count of each code before each run start
    occ = np.zeros((A, R), dtype=np.int64)
    contrib = np.zeros((A, R), dtype=np.int64)
    contrib[run_head, np.arange(R)] = run_len
    occ[:, 1:] = np.cumsum(contrib, axis=1)[:, :-1]

    counts = np.zeros(A + 1, dtype=np.int64)
    counts[1:] = np.bincount(codes, minlength=A)
    F = np.cumsum(counts)

    # per-char run lists (ascending run id within each char)
    order = np.argsort(run_head, kind="stable")
    cruns_flat = order.astype(np.int64)
    cruns_off = np.zeros(A + 1, dtype=np.int64)
    cruns_off[1:] = np.cumsum(np.bincount(run_head.astype(np.int64), minlength=A))
    return run_start, run_head, occ, F, cruns_flat, cruns_off


def build_toehold_tables(run_head, samples_last, sfirst, A: int):
    """Phi predecessor tables from per-run boundary samples (ToeholdSA::build_phi,
    toehold_sa.hpp:105-131): sfirst[r] = (SA[run_start[r]]+n-1)%n in BWT run
    order; samples_last[r] likewise at run ends."""
    R = run_head.shape[0]
    srt = np.argsort(sfirst, kind="stable")
    pred_pos = sfirst[srt]
    pred_to_run = srt.astype(np.int64)
    # ltk[c, r]: samples_last of the last c-run at or before run r — the
    # single-gather toehold table used by the batched LF_w_loc kernel.
    ltk = np.zeros((A, R), dtype=np.int64)
    rids = np.arange(R, dtype=np.int64)
    for c in range(A):
        marked = np.where(run_head == c, rids, -1)
        last = np.maximum.accumulate(marked)
        ltk[c] = np.where(last >= 0, samples_last[np.maximum(last, 0)], 0)
    return pred_pos, pred_to_run, ltk


def build_tk1_from_runs(codes, run_start, samples_last, A: int, dtype):
    """Dense toehold tk1[c, i] = samples_last of the last c-run ENDING at or
    before i.  Exactly matches the full-SA tk1 wherever the kernel reads it
    (lf_step_w_loc_occ1 only consults tk1[c, hi] when BWT[hi] != c, in which
    case the last c <= hi sits at a c-run end)."""
    n = codes.shape[0]
    R = run_start.shape[0]
    run_end = np.append(run_start[1:], n) - 1
    run_head = codes[run_start]
    tk1 = np.zeros((A, n), dtype=dtype)
    for c in range(A):
        ends = run_end[run_head == c]
        vals = samples_last[run_head == c]
        mark = np.full(n, -1, dtype=np.int64)
        mark[ends] = np.arange(ends.shape[0])
        ff = np.maximum.accumulate(mark)
        tk1[c] = np.where(ff >= 0, vals[np.maximum(ff, 0)], 0)
    return tk1


def build_phi1(pred_pos, pred_to_run, samples_last, n: int, dtype,
               chunk: int = 1 << 24):
    """Dense phi table: phi1[i] = ToeholdSA::phi(i) (toehold_sa.hpp:56-72)
    precomputed for every text position — the phi walk becomes one gather per
    located occurrence.  Chunked: peak temporaries are O(chunk), not O(n)
    (5 int64 n-arrays was the biggest RSS spike of a chr-scale build)."""
    out = np.empty(n, dtype=dtype)
    for lo in range(0, n, chunk):
        i = np.arange(lo, min(lo + chunk, n), dtype=np.int64)
        rk = np.searchsorted(pred_pos, i, side="left")
        jr = np.where(rk == 0, pred_pos.shape[0] - 1, rk - 1)
        j = pred_pos[jr]
        delta = np.where(j < i, i - j, i + 1)
        prev_sample = samples_last[pred_to_run[jr] - 1]
        out[lo: lo + i.shape[0]] = (prev_sample + delta) % n
    return out


def build_index(
    text: np.ndarray,
    markers: Sequence[Marker] | None = None,
    doc_starts: np.ndarray | None = None,
    doc_names: list[str] | None = None,
    ma_wsize: int = 10,
    with_sa_samples: bool = True,
    ftab_k: int = 0,
    sa: np.ndarray | None = None,
    dense: bool = True,
) -> RbtIndex:
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = int(text.shape[0])
    if sa is None:
        sa = suffix_array(text)
    bwt = bwt_from_sa(text, sa)

    alpha = Alphabet.from_text(text)
    codes = alpha.encode(bwt).astype(np.int64)  # all >= 0 by construction
    A = alpha.size
    run_start, run_head, occ, F, cruns_flat, cruns_off = core_tables(codes, A)
    R = run_start.shape[0]

    samples_last = pred_pos = pred_to_run = ltk = None
    if with_sa_samples:
        run_end = np.append(run_start[1:], n) - 1
        # text position of the BWT char of that row: (SA[i]+n-1) % n — the same
        # value the reference stores (y-1 with 0 -> n-1, toehold_sa.hpp:133-155)
        samples_last = (sa[run_end] + n - 1) % n
        sfirst = (sa[run_start] + n - 1) % n
        pred_pos, pred_to_run, ltk = build_toehold_tables(
            run_head, samples_last, sfirst, A
        )

    ma_row = ma_val = None
    if markers:
        # row i carries marker m iff SA[i] in (t-w, t] where t = marker text pos
        # (i.e. the variant lies within the first w characters of the suffix).
        isa = np.empty(n, dtype=np.int64)
        isa[sa] = np.arange(n, dtype=np.int64)
        # vectorized over all markers at once (a python loop here dominated
        # chr-scale builds): marker j covers text positions
        # [max(0, t_j-w+1), t_j], expanded with a flat repeat
        tpos = np.fromiter((m.text_pos for m in markers), np.int64, len(markers))
        packed = np.fromiter(
            (pack_marker(m.seq, m.pos, m.allele) for m in markers),
            np.int64, len(markers))
        lo_p = np.maximum(tpos - ma_wsize + 1, 0)
        span = tpos - lo_p + 1
        off = np.repeat(np.cumsum(span) - span, span)
        flat = np.arange(off.shape[0], dtype=np.int64) - off
        ps = np.repeat(lo_p, span) + flat
        ma_row = isa[ps]
        ma_val = np.repeat(packed, span)
        srt = np.lexsort((ma_val, ma_row))
        ma_row = ma_row[srt]
        ma_val = ma_val[srt]

    idx_dt = np.int32 if n < (1 << 31) - 2 else np.int64
    ma_start1 = None
    if ma_row is not None and dense and n < (1 << 31):
        # dense row -> marker-offset table: ma_start1[i] = #markers in rows
        # [0, i) — markers_at_range becomes two gathers instead of two
        # binary searches.  bincount+cumsum is O(M + n) with one n-temporary
        # (the searchsorted formulation was O(n log M) with int64 output)
        mdt = np.int32 if ma_row.shape[0] < (1 << 31) else np.int64
        cnt_per_row = np.bincount(ma_row, minlength=n).astype(mdt)
        ma_start1 = np.zeros(n + 1, dtype=mdt)
        np.cumsum(cnt_per_row, out=ma_start1[1:])
        del cnt_per_row

    bwt4 = occ_blk = kval = phi1 = fblock = None
    if dense and A <= 16:
        if A <= FB_CKPT and n < (1 << 31):
            # fused-block rows carry both the checkpoints and the packed BWT;
            # the split bwt4/occ_blk pair is only built when fblock can't be.
            # occ1 is NOT built for panel indexes: fblock beats it on hardware
            # and kval/phi1 cover the toehold/phi paths (tools/fblock_probe.py)
            fblock = build_fblock(codes, A)
        else:
            bwt4, occ_blk = build_dense_tables(codes, A)
        if with_sa_samples:
            # kval[i] = SA[i]: the toehold invariant through LF_w_loc
            # (rowbowt.hpp:553-573) is k == SA[hi] — both the trivial k-1
            # case and the samples_last[run] case land on SA of the new hi
            # — so the toehold of ANY search state is one gather from the
            # final hi; no per-step toehold maintenance at all.  4n bytes
            # each (int32), independent of the occ1 gate so chr-scale
            # indexes keep the 1-gather toehold + phi paths.
            kval = sa.astype(idx_dt)
            # with the FULL SA in hand, phi is SA-adjacency directly:
            # phi(SA[j]) = SA[j-1] (wrap j=0 -> SA[n-1]) — one scatter, ~40x
            # faster than the predecessor-searchsorted reconstruction (which
            # remains for sample-only raw builds, construct/rawio.py)
            phi1 = np.empty(n, dtype=idx_dt)
            phi1[sa[1:]] = sa[:-1].astype(idx_dt)
            phi1[sa[0]] = sa[n - 1]

    idx = RbtIndex(
        n=n,
        alpha=alpha,
        run_start=run_start,
        run_head=run_head,
        occ=occ,
        F=F,
        cruns_flat=cruns_flat,
        cruns_off=cruns_off,
        samples_last=samples_last,
        pred_pos=pred_pos,
        pred_to_run=pred_to_run,
        ltk=ltk,
        ma_row=ma_row,
        ma_val=ma_val,
        ma_start1=ma_start1,
        ma_wsize=ma_wsize,
        doc_starts=doc_starts.astype(np.int64) if doc_starts is not None else None,
        doc_names=doc_names,
        bwt4=bwt4,
        occ_blk=occ_blk,
        kval=kval,
        phi1=phi1,
        fblock=fblock,
    )
    if ftab_k:
        from rowbowt_tpu.engine.naive import build_ftab_dense

        idx.ftab = build_ftab_dense(idx, ftab_k)
        idx.ftab_k = ftab_k
    return idx


def build_index_from_panel(panel: Panel, **kw) -> RbtIndex:
    return build_index(
        panel.text,
        markers=panel.markers,
        doc_starts=panel.doc_starts,
        doc_names=panel.doc_names,
        ma_wsize=panel.wsize,
        **kw,
    )
