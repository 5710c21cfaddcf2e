"""Batched greedy seeding: the production rb_markers / rb_locs query paths.

Batched lockstep versions of the reference's data-dependent seeding loops:

- seeds_greedy_w_sample   == RowBowt::get_seeds_greedy_w_sample (rowbowt.hpp:222-256)
- markers_greedy_seeding  == RowBowt::get_markers_greedy_seeding (rowbowt.hpp:406-482),
  including the ftab kmer-shift restart scan (rowbowt.hpp:454-464)
- locate_from_longest_seed == RowBowt::locate_from_longest_seed (rowbowt.hpp:664-690)

The reference's per-read control flow (seed resets, the inner ftab restart
while-loop) becomes a per-lane state machine advanced one transition per
fori_loop iteration.  The ftab inner loop fuses into the failure transition:
every iteration computes both the LF step and the ftab probe for all lanes and
selects per lane, so each lane's position counter i advances >= 1 per iteration
and L iterations always complete the batch.

Variable-count outputs (seeds per read, markers per seed) become fixed-size
tables [B, S] / [B, S, K] plus true-count vectors; overflow is visible as
count > capacity.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.ops import rank as R
from rowbowt_tpu.ops import update as U


@partial(jax.jit, static_argnames=("min_length", "max_seeds"))
def seeds_greedy_w_sample(dx: DeviceIndex, qcodes, lengths, min_length: int,
                          max_seeds: int = 8):
    """Batched RowBowt::get_seeds_greedy_w_sample (rowbowt.hpp:222-256).

    Returns (slo, shi, sqs, sqe, ssamp) [B, S] and nseeds [B].  Seed i of lane
    b spans query offsets [sqs, sqe) (qend EXCLUSIVE, like the reference
    LFData from this routine) with BWT range (slo, shi) and toehold sample
    ssamp.  nseeds may exceed S (overflow: earliest seeds kept).
    """
    B, L = qcodes.shape
    S = max_seeds
    dt = dx.idx_dtype
    m = lengths.astype(dt)
    lo = jnp.zeros(B, dtype=dt)
    hi = jnp.full(B, dx.n - 1, dtype=dt)
    plo, phi_ = lo, hi
    first_k = (dx.arrays["samples_last"][dx.R - 1] + 1) % dx.n
    k = jnp.full(B, first_k, dtype=dt)
    pk = jnp.full(B, -1, dtype=dt)
    ei = m
    # transposed [S, B] so the loop-carried tables aren't lane-padded
    slo = jnp.full((S, B), 1, dtype=dt)
    shi = jnp.zeros((S, B), dtype=dt)
    sqs = jnp.zeros((S, B), dtype=dt)
    sqe = jnp.zeros((S, B), dtype=dt)
    ssamp = jnp.zeros((S, B), dtype=dt)
    ns = jnp.zeros(B, dtype=dt)
    defer_k = "kval" in dx.arrays  # ssamp == SA[recorded hi]: one gather at the end
    # big (n >= 2^31) layout: no dense kval/ltk — plain LF loop + per-seed
    # trajectory-span resolve (locate.traj_resolve_toehold) afterwards
    defer_big = (not defer_k) and "cruns_keys" in dx.arrays
    if defer_k or defer_big:
        plain = R.lf_step_auto(dx, prefer_fb96=True)

        def step(dx_, lo_, hi_, c_, k_):
            nlo, nhi = plain(dx_, lo_, hi_, c_)
            return nlo, nhi, k_
    elif "tk1_flat" in dx.arrays:
        step = R.lf_step_w_loc_occ1
    else:
        step = R.lf_step_w_loc

    def body(j, st):
        lo, hi, plo, phi_, k, pk, ei, slo, shi, sqs, sqe, ssamp, ns = st
        c = qcodes[:, L - 1 - j].astype(dt)
        active = j < m
        nlo, nhi, nk = step(dx, lo, hi, c, k)
        fail = active & (nlo > nhi)
        ok = active & ~fail
        # failure: emit (prev, qstart=m-j, qend=ei, ssamp=pk) if long enough
        emit = fail & (ei - (m - j) >= min_length)
        rec = emit & (ns < S)
        slot = jnp.minimum(ns, S - 1).astype(jnp.int32)
        slo = U.tslot_set(slo, slot, rec, plo)
        shi = U.tslot_set(shi, slot, rec, phi_)
        sqs = U.tslot_set(sqs, slot, rec, m - j)
        sqe = U.tslot_set(sqe, slot, rec, ei)
        ssamp = U.tslot_set(ssamp, slot, rec, pk)
        ns = ns + emit.astype(dt)
        # state update
        lo = jnp.where(ok, nlo, jnp.where(fail, 0, lo))
        hi = jnp.where(ok, nhi, jnp.where(fail, dx.n - 1, hi))
        k = jnp.where(ok, nk, jnp.where(fail, jnp.asarray(first_k, dtype=dt), k))
        plo = jnp.where(ok, nlo, jnp.where(fail, 0, plo))
        phi_ = jnp.where(ok, nhi, jnp.where(fail, dx.n - 1, phi_))
        pk = jnp.where(ok, nk, pk)
        ei = jnp.where(fail, m - j - 1, ei)
        return lo, hi, plo, phi_, k, pk, ei, slo, shi, sqs, sqe, ssamp, ns

    st = (lo, hi, plo, phi_, k, pk, ei, slo, shi, sqs, sqe, ssamp, ns)
    if defer_big:
        def body_rec(j, st2):
            inner, hi_rec = st2
            hi_rec = jax.lax.dynamic_update_index_in_dim(
                hi_rec, inner[1], j, 0)  # pre-step hi
            return body(j, inner), hi_rec

        st, hi_rec = jax.lax.fori_loop(
            0, L, body_rec, (st, jnp.zeros((L, B), dtype=dt)))
        lo, hi, plo, phi_, k, pk, ei, slo, shi, sqs, sqe, ssamp, ns = st
    else:
        (lo, hi, plo, phi_, k, pk, ei, slo, shi, sqs, sqe, ssamp, ns
         ) = jax.lax.fori_loop(0, L, body, st)
    # tail seed (rowbowt.hpp:252-254): qstart=0, qend=ei, from prev state
    emit = ei >= min_length
    rec = emit & (ns < S)
    slot = jnp.minimum(ns, S - 1).astype(jnp.int32)
    slo = U.tslot_set(slo, slot, rec, plo)
    shi = U.tslot_set(shi, slot, rec, phi_)
    sqs = U.tslot_set(sqs, slot, rec, jnp.zeros_like(ei))
    sqe = U.tslot_set(sqe, slot, rec, ei)
    ssamp = U.tslot_set(ssamp, slot, rec, pk)
    ns = ns + emit.astype(dt)
    if defer_big:
        # per-seed span [a, b]: seed covers query offsets [sqs, sqe) and each
        # restarts from the full range, so its steps are m-sqe .. m-1-sqs;
        # its toehold is the span's trajectory resolve (SA[shi])
        from rowbowt_tpu.engine.locate import (
            traj_nontrivial, traj_resolve_toehold,
        )

        csteps = qcodes[:, ::-1].T.astype(jnp.int32)
        nontriv = traj_nontrivial(dx, hi_rec, csteps, m)
        a = m[None, :] - sqe
        b = m[None, :] - 1 - sqs
        ssamp = traj_resolve_toehold(dx, hi_rec, csteps, nontriv, a, b
                                     ).astype(dt)
        ssamp = jnp.where(shi < slo, jnp.zeros((), dtype=dt), ssamp)
    slo, shi, sqs, sqe, ssamp = slo.T, shi.T, sqs.T, sqe.T, ssamp.T
    if defer_k:
        # toehold invariant: the sample of every recorded (slo, shi) is
        # SA[shi] — resolved in one [B, S] kval gather instead of per-step
        # toehold maintenance.  (Degenerate full-range records under
        # min_length=0 get SA[n-1], the freshly-reset sample, where the
        # reference would report the previous seed's stale sample.)
        ssamp = R.toehold_from_range(dx, slo, shi)
    return slo, shi, sqs, sqe, ssamp, ns


@partial(jax.jit, static_argnames=("max_hits",))
def locate_from_longest_seed(dx: DeviceIndex, slo, shi, sqs, sqe, ssamp, ns,
                             max_hits: int):
    """Batched RowBowt::locate_from_longest_seed (rowbowt.hpp:664-690).

    Picks each lane's longest seed (first wins ties, like the reference's
    strict > scan) and phi-walks its range; positions are corrected by -qstart.
    Returns (locs [B, max_hits] pad -1, count [B]); lanes with no seeds
    return count 0.
    """
    from rowbowt_tpu.engine.locate import locate

    B, S = slo.shape
    lens = sqe - sqs
    valid = jnp.arange(S, dtype=ns.dtype)[None, :] < jnp.minimum(ns, S)[:, None]
    lens = jnp.where(valid, lens, -1)
    best = jnp.argmax(lens, axis=1)
    rows = jnp.arange(B)
    blo = slo[rows, best]
    bhi = shi[rows, best]
    bqs = sqs[rows, best]
    bk = ssamp[rows, best]
    has = (ns > 0) & (bhi >= blo)
    locs, cnt = locate(dx, jnp.where(has, blo, 1), jnp.where(has, bhi, 0), bk,
                       max_hits=max_hits)
    locs = jnp.where(locs >= 0, locs - bqs[:, None], -1)
    return locs, jnp.where(has, cnt, 0)


@partial(jax.jit, static_argnames=("wsize", "max_range", "max_seeds", "max_k",
                                   "use_ftab", "values"))
def markers_greedy_seeding(dx: DeviceIndex, qcodes, lengths, wsize: int,
                           max_range: int = 1 << 62, max_seeds: int = 8,
                           max_k: int = 16, use_ftab: bool = True,
                           values: bool = True):
    """Batched RowBowt::get_markers_greedy_seeding (rowbowt.hpp:406-482).

    Per lane, seeds are emitted exactly at the reference's fn() callsites
    (rowbowt.hpp:449, 481) with their window-probed marker buffers:

    Returns:
      slo, shi   [B, S]    seed BWT range (prev_range / final range)
      sqs, sqe   [B, S]    fn's (m-i, seed_ei-1) pair — qend INCLUSIVE, may
                           wrap below qstart for degenerate tail seeds
      mvals      [B, S, K] packed markers per seed, chronological append order
                           (pre sort/unique — apply engine.filters on host);
                           with values=False these are ma_val ENTRY IDS
                           (resolve on host: ma_val[ids], -1 = empty)
      mcnt       [B, S]    true marker count (> K means truncation)
      nseeds     [B]       true seed count (> S means truncation)
    """
    B, L = qcodes.shape
    S, K = max_seeds, max_k
    # each probe (window or seed-final) needs >= wsize fresh chars within its
    # seed, and a failure adds at most one extra probe per wsize span
    W = 2 * (L // max(wsize, 1)) + 4
    dt = dx.idx_dtype
    m = lengths.astype(dt)
    max_range = jnp.asarray(min(int(max_range), int(jnp.iinfo(dt).max)), dtype=dt)

    ftk = dx.ftab_k if (use_ftab and dx.has_ftab and L >= dx.ftab_k > 0) else 0
    if ftk and ftk - 1 > wsize:
        raise ValueError("wsize cannot be less than ftab k-1 (rowbowt.hpp:423-426)")

    lo = jnp.zeros(B, dtype=dt)
    hi = jnp.full(B, dx.n - 1, dtype=dt)
    i = jnp.zeros(B, dtype=dt)
    if ftk:
        kc = R.kmer_codes(dx, qcodes[:, L - ftk:])
        flo, fhi, hit = R.ftab_lookup(dx, kc)
        hit = hit & (m >= ftk)
        lo = jnp.where(hit, flo.astype(dt), lo)
        hi = jnp.where(hit, fhi.astype(dt), hi)
        i = jnp.where(hit, ftk, 0).astype(dt)
    plo, phi_ = lo, hi
    seed_ei = m
    window_ei = m

    # window records: marker offset/count + owning seed slot; values expand
    # after the loop.  All record tables are TRANSPOSED ([W, B] / [S, B]):
    # the batch rides the 128-lane minor dim, so loop-carrying them costs
    # their true size (a [B, W] layout pads W up to 128 lanes — the padding
    # traffic dominated this loop before; tools/greedy ablation + ops/update)
    # RANGE records (probes are deferred to ONE bulk markers_bounds after
    # the loop — at big scale the in-loop probe was ~9 masked gathers per
    # step riding the dependent LF chain); unwritten slots = empty (1, 0)
    wlo = jnp.ones((W, B), dtype=dt)
    whi = jnp.zeros((W, B), dtype=dt)
    wseed = jnp.zeros((W, B), dtype=dt)
    nrec = jnp.zeros(B, dtype=dt)
    slo = jnp.full((S, B), 1, dtype=dt)
    shi = jnp.zeros((S, B), dtype=dt)
    sqs = jnp.zeros((S, B), dtype=dt)
    sqe = jnp.zeros((S, B), dtype=dt)
    ns = jnp.zeros(B, dtype=dt)
    qflat = qcodes.reshape(-1).astype(dt)  # row-major [B*L]: lane b col j at b*L+j
    lane_base = (jnp.arange(B, dtype=dt) * L)

    # the greedy loop interleaves LF with marker probes + slot records; it
    # takes the 96B rows when the index keeps both layouts (lf_step_auto)
    lf = R.lf_step_auto(dx, prefer_fb96=True)
    # ftab-restart REPLAY state: instead of re-gathering a [B, k] query window
    # every step (10x the loop's gather traffic), a restart-hit lane
    # consumes the kmer's k chars one LF step at a
    # time from the FULL range.  search_ftab's value is exactly find_range of
    # those chars, and its miss->full-range quirk (rowbowt.hpp:757) is an
    # empty range mid-replay -> hold FULL for the rest of the replay.  i
    # advances 1/iteration either way, so L iterations still complete the
    # batch and all recorded (i, seed_ei, window_ei) values match the jump
    # formulation exactly.
    rp = jnp.zeros(B, dtype=dt)  # chars left to replay (0 = normal)
    rpmiss = jnp.zeros(B, dtype=bool)

    def body(_, st):
        (lo, hi, plo, phi_, i, seed_ei, window_ei, wlo, whi, wseed, nrec,
         slo, shi, sqs, sqe, ns, rp, rpmiss) = st
        active = i < m
        normal = active & (rp == 0)
        col = jnp.clip(L - 1 - i, 0, L - 1).astype(dt)
        c = qflat[lane_base + col].astype(dt)
        nlo, nhi = lf(dx, lo, hi, c)

        ok = normal & (nlo <= nhi)
        fail = normal & (nlo > nhi)

        # --- success path: window probe (rowbowt.hpp:472-478)
        w_trigger = ok & (window_ei - (m - i - 1) >= wsize)
        # --- failure path: seed-final probe of prev (rowbowt.hpp:448)
        f_probe = fail & (seed_ei - (m - i) >= wsize)
        # one markers-bounds probe per iteration, target selected per lane
        tlo = jnp.where(fail, plo, nlo)
        thi = jnp.where(fail, phi_, nhi)
        do = w_trigger | f_probe
        go = do & ((thi - tlo + 1) <= max_range)
        slot_r = jnp.minimum(nrec, W - 1).astype(jnp.int32)
        wlo = U.tslot_set(wlo, slot_r, go, tlo)
        whi = U.tslot_set(whi, slot_r, go, thi)
        wseed = U.tslot_set(wseed, slot_r, go, ns)
        nrec = nrec + go.astype(dt)
        window_ei = jnp.where(w_trigger, m - i - 1, window_ei)

        # --- failure: emit seed (prev, (m-i, seed_ei-1))
        rec = fail & (ns < S)
        slot = jnp.minimum(ns, S - 1).astype(jnp.int32)
        slo = U.tslot_set(slo, slot, rec, plo)
        shi = U.tslot_set(shi, slot, rec, phi_)
        sqs = U.tslot_set(sqs, slot, rec, m - i)
        sqe = U.tslot_set(sqe, slot, rec, seed_ei - 1)
        ns = ns + fail.astype(dt)
        # post-failure reset (rowbowt.hpp:450-453)
        plo = jnp.where(fail, 0, plo)
        phi_ = jnp.where(fail, dx.n - 1, phi_)
        seed_ei = jnp.where(fail, m - i - 1, seed_ei)
        window_ei = jnp.where(fail, m - i - 1, window_ei)

        if ftk:
            # restart scan (rowbowt.hpp:454-464): search_ftab returns the FULL
            # range (not a failure) on a missing kmer (rowbowt.hpp:757), so the
            # scan's hit check passes on the very first probe, always —
            # i += k+1, prev = probe range (possibly full).  The scan's miss
            # branch is dead code in the reference.  Here the jump becomes a
            # k-step replay from FULL range (see rp/rpmiss above).
            hit = fail & (m - i - 1 >= ftk)
            to_full = fail & ~hit
            seed_ei = jnp.where(hit, m - i - 1, seed_ei)
            window_ei = jnp.where(hit, m - i - 1, window_ei)
            rstep = active & (rp > 0)
            held = rpmiss | (rstep & (nlo > nhi))  # miss: hold FULL hereafter
            rlo = jnp.where(held, 0, nlo)
            rhi = jnp.where(held, dx.n - 1, nhi)
            lo = jnp.where(ok, nlo, jnp.where(
                hit | to_full, 0, jnp.where(rstep, rlo, lo)))
            hi = jnp.where(ok, nhi, jnp.where(
                hit | to_full, dx.n - 1, jnp.where(rstep, rhi, hi)))
            plo = jnp.where(ok, nlo, jnp.where(
                hit, 0, jnp.where(rstep, rlo, plo)))
            phi_ = jnp.where(ok, nhi, jnp.where(
                hit, dx.n - 1, jnp.where(rstep, rhi, phi_)))
            rpmiss = jnp.where(hit, False, held)
            rp = jnp.where(hit, ftk, jnp.where(rstep, rp - 1, rp))
            i = jnp.where(active, i + 1, i)
        else:
            lo = jnp.where(ok, nlo, jnp.where(fail, 0, lo))
            hi = jnp.where(ok, nhi, jnp.where(fail, dx.n - 1, hi))
            plo = jnp.where(ok, nlo, plo)
            phi_ = jnp.where(ok, nhi, phi_)
            i = jnp.where(active, i + 1, i)
        return (lo, hi, plo, phi_, i, seed_ei, window_ei, wlo, whi, wseed,
                nrec, slo, shi, sqs, sqe, ns, rp, rpmiss)

    st = (lo, hi, plo, phi_, i, seed_ei, window_ei, wlo, whi, wseed, nrec,
          slo, shi, sqs, sqe, ns, rp, rpmiss)
    (lo, hi, plo, phi_, i, seed_ei, window_ei, wlo, whi, wseed, nrec,
     slo, shi, sqs, sqe, ns, rp, rpmiss) = jax.lax.fori_loop(0, L, body, st)

    # final emission (rowbowt.hpp:477-481): fn(range, (m-i, seed_ei-1), mbuf)
    nonempty = hi >= lo
    f_probe = nonempty & (seed_ei - (m - i) >= wsize)
    go = f_probe & ((hi - lo + 1) <= max_range)
    slot_r = jnp.minimum(nrec, W - 1).astype(jnp.int32)
    wlo = U.tslot_set(wlo, slot_r, go, lo)
    whi = U.tslot_set(whi, slot_r, go, hi)
    wseed = U.tslot_set(wseed, slot_r, go, ns)
    nrec = nrec + go.astype(dt)
    # deferred bulk probe of every recorded window/seed range
    s_flat, cnt_flat = R.markers_bounds(dx, wlo.reshape(-1), whi.reshape(-1))
    ws = s_flat.reshape(W, B).astype(dt)
    wc = cnt_flat.reshape(W, B).astype(dt)
    emit = m > 0
    rec = emit & (ns < S)
    slot = jnp.minimum(ns, S - 1).astype(jnp.int32)
    slo = U.tslot_set(slo, slot, rec, lo)
    shi = U.tslot_set(shi, slot, rec, hi)
    sqs = U.tslot_set(sqs, slot, rec, m - i)
    sqe = U.tslot_set(sqe, slot, rec, seed_ei - 1)
    ns = ns + emit.astype(dt)

    # expansion: replay the chronological per-seed appends from the records,
    # accumulating ENTRY IDS (pure VPU, flat [S*K, B] layout so nothing is
    # lane-padded) — marker values resolve in ONE gather at the end
    eflat = jnp.zeros((S * K, B), dtype=dt)
    evalid = jnp.zeros((S * K, B), dtype=bool)
    used_s = jnp.zeros((S, B), dtype=dt)
    mcnt = jnp.zeros((S, B), dtype=dt)
    ma_val = dx.arrays["ma_val"]
    M = ma_val.shape[0]
    col_s = (jnp.arange(S * K, dtype=dt) // K)[:, None]  # seed slot per row
    col_k = (jnp.arange(S * K, dtype=dt) % K)[:, None]  # in-seed position
    for w in range(W):
        live = (w < nrec) & (wseed[w] < S)
        sl = jnp.clip(wseed[w], 0, S - 1).astype(jnp.int32)
        cnt = jnp.where(live, wc[w], 0)
        u = U.tslot_get(used_s, sl)
        src = col_k - u[None, :]
        take = ((src >= 0) & (src < jnp.minimum(cnt, K)[None, :])
                & live[None, :] & (col_s == sl[None, :].astype(dt)))
        pos = jnp.minimum(ws[w][None, :] + jnp.clip(src, 0, K - 1), M - 1)
        eflat = jnp.where(take, pos, eflat)
        evalid = evalid | take
        used_s = U.tslot_set(used_s, sl, live, jnp.minimum(u + cnt, K))
        mcnt = U.tslot_set(mcnt, sl, live, U.tslot_get(mcnt, sl) + cnt)
    if values:
        mvals = jnp.where(evalid, ma_val[jnp.clip(eflat, 0, M - 1)], -1)
    else:
        # values=False: return ENTRY IDS (-1 = empty) and let the caller
        # resolve against ma_val on host — skips the [S*K, B] device gather,
        # the biggest single cost of this kernel (DESIGN.md cost anatomy)
        mvals = jnp.where(evalid, eflat, -1)
    # back to the public [B, S] / [B, S, K] layout (one transpose each)
    mvals = mvals.reshape(S, K, B).transpose(2, 0, 1)
    return (slo.T, shi.T, sqs.T, sqe.T, mvals, mcnt.T, ns)


@partial(jax.jit, static_argnames=("wsize", "max_range", "max_k"))
def markers_lmem_lanes(dx: DeviceIndex, qcodes, lengths, wsize: int,
                       max_range: int = 1 << 62, max_k: int = 16):
    """Batched RowBowt::get_markers_lmems inner loop (rowbowt.hpp:341-404).

    One lane = one (read, start offset) pair: the caller expands a read of
    length m into m lanes holding its length-(m-k) prefixes (lmem_expand).
    Each lane runs ONE backward search until failure and emits exactly one
    nonempty seed — the failing prev_range or the completed final range (the
    reference's second fn call on the failure path passes an empty range and
    is dropped by out_fn, rb_markers.cpp:373).

    Requires the ftab (the reference exits without it, rowbowt.hpp:346-349);
    a missing kmer yields the full range (search_ftab miss quirk) like the
    reference.  Returns (elo, ehi, eqs [B], mvals [B, K], mcnt [B]); the seed
    query span is (eqs, m-1).
    """
    B, L = qcodes.shape
    K = max_k
    dt = dx.idx_dtype
    if not (dx.has_ftab and dx.ftab_k > 0):
        raise ValueError("ftab must be enabled! (rowbowt.hpp:346-349)")
    ftk = dx.ftab_k
    if ftk - 1 > wsize:
        raise ValueError("wsize cannot be less than ftab k-1 (rowbowt.hpp:350-353)")
    m = lengths.astype(dt)
    max_range = jnp.asarray(min(int(max_range), int(jnp.iinfo(dt).max)), dtype=dt)

    lo = jnp.zeros(B, dtype=dt)
    hi = jnp.full(B, dx.n - 1, dtype=dt)
    i = jnp.zeros(B, dtype=dt)
    if L >= ftk:
        kc = R.kmer_codes(dx, qcodes[:, L - ftk:])
        flo, fhi, hit = R.ftab_lookup(dx, kc)
        # search_ftab misses return the full range; the ftab jump happens for
        # every lane with m >= k (rowbowt.hpp:369-377)
        jump = m >= ftk
        use = jump & hit
        lo = jnp.where(use, flo.astype(dt), lo)
        hi = jnp.where(use, fhi.astype(dt), hi)
        i = jnp.where(jump, ftk, 0).astype(dt)
    plo, phi_ = lo, hi
    window_ei = m
    done = jnp.zeros(B, dtype=bool)
    W = L // max(wsize, 1) + 2
    ws = jnp.zeros((W, B), dtype=dt)  # transposed: not lane-padded in the carry
    wc = jnp.zeros((W, B), dtype=dt)
    nrec = jnp.zeros(B, dtype=dt)
    elo = jnp.full(B, 1, dtype=dt)
    ehi = jnp.zeros(B, dtype=dt)
    eqs = jnp.zeros(B, dtype=dt)
    qflat = qcodes.reshape(-1).astype(dt)  # row-major [B*L]: lane b col j at b*L+j
    lane_base = (jnp.arange(B, dtype=dt) * L)

    lf = R.lf_step_auto(dx, prefer_fb96=True)

    def record(tlo, thi, do, ws, wc, nrec):
        go = do & ((thi - tlo + 1) <= max_range)
        s_, cnt = R.markers_bounds(dx, jnp.where(go, tlo, 1),
                                   jnp.where(go, thi, 0))
        cnt = jnp.where(go, cnt, 0).astype(dt)
        slot = jnp.minimum(nrec, W - 1).astype(jnp.int32)
        ws = U.tslot_set(ws, slot, go, s_.astype(dt))
        wc = U.tslot_set(wc, slot, go, cnt)
        return ws, wc, nrec + go.astype(dt)

    def body(_, st):
        lo, hi, plo, phi_, i, window_ei, done, ws, wc, nrec, elo, ehi, eqs = st
        active = (~done) & (i < m)
        col = jnp.clip(L - 1 - i, 0, L - 1).astype(dt)
        c = qflat[lane_base + col].astype(dt)
        nlo, nhi = lf(dx, lo, hi, c)
        fail = active & (nlo > nhi)
        ok = active & ~fail
        # failure: probe prev if i >= wsize, emit (prev, (m-i, m-1)), stop
        f_probe = fail & (i >= wsize)
        w_trigger = ok & (window_ei - (m - i - 1) >= wsize)
        tlo = jnp.where(fail, lo, nlo)   # prev_range is pre-LF state
        thi = jnp.where(fail, hi, nhi)
        ws, wc, nrec = record(tlo, thi, f_probe | w_trigger, ws, wc, nrec)
        window_ei = jnp.where(w_trigger, m - i - 1, window_ei)
        elo = jnp.where(fail, lo, elo)
        ehi = jnp.where(fail, hi, ehi)
        eqs = jnp.where(fail, m - i, eqs)
        done = done | fail
        lo = jnp.where(ok, nlo, lo)
        hi = jnp.where(ok, nhi, hi)
        i = jnp.where(active, i + 1, i)
        return lo, hi, plo, phi_, i, window_ei, done, ws, wc, nrec, elo, ehi, eqs

    st = (lo, hi, plo, phi_, i, window_ei, done, ws, wc, nrec, elo, ehi, eqs)
    (lo, hi, plo, phi_, i, window_ei, done, ws, wc, nrec, elo, ehi, eqs
     ) = jax.lax.fori_loop(0, L, body, st)
    # lanes that completed without failure: final probe + emit (rowbowt.hpp:399-403)
    fin = ~done
    f_probe = fin & (hi >= lo) & (i >= wsize) & (m > 0)
    ws, wc, nrec = record(lo, hi, f_probe, ws, wc, nrec)
    elo = jnp.where(fin, lo, elo)
    ehi = jnp.where(fin, hi, ehi)
    eqs = jnp.where(fin, m - i, eqs)

    # expansion: replay the chronological appends on [K, B] entry ids (no
    # lane padding, no per-pass value gathers), one ma_val gather at the end
    eb = jnp.zeros((K, B), dtype=dt)
    ev = jnp.zeros((K, B), dtype=bool)
    cused = jnp.zeros(B, dtype=dt)
    ctot = jnp.zeros(B, dtype=dt)
    ma_val = dx.arrays["ma_val"]
    M = ma_val.shape[0]
    col_k = jnp.arange(K, dtype=dt)[:, None]
    for w in range(W):
        live = w < nrec
        cnt = jnp.where(live, wc[w], 0)
        src = col_k - cused[None, :]
        take = (src >= 0) & (src < jnp.minimum(cnt, K)[None, :]) & live[None, :]
        pos = jnp.minimum(ws[w][None, :] + jnp.clip(src, 0, K - 1), M - 1)
        eb = jnp.where(take, pos, eb)
        ev = ev | take
        cused = jnp.where(live, jnp.minimum(cused + cnt, K), cused)
        ctot = ctot + cnt
    cbuf = jnp.where(ev, ma_val[jnp.clip(eb, 0, M - 1)], -1).T
    return elo, ehi, eqs, cbuf, ctot


def lmem_expand(reads):
    """Expand reads into per-start-offset prefix lanes for markers_lmem_lanes.

    Returns (lane_reads, owner, koff): lane j holds reads[owner[j]][: len - koff[j]]
    in ascending koff order per read (the reference's outer k loop)."""
    lane_reads, owner, koff = [], [], []
    for r, b in enumerate(reads):
        mfull = len(b)
        for k in range(mfull):
            lane_reads.append(b[: mfull - k])
            owner.append(r)
            koff.append(k)
    return lane_reads, owner, koff
