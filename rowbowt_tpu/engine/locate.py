"""Batched toehold locate.

find_ranges_w_toehold == RowBowt::find_range_w_toehold (rowbowt.hpp:167-184):
the toehold sample rides through the LF loop (lf_step_w_loc).  locate() is the
phi walk (ToeholdSA::locate_range, toehold_sa.hpp:37-49) vectorized across
lanes with a masked fori_loop to a static max_hits — the variable fan-out of
the reference becomes a fixed [B, max_hits] table plus a count vector.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.ops import rank as R
from rowbowt_tpu.ops import update as U


@jax.jit
def find_ranges_w_toehold(dx: DeviceIndex, qcodes, lengths):
    """Returns (lo, hi, ssamp) per lane; empty -> (1, 0, 0) like the reference.

    Fast path (kval indexes): by the invariant k == SA[hi] the toehold is a
    pure function of the final range, so the loop is the plain 2-gather count
    LF and the toehold is ONE kval gather at the end (ops.rank.
    toehold_from_range) — no per-step toehold maintenance at all.
    """
    B, L = qcodes.shape
    dt = dx.idx_dtype
    lengths = lengths.astype(dt)
    lo = jnp.zeros(B, dtype=dt)
    hi = jnp.full(B, dx.n - 1, dtype=dt)
    # get_last_run_sample (toehold_sa.hpp:97-99)
    k0 = (dx.arrays["samples_last"][dx.R - 1] + 1) % dx.n
    done = jnp.zeros(B, dtype=bool)
    zero = jnp.zeros((), dtype=dt)

    if "kval" in dx.arrays:
        from rowbowt_tpu.engine.count import find_ranges

        lo, hi = find_ranges(dx, qcodes, lengths, use_ftab=False)
        return lo, hi, R.toehold_from_range(dx, lo, hi)

    if "cruns_keys" in dx.arrays:
        return _toehold_trajectory(dx, qcodes, lengths)

    k = jnp.full(B, k0, dtype=dt)
    step = R.lf_step_w_loc_occ1 if "tk1_flat" in dx.arrays else R.lf_step_w_loc

    def body(j, st):
        lo, hi, k, done = st
        c = qcodes[:, L - 1 - j].astype(dt)
        active = (~done) & (j < lengths)
        nlo, nhi, nk = step(dx, lo, hi, c, k)
        lo = jnp.where(active, nlo, lo)
        hi = jnp.where(active, nhi, hi)
        k = jnp.where(active, nk, k)
        done = done | (active & (nlo > nhi))
        return lo, hi, k, done

    lo, hi, k, done = jax.lax.fori_loop(0, L, body, (lo, hi, k, done))
    # a failed search clears everything (rowbowt.hpp:177-180)
    k = jnp.where(hi < lo, zero, k)
    return lo, hi, k


def traj_nontrivial(dx: DeviceIndex, hi_rec, csteps, m):
    """[L, B] mask: step j was a NON-trivial LF_w_loc step (BWT[hi] != c,
    rowbowt.hpp:559-571) — bulk packed-word gathers, nothing in the loop."""
    L = hi_rec.shape[0]
    sym = R.bwt_sym(dx, hi_rec.reshape(-1)).reshape(hi_rec.shape)
    jidx = jnp.arange(L, dtype=m.dtype)[:, None]
    return (jidx < m[None, :]) & (sym != csteps)


def traj_resolve_toehold(dx: DeviceIndex, hi_rec, csteps, nontriv, a, b):
    """Toehold k = SA[hi after step b] for a search SPAN of steps [a, b]
    (inclusive), restarted from the full range at step a — the O(R)
    trajectory resolve shared by whole-read search (a=0), per-seed greedy
    spans, and checkpoints.

    hi_rec/csteps/nontriv are the [L, B] step records; a, b are [K, B] step
    indices (K=1 for whole-read).  b < a (empty span) resolves to k0 minus
    zero steps.  Returns k [K, B] int64; the caller masks failed lanes."""
    dt = jnp.int64
    L = hi_rec.shape[0]
    jidx = jnp.arange(L, dtype=dt)[:, None]
    # prefix max: last nontrivial step at or before each step
    lastnt = jax.lax.associative_scan(
        jnp.maximum, jnp.where(nontriv, jidx, -1), axis=0)
    bc = jnp.clip(b, 0, L - 1)
    lnt = jnp.take_along_axis(lastnt, bc, axis=0)
    valid_span = b >= a
    t_star = jnp.where(valid_span & (lnt >= a), lnt, -1)

    sl = dx.arrays["samples_last"]
    k0 = (sl[dx.R - 1].astype(dt) + 1) % dx.n
    steps_total = jnp.maximum(b - a + 1, 0)
    k_triv = (k0 - steps_total) % dx.n

    ts = jnp.clip(t_star, 0, L - 1)
    hi_ts = jnp.take_along_axis(hi_rec, ts, axis=0)
    c_ts = jnp.take_along_axis(csteps, ts, axis=0).astype(dt)
    rs = dx.arrays["big_run_start"]
    r_ts = jnp.searchsorted(rs, hi_ts.astype(rs.dtype), side="right",
                            method="scan_unrolled").astype(dt) - 1
    keys = dx.arrays["cruns_keys"]
    q = (c_ts * dx.R + r_ts).astype(keys.dtype)
    jc = jnp.searchsorted(keys, q, side="right",
                          method="scan_unrolled").astype(dt) - 1
    rr = keys[jnp.maximum(jc, 0)].astype(dt) - c_ts * dx.R
    k_at = sl[jnp.clip(rr, 0, dx.R - 1)].astype(dt)
    k_nt = (k_at - (b - t_star)) % dx.n
    return jnp.where(t_star < 0, k_triv, k_nt)


def _toehold_trajectory(dx: DeviceIndex, qcodes, lengths):
    """Toehold by trajectory postpass — the O(R) big-index path (n >= 2^31,
    no dense kval/ltk; bigindex.py run-space tables).

    Batched split of the reference's per-step LF_w_loc (rowbowt.hpp:
    553-573): the dependent chain stays the plain 2-gather LF count loop,
    which additionally RECORDS each step's pre-step hi ([L, B], ~100 MB at
    bench shapes).  Everything data-dependent about the toehold then becomes
    BULK parallel work after the loop:

      * trivial(t) = (BWT[hi_t] == c_t) — one packed-word element gather per
        step-lane (ops.rank.bwt_sym), pipelined, not in the dependent chain;
      * t* = last non-trivial step; its k = samples_last[last c-run at or
        before run_of(hi_t*)] — the reference's samples_last(run) case —
        via TWO searchsorteds per LANE (run_of over run_start; the ltk
        resolve over cruns_keys = run ids sorted by (head, id));
      * every step after t* is trivial and decrements k by 1 mod n
        (rowbowt.hpp:557-558), so k_final = (k_at - (len-1-t*)) mod n; lanes
        with no non-trivial step start from k0 = SA[n-1]: k = (k0 - len).

    Per-read cost over plain count: ~L element gathers (bulk) + O(log R)
    per lane — not the O(L log R) a per-step run-space LF_w_loc would pay
    inside the dependent loop.
    """
    B, L = qcodes.shape
    dt = jnp.int64
    m = lengths.astype(dt)
    lo = jnp.zeros(B, dtype=dt)
    hi = jnp.full(B, dx.n - 1, dtype=dt)
    done = jnp.zeros(B, dtype=bool)
    hi_rec = jnp.zeros((L, B), dtype=dt)
    step = R.lf_step_auto(dx)

    def body(j, st):
        lo, hi, done, hi_rec = st
        c = qcodes[:, L - 1 - j].astype(dt)
        active = (~done) & (j < m)
        hi_rec = jax.lax.dynamic_update_index_in_dim(hi_rec, hi, j, 0)
        nlo, nhi = step(dx, lo, hi, c)
        lo = jnp.where(active, nlo, lo)
        hi = jnp.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
        return lo, hi, done, hi_rec

    lo, hi, done, hi_rec = jax.lax.fori_loop(
        0, L, body, (lo, hi, done, hi_rec))

    csteps = qcodes[:, ::-1].T.astype(jnp.int32)  # [L, B]: char of step j
    nontriv = traj_nontrivial(dx, hi_rec, csteps, m)
    k = traj_resolve_toehold(dx, hi_rec, csteps, nontriv,
                             jnp.zeros((1, B), dtype=dt),
                             (m - 1)[None, :])[0]
    k = jnp.where(hi < lo, jnp.zeros((), dtype=dt), k)
    return lo, hi, k


@partial(jax.jit, static_argnames=("max_hits",))
def locate(dx: DeviceIndex, lo, hi, k, max_hits: int):
    """Phi walk: locs [B, max_hits] (pad -1), count [B] = min(range size, max_hits).

    Output order matches the reference exactly: toehold first, then the phi chain.
    """
    B = lo.shape[0]
    dt = lo.dtype
    n_occ = jnp.clip(hi - lo + 1, 0, max_hits)
    locs = jnp.full((B, max_hits), -1, dtype=dt)
    locs = locs.at[:, 0].set(jnp.where(n_occ > 0, k, -1))

    def body(j, st):
        locs, cur = st
        cur = R.phi_step(dx, cur)
        locs = locs.at[:, j].set(jnp.where(j < n_occ, cur, -1))
        return locs, cur

    if max_hits > 1:
        locs, _ = jax.lax.fori_loop(1, max_hits, body, (locs, k))
    return locs, n_occ


def _pow2_at_least(x: int, floor: int) -> int:
    v = floor
    while v < x:
        v <<= 1
    return v


def locate_ragged(dx: DeviceIndex, lo, hi, k, max_hits: int | None = None):
    """Ragged phi walk: O(total hits) output, not O(B * max range).

    The reference streams each occurrence as the phi chain produces it
    (toehold_sa.hpp:37-49) — fan-out is naturally ragged.  The batched
    equivalent buckets lanes by range size (pow2 widths, pow2-padded lane
    counts, so jit specializations stay O(log^2)) and phi-walks each bucket at
    its own width; one 10^5-occurrence lane no longer inflates every lane's
    row.  Returns (flat [total] int64 positions, offsets [B+1]): lane b's
    occurrences, toehold first then the phi chain, are flat[offsets[b]:
    offsets[b+1]].
    """
    import numpy as np

    lo_h = np.asarray(lo)
    hi_h = np.asarray(hi)
    k_h = np.asarray(k)
    B = lo_h.shape[0]
    sizes = np.where(hi_h >= lo_h, hi_h - lo_h + 1, 0).astype(np.int64)
    if max_hits is not None:
        sizes = np.minimum(sizes, max_hits)
    offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    flat = np.full(int(offsets[-1]), -1, dtype=np.int64)
    if offsets[-1] == 0:
        return flat, offsets

    buckets = np.zeros(B, dtype=np.int64)
    nz = sizes > 0
    buckets[nz] = 1 << np.maximum(
        (np.ceil(np.log2(sizes[nz])).astype(np.int64)), 2)
    dt = lo_h.dtype
    for w in np.unique(buckets[nz]):
        lanes = np.flatnonzero(buckets == w)
        P = _pow2_at_least(len(lanes), 8)
        blo = np.ones(P, dtype=dt)
        bhi = np.zeros(P, dtype=dt)
        bk = np.zeros(P, dtype=dt)
        blo[: len(lanes)] = lo_h[lanes]
        bhi[: len(lanes)] = hi_h[lanes]
        bk[: len(lanes)] = k_h[lanes]
        locs, _ = locate(dx, jnp.asarray(blo), jnp.asarray(bhi),
                         jnp.asarray(bk), max_hits=int(w))
        locs = np.asarray(locs)[: len(lanes)]
        bs = sizes[lanes]
        mask = np.arange(int(w), dtype=np.int64)[None, :] < bs[:, None]
        dest = (offsets[lanes][:, None] + np.arange(int(w), dtype=np.int64)[None, :])[mask]
        flat[dest] = locs[mask]
    return flat, offsets


@jax.jit
def resolve_docs(dx: DeviceIndex, locs):
    """Batched DocList resolve: (doc_id, offset) for a [B, K] position table."""
    d = R.doc_of(dx, locs)
    off = locs - dx.arrays["doc_starts"][jnp.maximum(d, 0)]
    return d, off


@partial(jax.jit, static_argnames=("wsize",))
def find_ranges_w_toehold_chkpnts(dx: DeviceIndex, qcodes, lengths, wsize: int):
    """Batched RowBowt::find_range_w_toehold_chkpnts (rowbowt.hpp:575-611):
    algorithmic checkpointing — record the (range, toehold) state every wsize
    characters along the backward search.

    Returns (clo, chi, ck, cqs, cqe) [B, C] and ncp [B] with C = L//wsize + 1.
    Checkpoint j of lane b covers query span [cqs, cqe) with BWT range
    (clo, chi) and toehold ck.  A failed full-read search returns ncp=0
    (the reference clears the vector, rowbowt.hpp:586-589).
    """
    B, L = qcodes.shape
    C = L // wsize + 1
    dt = dx.idx_dtype
    m = lengths.astype(dt)
    lo = jnp.zeros(B, dtype=dt)
    hi = jnp.full(B, dx.n - 1, dtype=dt)
    k0 = (dx.arrays["samples_last"][dx.R - 1] + 1) % dx.n
    k = jnp.full(B, k0, dtype=dt)
    done = jnp.zeros(B, dtype=bool)
    failed = jnp.zeros(B, dtype=bool)
    window_ei = m
    # transposed [C, B]: loop-carried record tables aren't lane-padded
    clo = jnp.full((C, B), 1, dtype=dt)
    chi = jnp.zeros((C, B), dtype=dt)
    ck = jnp.zeros((C, B), dtype=dt)
    cqs = jnp.zeros((C, B), dtype=dt)
    cqe = jnp.zeros((C, B), dtype=dt)
    ncp = jnp.zeros(B, dtype=dt)
    cb = jnp.zeros((C, B), dtype=dt)  # last processed step per checkpoint
    defer_k = "kval" in dx.arrays  # per-checkpoint k = kval[chi] after the loop
    defer_big = (not defer_k) and "cruns_keys" in dx.arrays
    hi_rec = jnp.zeros((L if defer_big else 1, B), dtype=dt)
    if defer_k or defer_big:
        plain = R.lf_step_auto(dx)

        def step(dx_, lo_, hi_, c_, k_):
            nlo, nhi = plain(dx_, lo_, hi_, c_)
            return nlo, nhi, k_
    elif "tk1_flat" in dx.arrays:
        step = R.lf_step_w_loc_occ1
    else:
        step = R.lf_step_w_loc

    def put(arr, slot, mask, val):
        # one-hot select on the transposed layout (ops/update.py)
        return U.tslot_set(arr, slot, mask, val)

    def body(j, st):
        (lo, hi, k, done, failed, window_ei, clo, chi, ck, cqs, cqe, ncp,
         cb, hi_rec) = st
        c = qcodes[:, L - 1 - j].astype(dt)
        active = (~done) & (j < m)
        if defer_big:
            hi_rec = jax.lax.dynamic_update_index_in_dim(hi_rec, hi, j, 0)
        nlo, nhi, nk = step(dx, lo, hi, c, k)
        fail = active & (nlo > nhi)
        ok = active & ~fail
        lo = jnp.where(ok, nlo, lo)
        hi = jnp.where(ok, nhi, hi)
        k = jnp.where(ok, nk, k)
        done = done | fail
        failed = failed | fail
        # checkpoint trigger (rowbowt.hpp:595-600): window_ei-(m-i) >= wsize
        trig = ok & (window_ei - (m - j) >= wsize)
        slot = jnp.minimum(ncp, C - 1).astype(jnp.int32)
        rec = trig & (ncp < C)
        clo = put(clo, slot, rec, lo)
        chi = put(chi, slot, rec, hi)
        ck = put(ck, slot, rec, k)
        cqs = put(cqs, slot, rec, m - j)
        cqe = put(cqe, slot, rec, window_ei)
        cb = put(cb, slot, rec, jnp.full_like(m, j))
        ncp = ncp + trig.astype(dt)
        window_ei = jnp.where(trig, m - j, window_ei)
        return (lo, hi, k, done, failed, window_ei, clo, chi, ck, cqs, cqe,
                ncp, cb, hi_rec)

    st = (lo, hi, k, done, failed, window_ei, clo, chi, ck, cqs, cqe, ncp,
          cb, hi_rec)
    (lo, hi, k, done, failed, window_ei, clo, chi, ck, cqs, cqe, ncp, cb,
     hi_rec) = jax.lax.fori_loop(0, L, body, st)
    # final push (rowbowt.hpp:604-608)
    fin = (~failed) & (hi >= lo) & ((m - 1) % wsize != 0) & (m > 0)
    slot = jnp.minimum(ncp, C - 1).astype(jnp.int32)
    rec = fin & (ncp < C)
    clo = put(clo, slot, rec, lo)
    chi = put(chi, slot, rec, hi)
    ck = put(ck, slot, rec, k)
    cqs = put(cqs, slot, rec, jnp.zeros_like(m))
    cqe = put(cqe, slot, rec, m)
    cb = put(cb, slot, rec, m - 1)
    ncp = ncp + fin.astype(dt)
    ncp = jnp.where(failed, 0, ncp)
    if defer_k:
        ck = R.toehold_from_range(dx, clo, chi)
    elif defer_big:
        # each checkpoint is a PREFIX of the single search (no restarts):
        # span [0, recorded step]; resolve from the step records
        csteps = qcodes[:, ::-1].T.astype(jnp.int32)
        nontriv = traj_nontrivial(dx, hi_rec, csteps, m)
        ck = traj_resolve_toehold(dx, hi_rec, csteps, nontriv,
                                  jnp.zeros_like(cb), cb).astype(dt)
        ck = jnp.where(chi < clo, jnp.zeros((), dtype=dt), ck)
    return clo.T, chi.T, ck.T, cqs.T, cqe.T, ncp


@partial(jax.jit, static_argnames=("max_hits",))
def find_locs(dx: DeviceIndex, qcodes, lengths, max_hits: int):
    """Batched RowBowt::find_locs (rowbowt.hpp:627-631): whole-read toehold
    search + phi-walk locate in one call."""
    lo, hi, k = find_ranges_w_toehold(dx, qcodes, lengths)
    locs, cnt = locate(dx, lo, hi, k, max_hits=max_hits)
    return lo, hi, locs, cnt
