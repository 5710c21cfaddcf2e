"""The production 1000G sharding layout: every dense table partitioned along
the BWT-position axis over the 'idx' mesh axis, fused-block rank per shard.

Layout (DESIGN.md "sharding"):
  fb3   [n_idx, per_blk, 24] int32 — fblock rows with SHARD-LOCAL exclusive
        checkpoints; stays int32 at ANY global n (a shard's local count can't
        exceed its 128*per_blk positions).  The global rank is
        base[shard, c] + local checkpoint + in-block popcount.
  base  [n_idx, 8] — global count of each char before the shard (replicated;
        n_idx*8 ints, trivial).
  kval2/phi2 [n_idx, per_pos]  — SA values / dense phi, position-sharded.
  ms2   [n_idx, per_pos + 1]   — dense marker offsets with the right edge
        duplicated so a shard can answer ma_start1[i] for any owned i..i+1.
  mv2   [n_idx, max_ent] int64 — packed markers, entry-sharded on the same
        position boundaries; goff [n_idx+1] = each shard's first global
        entry id (replicated).
  F     [A+1] replicated; k0 scalar replicated.

Every rank/gather is: all shards compute a local candidate, the owner's
survives one psum over 'idx' (O(batch/dp) ints per step over NVLink — see
DESIGN.md for the cost model).  Queries shard over 'dp' exactly like the
replicated path.

Equivalence targets: find_range (rowbowt.hpp:121-131), find_range_w_toehold
(:167-184), locate_range (toehold_sa.hpp:37-49), find_range_w_markers
(:292-339) — parity-tested against the single-device engines in
tests/test_parallel.py.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rowbowt_tpu.construct.build import DENSE_BLOCK, FB_CKPT, FB_ROW
from rowbowt_tpu.index import RbtIndex
from rowbowt_tpu.ops import update as U
from rowbowt_tpu.ops.rank import _fb_rank_from_rows


@dataclasses.dataclass
class ShardedDenseIndex:
    """Host-side container; device_put() places the shards on the mesh."""

    fb3: np.ndarray  # int32[n_idx, per_blk, 24], local checkpoints
    base: np.ndarray  # int64[n_idx, 8], global count before each shard
    F: np.ndarray  # int[A+1]
    n: int
    A: int
    n_idx: int
    per_blk: int
    k0: int  # (samples_last[R-1] + 1) % n, the initial toehold
    kval2: np.ndarray | None = None  # [n_idx, per_pos]
    phi2: np.ndarray | None = None  # [n_idx, per_pos]
    ms2: np.ndarray | None = None  # [n_idx, per_pos + 1]
    mv2: np.ndarray | None = None  # int64[n_idx, max_ent]
    goff: np.ndarray | None = None  # [n_idx + 1]
    ma_wsize: int = 10
    # big (n >= 2^31) layout: the O(n) kval2/phi2/ms2 cannot exist; the O(R)
    # run-space toehold/phi tables and the O(M) marker CSR are REPLICATED
    # (20-300x smaller than the sharded fb3) — bigindex.py conventions
    big_tables: dict | None = None  # run_start/samples_last/pred_pos/phi_at/
    #                                 cruns_keys[/ma_row/ma_val/ma_off], numpy
    R: int = 0
    ma_bs: tuple = ()  # (shift, iters) of the bucketed marker lower bound
    pp_bs: tuple = ()  # (shift, iters) of the bucketed phi-breakpoint bound

    @property
    def per_pos(self) -> int:
        return self.per_blk * DENSE_BLOCK

    @staticmethod
    def fb3_from_codes(codes: np.ndarray, A: int, n_idx: int):
        """(fb3, base) straight from BWT codes — the n >= 2^31 path: no global
        int32 fblock is ever materialized; each shard's checkpoints are local
        (int32 by construction) and `base` carries the int64 global offsets."""
        from rowbowt_tpu.construct.build import build_fblock

        n = codes.shape[0]
        nb = (n + DENSE_BLOCK - 1) // DENSE_BLOCK
        per_blk = (nb + n_idx - 1) // n_idx
        fb3 = np.zeros((n_idx, per_blk, FB_ROW), dtype=np.int32)
        fb3[:, :, FB_CKPT:] = -1  # pad nibble 15 matches no code
        base = np.zeros((n_idx, FB_CKPT), dtype=np.int64)
        run = np.zeros(FB_CKPT, dtype=np.int64)
        for s in range(n_idx):
            base[s] = run
            p0 = s * per_blk * DENSE_BLOCK
            p1 = min(p0 + per_blk * DENSE_BLOCK, n)
            if p1 <= p0:
                continue
            chunk = codes[p0:p1]
            # per-shard fblock with LOCAL checkpoints (chunk length < 2^31)
            fb_s = build_fblock(chunk, A)
            fb3[s, : fb_s.shape[0]] = fb_s
            run = run + np.bincount(chunk, minlength=FB_CKPT)[:FB_CKPT]
        return fb3, base, per_blk

    @staticmethod
    def build(idx: RbtIndex, n_idx: int) -> "ShardedDenseIndex":
        if idx.fblock is None:
            raise ValueError("ShardedDenseIndex needs an fblock build")
        dt = idx.idx_dtype
        fb = idx.fblock
        nb = fb.shape[0]
        per_blk = (nb + n_idx - 1) // n_idx
        fb3 = np.zeros((n_idx, per_blk, FB_ROW), dtype=np.int32)
        # pad rows: nibble 15 everywhere matches no code
        fb3[:, :, FB_CKPT:] = -1
        base = np.zeros((n_idx, FB_CKPT), dtype=np.int64)
        for s in range(n_idx):
            b0 = min(s * per_blk, nb)
            b1 = min(b0 + per_blk, nb)
            if b1 > b0:
                fb3[s, : b1 - b0] = fb[b0:b1]
                base[s] = fb[b0, :FB_CKPT]
                fb3[s, : b1 - b0, :FB_CKPT] -= fb[b0, :FB_CKPT]
            else:  # shard owns nothing: count before n == total per-char count
                base[s, : idx.A] = np.diff(idx.F.astype(np.int64))

        per_pos = per_blk * DENSE_BLOCK
        kval2 = phi2 = ms2 = mv2 = goff = None

        def pos_shard(arr, fill):
            out = np.full((n_idx, per_pos), fill, dtype=arr.dtype)
            flat = out.reshape(-1)
            flat[: arr.shape[0]] = arr
            return flat.reshape(n_idx, per_pos)

        if idx.kval is not None:
            kval2 = pos_shard(idx.kval.astype(dt), 0)
            phi2 = pos_shard(idx.phi1.astype(dt), 0)
        if idx.ma_start1 is not None:
            ms = idx.ma_start1.astype(dt)  # [n+1]
            M = int(ms[-1])
            ms2 = np.full((n_idx, per_pos + 1), M, dtype=dt)
            for s in range(n_idx):
                p0 = s * per_pos
                p1 = min(p0 + per_pos + 1, ms.shape[0])
                if p1 > p0:
                    ms2[s, : p1 - p0] = ms[p0:p1]
            goff = np.empty(n_idx + 1, dtype=np.int64)
            goff[:n_idx] = ms2[:, 0]
            goff[n_idx] = M
            max_ent = max(1, int((ms2[:, -1] - ms2[:, 0]).max()))
            mv2 = np.zeros((n_idx, max_ent), dtype=np.int64)
            for s in range(n_idx):
                e0, e1 = int(goff[s]), int(ms2[s, -1])
                mv2[s, : e1 - e0] = idx.ma_val[e0:e1]
        k0 = int((idx.samples_last[-1] + 1) % idx.n) if idx.samples_last is not None else 0
        return ShardedDenseIndex(
            fb3=fb3, base=base, F=idx.F.astype(dt), n=idx.n, A=idx.A,
            n_idx=n_idx, per_blk=per_blk, k0=k0,
            kval2=kval2, phi2=phi2, ms2=ms2, mv2=mv2, goff=goff,
            ma_wsize=idx.ma_wsize,
        )

    def device_put(self, mesh: Mesh, fb64: bool = True) -> dict:
        """fb64=True (default) repacks each shard's rows to the 64-symbol/64B
        layout before placement — checkpoints are shard-local either way, so
        the repack is row-wise identical to the replicated path's
        (fblock_to_fb64; 1.51x/1.33x measured on hardware, DESIGN.md)."""
        fb3 = self.fb3
        if fb64 and fb3.shape[-1] == FB_ROW:
            # 24-lane build rows only; the 40-lane (256-symbol) giant layout
            # ships as built
            from rowbowt_tpu.construct.build import FB64_ROW, fblock_to_fb64
            fb3 = fblock_to_fb64(
                np.asarray(fb3).reshape(-1, FB_ROW), self.n,
            ).reshape(self.n_idx, 2 * self.per_blk, FB64_ROW)
        sh = NamedSharding(mesh, P("idx"))
        rep = NamedSharding(mesh, P())
        d = {
            "fb3": jax.device_put(fb3, NamedSharding(mesh, P("idx", None, None))),
            "base": jax.device_put(self.base, rep),
            "F": jax.device_put(self.F, rep),
        }
        for name in ("kval2", "phi2", "ms2", "mv2"):
            v = getattr(self, name)
            if v is not None:
                d[name] = jax.device_put(v, NamedSharding(mesh, P("idx", None)))
        if self.goff is not None:
            d["goff"] = jax.device_put(self.goff, rep)
        if self.big_tables:
            for name, v in self.big_tables.items():
                d["big_" + name] = jax.device_put(v, rep)
        return d


def _specs(tables):
    by_name = {
        "fb3": P("idx", None, None), "base": P(), "F": P(),
        "kval2": P("idx", None), "phi2": P("idx", None),
        "ms2": P("idx", None), "mv2": P("idx", None), "goff": P(),
    }
    return {k: by_name.get(k, P()) for k in tables}  # big_* are replicated


def _mk_rank(sdx: ShardedDenseIndex, tb):
    """Shard-local fused-block rank closure (call inside shard_map).

    Row width/count come from the placed array, so both the 96B (16-word)
    and 64B (8-word, device_put default) layouts run the same code."""
    my = jax.lax.axis_index("idx")
    fb_loc = tb["fb3"][0] if tb["fb3"].ndim == 3 else tb["fb3"]
    per_blk = fb_loc.shape[0]  # rows per shard in the PLACED layout
    # 24 lanes = 128-symbol build rows, 16 = the 64B repack, 40 = the
    # 256-symbol giant layout
    shift = {FB_ROW: 7, 16: 6, 40: 8}[fb_loc.shape[1]]
    n = sdx.n
    F_ = tb["F"]
    base8 = tb["base"][my]  # [8] global count before this shard

    def rank(i, c):
        csafe = jnp.maximum(c, 0)
        isafe = jnp.minimum(i, n - 1)
        blk = isafe >> shift
        lblk = blk - my * per_blk
        owner = (lblk >= 0) & (lblk < per_blk)
        row = fb_loc[jnp.clip(lblk, 0, per_blk - 1)]
        v = _fb_rank_from_rows(row, isafe & ((1 << shift) - 1), csafe)
        sel = jnp.arange(FB_CKPT, dtype=jnp.int32)[None, :] == csafe[:, None].astype(jnp.int32)
        # widen the int32 local rank to the LANE dtype before adding the int64
        # global base — never narrow the base (it holds counts >= 2^31 on a
        # 1000G index); the psum rides the lane dtype too
        b = jnp.sum(jnp.where(sel, base8[None, :], 0), axis=1).astype(i.dtype)
        v = jax.lax.psum(jnp.where(owner, v.astype(i.dtype) + b, 0), "idx")
        total = (F_[csafe + 1] - F_[csafe]).astype(i.dtype)
        v = jnp.where(i >= n, total, v)
        return jnp.where(c < 0, 0, v)

    return rank


def _mk_sym(sdx: ShardedDenseIndex, tb):
    """Owner-picked BWT symbol at position i from the sharded fb rows (the
    sharded ops.rank.bwt_sym): one packed-word element gather + psum."""
    my = jax.lax.axis_index("idx")
    fb_loc = tb["fb3"][0] if tb["fb3"].ndim == 3 else tb["fb3"]
    per_blk = fb_loc.shape[0]
    shift = {FB_ROW: 7, 16: 6, 40: 8}[fb_loc.shape[1]]

    def sym(i):
        isafe = jnp.clip(i, 0, sdx.n - 1)
        blk = isafe >> shift
        lblk = blk - my * per_blk
        owner = (lblk >= 0) & (lblk < per_blk)
        off = (isafe & ((1 << shift) - 1)).astype(jnp.int32)
        w = fb_loc[jnp.clip(lblk, 0, per_blk - 1).astype(jnp.int32),
                   FB_CKPT + (off >> 3)]
        w = jax.lax.bitcast_convert_type(w, jnp.uint32)
        nib = ((w >> (4 * (off & 7)).astype(jnp.uint32)) & 15).astype(jnp.int32)
        return jax.lax.psum(jnp.where(owner, nib, 0), "idx")

    return sym


def _mk_ms(sdx: ShardedDenseIndex, tb):
    """Owner-picked global ma_start1[i] closure (i in [0, n]); call inside
    shard_map.  The right edge is duplicated into each shard (ms2 build), so
    the last shard owns the i == n probe."""
    my = jax.lax.axis_index("idx")
    ms_loc = tb["ms2"][0] if tb["ms2"].ndim == 2 else tb["ms2"]
    per = sdx.per_pos

    def ms_at(i):
        li = i - my * per
        owner = (li >= 0) & (li < per)
        owner = owner | ((my == sdx.n_idx - 1) & (li == per))
        v = ms_loc[jnp.clip(li, 0, per)]
        return jax.lax.psum(jnp.where(owner, v, 0), "idx")

    return ms_at


def _mk_mv_pick(sdx: ShardedDenseIndex, tb):
    """Entry-sharded packed-marker resolve: ids -> values via one owner psum."""
    my = jax.lax.axis_index("idx")
    mv_loc = tb["mv2"][0] if tb["mv2"].ndim == 2 else tb["mv2"]
    goff = tb["goff"]

    def pick(entry, valid):
        lg = entry.astype(jnp.int64) - goff[my]
        owner = (lg >= 0) & (lg < goff[my + 1] - goff[my]) & valid
        v = mv_loc[jnp.clip(lg, 0, mv_loc.shape[0] - 1)]
        return jax.lax.psum(jnp.where(owner, v, 0), "idx")

    return pick


def _mk_ms_any(sdx: ShardedDenseIndex, tb):
    """ma_start1[i] closure: dense owner-pick (ms2) or, on the big layout, a
    searchsorted over the REPLICATED marker CSR — no collective at all."""
    if "ms2" in tb:
        return _mk_ms(sdx, tb)
    mr = tb["big_ma_row"]
    if "big_ma_off" in tb and sdx.ma_bs:
        from rowbowt_tpu.ops.rank import bucketed_lower_bound

        shift, iters = sdx.ma_bs
        off = tb["big_ma_off"]

        def ms_at(i):
            return bucketed_lower_bound(mr, off, shift, iters, i)

        return ms_at

    def ms_at(i):
        return jnp.searchsorted(mr, i.astype(mr.dtype), side="left",
                                method="scan_unrolled").astype(i.dtype)

    return ms_at


def _mk_mv_any(sdx: ShardedDenseIndex, tb):
    """Packed-marker value resolve: entry-sharded psum (mv2) or a plain
    replicated gather (big layout)."""
    if "mv2" in tb:
        return _mk_mv_pick(sdx, tb)
    mv = tb["big_ma_val"]
    # int32 gather index only while the CSR fits; >= 2^31 entries need int64
    e_dt = jnp.int32 if mv.shape[0] < (1 << 31) else jnp.int64

    def pick(entry, valid):
        return mv[jnp.clip(entry, 0, mv.shape[0] - 1).astype(e_dt)]

    return pick


def _pos_pick(sdx: ShardedDenseIndex, tb, name, i):
    """Owner-picked gather from a position-sharded [n_idx, per_pos] table."""
    my = jax.lax.axis_index("idx")
    loc = tb[name][0] if tb[name].ndim == 2 else tb[name]
    per = sdx.per_pos
    li = i - my * per
    owner = (li >= 0) & (li < per)
    v = loc[jnp.clip(li, 0, per - 1)]
    return jax.lax.psum(jnp.where(owner, v, 0), "idx")


def _lf_body(sdx, rank, F_, qc, lens_, L):
    """Shared LF-loop body factory: returns body(j, (lo, hi, done)).

    Both ranks of the step (at lo and hi+1) ride ONE concatenated [2B]
    owner-psum — one collective per LF step, not two (halves the measured
    shard_map overhead, tools/sharded_probe.py)."""
    dt = lens_.dtype

    def body(j, st):
        lo, hi, done = st
        c = qc[:, L - 1 - j].astype(dt)
        active = (~done) & (j < lens_)
        both = rank(jnp.concatenate([lo, hi + 1]), jnp.concatenate([c, c]))
        B = lo.shape[0]
        cb = both[:B]
        ci = both[B:] - cb
        csafe = jnp.maximum(c, 0)
        nlo = F_[csafe] + cb
        nhi = nlo + ci - 1
        empty = (ci <= 0) | (c < 0)
        nlo = jnp.where(empty, jnp.ones((), dt), nlo)
        nhi = jnp.where(empty, jnp.zeros((), dt), nhi)
        lo = jnp.where(active, nlo, lo)
        hi = jnp.where(active, nhi, hi)
        done = done | (active & empty)
        return lo, hi, done

    return body


def find_ranges_sharded_dense(mesh: Mesh, sdx: ShardedDenseIndex, tables: dict,
                              qcodes, lengths):
    """Batched count over the position-sharded fblock index."""
    L = qcodes.shape[1]

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(_specs(tables), P("dp", None), P("dp")),
             out_specs=(P("dp"), P("dp")))
    def run(tb, qc, lens):
        rank = _mk_rank(sdx, tb)
        dt = tb["F"].dtype
        lens_ = lens.astype(dt)
        zero = (qc[:, 0] * 0).astype(dt)
        st = (zero, zero + (sdx.n - 1), zero != 0)
        lo, hi, _ = jax.lax.fori_loop(
            0, L, _lf_body(sdx, rank, tb["F"], qc, lens_, L), st)
        return lo, hi

    return jax.jit(run)(tables, qcodes, lengths)


def find_ranges_w_toehold_sharded_dense(mesh: Mesh, sdx: ShardedDenseIndex,
                                        tables: dict, qcodes, lengths):
    """Count LF + final kval pick: the sharded form of the kval invariant
    (toehold == SA[final hi], ops.rank.toehold_from_range).

    On the big (n >= 2^31) layout — no dense kval2 — this is the sharded
    trajectory postpass (engine.locate._toehold_trajectory): the count loop
    records each step's pre-step hi, BWT[hi] checks ride ONE owner-psum of
    [L, B] packed-word gathers (_mk_sym), and the single non-trivial ltk
    resolve runs on the replicated O(R) tables with no collective."""
    L = qcodes.shape[1]
    big = sdx.kval2 is None and sdx.big_tables is not None

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(_specs(tables), P("dp", None), P("dp")),
             out_specs=(P("dp"), P("dp"), P("dp")))
    def run(tb, qc, lens):
        rank = _mk_rank(sdx, tb)
        dt = tb["F"].dtype
        lens_ = lens.astype(dt)
        zero = (qc[:, 0] * 0).astype(dt)
        if not big:
            st = (zero, zero + (sdx.n - 1), zero != 0)
            lo, hi, _ = jax.lax.fori_loop(
                0, L, _lf_body(sdx, rank, tb["F"], qc, lens_, L), st)
            k = _pos_pick(sdx, tb, "kval2",
                          jnp.clip(hi, 0, sdx.n - 1)).astype(dt)
            k = jnp.where(hi < lo, jnp.zeros((), dt), k)
            return lo, hi, k

        Bl = qc.shape[0]
        base_body = _lf_body(sdx, rank, tb["F"], qc, lens_, L)
        hi_rec0 = jnp.zeros((L, Bl), dtype=dt) + zero[None, :]

        def body(j, st):
            lo, hi, done, hi_rec = st
            hi_rec = jax.lax.dynamic_update_index_in_dim(hi_rec, hi, j, 0)
            lo, hi, done = base_body(j, (lo, hi, done))
            return lo, hi, done, hi_rec

        lo, hi, _, hi_rec = jax.lax.fori_loop(
            0, L, body, (zero, zero + (sdx.n - 1), zero != 0, hi_rec0))

        sym = _mk_sym(sdx, tb)(hi_rec.reshape(-1)).reshape(L, Bl)
        csteps = qc[:, ::-1].T.astype(jnp.int32)
        jidx = jnp.arange(L, dtype=dt)[:, None]
        nontriv = (jidx < lens_[None, :]) & (sym != csteps)
        t_star = jnp.max(jnp.where(nontriv, jidx, -1), axis=0)

        sl = tb["big_samples_last"]
        k0 = (sl[sdx.R - 1].astype(dt) + 1) % sdx.n
        k_triv = (k0 - lens_) % sdx.n
        ts = jnp.maximum(t_star, 0)
        hi_ts = jnp.take_along_axis(hi_rec, ts[None, :], axis=0)[0]
        c_ts = jnp.take_along_axis(csteps, ts[None, :], axis=0)[0].astype(dt)
        rs = tb["big_run_start"]
        r_ts = jnp.searchsorted(rs, hi_ts.astype(rs.dtype), side="right",
                                method="scan_unrolled").astype(dt) - 1
        keys = tb["big_cruns_keys"]
        q = (c_ts * sdx.R + r_ts).astype(keys.dtype)
        jc = jnp.searchsorted(keys, q, side="right",
                              method="scan_unrolled").astype(dt) - 1
        rr = keys[jnp.maximum(jc, 0)].astype(dt) - c_ts * sdx.R
        k_at = sl[jnp.clip(rr, 0, sdx.R - 1)].astype(dt)
        k_nt = (k_at - (lens_ - 1 - t_star)) % sdx.n
        k = jnp.where(t_star < 0, k_triv, k_nt)
        k = jnp.where(hi < lo, jnp.zeros((), dt), k)
        return lo, hi, k

    return jax.jit(run)(tables, qcodes, lengths)


def locate_sharded_dense(mesh: Mesh, sdx: ShardedDenseIndex, tables: dict,
                         lo, hi, k, max_hits: int):
    """Sharded phi walk: each hop is one owner-picked phi2 gather + psum; on
    the big layout each hop is a searchsorted over the REPLICATED adjacency
    breakpoint table (ops.rank.phi_step "phi_at" semantics) — collective-free."""
    big = sdx.phi2 is None and sdx.big_tables is not None

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(_specs(tables), P("dp"), P("dp"), P("dp")),
             out_specs=(P("dp", None), P("dp")))
    def run(tb, lo, hi, k):
        dt = lo.dtype
        n_occ = jnp.clip(hi - lo + 1, 0, max_hits)
        locs = jnp.full((lo.shape[0], max_hits), -1, dtype=dt)
        locs = locs.at[:, 0].set(jnp.where(n_occ > 0, k, -1))
        if big:
            pp, pa = tb["big_pred_pos"], tb["big_phi_at"]
            if "big_pp_off" in tb and sdx.pp_bs:
                from rowbowt_tpu.ops.rank import bucketed_lower_bound

                shift, iters = sdx.pp_bs
                ppo = tb["big_pp_off"]

                def phi(cur):
                    rk = bucketed_lower_bound(pp, ppo, shift, iters,
                                              cur + 1) - 1
                    return (pa[rk].astype(dt)
                            + (cur - pp[rk].astype(dt))) % sdx.n
            else:
                def phi(cur):
                    rk = jnp.searchsorted(pp, cur.astype(pp.dtype),
                                          side="right",
                                          method="scan_unrolled"
                                          ).astype(dt) - 1
                    return (pa[rk].astype(dt)
                            + (cur - pp[rk].astype(dt))) % sdx.n
        else:
            def phi(cur):
                return _pos_pick(sdx, tb, "phi2",
                                 jnp.clip(cur, 0, sdx.n - 1)).astype(dt)

        def body(j, st):
            locs, cur = st
            cur = phi(cur)
            locs = locs.at[:, j].set(jnp.where(j < n_occ, cur, -1))
            return locs, cur

        if max_hits > 1:
            locs, _ = jax.lax.fori_loop(1, max_hits, body, (locs, k))
        return locs, n_occ

    return jax.jit(run)(tables, lo, hi, k)


def find_ranges_w_markers_sharded_dense(mesh: Mesh, sdx: ShardedDenseIndex,
                                        tables: dict, qcodes, lengths,
                                        wsize: int, max_range: int = 1 << 62,
                                        max_k: int = 32):
    """Sharded RowBowt::find_range_w_markers: the window loop records global
    (entry offset, count) pairs via ms2 owner picks; value expansion resolves
    each window's entry ids against the entry-sharded mv2 (one [B, max_k]
    psum per window pass, ~L/wsize per batch — not per step)."""
    B, L = qcodes.shape
    W = L // wsize + 2

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(_specs(tables), P("dp", None), P("dp")),
             out_specs=(P("dp"), P("dp"), P("dp", None), P("dp"), P("dp")))
    def run(tb, qc, lens):
        my = jax.lax.axis_index("idx")
        rank = _mk_rank(sdx, tb)
        ms_at = _mk_ms_any(sdx, tb)
        dt = tb["F"].dtype
        F_ = tb["F"]
        m = lens.astype(dt)
        Bl = qc.shape[0]
        mr = jnp.asarray(min(int(max_range), int(jnp.iinfo(dt).max)), dtype=dt)

        zero = (qc[:, 0] * 0).astype(dt)
        lo = zero
        hi = zero + (sdx.n - 1)
        too_short = m < wsize
        done = too_short
        window_ei = m
        # transposed [W, B] (not lane-padded); derived from a lane value so
        # the carries are dp-varying from iteration 0
        ws = jnp.zeros((W, Bl), dtype=dt) + zero[None, :]
        wc = jnp.zeros((W, Bl), dtype=dt) + zero[None, :]
        nw = zero

        def record(lo, hi, gate, ws, wc, nw):
            small = (hi - lo + 1) <= mr
            do = gate & small
            both = ms_at(jnp.clip(jnp.concatenate([
                jnp.where(do, lo, 0), jnp.where(do, hi + 1, 0)]), 0, sdx.n))
            s, e = both[: lo.shape[0]], both[lo.shape[0]:]
            cnt = jnp.where(do, jnp.maximum(e - s, 0), 0).astype(dt)
            slot = jnp.minimum(nw, W - 1).astype(jnp.int32)
            ws = U.tslot_set(ws, slot, do, s.astype(dt))
            wc = U.tslot_set(wc, slot, do, cnt)
            nw = nw + do.astype(dt)
            return ws, wc, nw

        def body(j, st):
            lo, hi, done, window_ei, ws, wc, nw = st
            c = qc[:, L - 1 - j].astype(dt)
            active = (~done) & (j < m)
            both = rank(jnp.concatenate([lo, hi + 1]), jnp.concatenate([c, c]))
            cb = both[: lo.shape[0]]
            ci = both[lo.shape[0]:] - cb
            csafe = jnp.maximum(c, 0)
            nlo = F_[csafe] + cb
            nhi = nlo + ci - 1
            empty = (ci <= 0) | (c < 0)
            nlo = jnp.where(empty, jnp.ones((), dt), nlo)
            nhi = jnp.where(empty, jnp.zeros((), dt), nhi)
            fail = active & empty
            nw = jnp.where(fail, 0, nw)
            lo = jnp.where(active, nlo, lo)
            hi = jnp.where(active, nhi, hi)
            done = done | fail
            ok = active & ~empty
            trigger = ok & (window_ei - (m - j) >= wsize)
            ws, wc, nw = record(lo, hi, trigger, ws, wc, nw)
            window_ei = jnp.where(trigger, m - j, window_ei)
            return lo, hi, done, window_ei, ws, wc, nw

        lo, hi, done, window_ei, ws, wc, nw = jax.lax.fori_loop(
            0, L, body, (lo, hi, done, window_ei, ws, wc, nw))
        final = (~done) & (~too_short) & (hi >= lo) & ((m - 1) % wsize != 0)
        ws, wc, nw = record(lo, hi, final, ws, wc, nw)

        # value expansion against the entry-sharded mv2: per-slot entry ids
        # computed arithmetically, then ONE owner-pick psum (was W of them)
        entry, valid, used, total = U.window_entry_ids(ws.T, wc.T, nw, max_k)
        vals = _mk_mv_any(sdx, tb)(entry, valid)
        buf = jnp.where(valid, vals, -1)
        one = jnp.ones((), dt)
        z = jnp.zeros((), dt)
        lo = jnp.where(done | too_short, one, lo)
        hi = jnp.where(done | too_short, z, hi)
        return lo, hi, buf, used, (total > used)

    return jax.jit(run)(tables, qcodes, lengths)


def markers_greedy_seeding_sharded_dense(mesh: Mesh, sdx: ShardedDenseIndex,
                                         tables: dict, qcodes, lengths,
                                         wsize: int, max_range: int = 1 << 62,
                                         max_seeds: int = 8, max_k: int = 16,
                                         values: bool = True):
    """The PRODUCTION genotyping engine on the position-sharded layout:
    RowBowt::get_markers_greedy_seeding (rowbowt.hpp:406-482) — rb_markers'
    workload (rb_markers.cpp:550-595) — over an index too big for one chip.

    Mirrors engine.seeds.markers_greedy_seeding's non-ftab state machine
    (the reference's rb_markers DEFAULT — -f is opt-in) with the sharded
    primitives: 2 collectives per LF step (the [2B] rank psum, then the [2B]
    window/seed marker-bounds psum — the probe targets depend on the step's
    ranks, so they cannot fuse), plus one [S*K, B] entry-value psum at the
    end.  Buffer-exact vs the replicated engine (tests/test_parallel.py).

    Returns (slo, shi, sqs, sqe [B,S], mvals [B,S,K], mcnt [B,S], ns [B]);
    with values=False, mvals holds ma_val ENTRY IDS for host resolve.
    """
    B, L = qcodes.shape
    S, K = max_seeds, max_k
    W = 2 * (L // max(wsize, 1)) + 4

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(_specs(tables), P("dp", None), P("dp")),
             out_specs=(P("dp", None), P("dp", None), P("dp", None),
                        P("dp", None), P("dp", None, None), P("dp", None),
                        P("dp")))
    def run(tb, qc, lens):
        rank = _mk_rank(sdx, tb)
        ms_at = _mk_ms_any(sdx, tb)
        dt = tb["F"].dtype
        F_ = tb["F"]
        m = lens.astype(dt)
        Bl = qc.shape[0]
        mr = jnp.asarray(min(int(max_range), int(jnp.iinfo(dt).max)), dtype=dt)
        zero = (qc[:, 0] * 0).astype(dt)

        lo = zero
        hi = zero + (sdx.n - 1)
        i = zero
        plo, phi_ = lo, hi
        seed_ei = m
        window_ei = m
        ws = jnp.zeros((W, Bl), dtype=dt) + zero[None, :]
        wc = jnp.zeros((W, Bl), dtype=dt) + zero[None, :]
        wseed = jnp.zeros((W, Bl), dtype=dt) + zero[None, :]
        nrec = zero
        slo = jnp.ones((S, Bl), dtype=dt) + zero[None, :]
        shi = jnp.zeros((S, Bl), dtype=dt) + zero[None, :]
        sqs = jnp.zeros((S, Bl), dtype=dt) + zero[None, :]
        sqe = jnp.zeros((S, Bl), dtype=dt) + zero[None, :]
        ns = zero
        qflat = qc.reshape(-1).astype(dt)
        lane_base = jnp.arange(Bl, dtype=dt) * L

        def body(_, st):
            (lo, hi, plo, phi_, i, seed_ei, window_ei, ws, wc, wseed, nrec,
             slo, shi, sqs, sqe, ns) = st
            active = i < m
            col = jnp.clip(L - 1 - i, 0, L - 1).astype(dt)
            c = qflat[(lane_base + col).astype(jnp.int32)].astype(dt)
            # LF: one concatenated [2B] rank psum (same shape as _lf_body)
            both = rank(jnp.concatenate([lo, hi + 1]), jnp.concatenate([c, c]))
            cb = both[:Bl]
            ci = both[Bl:] - cb
            csafe = jnp.maximum(c, 0)
            nlo = F_[csafe] + cb
            nhi = nlo + ci - 1
            empty = (ci <= 0) | (c < 0)
            nlo = jnp.where(empty, jnp.ones((), dt), nlo)
            nhi = jnp.where(empty, jnp.zeros((), dt), nhi)

            ok = active & ~empty
            fail = active & empty
            # success: window probe; failure: seed-final probe of prev
            w_trigger = ok & (window_ei - (m - i - 1) >= wsize)
            f_probe = fail & (seed_ei - (m - i) >= wsize)
            tlo = jnp.where(fail, plo, nlo)
            thi = jnp.where(fail, phi_, nhi)
            go = (w_trigger | f_probe) & ((thi - tlo + 1) <= mr)
            both_ms = ms_at(jnp.clip(jnp.concatenate([
                jnp.where(go, tlo, 0), jnp.where(go, thi + 1, 0)]), 0, sdx.n))
            s_ = both_ms[:Bl]
            cnt = jnp.where(go, jnp.maximum(both_ms[Bl:] - s_, 0), 0).astype(dt)
            slot_r = jnp.minimum(nrec, W - 1).astype(jnp.int32)
            ws = U.tslot_set(ws, slot_r, go, s_.astype(dt))
            wc = U.tslot_set(wc, slot_r, go, cnt)
            wseed = U.tslot_set(wseed, slot_r, go, ns)
            nrec = nrec + go.astype(dt)
            window_ei = jnp.where(w_trigger, m - i - 1, window_ei)

            rec = fail & (ns < S)
            slot = jnp.minimum(ns, S - 1).astype(jnp.int32)
            slo = U.tslot_set(slo, slot, rec, plo)
            shi = U.tslot_set(shi, slot, rec, phi_)
            sqs = U.tslot_set(sqs, slot, rec, m - i)
            sqe = U.tslot_set(sqe, slot, rec, seed_ei - 1)
            ns = ns + fail.astype(dt)
            seed_ei = jnp.where(fail, m - i - 1, seed_ei)
            window_ei = jnp.where(fail, m - i - 1, window_ei)
            lo = jnp.where(ok, nlo, jnp.where(fail, 0, lo))
            hi = jnp.where(ok, nhi, jnp.where(fail, sdx.n - 1, hi))
            plo = jnp.where(ok, nlo, jnp.where(fail, 0, plo))
            phi_ = jnp.where(ok, nhi, jnp.where(fail, sdx.n - 1, phi_))
            i = jnp.where(active, i + 1, i)
            return (lo, hi, plo, phi_, i, seed_ei, window_ei, ws, wc, wseed,
                    nrec, slo, shi, sqs, sqe, ns)

        st = (lo, hi, plo, phi_, i, seed_ei, window_ei, ws, wc, wseed, nrec,
              slo, shi, sqs, sqe, ns)
        (lo, hi, plo, phi_, i, seed_ei, window_ei, ws, wc, wseed, nrec,
         slo, shi, sqs, sqe, ns) = jax.lax.fori_loop(0, L, body, st)

        # final emission (rowbowt.hpp:477-481)
        nonempty = hi >= lo
        f_probe = nonempty & (seed_ei - (m - i) >= wsize)
        go = f_probe & ((hi - lo + 1) <= mr)
        both_ms = ms_at(jnp.clip(jnp.concatenate([
            jnp.where(go, lo, 0), jnp.where(go, hi + 1, 0)]), 0, sdx.n))
        s_ = both_ms[:Bl]
        cnt = jnp.where(go, jnp.maximum(both_ms[Bl:] - s_, 0), 0).astype(dt)
        slot_r = jnp.minimum(nrec, W - 1).astype(jnp.int32)
        ws = U.tslot_set(ws, slot_r, go, s_.astype(dt))
        wc = U.tslot_set(wc, slot_r, go, cnt)
        wseed = U.tslot_set(wseed, slot_r, go, ns)
        nrec = nrec + go.astype(dt)
        emit = m > 0
        rec = emit & (ns < S)
        slot = jnp.minimum(ns, S - 1).astype(jnp.int32)
        slo = U.tslot_set(slo, slot, rec, lo)
        shi = U.tslot_set(shi, slot, rec, hi)
        sqs = U.tslot_set(sqs, slot, rec, m - i)
        sqe = U.tslot_set(sqe, slot, rec, seed_ei - 1)
        ns = ns + emit.astype(dt)

        # chronological per-seed append replay (pure VPU, same as the
        # replicated engine), then ONE entry-sharded value psum
        eflat = jnp.zeros((S * K, Bl), dtype=dt) + zero[None, :]
        evalid = (jnp.zeros((S * K, Bl), dtype=dt) + zero[None, :]) != 0
        used_s = jnp.zeros((S, Bl), dtype=dt) + zero[None, :]
        mcnt = jnp.zeros((S, Bl), dtype=dt) + zero[None, :]
        col_s = (jnp.arange(S * K, dtype=dt) // K)[:, None]
        col_k = (jnp.arange(S * K, dtype=dt) % K)[:, None]
        for w in range(W):
            live = (w < nrec) & (wseed[w] < S)
            sl = jnp.clip(wseed[w], 0, S - 1).astype(jnp.int32)
            cnt = jnp.where(live, wc[w], 0)
            u = U.tslot_get(used_s, sl)
            src = col_k - u[None, :]
            take = ((src >= 0) & (src < jnp.minimum(cnt, K)[None, :])
                    & live[None, :] & (col_s == sl[None, :].astype(dt)))
            eflat = jnp.where(take, ws[w][None, :] + jnp.clip(src, 0, K - 1),
                              eflat)
            evalid = evalid | take
            used_s = U.tslot_set(used_s, sl, live, jnp.minimum(u + cnt, K))
            mcnt = U.tslot_set(mcnt, sl, live, U.tslot_get(mcnt, sl) + cnt)
        if values:
            vals = _mk_mv_any(sdx, tb)(eflat, evalid)
            mvals = jnp.where(evalid, vals, -1)
        else:
            mvals = jnp.where(evalid, eflat.astype(jnp.int64), -1)
        mvals = mvals.reshape(S, K, Bl).transpose(2, 0, 1)
        return (slo.T, shi.T, sqs.T, sqe.T, mvals, mcnt.T, ns)

    return jax.jit(run)(tables, qcodes, lengths)
