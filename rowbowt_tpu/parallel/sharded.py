"""Sharded-index query engines: run tables partitioned along R over the
'idx' mesh axis — for panel indexes whose tables exceed one card's memory
(SURVEY.md §2.3: 1000G-scale sharding; the genuinely distributed kernels).

Layout: shard s owns a contiguous slice of runs and therefore the contiguous
BWT position interval [bounds[s], bounds[s+1]).  A rank(i, c) query runs the
same local searchsorted on every shard; only the owner's contribution survives
the psum over 'idx'.  One LF step = 2 ranks = 2 psums over the interconnect.  The toehold
tables (samples_last, ltk) shard the same way; the phi predecessor array
(pred_pos, sorted text positions) shards contiguously in VALUE order, so a
global predecessor rank is the psum of local counts.

Queries stay sharded over 'dp' (replicated over 'idx'), so total collective
volume per step is O(batch/dp) ints — tiny next to the table gathers.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rowbowt_tpu.index import RbtIndex


@dataclasses.dataclass
class ShardedIndex:
    """Host-side container of the R-sharded tables + replicated scalars."""

    run_start: np.ndarray  # int[R_pad]  (padded with n so pads own nothing)
    run_head: np.ndarray  # int32[R_pad]
    occ: np.ndarray  # int[A, R_pad]
    F: np.ndarray  # int[A+1]
    bounds: np.ndarray  # int[n_idx+1]: first owned BWT position per shard
    n: int
    A: int
    n_idx: int
    R: int
    # --- locate support (None without SA samples) ---
    samples_last: np.ndarray | None = None  # int[R_pad], BWT run order
    ltk: np.ndarray | None = None  # int[A, R_pad]
    pred_pos: np.ndarray | None = None  # int[R_pad] sorted text positions (pad n)
    pred_to_run: np.ndarray | None = None  # int[R_pad]

    @staticmethod
    def build(idx: RbtIndex, n_idx: int) -> "ShardedIndex":
        dt = idx.idx_dtype
        R = idx.R
        R_pad = ((R + n_idx - 1) // n_idx) * n_idx
        rs = np.full(R_pad, idx.n, dtype=dt)
        rs[:R] = idx.run_start
        head = np.zeros(R_pad, dtype=np.int32)
        head[:R] = idx.run_head
        occ = np.zeros((idx.A, R_pad), dtype=dt)
        occ[:, :R] = idx.occ
        per = R_pad // n_idx
        bounds = np.empty(n_idx + 1, dtype=dt)
        for s in range(n_idx):
            r0 = s * per
            bounds[s] = rs[r0] if r0 < R else idx.n
        bounds[n_idx] = idx.n
        sl = ltk = pp = pr = None
        if idx.samples_last is not None:
            sl = np.zeros(R_pad, dtype=dt)
            sl[:R] = idx.samples_last
            ltk = np.zeros((idx.A, R_pad), dtype=dt)
            ltk[:, :R] = idx.ltk
            pp = np.full(R_pad, idx.n, dtype=dt)  # pad beyond any query pos
            pp[:R] = idx.pred_pos
            pr = np.zeros(R_pad, dtype=dt)
            pr[:R] = idx.pred_to_run
        return ShardedIndex(
            run_start=rs, run_head=head, occ=occ,
            F=idx.F.astype(dt), bounds=bounds,
            n=idx.n, A=idx.A, n_idx=n_idx, R=R,
            samples_last=sl, ltk=ltk, pred_pos=pp, pred_to_run=pr,
        )

    def device_put(self, mesh: Mesh) -> dict:
        sh_r = NamedSharding(mesh, P(None, "idx"))
        sh_v = NamedSharding(mesh, P("idx"))
        rep = NamedSharding(mesh, P())
        d = {
            "run_start": jax.device_put(self.run_start, sh_v),
            "run_head": jax.device_put(self.run_head, sh_v),
            "occ": jax.device_put(self.occ, sh_r),
            "F": jax.device_put(self.F, rep),
            "bounds": jax.device_put(self.bounds, rep),
        }
        if self.samples_last is not None:
            d["samples_last"] = jax.device_put(self.samples_last, sh_v)
            d["ltk"] = jax.device_put(self.ltk, sh_r)
            d["pred_pos"] = jax.device_put(self.pred_pos, sh_v)
            d["pred_to_run"] = jax.device_put(self.pred_to_run, sh_v)
        return d


def _specs(tables):
    by_name = {
        "run_start": P("idx"), "run_head": P("idx"), "occ": P(None, "idx"),
        "F": P(), "bounds": P(), "samples_last": P("idx"),
        "ltk": P(None, "idx"), "pred_pos": P("idx"), "pred_to_run": P("idx"),
    }
    return {k: by_name[k] for k in tables}


def _owner_pick(local_vals, owner, axis="idx"):
    """Every shard computes a candidate; only the owner's survives the psum."""
    return jax.lax.psum(jnp.where(owner, local_vals, 0), axis)


def find_ranges_sharded(mesh: Mesh, sidx: ShardedIndex, tables: dict,
                        qcodes, lengths):
    """Batched count over the R-sharded index.  qcodes [B, L] right-aligned,
    sharded over 'dp'; returns (lo [B], hi [B]) with (1,0) empty encoding."""
    n, A = sidx.n, sidx.A
    B, L = qcodes.shape

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(_specs(tables), P("dp", None), P("dp")),
        out_specs=(P("dp"), P("dp")),
    )
    def run(tb, qc, lens):
        my = jax.lax.axis_index("idx")
        lo_own, hi_own = tb["bounds"][my], tb["bounds"][my + 1]
        rs_loc = tb["run_start"]
        dt = rs_loc.dtype
        Rloc = rs_loc.shape[0]
        occ_flat = tb["occ"].reshape(-1)
        F_ = tb["F"]

        def rank_(i, c):
            csafe = jnp.maximum(c, 0)
            owner = (i >= lo_own) & (i < hi_own)
            r = jnp.searchsorted(rs_loc, jnp.minimum(i, n - 1),
                                 side="right").astype(dt) - 1
            rsafe = jnp.clip(r, 0, Rloc - 1)
            v = occ_flat[csafe * Rloc + rsafe]
            v = v + jnp.where(tb["run_head"][rsafe] == c, i - rs_loc[rsafe], 0)
            v = _owner_pick(v, owner)
            total = F_[csafe + 1] - F_[csafe]
            v = jnp.where(i >= n, total, v)
            return jnp.where(c < 0, 0, v)

        zero_lane = (qc[:, 0] * 0).astype(dt)
        lo = zero_lane
        hi = zero_lane + (n - 1)
        done = zero_lane != 0
        lens_ = lens.astype(dt)

        def body(j, st):
            lo, hi, done = st
            c = qc[:, L - 1 - j].astype(dt)
            active = (~done) & (j < lens_)
            cb = rank_(lo, c)
            ci = rank_(hi + 1, c) - cb
            csafe = jnp.maximum(c, 0)
            nlo = F_[csafe] + cb
            nhi = nlo + ci - 1
            empty = (ci <= 0) | (c < 0)
            one = jnp.ones((), dtype=dt)
            zero = jnp.zeros((), dtype=dt)
            nlo = jnp.where(empty, one, nlo)
            nhi = jnp.where(empty, zero, nhi)
            lo = jnp.where(active, nlo, lo)
            hi = jnp.where(active, nhi, hi)
            done = done | (active & empty)
            return lo, hi, done

        lo, hi, _ = jax.lax.fori_loop(0, L, body, (lo, hi, done))
        return lo, hi

    return jax.jit(run)(tables, qcodes, lengths)


def find_ranges_w_toehold_sharded(mesh: Mesh, sidx: ShardedIndex, tables: dict,
                                  qcodes, lengths):
    """Batched toehold search over the R-sharded index (LF_w_loc with the
    trivial-case check and ltk lookup resolved by the owning shard)."""
    n, A, R = sidx.n, sidx.A, sidx.R
    B, L = qcodes.shape

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(_specs(tables), P("dp", None), P("dp")),
        out_specs=(P("dp"), P("dp"), P("dp")),
    )
    def run(tb, qc, lens):
        my = jax.lax.axis_index("idx")
        n_idx = jax.lax.axis_size("idx")
        lo_own, hi_own = tb["bounds"][my], tb["bounds"][my + 1]
        rs_loc = tb["run_start"]
        dt = rs_loc.dtype
        Rloc = rs_loc.shape[0]
        occ_flat = tb["occ"].reshape(-1)
        ltk_flat = tb["ltk"].reshape(-1)
        F_ = tb["F"]
        r0 = my * Rloc  # global id of this shard's first run

        def local_run_of(i):
            r = jnp.searchsorted(rs_loc, jnp.minimum(i, n - 1),
                                 side="right").astype(dt) - 1
            return jnp.clip(r, 0, Rloc - 1)

        def rank_(i, c):
            csafe = jnp.maximum(c, 0)
            owner = (i >= lo_own) & (i < hi_own)
            rsafe = local_run_of(i)
            v = occ_flat[csafe * Rloc + rsafe]
            v = v + jnp.where(tb["run_head"][rsafe] == c, i - rs_loc[rsafe], 0)
            v = _owner_pick(v, owner)
            total = F_[csafe + 1] - F_[csafe]
            v = jnp.where(i >= n, total, v)
            return jnp.where(c < 0, 0, v)

        # samples_last[R-1] lives on the shard owning run R-1
        last_owner = (R - 1) // Rloc == my
        k0 = jax.lax.psum(
            jnp.where(last_owner, tb["samples_last"][(R - 1) % Rloc], 0), "idx")
        k0 = (k0 + 1) % n

        zero_lane = (qc[:, 0] * 0).astype(dt)
        lo = zero_lane
        hi = zero_lane + (n - 1)
        k = zero_lane + k0
        done = zero_lane != 0
        lens_ = lens.astype(dt)

        def body(j, st):
            lo, hi, k, done = st
            c = qc[:, L - 1 - j].astype(dt)
            active = (~done) & (j < lens_)
            csafe = jnp.maximum(c, 0)
            cb = rank_(lo, c)
            ci = rank_(hi + 1, c) - cb
            nlo = F_[csafe] + cb
            nhi = nlo + ci - 1
            empty = (ci <= 0) | (c < 0)
            # toehold update: owner of position hi answers trivial + ltk
            owner_hi = (hi >= lo_own) & (hi < hi_own)
            r_hi = local_run_of(hi)
            trivial_l = owner_hi & (tb["run_head"][r_hi] == c)
            trivial = jax.lax.psum(trivial_l.astype(dt), "idx") > 0
            ltk_v = _owner_pick(ltk_flat[csafe * Rloc + r_hi], owner_hi)
            nk = jnp.where(trivial, jnp.where(k == 0, n - 1, k - 1), ltk_v)
            one = jnp.ones((), dtype=dt)
            zero = jnp.zeros((), dtype=dt)
            nlo = jnp.where(empty, one, nlo)
            nhi = jnp.where(empty, zero, nhi)
            nk = jnp.where(empty, zero, nk)
            lo = jnp.where(active, nlo, lo)
            hi = jnp.where(active, nhi, hi)
            k = jnp.where(active, nk, k)
            done = done | (active & empty)
            return lo, hi, k, done

        lo, hi, k, _ = jax.lax.fori_loop(0, L, body, (lo, hi, k, done))
        k = jnp.where(hi < lo, jnp.zeros((), dtype=dt), k)
        return lo, hi, k

    return jax.jit(run)(tables, qcodes, lengths)


def locate_sharded(mesh: Mesh, sidx: ShardedIndex, tables: dict, lo, hi, k,
                   max_hits: int):
    """Sharded phi walk (ToeholdSA::locate_range): pred rank via psum of local
    counts, pred/sample lookups via owner shards."""
    n, R = sidx.n, sidx.R

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(_specs(tables), P("dp"), P("dp"), P("dp")),
        out_specs=(P("dp", None), P("dp")),
    )
    def run(tb, lo, hi, k):
        my = jax.lax.axis_index("idx")
        dt = lo.dtype
        pp = tb["pred_pos"]
        Rloc = pp.shape[0]
        r0 = my * Rloc

        def phi(i):
            # global predecessor rank: psum of local counts < i
            rk_l = jnp.searchsorted(pp, i, side="left").astype(dt)
            rk = jax.lax.psum(rk_l, "idx")
            jr = jnp.where(rk == 0, R - 1, rk - 1)
            local = jr - r0
            owner = (local >= 0) & (local < Rloc)
            lsafe = jnp.clip(local, 0, Rloc - 1)
            j = _owner_pick(pp[lsafe], owner)
            run_id = _owner_pick(tb["pred_to_run"][lsafe], owner)
            delta = jnp.where(j < i, i - j, i + 1)
            # samples_last[run_id - 1] via its owner
            prev = run_id - 1
            plocal = prev - r0
            powner = (plocal >= 0) & (plocal < Rloc)
            psafe = jnp.clip(plocal, 0, Rloc - 1)
            prev_sample = _owner_pick(tb["samples_last"][psafe], powner)
            return (prev_sample + delta) % n

        B = lo.shape[0]
        n_occ = jnp.clip(hi - lo + 1, 0, max_hits)
        locs = jnp.full((B, max_hits), -1, dtype=dt)
        locs = locs.at[:, 0].set(jnp.where(n_occ > 0, k, -1))

        def body(j, st):
            locs, cur = st
            cur = phi(cur)
            locs = locs.at[:, j].set(jnp.where(j < n_occ, cur, -1))
            return locs, cur

        if max_hits > 1:
            locs, _ = jax.lax.fori_loop(1, max_hits, body, (locs, k))
        return locs, n_occ

    return jax.jit(run)(tables, lo, hi, k)
