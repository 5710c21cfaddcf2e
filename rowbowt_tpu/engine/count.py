"""Batched backward search (count path).

The batched equivalent of RowBowt::find_range (rowbowt.hpp:121-131): B reads
advance one LF step per fori_loop iteration in lockstep, with done-masks; a
whole FASTQ batch is one jit'd program.  Optional ftab fast start mirrors
search_ftab (rowbowt.hpp:745-758).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.ops import rank as R


@partial(jax.jit, static_argnames=("use_ftab",))
def find_ranges(dx: DeviceIndex, qcodes, lengths, use_ftab: bool = True):
    """qcodes [B, L] right-aligned int32 (pad = -1), lengths [B].

    Returns (lo [B], hi [B]) with the reference's (1, 0) empty encoding.
    """
    B, L = qcodes.shape
    dt = dx.idx_dtype
    lengths = lengths.astype(dt)
    lo = jnp.zeros(B, dtype=dt)
    hi = jnp.full(B, dx.n - 1, dtype=dt)
    startj = jnp.zeros(B, dtype=dt)

    if use_ftab and dx.has_ftab and L >= dx.ftab_k > 0:
        k = dx.ftab_k
        kc = R.kmer_codes(dx, qcodes[:, L - k:])
        flo, fhi, hit = R.ftab_lookup(dx, kc)
        hit = hit & (lengths >= k)
        lo = jnp.where(hit, flo, lo)
        hi = jnp.where(hit, fhi, hi)
        startj = jnp.where(hit, k, 0).astype(dt)

    done = jnp.zeros(B, dtype=bool)
    step = R.lf_step_auto(dx)

    def body(j, st):
        lo, hi, done = st
        c = qcodes[:, L - 1 - j].astype(dt)
        active = (~done) & (j >= startj) & (j < lengths)
        nlo, nhi = step(dx, lo, hi, c)
        lo = jnp.where(active, nlo, lo)
        hi = jnp.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
        return lo, hi, done

    lo, hi, _ = jax.lax.fori_loop(0, L, body, (lo, hi, done))
    return lo, hi


def counts_from_ranges(lo, hi):
    """count = hi-lo+1, 0 when empty — matches rb_align's unsigned-wrap print
    semantics (rb_align.cpp:122) where the (1,0) empty range yields 0."""
    return jnp.where(hi >= lo, hi - lo + 1, 0)
