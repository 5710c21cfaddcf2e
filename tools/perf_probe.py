"""LF-loop variant microbenchmark on the real chip (not part of bench.py).

Usage: python tools/perf_probe.py [variant ...]
Variants: base colmajor fused fused_cm batch64k
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".cache", "bench_idx")
READ_LEN = 100


def timeit(fn, *a, n=5):
    import jax
    print("compiling...", file=sys.stderr, flush=True)
    jax.block_until_ready(fn(*a))  # warmup/compile
    print("compiled", file=sys.stderr, flush=True)
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp
    from functools import partial

    from rowbowt_tpu import runtime

    runtime.init(allow_explicit_cpu=False)

    from rowbowt_tpu.index import RbtIndex
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.engine.count import find_ranges

    idx = RbtIndex.load(CACHE, with_ma=False, with_sa=False)
    print(f"n={idx.n:,} R={idx.R:,}", file=sys.stderr)
    print("device:", jax.devices()[0].device_kind, file=sys.stderr, flush=True)
    dx = DeviceIndex.from_index(idx)
    import jax as _j; _j.block_until_ready(list(dx.arrays.values()))
    print("index on device", file=sys.stderr, flush=True)

    rng = np.random.default_rng(7)
    text = np.load(os.path.join(CACHE, "text.npy"))
    B = 32768
    starts = rng.integers(0, len(text) - READ_LEN - 1, size=2 * B)
    reads = np.stack([text[s:s + READ_LEN] for s in starts])
    tab = idx.alpha.encode_table()
    qc = tab[reads.astype(np.int64)].astype(np.int32)  # [2B, L] left-aligned == right-aligned (fixed len)
    lens = np.full(2 * B, READ_LEN, dtype=np.int32)

    dt = dx.idx_dtype
    occ1 = dx.arrays["occ1_flat"]
    F = dx.arrays["F"]
    A = dx.A
    n1 = dx.n + 1

    def lf_pair(lo, hi, c):
        csafe = jnp.maximum(c, 0).astype(dt)
        o_lo = occ1[csafe * n1 + lo]
        o_hi = occ1[csafe * n1 + hi + 1]
        sel = (jnp.arange(A, dtype=jnp.int32)[None, :] == c[:, None].astype(jnp.int32))
        f = jnp.sum(jnp.where(sel, F[None, :A], 0), axis=1).astype(dt)
        nlo = f + o_lo
        nhi = f + o_hi - 1
        empty = (nhi < nlo) | (c < 0)
        return jnp.where(empty, 1, nlo), jnp.where(empty, 0, nhi)

    @jax.jit
    def base(qcodes, lengths):
        return find_ranges(dx, qcodes, lengths, use_ftab=False)

    @jax.jit
    def colmajor(qt, lengths):
        # qt is [L, B]: per-step char fetch is a contiguous row
        L, Bn = qt.shape
        lo = jnp.zeros(Bn, dtype=dt)
        hi = jnp.full(Bn, dx.n - 1, dtype=dt)
        done = jnp.zeros(Bn, dtype=bool)

        def body(j, st):
            lo, hi, done = st
            c = qt[L - 1 - j].astype(dt)
            active = (~done) & (j < lengths)
            nlo, nhi = lf_pair(lo, hi, c)
            lo = jnp.where(active, nlo, lo)
            hi = jnp.where(active, nhi, hi)
            done = done | (active & (nlo > nhi))
            return lo, hi, done

        lo, hi, _ = jax.lax.fori_loop(0, L, body, (lo, hi, done))
        return lo, hi

    @jax.jit
    def fused(qcodes, lengths):
        # single gather of [2B] indices per step (lo and hi+1 concatenated)
        Bn, L = qcodes.shape
        lo = jnp.zeros(Bn, dtype=dt)
        hi = jnp.full(Bn, dx.n - 1, dtype=dt)
        done = jnp.zeros(Bn, dtype=bool)

        def body(j, st):
            lo, hi, done = st
            c = qcodes[:, L - 1 - j].astype(dt)
            csafe = jnp.maximum(c, 0).astype(dt)
            base_i = csafe * n1
            both = occ1[jnp.concatenate([base_i + lo, base_i + hi + 1])]
            o_lo, o_hi = both[:Bn], both[Bn:]
            sel = (jnp.arange(A, dtype=jnp.int32)[None, :] == c[:, None].astype(jnp.int32))
            f = jnp.sum(jnp.where(sel, F[None, :A], 0), axis=1).astype(dt)
            nlo = f + o_lo
            nhi = f + o_hi - 1
            empty = (nhi < nlo) | (c < 0)
            nlo = jnp.where(empty, 1, nlo)
            nhi = jnp.where(empty, 0, nhi)
            active = (~done) & (j < lengths)
            lo = jnp.where(active, nlo, lo)
            hi = jnp.where(active, nhi, hi)
            done = done | (active & (nlo > nhi))
            return lo, hi, done

        lo, hi, _ = jax.lax.fori_loop(0, L, body, (lo, hi, done))
        return lo, hi

    variants = sys.argv[1:] or ["base", "colmajor", "fused", "batch64k"]
    q32 = qc[:B]
    l32 = lens[:B]
    for v in variants:
        if v == "base":
            t = timeit(base, q32, l32)
            print(f"base      32k: {t*1e3:8.2f} ms  {B/t:,.0f} reads/s")
        elif v == "colmajor":
            qt = np.ascontiguousarray(q32.T)
            t = timeit(colmajor, qt, l32)
            print(f"colmajor  32k: {t*1e3:8.2f} ms  {B/t:,.0f} reads/s")
        elif v == "fused":
            t = timeit(fused, q32, l32)
            print(f"fused     32k: {t*1e3:8.2f} ms  {B/t:,.0f} reads/s")
        elif v == "batch64k":
            t = timeit(base, qc, lens)
            print(f"base      64k: {t*1e3:8.2f} ms  {2*B/t:,.0f} reads/s")


if __name__ == "__main__":
    main()
