"""Decompose the greedy-genotyping kernel's cost on the giant artifact.

The giant bench runs greedy at ~32% of the count loop's LF rate while chr
manages 74% — this probe times the pieces to find the gap:

  count    plain count loop at the greedy's batch shape (the LF ceiling)
  greedy   full markers_greedy_seeding (values=False, bench config)
  nowin    wsize so large no window ever triggers (isolates probe cost:
           records stay empty -> markers_bounds runs on all-empty ranges,
           expansion loop runs with live=False everywhere)
  bounds   ONE bulk markers_bounds on W*B realistic ranges (the deferred
           probe alone)

Usage: python tools/greedy_probe.py [small|giant]  (default giant)
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CACHE = os.path.join(
    REPO, ".cache",
    "bench_idx_big" if "big" in sys.argv[1:] else "bench_idx_giant")


def main():
    import jax
    import jax.numpy as jnp

    from rowbowt_tpu.bigindex import BigIndex
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding

    big = BigIndex.load(CACHE)
    meta = json.load(open(os.path.join(CACHE, "meta.json")))
    qcodes = np.load(os.path.join(CACHE, "qcodes.npy"))
    lens = np.load(os.path.join(CACHE, "qlens.npy"))
    print(f"probe: n={meta['n']:,} R={big.R:,}", file=sys.stderr)
    dx = big.device_index()
    dev = jax.devices()[0]

    B = 65_536
    L = qcodes.shape[1]
    nb = min(4, qcodes.shape[0] // B)
    qc3 = jnp.asarray(qcodes[:nb * B].reshape(nb, B, L))
    len2 = jnp.asarray(lens[:nb * B].reshape(nb, B))
    n_lanes = nb * B

    def timeit(fn, reps=2):
        jax.block_until_ready(fn(0))  # compile + warm
        best = float("inf")
        for s in range(1, reps + 1):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(s))
            best = min(best, time.perf_counter() - t0)
        return best

    # --- count at the same shape
    from rowbowt_tpu.engine.count import find_ranges

    @jax.jit
    def count_all(dx, qc3, len2, salt):
        def step(_, xs):
            qc, ln = xs
            lo, hi = find_ranges(dx, qc, ln + salt - salt)
            return None, jnp.sum(hi - lo)
        _, s = jax.lax.scan(step, None, (qc3, len2))
        return jnp.sum(s)

    t = timeit(lambda s: count_all(dx, qc3, len2, s))
    print(f"count : {n_lanes/t:10,.0f} lanes/s ({t:.3f}s)", file=sys.stderr)

    # --- full greedy (bench config)
    def mk_greedy(wsize):
        @jax.jit
        def g(dx, qc3, len2, salt):
            def step(_, xs):
                qc, ln = xs
                outs = markers_greedy_seeding(
                    dx, qc, ln + salt - salt, wsize=wsize, max_range=1000,
                    max_seeds=8, max_k=16, use_ftab=False, values=False)
                return None, outs[0].sum() + outs[5].sum()
            _, s = jax.lax.scan(step, None, (qc3, len2))
            return jnp.sum(s)
        return g

    g10 = mk_greedy(10)
    t = timeit(lambda s: g10(dx, qc3, len2, s))
    print(f"greedy: {n_lanes/t:10,.0f} lanes/s ({t:.3f}s)", file=sys.stderr)

    gno = mk_greedy(L + 7)  # no window can ever reach wsize
    t = timeit(lambda s: gno(dx, qc3, len2, s))
    print(f"nowin : {n_lanes/t:10,.0f} lanes/s ({t:.3f}s)", file=sys.stderr)

    # --- bulk markers_bounds alone at the kernel's record shape
    import rowbowt_tpu.ops.rank as R
    W = 2 * (L // 10) + 4
    rng = np.random.default_rng(7)
    width = rng.integers(1, 500, size=W * B)
    wlo = rng.integers(0, big.n - 1000, size=W * B)
    whi_ = wlo + width

    @jax.jit
    def bounds(dx, lo, hi, salt):
        s, c = R.markers_bounds(dx, lo + salt - salt, hi)
        return s.sum() + c.sum()

    lo_d = jax.device_put(jnp.asarray(wlo))
    hi_d = jax.device_put(jnp.asarray(whi_))
    t = timeit(lambda s: bounds(dx, lo_d, hi_d, s))
    print(f"bounds: {W*B/t:10,.0f} ranges/s ({t:.3f}s for {W}x{B}) "
          f"x{nb} batches -> {nb*t:.3f}s/greedy-call", file=sys.stderr)


if __name__ == "__main__":
    main()
