"""Is the big (n=2.4G) LF loop at gather speed-of-light?

(a) achieved count rate on the real 2.24 GB fb2_64 table at several scan
    interleave shapes (the chr lesson: independent per-batch LF chains
    pipeline through the gather engine — DESIGN.md "Engine cost anatomy" #4);
(b) raw dependent-chain 2-row-gather rate on the SAME table — the
    speed-of-light bound (an LF step cannot beat two dependent row gathers).

Timing syncs with block_until_ready.

Run on the GPU:  python tools/big_probe.py
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rowbowt_tpu import runtime  # noqa: E402

runtime.init(allow_explicit_cpu=False)

from rowbowt_tpu.bigindex import BigIndex  # noqa: E402
from rowbowt_tpu.engine.count import find_ranges  # noqa: E402

CACHE = os.path.join(REPO, ".cache", "bench_idx_big")


def timeit(fn, *a, reps=3):
    jax.block_until_ready(fn(*a))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        best = min(best, time.perf_counter() - t0)
    return best


@jax.jit
def _count_scan(dx, q3, l3):
    def step(_, xs):
        lo, hi = find_ranges(dx, xs[0], xs[1], use_ftab=False)
        return None, jnp.sum(lo) + jnp.sum(hi)
    _, s = jax.lax.scan(step, None, (q3, l3))
    return jnp.sum(s)


K = 50


@jax.jit
def _chains(tab, nrows, i4):
    """[nbatch, B] independent dependent-chains of 2 row gathers x K steps."""
    def one(i0):
        def body(t, i):
            r1 = tab[i]
            r2 = tab[(i * 7 + 13) % nrows]
            v = jnp.sum(r1[:, :8] ^ r2[:, :8], axis=1).astype(jnp.uint32)
            return ((v * jnp.uint32(2654435761) + t.astype(jnp.uint32))
                    % nrows).astype(jnp.int32)
        return jnp.sum(jax.lax.fori_loop(0, K, body, i0))

    def step(_, i0):
        return None, one(i0)
    _, s = jax.lax.scan(step, None, i4)
    return jnp.sum(s)


def main():
    big = BigIndex.load(CACHE)
    print(f"big index: n={big.n:,}", file=sys.stderr)
    dx = big.device_index(with_locate=False, with_markers=False)
    key = "fb2_64" if "fb2_64" in dx.arrays else "fb2"
    fbdev = dx.arrays[key]
    nb = fbdev.shape[0]
    print(f"device table {key}: {nb:,} rows x {fbdev.shape[1]*4}B = "
          f"{fbdev.nbytes/2**30:.2f} GB on {jax.devices()[0]}", file=sys.stderr)

    qcodes = np.load(os.path.join(CACHE, "qcodes.npy"))
    lens = np.load(os.path.join(CACHE, "qlens.npy"))
    N, L = qcodes.shape

    for nbatch in (1, 2, 4, 8):
        B = N // nbatch
        q3 = jnp.asarray(qcodes[: nbatch * B].reshape(nbatch, B, L).astype(np.int32))
        l3 = jnp.asarray(lens[: nbatch * B].reshape(nbatch, B).astype(np.int32))
        t = timeit(_count_scan, dx, q3, l3)
        print(f"(a) count scan {nbatch}x{B//1024}k lanes: "
              f"{nbatch*B/t:>10,.0f} reads/s  {2*nbatch*B*L/t/1e6:7.1f} M ranks/s")

    rng = np.random.default_rng(7)
    for nbatch, B in ((2, 65_536), (4, 32_768)):
        i4 = jnp.asarray(rng.integers(0, nb, size=(nbatch, B), dtype=np.int32))
        tb = timeit(_chains, fbdev, nb, i4)
        g = 2 * nbatch * B * K / tb
        print(f"(b) raw 2-row chains {nbatch}x{B//1024}k: {g/1e6:7.1f} M "
              f"row-gathers/s -> LF-step ceiling {g/2/1e6:,.1f} M steps/s")


if __name__ == "__main__":
    main()
