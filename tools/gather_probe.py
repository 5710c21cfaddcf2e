"""Microbenchmark: random-gather cost vs table size on the GPU.

Measures the cost of the count path's fundamental op — gather B random int32
elements from a table of T bytes — for T from cache-resident to occ1-sized,
plus a chained variant (each gather's output feeds the next gather's index,
like the LF loop's sequential dependence).
"""

import sys
import time

import numpy as np


def timeit(fn, *a, n=10):
    import jax

    jax.block_until_ready(fn(*a))
    best = float("inf")
    for _i in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    B = 32768
    STEPS = 100
    rng = np.random.default_rng(0)
    print("device:", jax.devices()[0].device_kind, file=sys.stderr)

    for size_mb in [int(x) for x in (sys.argv[1:] or ["16"])]:
        T = size_mb * (1 << 20) // 4
        # table[i] = another valid random index, so gathers chain
        tab = jnp.asarray(rng.integers(0, T, size=T, dtype=np.int32))
        idx0 = jnp.asarray(rng.integers(0, T, size=B, dtype=np.int32))

        @jax.jit
        def chained(tab, idx):
            def body(j, i):
                return tab[i]
            return jnp.sum(jax.lax.fori_loop(0, STEPS, body, idx))

        t = timeit(chained, tab, idx0)
        per = t / STEPS
        print(
            f"tab {size_mb:4d}MB: {per*1e6:8.1f} us/step "
            f"({per/B*1e9:6.2f} ns/elem, {B*32/per/1e9:6.1f} GB/s @32B-line)"
        )


if __name__ == "__main__":
    main()
