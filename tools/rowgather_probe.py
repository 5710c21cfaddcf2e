"""Probe: element gather vs row gather cost for dependent chains."""
import os, sys, time
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
from rowbowt_tpu import runtime  # noqa: E402

runtime.init(allow_explicit_cpu=False)

N = 8_000_000
B = 32768
K = 20  # chain length
rng = np.random.default_rng(0)
elem = jnp.asarray(rng.integers(0, N, size=N, dtype=np.int32))        # [N] int32
row8 = jnp.asarray(rng.integers(0, N, size=(N, 8), dtype=np.int32))   # [N,8]
row2_64 = jnp.asarray(rng.integers(0, N, size=(N, 2), dtype=np.int64))# [N,2] i64
i0 = jnp.asarray(rng.integers(0, N, size=B, dtype=np.int32))


def timeit(name, fn, *args):
    out = fn(*args); jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args); jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{name}: {best*1e3:.2f} ms total, {best/K*1e3:.3f} ms/gather")


@jax.jit
def chain_elem(i):
    for _ in range(K):
        i = elem[i]
    return i

@jax.jit
def chain_row8(i):
    for t in range(K):
        r = row8[i]           # [B, 8]
        i = r[:, t % 8]
    return i

@jax.jit
def chain_row2_64(i):
    i = i.astype(jnp.int64)
    for t in range(K):
        r = row2_64[i]        # [B, 2] int64
        i = jnp.clip(r[:, t % 2], 0, N - 1)
    return i

@jax.jit
def chain_row8_dyn(i, c):
    # row gather + data-dependent column select (like occT[i] then pick char c)
    for _ in range(K):
        r = row8[i]           # [B, 8]
        sel = (jnp.arange(8, dtype=jnp.int32)[None, :] == c[:, None])
        i = jnp.sum(jnp.where(sel, r, 0), axis=1)
    return i

c = jnp.asarray(rng.integers(0, 8, size=B, dtype=np.int32))

timeit("elem  [B] from [N] i32   ", chain_elem, i0)
timeit("row8  [B,8] from [N,8]   ", chain_row8, i0)
timeit("row2  [B,2] from [N,2]i64", chain_row2_64, i0)
timeit("row8+colselect (occT LF) ", chain_row8_dyn, i0, c)

# independent (non-chained) gathers: how much does dependency cost?
@jax.jit
def indep_elem(i):
    acc = jnp.zeros(B, jnp.int32)
    for t in range(K):
        acc = acc + elem[(i + t) % N]
    return acc
timeit("elem indep (no chain)    ", indep_elem, i0)
os._exit(0)
