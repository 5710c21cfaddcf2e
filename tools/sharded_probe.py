"""Probe: shard_map + per-rank psum machinery cost on ONE real chip
(mesh 1x1 — collectives degenerate, so the delta vs the plain engine is pure
sharding-machinery overhead), plus virtual-mesh scaling sanity on CPU.
Numbers go to DESIGN.md (sharding cost model)."""
import os, sys, time
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CACHE = os.path.join(REPO, ".cache", "bench_idx")

import jax
import jax.numpy as jnp
from rowbowt_tpu import runtime  # noqa: E402

runtime.init(allow_explicit_cpu=False)

from rowbowt_tpu.index import RbtIndex
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.engine.count import find_ranges
from rowbowt_tpu.parallel.mesh import make_mesh
from rowbowt_tpu.parallel.sharded_dense import (
    ShardedDenseIndex, find_ranges_sharded_dense)


def timeit(fn, *a, reps=3):
    jax.block_until_ready(fn(*a))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        best = min(best, time.perf_counter() - t0)
    return best


idx = RbtIndex.load(CACHE)
dx = DeviceIndex.from_index(idx).lean()
text = np.load(os.path.join(CACHE, "text.npy"))
acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
rng = np.random.default_rng(7)
tab = idx.alpha.encode_table()
B, L = 131072, 100
starts = rng.integers(0, len(text) - L - 1, size=B)
reads = np.stack([text[s:s + L] for s in starts])
bad = ~np.isin(reads, acgt).all(axis=1)
reads[bad] = reads[np.flatnonzero(~bad)[0]]
qc = jnp.asarray(tab[reads.astype(np.int64)].astype(np.int32))
ln = jnp.asarray(np.full(B, L, np.int32))

fx = jax.jit(lambda d, q, l: find_ranges(d, q, l, use_ftab=False))
t0 = timeit(fx, dx, qc, ln)
lo0 = np.asarray(fx(dx, qc, ln)[0])
print(f"plain engine      : {t0*1e3:8.2f} ms  {B/t0:>12,.0f} reads/s")

mesh = make_mesh(n_dp=1, n_idx=1)
sdx = ShardedDenseIndex.build(idx, n_idx=1)
tables = sdx.device_put(mesh)
fs = lambda q, l: find_ranges_sharded_dense(mesh, sdx, tables, q, l)
t1 = timeit(fs, qc, ln)
lo1 = np.asarray(fs(qc, ln)[0])
assert (lo0 == lo1).all()
print(f"sharded mesh(1,1) : {t1*1e3:8.2f} ms  {B/t1:>12,.0f} reads/s  "
      f"overhead {100*(t1-t0)/t0:+.1f}%")
