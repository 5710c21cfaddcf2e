"""Probe: per-LF-step cost breakdown — query layout, gather count, scan vs fori."""
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
from rowbowt_tpu.ops import rank as R

idx = RbtIndex.load(CACHE)
dx = DeviceIndex.from_index(idx)
B, L = 32768, 100
rng = np.random.default_rng(5)
qc = rng.integers(2, 6, size=(B, L)).astype(np.int32)  # ACGT codes
ln = np.full(B, L, dtype=np.int32)
qcd = jnp.asarray(qc)
qtd = jnp.asarray(qc.T.copy())  # [L, B]
lnd = jnp.asarray(ln)


def timeit(name, fn, *args):
    out = fn(*args); jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args); jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{name}: {best*1e3:.1f} ms  ({L*B/best/1e6:.1f} Mstep/s)")
    return out


@jax.jit
def loop_bl(qc, ln):  # current layout [B, L]
    lo = jnp.zeros(B, jnp.int32); hi = jnp.full(B, dx.n - 1, jnp.int32)
    done = jnp.zeros(B, bool)
    def body(j, st):
        lo, hi, done = st
        c = qc[:, L - 1 - j]
        active = (~done) & (j < ln)
        nlo, nhi = R.lf_step_occ1(dx, lo, hi, c)
        lo = jnp.where(active, nlo, lo); hi = jnp.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
        return lo, hi, done
    lo, hi, _ = jax.lax.fori_loop(0, L, body, (lo, hi, done))
    return lo, hi


@jax.jit
def loop_lb(qt, ln):  # transposed [L, B]
    lo = jnp.zeros(B, jnp.int32); hi = jnp.full(B, dx.n - 1, jnp.int32)
    done = jnp.zeros(B, bool)
    def body(j, st):
        lo, hi, done = st
        c = jax.lax.dynamic_index_in_dim(qt, L - 1 - j, 0, keepdims=False)
        active = (~done) & (j < ln)
        nlo, nhi = R.lf_step_occ1(dx, lo, hi, c)
        lo = jnp.where(active, nlo, lo); hi = jnp.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
        return lo, hi, done
    lo, hi, _ = jax.lax.fori_loop(0, L, body, (lo, hi, done))
    return lo, hi


@jax.jit
def scan_lb(qt, ln):  # lax.scan over reversed rows
    lo = jnp.zeros(B, jnp.int32); hi = jnp.full(B, dx.n - 1, jnp.int32)
    done = jnp.zeros(B, bool)
    js = jnp.arange(L, dtype=jnp.int32)
    def body(st, xs):
        lo, hi, done = st
        c, j = xs
        active = (~done) & (j < ln)
        nlo, nhi = R.lf_step_occ1(dx, lo, hi, c)
        lo = jnp.where(active, nlo, lo); hi = jnp.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
        return (lo, hi, done), None
    (lo, hi, _), _ = jax.lax.scan(body, (lo, hi, done), (qt[::-1], js))
    return lo, hi


@jax.jit
def gathers_only(qt, ln):  # isolate: 2 occ1 gathers/step, no masks
    occ1 = dx.arrays["occ1_flat"]
    n1 = dx.n + 1
    lo = jnp.zeros(B, jnp.int32); hi = jnp.full(B, dx.n - 1, jnp.int32)
    def body(st, c):
        lo, hi = st
        a = occ1[jnp.clip(c * n1 + lo, 0, occ1.shape[0] - 1)]
        b = occ1[jnp.clip(c * n1 + hi, 0, occ1.shape[0] - 1)]
        return (a.astype(jnp.int32), (a + b).astype(jnp.int32) % dx.n), None
    (lo, hi), _ = jax.lax.scan(body, (lo, hi), qt[::-1])
    return lo, hi


@jax.jit
def one_gather(qt, ln):  # 1 gather/step
    occ1 = dx.arrays["occ1_flat"]
    n1 = dx.n + 1
    lo = jnp.zeros(B, jnp.int32)
    def body(lo, c):
        a = occ1[jnp.clip(c * n1 + lo, 0, occ1.shape[0] - 1)]
        return a.astype(jnp.int32), None
    lo, _ = jax.lax.scan(body, lo, qt[::-1])
    return lo


o1 = timeit("fori [B,L] (current)", loop_bl, qcd, lnd)
o2 = timeit("fori [L,B] transposed", loop_lb, qtd, lnd)
o3 = timeit("scan [L,B] transposed", scan_lb, qtd, lnd)
assert (np.asarray(o1[0]) == np.asarray(o2[0])).all()
assert (np.asarray(o1[0]) == np.asarray(o3[0])).all()
timeit("scan 2-gathers only", gathers_only, qtd, lnd)
timeit("scan 1-gather only", one_gather, qtd, lnd)
os._exit(0)
