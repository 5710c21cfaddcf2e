"""GPU probe: big count throughput against the batch interleave shape.

tools/big_probe.py measures the dependent-gather speed of light on the big
table; the interleaved independent per-batch chains are what hide gather
latency (DESIGN.md).  Measure count throughput at 2x65k, 4x65k (reads
duplicated), and 8x32k on the GPU.

    python tools/big_scan_probe.py
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

BIG = os.path.join(REPO, ".cache", "bench_idx_big")


def main():
    big = BigIndex.load(BIG)
    qcodes = np.load(os.path.join(BIG, "qcodes.npy"))
    lens = np.load(os.path.join(BIG, "qlens.npy"))
    # count-only device set (same as the bench big count section)
    dx = big.device_index(with_locate=False, with_markers=False)
    jax.block_until_ready(dx.arrays["fb2_64"])
    print(f"device {jax.devices()[0]}", file=sys.stderr)

    def timeit(qc3, len2, tag):
        @jax.jit
        def count_all(dx, qc3, len2, salt):
            def step(_, xs):
                qc, ln = xs
                return None, find_ranges(dx, qc, ln)
            _, (lo, hi) = jax.lax.scan(step, None, (qc3, len2 + salt - salt))
            return jnp.sum(lo) + jnp.sum(hi)

        jax.block_until_ready(count_all(dx, qc3, len2, 0))
        best = float("inf")
        for s in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(count_all(dx, qc3, len2, s + 1))
            best = min(best, time.perf_counter() - t0)
        n_lanes = qc3.shape[0] * qc3.shape[1]
        print(f"{tag}: {n_lanes / best:,.0f} lanes/s "
              f"({n_lanes} lanes, {best:.3f}s)", file=sys.stderr)
        return n_lanes / best

    N, L = qcodes.shape
    q = qcodes.astype(np.int32)
    ln = lens.astype(np.int32)
    shapes = [(2, 65536), (4, 65536), (8, 32768), (4, 32768)]
    for nb, b in shapes:
        need = nb * b
        reps = -(-need // N)
        qq = np.tile(q, (reps, 1))[:need].reshape(nb, b, L)
        ll = np.tile(ln, reps)[:need].reshape(nb, b)
        timeit(jnp.asarray(qq), jnp.asarray(ll), f"{nb}x{b}")




def phi_probe():
    """Raw phi-hop rate on the big artifact: bitmap-rank rows vs the bucketed
    breakpoint search, outside the ragged walk's
    per-bucket dispatch overhead."""
    import time

    from rowbowt_tpu.engine.locate import find_ranges_w_toehold, locate

    big = BigIndex.load(BIG)
    qcodes = np.load(os.path.join(BIG, "qcodes.npy"))
    lens = np.load(os.path.join(BIG, "qlens.npy"))
    dx = big.device_index()
    jax.block_until_ready(dx.arrays["fb2_64"])
    B = 8192
    uq = jnp.asarray(qcodes[:B].astype(np.int32))
    ul = jnp.asarray(np.full(B, 10, dtype=np.int32))  # ~2.3k hits/lane
    lo, hi, k = find_ranges_w_toehold(dx, uq, ul)

    for mh in (64, 256):
        @jax.jit
        def walk(dx, lo, hi, k, salt):
            locs, cnt = locate(dx, lo, hi, k + salt - salt, max_hits=mh)
            return jnp.sum(locs) + jnp.sum(cnt)

        jax.block_until_ready(walk(dx, lo, hi, k, 0))
        best = float("inf")
        for s in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(walk(dx, lo, hi, k, s + 1))
            best = min(best, time.perf_counter() - t0)
        hops = B * mh
        print(f"phi walk max_hits={mh}: {hops/best/1e6:,.2f} M hops/s "
              f"({best:.3f}s)", file=sys.stderr)





def concat_probe():
    """One [2B]-lane rank per LF step (concatenated lo/hi+1) vs two [B]-lane
    ranks — fewer op dispatches on the same gather volume."""
    import time

    from rowbowt_tpu.ops import rank as RK

    big = BigIndex.load(BIG)
    qcodes = np.load(os.path.join(BIG, "qcodes.npy"))
    dx = big.device_index(with_locate=False, with_markers=False)
    jax.block_until_ready(dx.arrays["fb2_64"])
    print(f"device {jax.devices()[0]}", file=sys.stderr)
    N, L = qcodes.shape

    def lf_concat(dx, lo, hi, c):
        i2 = jnp.concatenate([lo, hi + 1])
        c2 = jnp.concatenate([c, c])
        v = RK.rank_fblock2(dx, i2, c2, "fb2_64", 6)
        B = lo.shape[0]
        before = v[:B]
        inside = v[B:] - before
        nlo = RK._f_onehot(dx, c).astype(lo.dtype) + before
        nhi = nlo + inside - 1
        empty = (inside <= 0) | (c < 0)
        one = jnp.ones((), dtype=nlo.dtype)
        zero = jnp.zeros((), dtype=nlo.dtype)
        return jnp.where(empty, one, nlo), jnp.where(empty, zero, nhi)

    for tag, step in (("2-call", RK.lf_step_fblock2), ("concat", lf_concat)):
        for nb, b in ((4, 65536), (8, 65536)):
            need = nb * b
            reps = -(-need // N)
            qq = jnp.asarray(np.tile(qcodes.astype(np.int32), (reps, 1))
                             [:need].reshape(nb, b, L))

            @jax.jit
            def count_all(dx, qc3, salt):
                def outer(_, qc):
                    B = qc.shape[0]
                    dt = jnp.int64
                    lo = jnp.zeros(B, dtype=dt)
                    hi = jnp.full(B, dx.n - 1, dtype=dt)
                    done = jnp.zeros(B, dtype=bool)

                    def body(j, st):
                        lo, hi, done = st
                        c = qc[:, L - 1 - j].astype(dt) + salt - salt
                        nlo, nhi = step(dx, lo, hi, c)
                        act = ~done
                        lo = jnp.where(act, nlo, lo)
                        hi = jnp.where(act, nhi, hi)
                        done = done | (act & (nlo > nhi))
                        return lo, hi, done

                    lo, hi, _ = jax.lax.fori_loop(0, L, body, (lo, hi, done))
                    return None, jnp.sum(lo) + jnp.sum(hi)
                _, s = jax.lax.scan(outer, None, qc3)
                return jnp.sum(s)

            jax.block_until_ready(count_all(dx, qq, 0))
            best = float("inf")
            for s in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(count_all(dx, qq, s + 1))
                best = min(best, time.perf_counter() - t0)
            print(f"{tag} {nb}x{b}: {need/best:,.0f} lanes/s", file=sys.stderr)


if __name__ == "__main__":
    probe = os.environ.get("RBT_PROBE")
    if probe == "phi":
        phi_probe()
    elif probe == "concat":
        concat_probe()
    else:
        main()
