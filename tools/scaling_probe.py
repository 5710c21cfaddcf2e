"""Virtual-mesh sharding scaling curve: the SAME index
run at n_idx = 1/2/4/8 on the 8-device CPU mesh, wall-clock per LF step.

This cannot measure NVLink (virtual CPU devices only); it bounds the
COLLECTIVE/BOXING machinery cost trend: how much the shard_map psum-per-rank
program slows down as the index axis widens while total devices stay fixed.
Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python tools/scaling_probe.py [n_syms]
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from rowbowt_tpu.alphabet import SEP_BYTE, TERM_BYTE
    from rowbowt_tpu.construct.build import build_index
    from rowbowt_tpu.engine.count import find_ranges
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.parallel.mesh import make_mesh, replicate_index
    from rowbowt_tpu.parallel.sharded_dense import (
        ShardedDenseIndex, find_ranges_sharded_dense,
    )

    n_syms = int(sys.argv[1]) if len(sys.argv) > 1 else 4_000_000
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = np.concatenate([
        rng.choice(acgt, size=n_syms - 11),
        np.full(10, SEP_BYTE, np.uint8), [np.uint8(TERM_BYTE)]])
    idx = build_index(text, with_sa_samples=False)

    B, L = 2048, 100
    starts = rng.integers(0, n_syms - L - 12, size=B)
    reads = np.stack([text[s:s + L] for s in starts])
    tab = idx.alpha.encode_table()
    qc = tab[reads.astype(np.int64)].astype(np.int32)
    lens = np.full(B, L, dtype=np.int32)

    # replicated DP baseline (no shard_map, no collectives)
    mesh0 = make_mesh(n_dp=8)
    dx = replicate_index(mesh0, DeviceIndex.from_index(idx))
    import jax.numpy as jnp

    qs = jax.device_put(jnp.asarray(qc),
                        jax.sharding.NamedSharding(
                            mesh0, jax.sharding.PartitionSpec("dp", None)))
    ls = jax.device_put(jnp.asarray(lens),
                        jax.sharding.NamedSharding(
                            mesh0, jax.sharding.PartitionSpec("dp")))

    def timeit(fn, reps=3):
        jax.block_until_ready(fn())
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            best = min(best, time.perf_counter() - t0)
        return best

    t_rep = timeit(lambda: find_ranges(dx, qs, ls))
    print(f"n={n_syms:,} B={B} L={L}  (8 virtual CPU devices)")
    print(f"replicated dp=8        : {t_rep*1e3:8.1f} ms  "
          f"{t_rep/L*1e6:6.2f} us/LF-step  1.00x")
    for n_idx in (1, 2, 4, 8):
        n_dp = 8 // n_idx
        mesh = make_mesh(n_dp=n_dp, n_idx=n_idx)
        sdx = ShardedDenseIndex.build(idx, n_idx=n_idx)
        tables = sdx.device_put(mesh)
        t = timeit(lambda: find_ranges_sharded_dense(mesh, sdx, tables, qc, lens))
        print(f"sharded dp={n_dp} x idx={n_idx}   : {t*1e3:8.1f} ms  "
              f"{t/L*1e6:6.2f} us/LF-step  {t/t_rep:.2f}x")


if __name__ == "__main__":
    main()
