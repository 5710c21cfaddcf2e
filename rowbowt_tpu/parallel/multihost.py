"""Multi-host orchestration: N processes × M local cards, one global mesh.

The reference is single-node (SURVEY.md §2.3); this is the scaling story for
configs "1 card / 1 host / N hosts" (BASELINE.md):

  host i                    host j
  ┌───────────────┐        ┌───────────────┐
  │ FASTQ shard i │network │ FASTQ shard j │   each host streams its own read
  │ native reader ├───────►│ native reader │   shard (no cross-host data path
  │ local cards   │ NVLink │ local cards   │   for inputs)
  └──────┬────────┘        └──────┬────────┘
         └──────── global mesh ───┘            index replicated or R-sharded
                                               ('idx' axis inside each host
                                               so collectives stay on NVLink)

Usage (same script on every host):

    from rowbowt_tpu.parallel import multihost as mh
    mh.init(coordinator="host0:1234", num_processes=N, process_id=i)
    mesh = mh.global_mesh(n_idx=1)
    dx   = replicate_index(mesh, DeviceIndex.from_index(idx))
    for qc, lens in my_shard_batches:            # host-local reads
        gqc  = mh.host_batch_to_global(mesh, qc)
        glen = mh.host_batch_to_global(mesh, lens)
        lo, hi = find_ranges(dx, gqc, glen)
        lo0 = mh.gather_to_host0(lo)             # ordered merge on host 0

Single-process runs skip jax.distributed and behave identically, so the whole
path is exercised by the CPU-mesh tests and the driver's dryrun.
"""

from __future__ import annotations

import numpy as np


def init(coordinator: str | None = None, num_processes: int = 1,
         process_id: int = 0) -> None:
    """jax.distributed.initialize wrapper; no-op for single-process runs."""
    if num_processes <= 1:
        return
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_idx: int = 1, devices=None):
    """(dp, idx) mesh over ALL processes' devices.  Device order groups each
    host's cards contiguously, so an 'idx' axis of size <= cards-per-host
    keeps index-shard collectives inside one host."""
    from rowbowt_tpu.parallel.mesh import make_mesh

    import jax

    devs = list(devices if devices is not None else jax.devices())
    return make_mesh(n_dp=len(devs) // n_idx, n_idx=n_idx, devices=devs)


def host_batch_to_global(mesh, local_batch: np.ndarray):
    """Assemble per-host batches into one global 'dp'-sharded array.

    Every process passes its OWN local rows; the global batch is their
    concatenation in process order (jax.make_array_from_process_local_data).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P("dp", *([None] * (local_batch.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local_batch)


def gather_to_host0(garr) -> np.ndarray:
    """Gather a 'dp'-sharded result to every host (row order = process order);
    callers on host 0 write output, others discard."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(garr, tiled=True))


def my_rows(garr, rows_per_process: int) -> np.ndarray:
    """This process's slice of a 'dp'-sharded result built with
    host_batch_to_global (global row order = process order), so each host can
    emit its OWN shard's output without any cross-host name exchange."""
    import jax

    full = gather_to_host0(garr)
    off = jax.process_index() * rows_per_process
    return full[off: off + rows_per_process]


def is_host0() -> bool:
    import jax

    return jax.process_index() == 0
