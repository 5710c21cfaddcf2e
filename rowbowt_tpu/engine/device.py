"""DeviceIndex: the jax-resident view of an RbtIndex.

A registered pytree whose leaves are the flat sorted tables (DESIGN.md) so it
can be passed straight through jit / shard_map and sharded with NamedSharding.
Static metadata (sizes, dtypes, ftab k, window size) rides in the aux data so
recompilation only happens when the index *shape* changes, not its contents.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from rowbowt_tpu.index import RbtIndex


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceIndex:
    arrays: dict[str, Any]
    n: int
    R: int
    A: int
    ma_wsize: int
    ftab_k: int
    acgt_codes: tuple  # index codes of A,C,G,T (or None entries when absent)
    # (shift, iters) of the bucketed lower bounds over the big layout's
    # sorted tables (ops.rank.bucketed_lower_bound): ma_bs for the marker
    # CSR, pp_bs for the phi breakpoint table; () when dense/plain serve
    ma_bs: tuple = ()
    pp_bs: tuple = ()
    # static (bucket shift, row-unroll count) of the marker run-pack rank
    # (bigindex.marker_run_pack / ops.rank._ms_runs); 0 = no run-pack tables
    ma_rp: tuple | int = 0

    def tree_flatten(self):
        keys = tuple(sorted(self.arrays))
        leaves = tuple(self.arrays[k] for k in keys)
        aux = (keys, self.n, self.R, self.A, self.ma_wsize, self.ftab_k,
               self.acgt_codes, self.ma_bs, self.pp_bs, self.ma_rp)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        keys, n, R, A, ma_wsize, ftab_k, acgt, ma_bs, pp_bs, ma_rp = aux
        return cls(dict(zip(keys, leaves)), n, R, A, ma_wsize, ftab_k, acgt,
                   ma_bs, pp_bs, ma_rp)

    @property
    def idx_dtype(self):
        if "run_start" in self.arrays:
            return self.arrays["run_start"].dtype
        return self.arrays["F"].dtype  # big (n >= 2^31) indexes carry no run tables

    @property
    def has_sa(self) -> bool:
        return "samples_last" in self.arrays

    @property
    def has_ma(self) -> bool:
        # ma_val is always attached with markers; ma_row may be replaced by
        # the run-pack rank tables (bigindex.marker_run_pack)
        return "ma_val" in self.arrays

    @property
    def has_ftab(self) -> bool:
        return "ftab" in self.arrays

    @property
    def has_dense(self) -> bool:
        return "bwt4" in self.arrays

    # run-space tables shadowed by the dense fast paths; dropping them from a
    # chr-scale DeviceIndex saves ~1 GB of device memory (occ is A*R, ltk is A*R)
    _LEAN_DROP = ("occ_flat", "cruns_flat", "cruns_off", "ltk",
                  "pred_pos", "pred_to_run")

    def lean(self) -> "DeviceIndex":
        """A view without the run-space rank/toehold tables.  Valid when a
        dense LF backend (occ1/fblock/bwt4) plus kval+phi1 cover every engine
        path; keeps run_start/samples_last (cheap, R-sized)."""
        assert ("occ1_flat" in self.arrays or "fblock" in self.arrays
                or "fblock64" in self.arrays or "bwt4" in self.arrays)
        arrs = {k: v for k, v in self.arrays.items() if k not in self._LEAN_DROP}
        return DeviceIndex(arrs, self.n, self.R, self.A, self.ma_wsize,
                           self.ftab_k, self.acgt_codes)

    @staticmethod
    def from_index(idx: RbtIndex, device=None, fb64: bool | None = None) -> "DeviceIndex":
        """fb64=None (default) repacks the fblock to 64-symbol/64B rows (row
        gathers pay per memory transaction); the construct.build thresholds
        decide, and are open for re-tuning on the GPU.  The on-disk artifact
        always stores the denser 96B layout; the repack is load-time only.
        fb64=False forces the 96B rows (tests/diagnostics)."""
        arrs_np = dict(idx.device_arrays())
        keep_both = False
        if fb64 is None:
            from rowbowt_tpu.construct.build import FB64_MIN_N, FB96_KEEP_MAX_N
            fb64 = "fblock" in arrs_np and idx.n >= FB64_MIN_N
            # default policy: small indexes keep BOTH layouts — the greedy
            # loop prefers the 96B rows in-cache (lf_step_auto with
            # prefer_fb96=True), the pure LF loops take the 64B rows.
            # Explicit fb64=True/False forces a single layout (diagnostics).
            keep_both = fb64 and idx.n < FB96_KEEP_MAX_N
        if fb64 and "fblock" in arrs_np:
            from rowbowt_tpu.construct.build import fblock_to_fb64
            fb96 = arrs_np["fblock"] if keep_both else arrs_np.pop("fblock")
            arrs_np["fblock64"] = fblock_to_fb64(np.asarray(fb96), idx.n)
        arrs = {k: jnp.asarray(v) for k, v in arrs_np.items()}
        if device is not None:
            arrs = {k: jax.device_put(v, device) for k, v in arrs.items()}
        acgt_np = idx.alpha.encode(np.frombuffer(b"ACGT", dtype=np.uint8))
        return DeviceIndex(
            arrays=arrs,
            n=idx.n,
            R=idx.R,
            A=idx.A,
            ma_wsize=idx.ma_wsize,
            ftab_k=idx.ftab_k,
            acgt_codes=tuple(int(c) for c in acgt_np),
        )
