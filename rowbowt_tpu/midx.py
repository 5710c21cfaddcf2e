"""Positional marker index — the rle_window_arr / `.midx` equivalent.

The reference's rb_locs pipeline (src/rb_markers_tsa.cpp:76-88) locates a read
at text position l, then asks a separate structure for the markers overlapping
text span [l, l+readlen-1] (pfbwt-f's rle_window_arr, built by build_midx from
a text marker-position file).  Device-friendly replacement: sorted marker text
positions + packed values, queried with searchsorted — dense tables instead of
run-length-encoded window lists.

Text input format for rbt_midx (one marker site occurrence per line):
    <text_pos> <seq> <pos> <allele>
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np

from rowbowt_tpu.index import pack_marker


@dataclasses.dataclass
class PosMarkers:
    pos: np.ndarray  # int64[M] sorted text positions
    val: np.ndarray  # int64[M] packed markers (ties sorted by value)

    @staticmethod
    def from_pairs(positions, values) -> "PosMarkers":
        pos = np.asarray(positions, dtype=np.int64)
        val = np.asarray(values, dtype=np.int64)
        srt = np.lexsort((val, pos))
        return PosMarkers(pos[srt], val[srt])

    @staticmethod
    def from_panel(panel) -> "PosMarkers":
        return PosMarkers.from_pairs(
            [m.text_pos for m in panel.markers],
            [pack_marker(m.seq, m.pos, m.allele) for m in panel.markers],
        )

    @staticmethod
    def from_text_file(path: str) -> "PosMarkers":
        ps, vs = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                tpos, seq, pos, allele = (int(x) for x in parts[:4])
                ps.append(tpos)
                vs.append(pack_marker(seq, pos, allele))
        return PosMarkers.from_pairs(ps, vs)

    def at_range(self, l: int, r: int) -> np.ndarray:
        """Markers at text positions in [l, r] (rle_window_arr::at_range)."""
        s = int(np.searchsorted(self.pos, l, side="left"))
        e = int(np.searchsorted(self.pos, r + 1, side="left"))
        return self.val[s:e]

    def device(self):
        """jax-resident view for the batched kernel below."""
        import jax.numpy as jnp

        return jnp.asarray(self.pos), jnp.asarray(self.val)

    def save(self, path: str) -> None:
        np.savez(path, pos=self.pos, val=self.val)

    @staticmethod
    def load(path: str) -> "PosMarkers":
        z = np.load(path)
        return PosMarkers(z["pos"], z["val"])


def at_ranges_batched(pos_dev, val_dev, l, r, max_k: int):
    """[N]-batched rle_window_arr::at_range: markers whose text position lies
    in [l[i], r[i]] — two searchsorted + one bounded gather, the device form
    of the per-read host loop rb_markers_tsa.cpp:76-88 drives.

    Returns (vals [N, max_k] packed int64, -1 pad; cnt [N] true counts —
    cnt > max_k means truncation, the caller re-probes wider)."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("k",))
    def run(pos, val, l, r, k):
        s = jnp.searchsorted(pos, l, side="left").astype(jnp.int64)
        e = jnp.searchsorted(pos, r + 1, side="left").astype(jnp.int64)
        cnt = e - s
        offs = jnp.arange(k, dtype=jnp.int64)[None, :]
        idxs = jnp.minimum(s[:, None] + offs, pos.shape[0] - 1)
        vals = jnp.where(offs < cnt[:, None], val[idxs], -1)
        return vals, cnt

    if int(pos_dev.shape[0]) == 0:
        import jax.numpy as jnp

        N = l.shape[0]
        return (jnp.full((N, max_k), -1, dtype=jnp.int64),
                jnp.zeros(N, dtype=jnp.int64))
    return run(pos_dev, val_dev, l, r, max_k)
