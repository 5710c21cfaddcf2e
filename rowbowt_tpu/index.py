"""RbtIndex: the serialized/deviceable pangenome r-index.

Everything the reference stores across its five artifacts (.rbwt/.tsa/.mab/.docs/.ftab,
/root/reference/include/rowbowt_io.hpp:17-21) lives here as flat sorted numpy arrays
(DESIGN.md table).  The index *is* the checkpoint, like the reference: build once,
save/load, query many.  `device_arrays()` returns the pytree of jax-ready arrays.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from rowbowt_tpu.alphabet import Alphabet

_META_NAME = "rbt_meta.json"
_ARRS_NAME = "rbt_arrays.npz"


def pack_marker(seq: int, pos: int, allele: int) -> int:
    """Pack (seq, pos, allele) into one int64: seq:15 | pos:40 | allele:8.

    Mirrors pfbwt-f's packed MarkerT u64 with free accessors get_seq/get_pos/get_allele
    (used at /root/reference/src/rb_markers.cpp:229-235); the packing order makes the
    integer sort equal the reference's marker_cmp (seq, pos, allele) order.
    """
    return (int(seq) << 48) | (int(pos) << 8) | int(allele)


def marker_seq(m) -> np.ndarray:
    return np.asarray(m) >> 48


def marker_pos(m) -> np.ndarray:
    return (np.asarray(m) >> 8) & ((1 << 40) - 1)


def marker_allele(m) -> np.ndarray:
    return np.asarray(m) & 0xFF


@dataclasses.dataclass
class RbtIndex:
    # --- core BWT run tables (replaces rle_string, /root/reference/include/rle_string.hpp) ---
    n: int  # text length
    alpha: Alphabet  # byte values <-> codes
    run_start: np.ndarray  # int[R], BWT position of each run start (sorted)
    run_head: np.ndarray  # uint8[R], code of each run
    occ: np.ndarray  # int[A, R]: count of code a in BWT[0:run_start[r]]
    F: np.ndarray  # int[A+1]: F[c] = count of codes < c in text

    # --- per-char run lists (replaces per-letter bitvectors / select) ---
    cruns_flat: np.ndarray  # int[R]: run ids grouped by char, ascending within char
    cruns_off: np.ndarray  # int[A+1]: offsets into cruns_flat

    # --- toehold SA (replaces ToeholdSA, /root/reference/include/toehold_sa.hpp) ---
    samples_last: np.ndarray | None  # int[R]: (SA[last row of run]+n-1)%n, run order
    pred_pos: np.ndarray | None  # int[R]: sorted first-row sample text positions
    pred_to_run: np.ndarray | None  # int[R]: run id of each pred_pos entry
    ltk: np.ndarray | None  # int[A, R]: samples_last of last c-run at or before r

    # --- marker array CSR (replaces pfbwt-f MarkerArray) ---
    ma_row: np.ndarray | None  # int[M]: BWT row per marker entry, sorted
    ma_val: np.ndarray | None  # int64[M]: packed markers
    ma_wsize: int  # marker window size w

    # --- doc list (replaces DocList, /root/reference/include/doclist.hpp) ---
    doc_starts: np.ndarray | None  # int[D] sorted text positions
    doc_names: list[str] | None

    # --- ftab (replaces FTab, /root/reference/include/ftab.hpp) ---
    ftab: np.ndarray | None = None  # int[4^k, 2]: (start, end); start==-1 -> absent
    ftab_k: int = 0

    # --- dense FM tables (device fast path; DESIGN.md) ---
    ma_start1: np.ndarray | None = None  # int[n+1]: #markers in rows [0, i) (dense probe)
    bwt4: np.ndarray | None = None  # uint32[nb*16]: 4-bit packed BWT, 128 syms/block
    occ_blk: np.ndarray | None = None  # int[A, nb]: count of c before each block
    occ1: np.ndarray | None = None  # int[A, n+1]: full positional occ (1 gather/rank)
    tk1: np.ndarray | None = None  # int[A, n]: dense toehold (last-c sample at <=i; raw-input builds)
    kval: np.ndarray | None = None  # int[n]: SA[i] — toehold invariant k == SA[hi] (full-SA builds)
    phi1: np.ndarray | None = None  # int[n]: dense phi (1 gather per phi step)
    fblock: np.ndarray | None = None  # int32[nb, 24]: interleaved checkpoint+packed-BWT rows

    @property
    def R(self) -> int:
        return int(self.run_start.shape[0])

    @property
    def A(self) -> int:
        return self.alpha.size

    @property
    def idx_dtype(self):
        return np.int32 if self.n < (1 << 31) - 2 else np.int64

    def run_lengths(self) -> np.ndarray:
        ends = np.append(self.run_start[1:], self.n)
        return ends - self.run_start

    # ---------------- serialization ----------------

    def save(self, prefix: str) -> None:
        os.makedirs(prefix, exist_ok=True)
        arrs = {
            "alpha_bytes": self.alpha.bytes_,
            "run_start": self.run_start,
            "run_head": self.run_head,
            "occ": self.occ,
            "F": self.F,
            "cruns_flat": self.cruns_flat,
            "cruns_off": self.cruns_off,
        }
        for name in ("samples_last", "pred_pos", "pred_to_run", "ltk", "ma_row",
                     "ma_val", "ma_start1", "doc_starts", "ftab", "bwt4",
                     "occ_blk", "occ1", "tk1", "kval", "phi1", "fblock"):
            v = getattr(self, name)
            if v is not None:
                arrs[name] = v
        np.savez(os.path.join(prefix, _ARRS_NAME), **arrs)
        meta = {
            "format": "rowbowt-tpu-index",
            "version": 4,  # v4: fused-block rank rows (fblock) replace bwt4/occ_blk
            "n": self.n,
            "R": self.R,
            "ma_wsize": self.ma_wsize,
            "ftab_k": self.ftab_k,
            "doc_names": self.doc_names,
        }
        with open(os.path.join(prefix, _META_NAME), "w") as f:
            json.dump(meta, f)

    @staticmethod
    def load(prefix: str, with_sa=True, with_ma=True, with_dl=True, with_ft=True) -> "RbtIndex":
        """Flag-gated loading, mirroring LoadRbwtFlag (/root/reference/include/rowbowt_io.hpp:146-158)."""
        with open(os.path.join(prefix, _META_NAME)) as f:
            meta = json.load(f)
        z = np.load(os.path.join(prefix, _ARRS_NAME))

        def get(name, cond=True):
            return z[name] if (cond and name in z.files) else None

        return RbtIndex(
            n=int(meta["n"]),
            alpha=Alphabet(z["alpha_bytes"]),
            run_start=z["run_start"],
            run_head=z["run_head"],
            occ=z["occ"],
            F=z["F"],
            cruns_flat=z["cruns_flat"],
            cruns_off=z["cruns_off"],
            samples_last=get("samples_last", with_sa),
            pred_pos=get("pred_pos", with_sa),
            pred_to_run=get("pred_to_run", with_sa),
            ltk=get("ltk", with_sa),
            ma_row=get("ma_row", with_ma),
            ma_val=get("ma_val", with_ma),
            ma_start1=get("ma_start1", with_ma),
            ma_wsize=int(meta.get("ma_wsize", 10)),
            doc_starts=get("doc_starts", with_dl),
            doc_names=meta.get("doc_names") if with_dl else None,
            ftab=get("ftab", with_ft),
            ftab_k=int(meta.get("ftab_k", 0)),
            bwt4=get("bwt4"),
            occ_blk=get("occ_blk"),
            occ1=get("occ1"),
            tk1=get("tk1", with_sa),
            kval=get("kval", with_sa),
            phi1=get("phi1", with_sa),
            fblock=get("fblock"),
        )

    # ---------------- device view ----------------

    def device_arrays(self) -> dict:
        """Numpy pytree with dtypes chosen for the device (int32 fast path when
        the index fits; int64 otherwise).  jnp.asarray(...) of each leaf is done
        by the engine so shardings can be applied first."""
        dt = self.idx_dtype
        d = {
            "run_start": self.run_start.astype(dt),
            "run_head": self.run_head.astype(np.int32),
            "occ_flat": self.occ.astype(dt).reshape(-1),  # [A*R], row-major by char
            "F": self.F.astype(dt),
            "cruns_flat": self.cruns_flat.astype(dt),
            "cruns_off": self.cruns_off.astype(dt),
        }
        if self.samples_last is not None:
            d["samples_last"] = self.samples_last.astype(dt)
            d["pred_pos"] = self.pred_pos.astype(dt)
            d["pred_to_run"] = self.pred_to_run.astype(dt)
            if self.ltk is not None:
                d["ltk"] = self.ltk.astype(dt).reshape(-1)
        if self.ma_row is not None:
            d["ma_row"] = self.ma_row.astype(dt)
            d["ma_val"] = self.ma_val.astype(np.int64)
        if self.doc_starts is not None:
            d["doc_starts"] = self.doc_starts.astype(dt)
        if self.ftab is not None:
            d["ftab"] = self.ftab.astype(dt)
        if self.ma_start1 is not None and self.ma_row is not None:
            d["ma_start1"] = self.ma_start1.astype(dt)
        if self.bwt4 is not None:
            d["bwt4"] = self.bwt4.astype(np.uint32)
            d["occ_blk_flat"] = self.occ_blk.astype(dt).reshape(-1)
        if self.occ1 is not None:
            d["occ1_flat"] = self.occ1.astype(dt).reshape(-1)
        if self.fblock is not None:
            d["fblock"] = self.fblock  # int32[nb, 24], dtype fixed by layout
        if self.tk1 is not None and self.samples_last is not None:
            d["tk1_flat"] = self.tk1.astype(dt).reshape(-1)
        if self.kval is not None and self.samples_last is not None:
            d["kval"] = self.kval.astype(dt)
        if self.phi1 is not None and self.samples_last is not None:
            d["phi1"] = self.phi1.astype(dt)
        return d
