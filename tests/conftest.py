"""Test config: force an 8-device virtual CPU mesh before jax initializes,
so multi-device sharding paths are testable without a GPU."""

import fcntl
import os
import shutil
import subprocess

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

REF_ROOT = os.environ.get("RBT_REFERENCE_ROOT", "/root/reference")
REF_DATA = os.path.join(REF_ROOT, "tests", "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session", autouse=True)
def native_lib(tmp_path_factory):
    """Build native/librbt_native.so once per run when a compiler exists.
    xdist workers share one file lock, so one builds and the rest find the
    library up to date."""
    from rowbowt_tpu.construct.sa import _load_native

    if shutil.which(os.environ.get("CXX", "g++")) and shutil.which("make"):
        lock = tmp_path_factory.getbasetemp().parent / "native_build.lock"
        with open(lock, "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                           capture_output=True, check=False)
    return _load_native()


@pytest.fixture(scope="session")
def seeded_panel(tmp_path_factory):
    """A tiny seeded FASTA + phased VCF + FASTQ (construct/synth.py)."""
    from rowbowt_tpu.construct import synth

    return synth.write_panel(str(tmp_path_factory.mktemp("seeded_panel")),
                             seed=7, ref_len=50_000, n_samples=2, n_sites=150,
                             n_reads=96, read_len=60)


@pytest.fixture(scope="session")
def seeded_index_dir(seeded_panel, tmp_path_factory):
    """rbt_build --fasta --vcf -s -m -l over the seeded panel."""
    from rowbowt_tpu.cli import rbt_build

    out = str(tmp_path_factory.mktemp("seeded_idx") / "panel.idx")
    assert rbt_build.main(["--fasta", seeded_panel.fasta, "--vcf",
                           seeded_panel.vcf, "-s", "-m", "-l", "-o", out]) == 0
    return out


@pytest.fixture(scope="session")
def seeded_index(seeded_index_dir):
    from rowbowt_tpu.index import RbtIndex

    return RbtIndex.load(seeded_index_dir)


@pytest.fixture(scope="session")
def tiny_panel():
    from rowbowt_tpu.construct import build_panel

    if not os.path.isdir(REF_DATA):
        pytest.skip("reference checkout not found (set RBT_REFERENCE_ROOT)")
    return build_panel(
        os.path.join(REF_DATA, "small.fa"),
        os.path.join(REF_DATA, "small.fa.vcf.gz"),
        wsize=10,
    )


@pytest.fixture(scope="session")
def tiny_index(tiny_panel):
    from rowbowt_tpu.construct.build import build_index_from_panel

    return build_index_from_panel(tiny_panel)


@pytest.fixture(scope="session")
def tiny_index_ftab(tiny_panel):
    from rowbowt_tpu.construct.build import build_index_from_panel

    return build_index_from_panel(tiny_panel, ftab_k=10)


def encode_query(idx, s: str) -> np.ndarray:
    return idx.alpha.encode(np.frombuffer(s.encode(), dtype=np.uint8)).astype(np.int64)


@pytest.fixture(scope="session")
def rand_index():
    """Small random-text index (with markers at random sites) for property tests."""
    from rowbowt_tpu.construct.build import build_index
    from rowbowt_tpu.construct.panel import Marker
    from rowbowt_tpu.alphabet import SEP_BYTE, TERM_BYTE

    rng = np.random.default_rng(42)
    parts = []
    doc_starts = []
    pos = 0
    w = 7
    markers = []
    for d in range(3):
        L = int(rng.integers(200, 400))
        seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=L)
        doc_starts.append(pos)
        for _ in range(6):
            p = int(rng.integers(0, L))
            markers.append(Marker(text_pos=pos + p, seq=0, pos=p, allele=int(rng.integers(0, 2))))
        parts.append(seq)
        parts.append(np.full(w, SEP_BYTE, dtype=np.uint8))
        pos += L + w
    parts.append(np.array([TERM_BYTE], dtype=np.uint8))
    text = np.concatenate(parts)
    return build_index(
        text,
        markers=markers,
        doc_starts=np.array(doc_starts, dtype=np.int64),
        doc_names=[f"doc{d}" for d in range(3)],
        ma_wsize=w,
    ), text
