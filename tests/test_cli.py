"""End-to-end CLI tests over the reference fixtures (skipped when the
reference checkout is absent; tests/test_cli_seeded.py covers the same CLIs
on a seeded panel)."""

import os

import numpy as np
import pytest

from conftest import REF_DATA as REF

GOLDEN_COUNTS = """\
r1.ref (24279,24280), count=2
r1.sample0.0 (24175,24175), count=1
r2.ref (27430,27432), count=3
r2.sample0.0 (27430,27432), count=3
r3.ref (17409,17409), count=1
r3.sample0.0 (17416,17417), count=2
"""

GOLDEN_LOCS = {
    "r1.ref": [20306, 286],
    "r1.sample0.0": [10296],
    "r2.ref": [11897, 21907, 1887],
    "r2.sample0.0": [11897, 21907, 1887],
    "r3.ref": [4644],
    "r3.sample0.0": [14654, 24664],
}


@pytest.fixture(scope="module")
def ref_data():
    if not os.path.isdir(REF):
        pytest.skip("reference checkout not found (set RBT_REFERENCE_ROOT)")
    return REF


@pytest.fixture(scope="module")
def built_index(ref_data, tmp_path_factory):
    from rowbowt_tpu.cli import rbt_build

    out = str(tmp_path_factory.mktemp("cli") / "small.idx")
    rc = rbt_build.main([
        "--fasta", f"{REF}/small.fa", "--vcf", f"{REF}/small.fa.vcf.gz",
        "-s", "-m", "-l", "-f", "-k", "10", "-o", out,
    ])
    assert rc == 0
    return out


def test_align_counts(built_index, capsys):
    from rowbowt_tpu.cli import rbt_align

    assert rbt_align.main([built_index, f"{REF}/simple_query.fq"]) == 0
    assert capsys.readouterr().out == GOLDEN_COUNTS


def test_align_locate_markers(built_index, capsys):
    from rowbowt_tpu.cli import rbt_align

    assert rbt_align.main([built_index, f"{REF}/simple_query.fq", "-s", "-m"]) == 0
    out = capsys.readouterr().out.splitlines()
    # 3 lines per read: count, locs, markers
    assert len(out) == 18
    for i, name in enumerate(GOLDEN_COUNTS.splitlines()):
        rname = name.split()[0]
        locs_line = out[3 * i + 1]
        assert locs_line.startswith("\tlocs: ")
        got = [int(x.split("/")[0]) for x in locs_line.split()[1:]]
        assert got == GOLDEN_LOCS[rname], rname
    # golden markers (tests/rb_tests.cpp:123-141): r1 pair hits pos 289,
    # r3 pair hits pos 4650
    assert "289/0" in out[2] and "289/1" in out[5]
    assert "4650/0" in out[14] and "4650/1" in out[17]
    assert "no markers" in out[8] and "no markers" in out[11]


def test_markers_cli(built_index, capsys):
    from rowbowt_tpu.cli import rbt_markers

    assert rbt_markers.main([built_index, f"{REF}/error_query.fq",
                             "-w", "10", "-r", "10000"]) == 0
    out = [l for l in capsys.readouterr().out.splitlines()]
    # every line: name range_size strand qstart qlen markers|.
    assert all(len(l.split()) >= 6 for l in out)
    strands = {l.split()[2] for l in out}
    assert strands <= {"+", "-"}
    # r1.sample0.0 carries marker 289 allele 1 (VCF row 1): present on some seed
    r1s = [l for l in out if l.startswith("r1.sample0.0") and "/289/1" in l]
    assert r1s, out[:8]


def test_locs_cli(built_index, capsys, tmp_path):
    from rowbowt_tpu.cli import rbt_locs

    assert rbt_locs.main([built_index, f"{REF}/error_query.fq",
                          "-w", "10", "-m", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6
    assert all(l.split()[0].startswith(("r1", "r2", "r3")) for l in out)
    # r1.sample0.0 locates at 10296 where hap0 carries 0/289/1
    line = next(l for l in out if l.startswith("r1.sample0.0"))
    assert "0/289/1" in line


def test_midx_cli(tmp_path, capsys):
    from rowbowt_tpu.cli import rbt_midx
    from rowbowt_tpu.midx import PosMarkers

    src = tmp_path / "markers.txt"
    src.write_text("100 0 50 1\n200 1 60 0\n150 0 55 2\n")
    out = str(tmp_path / "m.midx.npz")
    assert rbt_midx.main([str(src), out]) == 0
    pm = PosMarkers.load(out)
    assert list(pm.pos) == [100, 150, 200]
    got = pm.at_range(100, 160)
    assert len(got) == 2


def test_markers_heuristic_strand_skip_parity(built_index, capsys, monkeypatch):
    """--heuristic --best-strand-only with the device strand skip (reverse
    kernel only for non-stopped reads) must print byte-identical output to
    the always-both-strands path (rb_markers.cpp:429-519 semantics)."""
    from rowbowt_tpu.cli import rbt_markers

    argv = [built_index, f"{REF}/error_query.fq", "-w", "10",
            "--heuristic", "--best-strand-only", "-y", "10"]
    assert rbt_markers.main(argv) == 0
    fast = capsys.readouterr().out
    monkeypatch.setenv("RBT_NO_STRAND_SKIP", "1")
    assert rbt_markers.main(argv) == 0
    slow = capsys.readouterr().out
    assert fast == slow
    assert fast.strip()


def test_markers_cli_lmem(built_index, capsys):
    from rowbowt_tpu.cli import rbt_markers

    assert rbt_markers.main([built_index, f"{REF}/error_query.fq",
                             "-w", "10", "-r", "10000", "--lmem",
                             "-b", "16"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out and all(len(l.split()) >= 6 for l in out)
    r1s = [l for l in out if l.startswith("r1.sample0.0") and "/289/1" in l]
    assert r1s, out[:8]


def test_align_markers_no_truncation(tmp_path, capsys):
    """rb_align prints EVERY marker in the range (rb_align.cpp:137-144); a
    range with more than the first probe's 64 slots must re-probe, not clip."""
    from rowbowt_tpu.alphabet import TERM_BYTE
    from rowbowt_tpu.cli import rbt_align
    from rowbowt_tpu.construct.build import build_index
    from rowbowt_tpu.construct.panel import Marker
    from rowbowt_tpu.engine import naive

    rng_ = np.random.default_rng(3)
    seq = rng_.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=600)
    text = np.concatenate([seq, np.array([TERM_BYTE], dtype=np.uint8)])
    w = 7
    markers = [Marker(text_pos=int(p), seq=0, pos=int(p), allele=0)
               for p in rng_.choice(600, size=120, replace=False)]
    idx = build_index(text, markers=markers, ma_wsize=w)
    pre = str(tmp_path / "dense.idx")
    idx.save(pre)
    # a 1bp query covers ~n/4 rows -> far more than 64 marker entries
    q = tmp_path / "q.fq"
    q.write_text("@tiny\nA\n+\nI\n")
    assert rbt_align.main([pre, str(q), "-m"]) == 0
    out = capsys.readouterr().out.splitlines()
    rng = [int(x) for x in out[0].split("(")[1].split(")")[0].split(",")]
    want = naive.markers_at_range(idx, rng[0], rng[1])
    got = out[1].split()[1:]
    assert len(want) > 64, "fixture no longer exercises overflow"
    assert len(got) == len(want)


def test_build_fbb_rank_only(ref_data, tmp_path, capsys):
    """rbt_build -x: rank-only backend (reference fbb_string semantics) —
    counts byte-golden, -s refused like fbb's missing select."""
    from rowbowt_tpu.cli import rbt_align, rbt_build

    out = str(tmp_path / "fbb.idx")
    rc = rbt_build.main([
        "--fasta", f"{REF}/small.fa", "--vcf", f"{REF}/small.fa.vcf.gz",
        "-x", "-s", "-m", "-l", "-o", out,  # -s must be warned away, not honored
    ])
    assert rc == 0
    assert "fbb backend does not support" in capsys.readouterr().err

    assert rbt_align.main([out, f"{REF}/simple_query.fq"]) == 0
    got = capsys.readouterr().out
    assert got == GOLDEN_COUNTS

    assert rbt_align.main(["-s", out, f"{REF}/simple_query.fq"]) == 1
    assert "locate is unavailable" in capsys.readouterr().err


def test_sharded_stream_script(built_index, capsys):
    """Config-5 driver (streamed FASTQ x sharded index on the virtual mesh)
    prints the same count lines as rbt_align."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "sharded_stream",
        os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "sharded_stream.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main([built_index, f"{REF}/simple_query.fq", "--n-idx", "4"])
    assert rc == 0
    assert capsys.readouterr().out == GOLDEN_COUNTS


def test_missing_component_errors(ref_data, tmp_path, capsys):
    """Clean errors (not tracebacks) when a query needs a component the index
    wasn't built with — the reference die()s with a message (utils.hpp:16-19)."""
    from rowbowt_tpu.cli import rbt_align, rbt_build, rbt_locs, rbt_markers

    out = str(tmp_path / "bare.idx")
    assert rbt_build.main(["--fasta", f"{REF}/small.fa", "-o", out]) == 0
    capsys.readouterr()

    assert rbt_align.main(["-m", out, f"{REF}/simple_query.fq"]) == 1
    assert "no marker array" in capsys.readouterr().err
    assert rbt_markers.main([out, f"{REF}/simple_query.fq"]) == 1
    assert "no marker array" in capsys.readouterr().err
    assert rbt_locs.main([out, f"{REF}/simple_query.fq"]) == 1
    err = capsys.readouterr().err
    assert "not found" in err or "no toehold SA" in err


@pytest.fixture(scope="module")
def big_format_index(tmp_path_factory, tiny_index, tiny_panel):
    """The tiny fixture re-packed as a BigIndex (two-level) artifact — the CLI
    must serve it through the same binaries (rb_align.cpp:147-193 contract)."""
    from rowbowt_tpu.bigindex import BigIndex
    from rowbowt_tpu.index import pack_marker

    idx = tiny_index
    run_len = np.diff(np.append(idx.run_start, idx.n))
    codes = np.repeat(idx.run_head.astype(np.uint8), run_len)
    sa = np.asarray(idx.kval).astype(np.uint32)
    big = BigIndex.from_codes(codes, idx.alpha, n_sup=4)
    big.attach_locate(codes, sa)
    ms = tiny_panel.markers
    big.attach_markers(sa, [m.text_pos for m in ms],
                       [pack_marker(m.seq, m.pos, m.allele) for m in ms],
                       idx.ma_wsize)
    big.doc_starts = np.asarray(idx.doc_starts)
    big.doc_names = list(idx.doc_names)
    out = str(tmp_path_factory.mktemp("cli_big") / "big.idx")
    big.save(out)
    return out


def test_align_cli_on_big_artifact(big_format_index, capsys):
    """rbt_align auto-detects the big artifact: counts, locs, and markers all
    golden — the full capability matrix through one CLI."""
    from rowbowt_tpu.cli import rbt_align

    assert rbt_align.main([big_format_index, f"{REF}/simple_query.fq"]) == 0
    assert capsys.readouterr().out == GOLDEN_COUNTS

    assert rbt_align.main([big_format_index, f"{REF}/simple_query.fq",
                           "-s", "-m"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 18
    for i, name in enumerate(GOLDEN_COUNTS.splitlines()):
        rname = name.split()[0]
        locs_line = out[3 * i + 1]
        assert locs_line.startswith("\tlocs: ")
        got = [int(x.split("/")[0]) for x in locs_line.split()[1:]]
        assert got == GOLDEN_LOCS[rname], rname
    assert "289/0" in out[2] and "289/1" in out[5]
    assert "4650/0" in out[14] and "4650/1" in out[17]
    assert "no markers" in out[8] and "no markers" in out[11]


def test_markers_cli_on_big_artifact(built_index, big_format_index, capsys):
    """rbt_markers (the production genotyping tool) byte-identical between the
    replicated RbtIndex and the big two-level artifact."""
    from rowbowt_tpu.cli import rbt_markers

    argv_tail = [f"{REF}/error_query.fq", "-w", "10", "-r", "10000"]
    assert rbt_markers.main([built_index] + argv_tail) == 0
    want = capsys.readouterr().out
    assert rbt_markers.main([big_format_index] + argv_tail) == 0
    got = capsys.readouterr().out
    assert got == want
    assert want.strip()
