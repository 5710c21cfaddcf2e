"""The CLIs end to end on the seeded panel (construct/synth.py), checked
against engine/naive.py through chip_smoke.py's own parse and parity code —
the same checks chip_smoke runs on the card at chromosome scale."""

import importlib.util
import os

import numpy as np
import pytest

import chip_smoke as cs
from rowbowt_tpu.io.fastq import read_seqs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reads(seeded_panel):
    return [(name, seq) for name, seq, _ in read_seqs(seeded_panel.fastq)]


@pytest.fixture(scope="module")
def align_text(seeded_index_dir, seeded_panel):
    from rowbowt_tpu.cli import rbt_align

    return cs.run_cli(rbt_align.main,
                      [seeded_index_dir, seeded_panel.fastq, "-s", "-m"])


@pytest.fixture(scope="module")
def markers_text(seeded_index_dir, seeded_panel):
    from rowbowt_tpu.cli import rbt_markers

    return cs.run_cli(rbt_markers.main,
                      [seeded_index_dir, seeded_panel.fastq, "-w", "10"])


def _sharded_stream():
    spec = importlib.util.spec_from_file_location(
        "sharded_stream", os.path.join(REPO, "scripts", "sharded_stream.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_seeded_build_shape(seeded_index, seeded_panel):
    """One reference document plus 2 haplotypes per sample; every document
    carries one marker per site."""
    docs = 1 + 2 * seeded_panel.n_samples
    assert len(seeded_index.doc_names) == docs
    assert seeded_index.n == docs * (seeded_panel.ref_len + 10) + 1
    assert seeded_index.ma_row is not None and seeded_index.kval is not None


def test_align_counts_match_naive(seeded_index_dir, seeded_index, reads):
    from rowbowt_tpu.cli import rbt_align
    from rowbowt_tpu.engine import naive

    out = cs.run_cli(rbt_align.main, [seeded_index_dir,
                                      _write_fq(reads, seeded_index_dir)])
    lines = out.splitlines()
    assert len(lines) == len(reads)
    for line, (name, seq) in zip(lines, reads):
        codes = seeded_index.alpha.encode(
            np.frombuffer(seq, np.uint8)).astype(np.int64)
        s, e = naive.find_range(seeded_index, codes)
        cnt = e - s + 1 if e >= s else 0
        assert line == f"{name} ({s},{e}), count={cnt}"


def _write_fq(reads, where):
    path = where.rstrip("/") + ".reads.fq"
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    return path


def test_align_locate_markers_match_naive(seeded_index, reads, align_text):
    got = cs.parse_align(align_text)
    assert list(got) == [name for name, _ in reads]
    hits = 0
    for name, seq in reads:
        want = cs.expected_align(seeded_index, seq)
        assert got[name] == want, name
        hits += len(want.locs)
    assert hits >= len(reads) // 2  # most reads come from the panel


def test_markers_match_naive_greedy(seeded_index, reads, markers_text):
    got = cs.parse_markers(markers_text)
    seeds = 0
    for name, seq in reads:
        want = cs.expected_markers(seeded_index, name, seq)
        assert got.get(name, []) == want, name
        seeds += len(want)
    assert seeds >= len(reads)  # both strands seed


def test_check_parity_counts(seeded_index, reads, align_text, markers_text):
    res = cs.check_parity(seeded_index, reads, cs.parse_align(align_text),
                          cs.parse_markers(markers_text))
    assert res == {k: len(reads) for k in
                   ("reads", "count", "locate", "markers", "greedy")}


@pytest.mark.parametrize("kind", ["locate", "greedy", "missing"])
def test_check_parity_catches_mismatch(seeded_index, reads, align_text,
                                       markers_text, kind):
    """A corrupted CLI output must fail the parity phase, not pass it."""
    align = cs.parse_align(align_text)
    markers = cs.parse_markers(markers_text)
    name = next(n for n, _ in reads if align[n].locs)
    if kind == "locate":
        l, doc, off = align[name].locs[0]
        align[name].locs[0] = (l + 1, doc, off + 1)
    elif kind == "greedy":
        markers[name] = markers[name][:-1]
    else:
        del align[name]
    with pytest.raises(cs.PhaseError):
        cs.check_parity(seeded_index, reads, align, markers)


def test_parse_align_record():
    text = ("r1 (5,7), count=3\n\tlocs: 10/chr1:10 70/chr1_s_0:9 \n"
            "\tmarkers: 289/0 289/1 \n"
            "r2 (1,0), count=0\n\tlocs: \n"
            "\tmarkers: no markers (consider building the marker array with "
            "a larger window size)\n")
    got = cs.parse_align(text)
    assert got["r1"] == cs.AlignRecord((5, 7), 3, [(10, "chr1", 10),
                                                  (70, "chr1_s_0", 9)],
                                       [(289, 0), (289, 1)])
    assert got["r2"] == cs.AlignRecord((1, 0), 0, [], [])


def test_two_level_layouts_match_dense(seeded_index, seeded_panel, reads,
                                       native_lib):
    """chip_smoke's layouts phase at tiny size: fb2_64 and fb2_256 give the
    dense index's toehold ranges, locs and greedy seeds exactly."""
    if native_lib is None:
        pytest.skip("no native lib (rbt_fb2_fill_rle)")
    from rowbowt_tpu.construct import build_panel
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.index import pack_marker

    panel = build_panel(seeded_panel.fasta, seeded_panel.vcf, wsize=10)
    layouts = cs.two_level_indexes(
        seeded_index, [m.text_pos for m in panel.markers],
        [pack_marker(m.seq, m.pos, m.allele) for m in panel.markers])
    assert set(layouts) == {"fb2_64", "fb2_256"}
    qc, lens, gq, gl = cs.query_lanes(seeded_index, [s for _, s in reads], 64)
    ref = cs.engine_outputs(DeviceIndex.from_index(seeded_index), qc, lens,
                            gq, gl)
    for label, big in layouts.items():
        bdx = big.device_index()
        assert label in bdx.arrays
        got = cs.engine_outputs(bdx, qc, lens, gq, gl)
        assert cs.compare_outputs(ref, got, label) == len(ref)


def test_rbt_align_pad_lanes_stay_empty(seeded_index_dir, seeded_panel,
                                        align_text):
    """A batch wider than the read count pads with empty lanes; their full
    range must not be located or marker-expanded (identical output)."""
    from rowbowt_tpu.cli import rbt_align

    wide = cs.run_cli(rbt_align.main, [seeded_index_dir, seeded_panel.fastq,
                                       "-s", "-m", "-b", "4096"])
    narrow = cs.run_cli(rbt_align.main, [seeded_index_dir, seeded_panel.fastq,
                                         "-s", "-m", "-b", "32"])
    assert wide == narrow == align_text


def test_sharded_stream_counts_match_rbt_align(seeded_index_dir, seeded_panel,
                                               align_text):
    """Streamed FASTQ over the position-sharded index on the virtual mesh
    prints rbt_align's count lines."""
    ss = _sharded_stream()
    out = cs.run_cli(ss.main, [seeded_index_dir, seeded_panel.fastq,
                               "--n-idx", "4"])
    assert out.splitlines() == align_text.splitlines()[0::3]


@pytest.mark.parametrize("n_idx", [4, 1])
def test_sharded_stream_greedy_matches_single_device(
        seeded_index_dir, seeded_index, seeded_panel, n_idx):
    """chip_smoke --four-gpus at tiny size: sharded (idx=4) and replicated
    (dp mesh) greedy genotyping == the single-device engine, line for line."""
    from rowbowt_tpu.cli.common import iter_query_batches
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding

    ss = _sharded_stream()
    got = cs.run_cli(ss.main, [seeded_index_dir, seeded_panel.fastq,
                               "--greedy", "--n-idx", str(n_idx), "-b", "64",
                               "--wsize", "10", "--max-range", "1000"])
    dx = DeviceIndex.from_index(seeded_index)
    comp = ss.complement_codes(seeded_index.alpha)
    want = []
    for names, qc, lens in iter_query_batches(seeded_index,
                                              seeded_panel.fastq, 64):
        inter, il = ss.revcomp_lanes(qc, lens, comp, len(names))
        g = [np.asarray(x) for x in markers_greedy_seeding(
            dx, inter, il.astype(np.int32), wsize=10, max_range=1000,
            use_ftab=False)]
        want += ss.greedy_lines(names, g[4], g[5], g[6])
    assert got.splitlines() == want
    assert len(want) == 2 * seeded_panel.n_reads
    assert any(not line.endswith("markers: ") for line in want)
