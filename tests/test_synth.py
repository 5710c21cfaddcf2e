"""construct/synth.py: the seeded panel generator round-trips through the
FASTA/VCF/FASTQ readers with the statistics it promises."""

import numpy as np

from rowbowt_tpu.construct import synth
from rowbowt_tpu.construct.panel import parse_fasta, parse_vcf
from rowbowt_tpu.io.fastq import read_seqs


def _gen(tmp_path, seed, **kw):
    args = dict(ref_len=20_011, n_samples=3, n_sites=400, n_reads=2_000,
                read_len=50)
    args.update(kw)
    return synth.write_panel(str(tmp_path / f"s{seed}"), seed=seed, **args)


def test_panel_round_trip(tmp_path):
    p = _gen(tmp_path, 3)
    (name, ref), = parse_fasta(p.fasta)
    assert name == p.contig and len(ref) == p.ref_len
    assert set(ref) <= set("ACGT")
    variants, samples = parse_vcf(p.vcf)
    assert samples == [f"sample{s}" for s in range(3)]
    assert len(variants) == 400
    assert len({v.pos0 for v in variants}) == 400
    alt_calls = 0
    for v in variants:
        assert ref[v.pos0] == v.ref and v.alts[0] != v.ref
        for gt in v.genotypes.values():
            assert len(gt) == 2 and set(gt) <= {0, 1}
            alt_calls += sum(gt)
    assert 0.4 < alt_calls / (400 * 6) < 0.6  # alt_p = 0.5


def test_reads_come_from_haplotypes(tmp_path):
    p = _gen(tmp_path, 4)
    (_, ref), = parse_fasta(p.fasta)
    reads = list(read_seqs(p.fastq))
    assert len(reads) == 2_000
    assert all(len(s) == 50 for _, s, _ in reads)
    with_n = sum(b"N" in s for _, s, _ in reads)
    assert 0 < with_n < 40  # n_frac = 0.005
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    ref_b = ref.encode()
    exact = sum(s in ref_b or s.translate(comp)[::-1] in ref_b
                for _, s, _ in reads)
    # a read of 50 bp spans one site (1 per 50 bp) on average; about half the
    # reads match the reference exactly on one strand, the rest carry a
    # substitution, an N or a site where their haplotype has the ALT
    assert 0.3 * len(reads) < exact < 0.7 * len(reads)


def test_generator_is_seeded(tmp_path):
    a, b, c = _gen(tmp_path, 5), _gen(tmp_path / "again", 5), _gen(tmp_path, 6)
    for path in ("fasta", "vcf", "fastq"):
        same = open(getattr(a, path), "rb").read()
        assert same == open(getattr(b, path), "rb").read()
    assert open(a.fastq, "rb").read() != open(c.fastq, "rb").read()


def test_sample_reads_substitutions_change_the_base():
    rng = np.random.default_rng(0)
    hap = synth.ACGT[rng.integers(0, 4, size=(1, 500))]
    reads = synth.sample_reads(hap, 400, 30, np.random.default_rng(1),
                               sub_frac=1.0, n_frac=0.0)
    comp = synth._COMP
    hap_b = hap[0].tobytes()
    for r in reads:
        fwd = r.tobytes()
        rc = comp[r[::-1]].tobytes()
        # exactly one substitution: no strand of the read occurs verbatim
        assert fwd not in hap_b and rc not in hap_b
