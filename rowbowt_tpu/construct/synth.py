"""Seeded panel generator: FASTA reference + phased VCF + FASTQ reads on disk.

The inputs `rbt_build --fasta --vcf` and the query CLIs take, generated from a
seed so every run (tests, `chip_smoke.py`) rebuilds the same panel without a
download:

- a uniform random reference of `ref_len` bp on one contig;
- `n_sites` biallelic SNVs at distinct positions, each ALT differing from REF;
  every haplotype of every diploid sample carries the ALT with probability
  `alt_p`, independently (the statistics of bench.py's synthetic panels);
- `n_reads` reads of `read_len` bp sampled uniformly from the haplotypes, half
  of them reverse-complemented; a fraction `sub_frac` carries one substitution
  and a fraction `n_frac` one `N`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, dtype=np.uint8)
_COMP[ACGT] = np.frombuffer(b"TGCA", dtype=np.uint8)
_COMP[ord("N")] = ord("N")


@dataclasses.dataclass
class SynthPanel:
    fasta: str
    vcf: str
    fastq: str
    contig: str
    ref_len: int
    n_samples: int
    n_sites: int
    n_reads: int


def _haplotypes(ref, pos, alt, carry):
    """[n_haps, ref_len] uint8 haplotype sequences (carry: bool[n_sites, H])."""
    haps = np.repeat(ref[None, :], carry.shape[1], axis=0)
    for h in range(carry.shape[1]):
        c = carry[:, h]
        haps[h, pos[c]] = alt[c]
    return haps


def _write_fasta(path, contig, seq, width=60):
    full = seq.shape[0] // width * width
    lines = np.empty((full // width, width + 1), dtype=np.uint8)
    lines[:, :width] = seq[:full].reshape(-1, width)
    lines[:, width] = ord("\n")
    with open(path, "wb") as f:
        f.write(f">{contig}\n".encode())
        f.write(lines.tobytes())
        if full < seq.shape[0]:
            f.write(seq[full:].tobytes() + b"\n")


def _write_vcf(path, contig, ref_len, ref, pos, alt, carry, samples):
    H = carry.shape[1]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={contig},length={ref_len}>\n")
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        gt = carry.astype(np.uint8) + ord("0")
        for j in range(pos.shape[0]):
            g = gt[j]
            calls = "\t".join(f"{chr(g[2 * s])}|{chr(g[2 * s + 1])}"
                              for s in range(H // 2))
            f.write(f"{contig}\t{int(pos[j]) + 1}\t.\t{chr(ref[pos[j]])}\t"
                    f"{chr(alt[j])}\t.\tPASS\t.\tGT\t{calls}\n")


def sample_reads(haps, n_reads, read_len, rng, sub_frac=0.2, n_frac=0.005):
    """[n_reads, read_len] uint8 reads from random haplotypes, half of them
    reverse-complemented, with the substitutions and Ns described above."""
    H, ref_len = haps.shape
    hap = rng.integers(0, H, size=n_reads)
    start = rng.integers(0, ref_len - read_len + 1, size=n_reads)
    cols = start[:, None] + np.arange(read_len)[None, :]
    reads = haps[hap[:, None], cols]
    sub = np.flatnonzero(rng.random(n_reads) < sub_frac)
    spos = rng.integers(0, read_len, size=sub.shape[0])
    cur = reads[sub, spos]
    cur_code = np.searchsorted(ACGT, cur)  # reads hold ACGT only here
    reads[sub, spos] = ACGT[(cur_code + rng.integers(1, 4, size=sub.shape[0])) % 4]
    nn = np.flatnonzero(rng.random(n_reads) < n_frac)
    reads[nn, rng.integers(0, read_len, size=nn.shape[0])] = ord("N")
    rev = rng.random(n_reads) < 0.5
    reads[rev] = _COMP[reads[rev][:, ::-1]]
    return reads


def write_fastq(path, reads, prefix="read"):
    L = reads.shape[1]
    qual = b"I" * L
    with open(path, "wb") as f:
        for i in range(reads.shape[0]):
            f.write(b"@%s%d\n%s\n+\n%s\n" % (prefix.encode(), i,
                                            reads[i].tobytes(), qual))


def write_panel(out_dir: str, seed: int, ref_len: int = 20_000_000,
                n_samples: int = 4, n_sites: int = 60_000,
                n_reads: int = 65_536, read_len: int = 100,
                alt_p: float = 0.5, sub_frac: float = 0.2,
                n_frac: float = 0.005, contig: str = "chr1") -> SynthPanel:
    """Write panel.fa, panel.vcf and reads.fq under out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    ref = ACGT[rng.integers(0, 4, size=ref_len)]
    pos = np.sort(rng.choice(ref_len, size=n_sites, replace=False))
    ref_code = np.searchsorted(ACGT, ref[pos])
    alt = ACGT[(ref_code + rng.integers(1, 4, size=n_sites)) % 4]
    carry = rng.random((n_sites, 2 * n_samples)) < alt_p
    samples = [f"sample{s}" for s in range(n_samples)]
    p = SynthPanel(fasta=os.path.join(out_dir, "panel.fa"),
                   vcf=os.path.join(out_dir, "panel.vcf"),
                   fastq=os.path.join(out_dir, "reads.fq"),
                   contig=contig, ref_len=ref_len, n_samples=n_samples,
                   n_sites=n_sites, n_reads=n_reads)
    _write_fasta(p.fasta, contig, ref)
    _write_vcf(p.vcf, contig, ref_len, ref, pos, alt, carry, samples)
    haps = _haplotypes(ref, pos, alt, carry)
    write_fastq(p.fastq, sample_reads(haps, n_reads, read_len, rng,
                                      sub_frac=sub_frac, n_frac=n_frac))
    return p
