"""Native C++ FASTQ reader vs the Python reader: identical batches."""

import gzip

import numpy as np
import pytest

from rowbowt_tpu.alphabet import normalize_read, revcomp
from rowbowt_tpu.engine.batch import encode_batch
from rowbowt_tpu.io.fastq import NativeBatchReader, read_seqs

FASTA = b""">r1 with comment
ACGTACGTNN
acgt
>r2
TTTT
@q1
ACGNNACG
+
IIIIIIII
"""

FASTQ = b"""@q1 desc
ACGTACGT
+
IIIIIIII
@q2
NNNN
+
!!!!
"""


@pytest.fixture(params=["plain", "gz"])
def mixed_file(request, tmp_path):
    p = tmp_path / ("reads.fa" + (".gz" if request.param == "gz" else ""))
    data = FASTA
    p.write_bytes(gzip.compress(data) if request.param == "gz" else data)
    return str(p)


def test_read_seqs_mixed(mixed_file):
    recs = list(read_seqs(mixed_file))
    assert [r[0] for r in recs] == ["r1", "r2", "q1"]
    assert recs[0][1] == b"ACGTACGTNNacgt"
    assert recs[2][2] == b"IIIIIIII"


@pytest.mark.parametrize("with_rc,norm", [(False, False), (True, True)])
def test_native_reader_matches_python(tmp_path, seeded_index, with_rc, norm):
    if not NativeBatchReader.available():
        pytest.skip("no native lib")
    p = tmp_path / "reads.fq.gz"
    p.write_bytes(gzip.compress(FASTQ))
    idx = seeded_index
    batches = list(NativeBatchReader(str(p), idx.alpha.encode_table(),
                                     batch_size=4, with_rc=with_rc,
                                     normalize=norm))
    assert len(batches) == 1
    names, qc, lens = batches[0]
    assert names == ["q1", "q2"]
    # rebuild expectations with the Python path
    seqs = []
    for _, seq, _ in read_seqs(str(p)):
        s = normalize_read(seq) if norm else np.frombuffer(seq, np.uint8)
        seqs.append(s)
        if with_rc:
            seqs.append(revcomp(s))
    want_qc, want_lens = encode_batch(idx, [s.tobytes() for s in seqs],
                                      pad_to=qc.shape[1])
    nl = len(seqs)
    np.testing.assert_array_equal(qc[:nl], want_qc)
    np.testing.assert_array_equal(lens[:nl], want_lens)
    assert (lens[nl:] == 0).all()


def test_native_reader_multi_batch(tmp_path, seeded_index):
    if not NativeBatchReader.available():
        pytest.skip("no native lib")
    recs = b"".join(
        f"@r{i}\nACGTACGTAC\n+\nIIIIIIIIII\n".encode() for i in range(10)
    )
    p = tmp_path / "many.fq"
    p.write_bytes(recs)
    out = []
    for names, qc, lens in NativeBatchReader(str(p),
                                             seeded_index.alpha.encode_table(),
                                             batch_size=4):
        out.extend(names)
        assert qc.shape[0] == 4
    assert out == [f"r{i}" for i in range(10)]
