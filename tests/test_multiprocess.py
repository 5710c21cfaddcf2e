"""REAL two-process jax.distributed run of the config-5 deployment script:
each process streams its own FASTQ shard over a (dp x idx) mesh spanning both
processes' CPU devices (Gloo collectives), index position-sharded; host 0
emits ordered results.  This exercises make_array_from_process_local_data and
process_allgather across an actual process boundary — the cross-host path the
single-process tests degenerate away."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("markers", [False, True])
def test_two_process_sharded_stream(rand_index, tmp_path, markers):
    from rowbowt_tpu.engine import naive

    idx, text = rand_index
    pre = str(tmp_path / "idx")
    idx.save(pre)

    rng = np.random.default_rng(31)
    L = 20
    reads = []
    for _ in range(8):
        p = int(rng.integers(0, len(text) - L))
        reads.append(bytes(text[p:p + L]))
    shards = [reads[:4], reads[4:]]
    paths = []
    for s, shard in enumerate(shards):
        fq = tmp_path / f"shard{s}.fq"
        with open(fq, "w") as f:
            for i, r in enumerate(shard):
                f.write(f"@s{s}r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
        paths.append(str(fq))

    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            PYTHONPATH=REPO,
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "sharded_stream.py"),
             pre, paths[pid], "--n-idx", "2", "-b", "4",
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(pid)]
            + (["-m", "--wsize", str(rand_index[0].ma_wsize)] if markers else []),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (out, err)
        outs.append(out)
    def result_lines(out):  # Gloo logs ride stdout; results start with names
        return [l for l in out.splitlines() if l.startswith("s0r") or
                l.startswith("s1r")]

    # each host writes ITS OWN shard's results, in its own input order
    for pid in range(2):
        lines = result_lines(outs[pid])
        assert len(lines) == 4, outs[pid]
        for i, (line, r) in enumerate(zip(lines, shards[pid])):
            assert line.startswith(f"s{pid}r{i} ")
            codes = idx.alpha.encode(np.frombuffer(r, np.uint8)).astype(np.int64)
            lo, hi = naive.find_range(idx, codes)
            cnt = hi - lo + 1 if hi >= lo else 0
            assert line.endswith(f"({lo},{hi}), count={cnt}"), (line, lo, hi)


def test_two_process_sharded_stream_big_artifact(rand_index, tmp_path):
    """The same two-process config-5 flow on a BIG-format (two-level) artifact:
    sharded_stream auto-detects it, shards the fb tables n_idx == n_sup ways,
    replicates the O(R)/O(M) aux tables, and streams FASTQ with markers."""
    from rowbowt_tpu.bigindex import BigIndex
    from rowbowt_tpu.engine import naive

    idx, text = rand_index
    run_len = np.diff(np.append(idx.run_start, idx.n))
    codes = np.repeat(idx.run_head.astype(np.uint8), run_len)
    sa = np.asarray(idx.kval).astype(np.uint32)
    big = BigIndex.from_codes(codes, idx.alpha, n_sup=2)
    big.attach_locate(codes, sa)
    big.ma_row = np.asarray(idx.ma_row).astype(np.uint32)
    big.ma_val = np.asarray(idx.ma_val)
    big.ma_wsize = idx.ma_wsize
    pre = str(tmp_path / "bigidx")
    big.save(pre)
    assert BigIndex.is_big_dir(pre)

    rng = np.random.default_rng(37)
    L = 20
    reads = []
    for _ in range(8):
        p = int(rng.integers(0, len(text) - L))
        reads.append(bytes(text[p:p + L]))
    shards = [reads[:4], reads[4:]]
    paths = []
    for s, shard in enumerate(shards):
        fq = tmp_path / f"shard{s}.fq"
        with open(fq, "w") as f:
            for i, r in enumerate(shard):
                f.write(f"@s{s}r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
        paths.append(str(fq))

    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            PYTHONPATH=REPO,
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "sharded_stream.py"),
             pre, paths[pid], "--n-idx", "2", "-b", "4",
             "-m", "--wsize", str(idx.ma_wsize),
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (out, err)
        outs.append(out)

    for pid in range(2):
        lines = [l for l in outs[pid].splitlines() if l.startswith(f"s{pid}r")]
        assert len(lines) == 4, outs[pid]
        for i, (line, r) in enumerate(zip(lines, shards[pid])):
            assert line.startswith(f"s{pid}r{i} ")
            qcodes = idx.alpha.encode(np.frombuffer(r, np.uint8)).astype(np.int64)
            lo, hi = naive.find_range(idx, qcodes)
            cnt = hi - lo + 1 if hi >= lo else 0
            assert line.endswith(f"({lo},{hi}), count={cnt}"), (line, lo, hi)


def test_four_process_sharded_stream_nontrivial_batch(rand_index, tmp_path):
    """FOUR jax.distributed processes (2 CPU devices each -> a 4x2 dp-by-idx
    mesh) streaming a NON-trivIAL batch: 2,048 reads of L=100 split across
    the four hosts, batch size 512.  Every host's counts must equal naive."""
    from rowbowt_tpu.engine import naive

    idx, text = rand_index
    pre = str(tmp_path / "idx")
    idx.save(pre)

    rng = np.random.default_rng(71)
    L, NPROC, PER = 100, 4, 512
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    while len(reads) < NPROC * PER:
        p = int(rng.integers(0, len(text) - L))
        r = np.array(text[p:p + L])
        if rng.random() < 0.3:  # mutations: some empty ranges
            r[int(rng.integers(0, L))] = acgt[int(rng.integers(0, 4))]
        if np.isin(r, acgt).all():
            reads.append(bytes(r))
    shards = [reads[s * PER:(s + 1) * PER] for s in range(NPROC)]
    paths = []
    for s, shard in enumerate(shards):
        fq = tmp_path / f"shard{s}.fq"
        with open(fq, "w") as f:
            for i, r in enumerate(shard):
                f.write(f"@s{s}r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
        paths.append(str(fq))

    port = _free_port()
    procs = []
    for pid in range(NPROC):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            PYTHONPATH=REPO,
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "sharded_stream.py"),
             pre, paths[pid], "--n-idx", "2", "-b", "512",
             "--coordinator", f"localhost:{port}",
             "--num-processes", str(NPROC), "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (out[-2000:], err[-2000:])
        outs.append(out)

    # spot-check 24 random reads per host against naive (full 2,048 naive
    # searches would dominate the test wall)
    for pid in range(NPROC):
        lines = [l for l in outs[pid].splitlines()
                 if l.startswith(f"s{pid}r")]
        assert len(lines) == PER, (pid, len(lines))
        for i in rng.choice(PER, size=24, replace=False):
            line = lines[i]
            assert line.startswith(f"s{pid}r{i} ")
            codes = idx.alpha.encode(
                np.frombuffer(shards[pid][i], np.uint8)).astype(np.int64)
            lo, hi = naive.find_range(idx, codes)
            cnt = hi - lo + 1 if hi >= lo else 0
            assert line.endswith(f"({lo},{hi}), count={cnt}"), (line, lo, hi)


def test_two_process_greedy_stream(rand_index, tmp_path):
    """The PRODUCTION greedy-genotyping path through the config-5 deployment
    script across a real process boundary: seeds + marker values per strand
    must equal the naive reference spec."""
    from rowbowt_tpu.engine import naive
    from rowbowt_tpu.index import marker_allele, marker_pos

    idx, text = rand_index
    pre = str(tmp_path / "idx")
    idx.save(pre)
    w = idx.ma_wsize

    rng = np.random.default_rng(53)
    L = 48
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    while len(reads) < 8:
        p = int(rng.integers(0, len(text) - L))
        r = np.array(text[p:p + L])
        if rng.random() < 0.5:
            r[int(rng.integers(0, L))] = acgt[int(rng.integers(0, 4))]
        if np.isin(r, acgt).all():
            reads.append(bytes(r))
    shards = [reads[:4], reads[4:]]
    paths = []
    for s, shard in enumerate(shards):
        fq = tmp_path / f"shard{s}.fq"
        with open(fq, "w") as f:
            for i, r in enumerate(shard):
                f.write(f"@s{s}r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
        paths.append(str(fq))

    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            PYTHONPATH=REPO,
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "sharded_stream.py"),
             pre, paths[pid], "--n-idx", "2", "-b", "4", "--greedy",
             "--wsize", str(w), "--max-range", "1000",
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (out[-2000:], err[-2000:])
        outs.append(out)

    tab = idx.alpha.encode_table()
    comp = np.full(16, -1, dtype=np.int64)
    for x, y in zip(b"ACGT", b"TGCA"):
        comp[int(tab[x])] = int(tab[y])
    for pid in range(2):
        lines = [l for l in outs[pid].splitlines() if l.startswith(f"s{pid}r")]
        assert len(lines) == 8, outs[pid]  # 2 strands x 4 reads
        for i, r in enumerate(shards[pid]):
            fwd = tab[np.frombuffer(r, np.uint8).astype(np.int64)]
            for strand, codes in (("+", fwd), ("-", comp[fwd[::-1]])):
                seeds, vals = [], []
                naive.get_markers_greedy_seeding(
                    idx, codes.astype(np.int64), w, 1000,
                    lambda rn, span, mb: (seeds.append(span),
                                          vals.extend(int(v) for v in mb)),
                    use_ftab=False)
                exp = (f"s{pid}r{i} {strand} seeds={len(seeds)} markers: "
                       + "".join(f"{int(marker_pos(np.int64(v)))}/"
                                 f"{int(marker_allele(np.int64(v)))} "
                                 for v in vals))
                line = lines[2 * i + (0 if strand == '+' else 1)]
                assert line.rstrip() == exp.rstrip(), (line, exp)
