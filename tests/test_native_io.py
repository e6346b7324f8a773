"""Native C++ parser vs the pure-Python reader (when built)."""

import gzip

import numpy as np
import pytest

from genomicsbench_palisade_tpu.io.fastq import read_all
from genomicsbench_palisade_tpu.io.native import available, parse_reads_native
from genomicsbench_palisade_tpu.ops.oracle.fmi import encode_read


def test_native_matches_python(tmp_path):
    if not available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(0)
    reads = ["".join(rng.choice(list("ACGTN"), int(rng.integers(50, 200)))) for _ in range(30)]
    fq = tmp_path / "t.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    gz = tmp_path / "t.fq.gz"
    with gzip.open(gz, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    for path in (fq, gz):
        codes, quals, offsets, lengths = parse_reads_native(str(path))
        pyreads = read_all(str(path))
        assert len(lengths) == len(pyreads) == len(reads)
        for i, (name, seq, qual) in enumerate(pyreads):
            got = codes[offsets[i] : offsets[i] + lengths[i]]
            np.testing.assert_array_equal(got, encode_read(seq).astype(np.int8))
        assert quals is not None and (quals == ord("I") - 33).all()


def test_native_bam_matches_python(tmp_path):
    """Native BAM parse == pure-Python parse on a generated file."""
    import numpy as np
    from genomicsbench_palisade_tpu.io import bam as B
    from genomicsbench_palisade_tpu.io.native import available, read_bam_native

    if not available():
        import pytest

        pytest.skip("native lib not built")
    rng = np.random.default_rng(0)
    refs = [("chr1", 10000), ("chr2", 5000)]
    records = []
    for i in range(60):
        l = int(rng.integers(20, 150))
        seq = rng.integers(1, 16, l).astype(np.uint8)
        records.append(B.BamRecord(
            name=f"read{i}", flag=int(rng.choice([0, 16, 4, 1024])),
            ref_id=int(rng.integers(0, 2)), pos=int(rng.integers(0, 4000)),
            mapq=int(rng.integers(0, 60)),
            cigar=[("S", 5), ("M", l - 5)] if l > 5 else [("M", l)],
            seq_nt16=seq, qual=rng.integers(0, 40, l).astype(np.uint8),
            tags={},
        ))
    path = tmp_path / "t.bam"
    B.write_bam(str(path), refs, records)

    # force the pure-python path for ground truth
    refs_py, recs_py = B.read_bam(str(path), parse_tags=True)
    refs_nat, recs_nat = B.read_bam(str(path))  # native fast path
    assert refs_py == refs_nat == refs
    assert len(recs_py) == len(recs_nat) == 60
    for a, b in zip(recs_py, recs_nat):
        assert a.name == b.name and a.flag == b.flag and a.pos == b.pos
        assert a.ref_id == b.ref_id and a.mapq == b.mapq and a.cigar == b.cigar
        np.testing.assert_array_equal(a.seq_nt16, b.seq_nt16)
        np.testing.assert_array_equal(a.qual, b.qual)
