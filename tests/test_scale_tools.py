"""Smoke coverage for the dataset-scale rehearsal tools.

Full-scale runs (10.6M bsw pairs, 1001 chain calls to 87k anchors, the
multi-Gbp fmi index) happen on the GPU via the tools themselves; these
tests keep the tool plumbing green — generation, CLI-path dispatch,
parity spot checks — on the CPU at smoke sizes.
"""

import pathlib
import sys

import numpy as np

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))


def test_chain_scale_smoke(tmp_path):
    import chain_scale_bench as T

    rc = T.main(["--smoke", "--calls", "12", "--parity-max", "4",
                 "--workdir", str(tmp_path)])
    assert rc == 0


def test_bsw_scale_smoke(tmp_path):
    import bsw_scale_bench as T

    rc = T.main(["--smoke", "--pairs", "512", "--parity-sample", "64",
                 "--workdir", str(tmp_path)])
    assert rc == 0


def test_synth_fastq_roundtrip(tmp_path):
    import synth_fastq as T

    from genomicsbench_palisade_tpu.io.fastq import read_all

    rng = np.random.default_rng(2)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 5000))
    ref = tmp_path / "ref.fa"
    ref.write_text(">c1\n" + "\n".join(
        seq[i : i + 80] for i in range(0, len(seq), 80)) + "\n")
    fq = tmp_path / "reads.fq"
    rc = T.main([str(ref), str(fq), "--reads", "64", "--read-len", "40"])
    assert rc == 0
    recs = read_all(str(fq))
    assert len(recs) == 64
    assert all(len(s) == 40 and set(s) <= set("ACGT") for _n, s, _q in recs)


def test_abea_scale_smoke():
    import abea_scale_bench as T

    rc = T.main(["--smoke"])
    assert rc == 0


def test_poa_scale_smoke():
    import poa_scale_bench as T

    rc = T.main(["--smoke"])
    assert rc == 0


def test_kmer_scale_smoke():
    import kmer_scale_bench as T

    rc = T.main(["--smoke"])
    assert rc == 0
