"""CLI driver contracts: kmer-cnt and abea eventalign end-to-end."""

import numpy as np
import pytest


@pytest.fixture
def kmer_inputs(tmp_path):
    rng = np.random.default_rng(0)
    fa = tmp_path / "reads.fasta"
    reads = ["".join(rng.choice(list("ACGT"), 6000)) for _ in range(3)]
    reads.append("".join(rng.choice(list("ACGT"), 100)))  # filtered (<5000)
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    cfg = tmp_path / "asm.cfg"
    cfg.write_text("kmer_size = 17\nuse_minimizers = 0\nassemble_kmer_sample = 1\n")
    return fa, cfg, reads


def test_kmer_cnt_cli(kmer_inputs, capsys):
    fa, cfg, reads = kmer_inputs
    from genomicsbench_palisade_tpu.cli.kmer_cnt import main
    from genomicsbench_palisade_tpu.ops.oracle import kmer as KO

    rc = main(["--reads", str(fa), "--config", str(cfg), "--debug"])
    assert rc == 0
    out = capsys.readouterr()
    assert f"readsFasta: {fa}" in out.out
    assert "minReadLength: 5000" in out.out
    assert "useMinimizers: 0" in out.out
    assert "Kernel time:" in out.err
    want = KO.count_kmers(reads)
    assert f"Total k-mers {want['total_kmers']}" in out.err
    assert f"Hash size: {want['hash_size']}" in out.err


@pytest.fixture
def abea_inputs(tmp_path):
    rng = np.random.default_rng(1)
    k = 6
    # synthetic pore model TSV over all 4096 6-mers
    level_mean = rng.normal(90, 12, 4 ** k).astype(np.float32)
    level_stdv = (rng.random(4 ** k) * 2 + 1).astype(np.float32)
    bases = "ACGT"
    lines = ["#synthetic\tmodel", "kmer\tlevel_mean\tlevel_stdv\tsd_mean\tsd_stdv"]
    for r in range(4 ** k):
        kmer = "".join(bases[(r >> (2 * (k - 1 - j))) & 3] for j in range(k))
        lines.append(f"{kmer}\t{level_mean_of(kmer, level_mean):.5f}"
                     f"\t{level_stdv_of(kmer, level_stdv):.5f}\t0\t0")
    model_tsv = tmp_path / "model.tsv"
    model_tsv.write_text("\n".join(lines) + "\n")

    seq = "".join(rng.choice(list(bases), 150))
    # raw signal: per k-mer dwell of ~15 samples at the model level
    from genomicsbench_palisade_tpu.ops.oracle.abea import get_kmer_rank

    raw = []
    for i in range(len(seq) - k + 1):
        r = get_kmer_rank(seq[i:i + k])
        dwell = int(rng.integers(10, 20))
        raw.extend(level_mean[r] + rng.normal(0, 0.4, dwell))
    raw = np.array(raw, dtype=np.float32)

    fa = tmp_path / "reads.fasta"
    fa.write_text(f">read1\n{seq}\n")
    npz = tmp_path / "signals.npz"
    np.savez(npz, read1=raw)
    return fa, npz, model_tsv


def level_mean_of(kmer, table):
    from genomicsbench_palisade_tpu.ops.oracle.abea import get_kmer_rank

    return float(table[get_kmer_rank(kmer)])


def level_stdv_of(kmer, table):
    from genomicsbench_palisade_tpu.ops.oracle.abea import get_kmer_rank

    return float(table[get_kmer_rank(kmer)])


def test_abea_cli(abea_inputs, tmp_path, capsys):
    fa, npz, model_tsv = abea_inputs
    from genomicsbench_palisade_tpu.cli.abea import main

    out_tsv = tmp_path / "events.tsv"
    rc = main(["--reads", str(fa), "--raw", str(npz), "--model", str(model_tsv),
               "-o", str(out_tsv)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "Kernel time:" in err
    assert "1 reads" in err
    lines = out_tsv.read_text().strip().split("\n")
    assert lines[0].startswith("contig\tposition\treference_kmer")
    assert len(lines) > 50  # one row per aligned event
    first = lines[1].split("\t")
    assert first[0] == "read1"
    # positions are monotone non-decreasing along the alignment
    pos = [int(l.split("\t")[1]) for l in lines[1:]]
    assert pos == sorted(pos)
    assert pos[0] == 0 and pos[-1] == 150 - 6


def test_pore_model_loader_roundtrip(abea_inputs):
    _fa, _npz, model_tsv = abea_inputs
    from genomicsbench_palisade_tpu.io.signal import load_pore_model

    m = load_pore_model(str(model_tsv))
    assert m["level_mean"].shape == (4096,)
    np.testing.assert_allclose(
        m["level_log_stdv"], np.log(m["level_stdv"]), rtol=1e-6
    )


def test_logger_levels_and_sink(tmp_path, capsys):
    from genomicsbench_palisade_tpu.utils.logger import Logger, ProgressPercent

    log = Logger()  # fresh instance, not the singleton
    log.set_output_file(str(tmp_path / "log.txt"))
    log.info("hello")
    log.debug("quiet")  # not on console without debugging
    log.set_debugging(True)
    log.debug("loud")
    err = capsys.readouterr().err
    assert "INFO: hello" in err
    assert "DEBUG: quiet" not in err
    assert "DEBUG: loud" in err
    sink = (tmp_path / "log.txt").read_text()
    assert "DEBUG: quiet" in sink  # file sink gets everything
    import re
    assert re.search(r"\[\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\] INFO: hello", sink)

    import io
    buf = io.StringIO()
    pb = ProgressPercent(10, stream=buf)
    for _ in range(10):
        pb.advance()
    out = buf.getvalue()
    assert "100%" in out and out.endswith("\n")


def test_peak_rss_and_memsize():
    from genomicsbench_palisade_tpu.utils.logger import get_memory_size, get_peak_rss

    assert get_peak_rss() > 1024 ** 2  # at least a MiB
    assert get_memory_size() > 1024 ** 3  # at least a GiB


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_enable(tmp_path, monkeypatch, from_env):
    """The cache lands in JAX_COMPILATION_CACHE_DIR when it is set, else
    in the fixed <repo>/.jax_cache."""
    import os
    import pathlib

    import jax

    from genomicsbench_palisade_tpu.utils import compile_cache as CC

    repo = pathlib.Path(CC.__file__).resolve().parents[2]
    if from_env:
        want = str(tmp_path / "xla")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        want = str(repo / ".jax_cache")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = CC.enable()
        assert path == want
        assert os.path.isdir(path)
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
