"""fmi device kernels: exact parity vs the oracle on tiny indexes."""

import jax.numpy as jnp
import numpy as np
import pytest

from genomicsbench_palisade_tpu.index import fmi_index as FI
from genomicsbench_palisade_tpu.ops import fmi as F
from genomicsbench_palisade_tpu.ops import fmi_pipeline as FP
from genomicsbench_palisade_tpu.ops.oracle import fmi as FO


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(9)
    unit = "".join(rng.choice(list("ACGT"), 120))
    fwd = (unit * 5) + "".join(rng.choice(list("ACGT"), 400))
    oidx = FO.build_index(fwd)
    didx = FI.from_oracle_index(oidx, np.int32)
    index = {k: jnp.asarray(v) for k, v in didx.as_device_arrays().items()}
    reads = []
    for _ in range(24):
        ln = int(rng.integers(40, 151))
        st0 = int(rng.integers(0, len(fwd) - ln))
        r = fwd[st0 : st0 + ln]
        r = "".join(
            ch if rng.random() > 0.03 else rng.choice(list("ACGTN")) for ch in r
        )
        reads.append(r)
    l_max = max(len(r) for r in reads)
    enc = np.full((len(reads), l_max), 4, np.int32)
    rl = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        e = FO.encode_read(r)
        enc[i, : len(e)] = e
        rl[i] = len(e)
    return oidx, index, fwd, reads, enc, rl


def test_backward_ext_matches_oracle(setup):
    oidx, index, fwd, *_ = setup
    rng = np.random.default_rng(11)
    for _ in range(30):
        plen = int(rng.integers(1, 10))
        start = int(rng.integers(0, len(fwd) - plen))
        codes = [FO._CODE[c] for c in fwd[start : start + plen]]
        a0 = codes[-1]
        sm = {
            "rid": 0, "m": 0, "n": 0,
            "k": int(oidx.count[a0]),
            "l": int(oidx.count[3 - a0]),
            "s": int(oidx.count[a0 + 1] - oidx.count[a0]),
        }
        k = jnp.array([sm["k"]]); l = jnp.array([sm["l"]]); s = jnp.array([sm["s"]])
        for a in reversed(codes[:-1]):
            sm = FO.backward_ext(oidx, sm, a)
            k, l, s = F.backward_ext(index, k, l, s, jnp.array([a]))
            assert (int(k[0]), int(l[0]), int(s[0])) == (sm["k"], sm["l"], sm["s"])


def test_all_pos_matches_oracle(setup):
    oidx, index, fwd, reads, enc, rl = setup
    b = len(reads)
    bufs, counts, ovf = F.smems_all_pos_batch(
        index, jnp.asarray(enc), jnp.asarray(rl), jnp.ones(b, jnp.int32), 19
    )
    bufs = {k: np.asarray(v) for k, v in bufs.items()}
    counts = np.asarray(counts)
    assert not np.asarray(ovf).any()
    for i, r in enumerate(reads):
        want = FO.get_smems_all_pos(oidx, FO.encode_read(r), 1, 19, 0)
        got = [
            tuple(int(bufs[f][i, p]) for f in ("m", "n", "k", "l", "s"))
            for p in range(counts[i])
        ]
        assert got == [(w["m"], w["n"], w["k"], w["l"], w["s"]) for w in want], i


def test_full_pipeline_matches_oracle(setup):
    oidx, index, fwd, reads, enc, rl = setup
    got, n1, n2, n3, ovf = FP.fmi_pipeline_batch(index, enc, rl)
    want, w1, w2, w3 = FO.fmi_pipeline(oidx, [FO.encode_read(r) for r in reads])
    assert (n1, n2, n3) == (w1, w2, w3)
    assert n2 > 0  # the repetitive reference must exercise the reseed phase
    assert not ovf
    gl = list(
        zip(got["rid"].tolist(), got["m"].tolist(), got["n"].tolist(),
            got["k"].tolist(), got["l"].tolist(), got["s"].tolist())
    )
    wl = [(w["rid"], w["m"], w["n"], w["k"], w["l"], w["s"]) for w in want]
    assert gl == wl


def test_fmi_cli_pipelined(tmp_path, capsys):
    """The software-pipelined driver produces the same totalSmems as the
    direct batch call, across multiple in-flight batches."""
    import numpy as np

    from genomicsbench_palisade_tpu.index import builder as IB
    from genomicsbench_palisade_tpu.index.fmi_index import save_npz

    rng = np.random.default_rng(8)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 3000)])
    codes = IB._CODE_TABLE[np.frombuffer(genome.encode(), np.uint8)]
    didx = IB.build_arrays(codes)
    save_npz(didx, str(tmp_path / "idx.npz"))
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(40):
            s = int(rng.integers(0, 3000 - 80))
            f.write(f"@q{i}\n{genome[s:s+80]}\n+\n{'I'*80}\n")

    from genomicsbench_palisade_tpu.cli.fmi import main

    rc = main([str(tmp_path / "idx.npz"), str(fq), "16"])  # 3 batches in flight
    assert rc == 0
    out = capsys.readouterr().out
    assert "totalSmems = " in out
    total = int(out.split("totalSmems = ")[1].split()[0])
    # every exact 80bp read yields >= 1 phase-1 SMEM + phase-3 seeds
    assert total >= 40


def test_fmi_cli_host_engine_matches_device(tmp_path, capsys):
    """--engine host output == --engine device output (bit-exact
    intervals)."""
    import numpy as np

    from genomicsbench_palisade_tpu.index import builder as IB
    from genomicsbench_palisade_tpu.index.fmi_index import save_npz
    from genomicsbench_palisade_tpu.io.native import available

    if not available():
        import pytest

        pytest.skip("native lib not built")
    rng = np.random.default_rng(9)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 2500)])
    codes = IB._CODE_TABLE[np.frombuffer(genome.encode(), np.uint8)]
    didx = IB.build_arrays(codes)
    save_npz(didx, str(tmp_path / "idx.npz"))
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(30):
            s = int(rng.integers(0, 2500 - 70))
            f.write(f"@q{i}\n{genome[s:s+70]}\n+\n{'I'*70}\n")

    from genomicsbench_palisade_tpu.cli.fmi import main

    main([str(tmp_path / "idx.npz"), str(fq), "--engine", "host",
          "--print-output"])
    host_out = capsys.readouterr().out
    main([str(tmp_path / "idx.npz"), str(fq), "--engine", "device",
          "--print-output"])
    device_out = capsys.readouterr().out

    def intervals(text):
        return [l for l in text.split("\n") if l.startswith("[") or l.endswith(":")]

    assert intervals(host_out) == intervals(device_out)
    assert "totalSmems = " in host_out
    h_total = host_out.split("totalSmems = ")[1].split()[0]
    t_total = device_out.split("totalSmems = ")[1].split()[0]
    assert h_total == t_total


def test_fmi_native_interleaved_matches_serial(tmp_path, monkeypatch):
    """The software-pipelined (coroutine-interleaved) engine must emit
    bit- and ORDER-identical SMEMs to the serial state machine across
    all 3 phases (native/fmsearch.cpp run_interleaved vs all_pos)."""
    import numpy as np

    from genomicsbench_palisade_tpu.index import builder as IB
    from genomicsbench_palisade_tpu.io.native import available, fmi_search_native

    if not available():
        import pytest

        pytest.skip("native lib not built")
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 6000).astype(np.int8)
    didx = IB.build_arrays(codes)
    n, L = 120, 90
    starts = rng.integers(0, len(codes) - L, n)
    enc = np.stack([codes[s : s + L] for s in starts]).astype(np.int8)
    sub = rng.random(enc.shape) < 0.04
    enc[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.int8)
    enc[rng.random(enc.shape) < 0.003] = 4  # ambiguous bases
    rl = rng.integers(40, L + 1, n).astype(np.int32)
    outs = {}
    for engine in ("serial", "interleaved"):
        monkeypatch.setenv("GT_FMI_ENGINE", engine)
        outs[engine] = fmi_search_native(didx, enc, rl, min_seed_len=12)
    m_s, m_i = outs["serial"][0], outs["interleaved"][0]
    assert outs["serial"][1:] == outs["interleaved"][1:]  # phase counts
    assert sum(outs["serial"][1:]) > 100  # all phases exercised
    for key in m_s:
        np.testing.assert_array_equal(m_s[key], m_i[key])


@pytest.mark.parametrize("pack_mode", [64, 32])
def test_fmi_hostpack_sidecar_roundtrip(tmp_path, pack_mode):
    """load_npz indexes persist the host engine's packed occ rows as a
    mmap-able <npz>.hostpack{,32}.npy sidecar; a second load must reuse
    it (mmap) and produce identical SMEMs (io/native.py pack cache)."""
    import numpy as np

    from genomicsbench_palisade_tpu.index import builder as IB
    from genomicsbench_palisade_tpu.index import fmi_index as FI
    from genomicsbench_palisade_tpu.io.native import available, fmi_search_native

    if not available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 4000).astype(np.int8)
    idx = IB.build_arrays(codes)
    p = str(tmp_path / "idx.npz")
    FI.save_npz(idx, p)
    n, L = 40, 70
    starts = rng.integers(0, len(codes) - L, n)
    enc = np.stack([codes[s : s + L] for s in starts]).astype(np.int8)
    rl = np.full(n, L, np.int32)

    d1 = FI.load_npz(p)
    out1 = fmi_search_native(d1, enc, rl, min_seed_len=12, pack_mode=pack_mode)
    import os

    suffix = ".hostpack.npy" if pack_mode == 64 else ".hostpack32.npy"
    sidecar = p + suffix
    assert os.path.exists(sidecar)

    d2 = FI.load_npz(p)
    out2 = fmi_search_native(d2, enc, rl, min_seed_len=12, pack_mode=pack_mode)
    attr = "_host_pack" if pack_mode == 64 else "_host_pack32"
    assert isinstance(getattr(d2, attr), np.memmap)  # cache was reused
    assert out1[1:] == out2[1:]
    for key in out1[0]:
        np.testing.assert_array_equal(out1[0][key], out2[0][key])
