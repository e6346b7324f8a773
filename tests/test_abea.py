"""abea: device band-fill + host traceback vs the oracle on synthetic reads."""

import numpy as np
import pytest

from genomicsbench_palisade_tpu.ops import abea as A
from genomicsbench_palisade_tpu.ops.oracle import abea as AO


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(0)
    m = {
        "level_mean": rng.normal(90, 12, 4096).astype(np.float32),
        "level_stdv": (rng.random(4096).astype(np.float32) * 2 + 1),
    }
    m["level_log_stdv"] = np.log(m["level_stdv"]).astype(np.float32)
    return m


def _synth(rng, model, seq, epk=1.8):
    k = 6
    means = []
    for i in range(len(seq) - k + 1):
        r = AO.get_kmer_rank(seq[i : i + k])
        for _ in range(max(1, int(rng.poisson(epk - 1)) + 1)):
            means.append(
                model["level_mean"][r] + rng.normal(0, model["level_stdv"][r] * 0.5)
            )
    return np.array(means, dtype=np.float32)


def test_abea_matches_oracle(model):
    rng = np.random.default_rng(0)
    for t in range(5):
        seq = "".join(rng.choice(list("ACGT"), int(rng.integers(60, 180))))
        ev = _synth(rng, model, seq)
        want = AO.align(seq, ev, model, 1.0, 0.0)
        got = A.align_events(seq, ev, model, 1.0, 0.0)
        assert got == want, t
        assert want, "synthetic alignments should pass QC"


def test_abea_alignment_sane(model):
    """Aligned pairs must be monotone and span the sequence."""
    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list("ACGT"), 120))
    ev = _synth(rng, model, seq)
    aln = A.align_events(seq, ev, model, 1.0, 0.0)
    assert aln[0][0] == 0 and aln[-1][0] == len(seq) - 6
    ks = [a[0] for a in aln]
    es = [a[1] for a in aln]
    assert all(b - a in (0, 1) for a, b in zip(ks, ks[1:]))
    assert all(b - a in (0, 1) for a, b in zip(es, es[1:]))


def test_abea_qc_failure(model):
    """Random events that don't match the sequence should be QC-dropped."""
    rng = np.random.default_rng(4)
    seq = "".join(rng.choice(list("ACGT"), 100))
    ev = rng.normal(0, 1, 150).astype(np.float32)  # garbage far from model
    got = A.align_events(seq, ev, model, 1.0, 0.0)
    want = AO.align(seq, ev, model, 1.0, 0.0)
    assert got == want == []


def test_abea_native_traceback_matches_python(model):
    """native/abea_tb.cpp vs the numpy lockstep walk, incl. a QC-drop read."""
    from genomicsbench_palisade_tpu.io.native import available

    if not available():
        pytest.skip("native lib not built")
    import functools

    import jax

    from genomicsbench_palisade_tpu.ops.abea import (
        _bucket, _prep_read, _traceback_batch, abea_fill_bands)

    rng = np.random.default_rng(11)
    seqs, evs = [], []
    for _ in range(6):
        seq = "".join(rng.choice(list("ACGT"), int(rng.integers(60, 120))))
        seqs.append(seq)
        evs.append(_synth(rng, model, seq))
    seqs.append("".join(rng.choice(list("ACGT"), 80)))  # QC-drop read
    evs.append(rng.normal(0, 1, 120).astype(np.float32))

    bw, k = 100, 6
    e_buck = _bucket(max(len(e) for e in evs))
    k_buck = _bucket(max(len(s) - k + 1 for s in seqs))
    lm = np.asarray(model["level_mean"], np.float32)
    ls = np.asarray(model["level_stdv"], np.float32)
    lls = np.asarray(model["level_log_stdv"], np.float32)
    fill = functools.partial(abea_fill_bands, n_bands_pad=e_buck + k_buck + 2)
    traces_g, bes_g, lv_g, kranks_g = [], [], [], []
    for seq, ev in zip(seqs, evs):
        ev_pad, ranks_pad, lp_consts, trim_vals, kranks = _prep_read(
            seq, ev, bw, k, e_buck, k_buck)
        tr, bes, _, lv = jax.jit(fill)(
            ev_pad, ranks_pad, len(ev), len(seq) - k + 1,
            lm, ls, lls, np.float32(1.0), np.float32(0.0), lp_consts,
            trim_vals)
        nb = len(ev) + len(seq) - k + 1 + 2
        traces_g.append(np.asarray(tr)[: nb - 2])
        bes_g.append(np.asarray(bes)[: nb - 2])
        lv_g.append(np.asarray(lv)[: nb - 2].astype(np.float64))
        kranks_g.append(kranks)
    args = (seqs, evs, model, [1.0] * len(seqs), [0.0] * len(seqs),
            traces_g, bes_g, lv_g, kranks_g, bw, k)
    got = _traceback_batch(*args, use_native=True)
    want = _traceback_batch(*args, use_native=False)
    assert got == want
    assert want[-1] == [] and any(want[:-1])


def test_abea_native_engine_matches_oracle(model):
    """Native host fill (native/abeafill.cpp, the production default)
    must be bit-identical to the cited oracle — alignments AND QC
    drops — across scales/shifts and a signal-corrupted read."""
    from genomicsbench_palisade_tpu.io.native import available

    if not available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(77)
    seqs, evs, scales, shifts = [], [], [], []
    for t in range(10):
        seq = "".join(rng.choice(list("ACGT"), int(rng.integers(40, 400))))
        ev = _synth(rng, model, seq)
        if t % 3 == 0:  # QC-drop pressure
            ev = (np.asarray(ev) + rng.normal(0, 25, len(ev))
                  ).astype(np.float32)
        seqs.append(seq)
        evs.append(ev)
        scales.append(float(rng.uniform(0.8, 1.2)))
        shifts.append(float(rng.uniform(-4, 4)))
    got = A.align_events_batch_native(seqs, evs, model, scales, shifts)
    assert got is not None
    want = [AO.align(s, e, model, sc, sh)
            for s, e, sc, sh in zip(seqs, evs, scales, shifts)]
    assert got == want
    assert any(not w for w in want) and any(w for w in want)


def test_abea_native_engine_is_default_dispatch(model):
    """align_events_batch with no engine flags routes through the
    native fill when the lib is built (identical results either way)."""
    from genomicsbench_palisade_tpu.io.native import available

    if not available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(13)
    seq = "".join(rng.choice(list("ACGT"), 120))
    ev = _synth(rng, model, seq)
    got = A.align_events_batch([seq], [ev], model, [1.0], [0.0])
    want = A.align_events_batch_native([seq], [ev], model, [1.0], [0.0])
    assert got == want == [AO.align(seq, ev, model, 1.0, 0.0)]


def test_abea_scan_engine_matches_oracle(model):
    """align_events_batch with the native fill skipped runs the device
    band-fill scan (vmapped over a shared bucket) + host traceback; two
    reads must match the cited oracle exactly."""
    rng = np.random.default_rng(31)
    seqs = ["".join(rng.choice(list("ACGT"), 80)) for _ in range(2)]
    evs = [_synth(rng, model, s) for s in seqs]
    got = A.align_events_batch(seqs, evs, model, [1.0] * 2, [0.0] * 2,
                               use_native=False)
    want = [AO.align(s, e, model, 1.0, 0.0) for s, e in zip(seqs, evs)]
    assert got == want
