"""JAX phmm kernel vs oracle and vs reference golden fixtures."""

import json

import numpy as np
import pytest

from genomicsbench_palisade_tpu.ops import phmm as P
from genomicsbench_palisade_tpu.ops.oracle import phmm as O


def _random_cases(rng, n, max_r=40, max_h=60, qlo=33, qhi=90):
    reads, haps, pairs = [], [], []
    for k in range(n):
        rl = int(rng.integers(3, max_r))
        hl = int(rng.integers(3, max_h))
        bases = rng.integers(0, 5, rl)
        reads.append(
            {
                "bases": bases,
                "q": rng.integers(qlo, qhi, rl),
                "i": rng.integers(qlo, qhi, rl),
                "d": rng.integers(qlo, qhi, rl),
                "c": rng.integers(qlo, qhi, rl),
            }
        )
        haps.append(rng.integers(0, 5, hl))
        pairs.append((k, k))
    return reads, haps, pairs


def test_phmm_jax_vs_oracle_random():
    rng = np.random.default_rng(0)
    reads, haps, pairs = _random_cases(rng, 24)
    batch = P.prepare_batch(reads, haps, pairs)
    got = P.phmm_likelihoods(batch, reads, haps, pairs)
    for bi, (ri, hi) in enumerate(pairs):
        r = reads[ri]
        want = O.compute_likelihood(r["bases"], haps[hi], r["q"], r["i"], r["d"], r["c"])
        assert abs(got[bi] - want) < 1e-5, (bi, got[bi], want)


def test_phmm_jax_vs_reference_fixtures(fixtures_dir):
    cases = json.load(open(fixtures_dir / "phmm_golden.json"))
    reads, haps, pairs = [], [], []
    for k, case in enumerate(cases):
        reads.append(
            {
                "bases": O.encode_bases(case["rs"]),
                "q": np.array([ord(c) for c in case["q"]]),
                "i": np.array([ord(c) for c in case["i"]]),
                "d": np.array([ord(c) for c in case["d"]]),
                "c": np.array([ord(c) for c in case["c"]]),
            }
        )
        haps.append(O.encode_bases(case["hap"]))
        pairs.append((k, k))
    batch = P.prepare_batch(reads, haps, pairs)
    got = P.phmm_likelihoods(batch, reads, haps, pairs)
    for bi, case in enumerate(cases):
        assert abs(got[bi] - case["log10"]) < 1e-5, (bi, got[bi], case["log10"])


def test_phmm_fallback_path():
    """Long read with terrible quals -> float underflow -> double fallback."""
    rl, hl = 100, 100
    # ~18 confident mismatches: raw float underflows past MIN_ACCEPTED but
    # the float64 recompute stays finite (actual prob ~1e-100).
    bases = np.full(rl, 1, dtype=np.int64)
    bases[:18] = 0  # mismatch vs the all-C hap
    reads = [
        {
            "bases": bases,
            "q": np.full(rl, 60),
            "i": np.full(rl, 60),
            "d": np.full(rl, 60),
            "c": np.full(rl, 60),
        }
    ]
    haps = [np.full(hl, 1, dtype=np.int64)]  # all C
    pairs = [(0, 0)]
    batch = P.prepare_batch(reads, haps, pairs)
    _, result, fallback = P.phmm_forward(batch)
    assert bool(fallback[0])
    got = P.phmm_likelihoods(batch, reads, haps, pairs)
    r = reads[0]
    want = O.compute_likelihood(r["bases"], haps[0], r["q"], r["i"], r["d"], r["c"])
    assert abs(got[0] - want) < 1e-9  # same float64 oracle path
    assert np.isfinite(got[0]) and got[0] < -50  # genuinely tiny likelihood


def test_phmm_golden_single_on_device():
    rs = O.encode_bases("ACGT")
    q = np.full(4, ord("+"))
    reads = [{"bases": rs, "q": q, "i": q, "d": q, "c": q}]
    batch = P.prepare_batch(reads, [rs], [(0, 0)])
    log10, _, _ = P.phmm_forward(batch)
    assert abs(float(log10[0]) - (-6.022797e-01)) < 1e-5


def test_phmm_f64_batched_matches_scalar_oracle():
    """Vectorized f64 fallback bit-identical to the scalar double oracle."""
    import numpy as np

    from genomicsbench_palisade_tpu.ops import phmm as P
    from genomicsbench_palisade_tpu.ops.oracle import phmm as O
    from genomicsbench_palisade_tpu.ops.phmm_f64 import phmm_forward_sweep

    rng = np.random.default_rng(5)
    reads, haps, pairs = [], [], []
    for i in range(24):
        rl, hl = int(rng.integers(3, 40)), int(rng.integers(3, 60))
        reads.append({
            "bases": rng.integers(0, 5, rl),
            "q": rng.integers(36, 60, rl),
            "i": rng.integers(36, 60, rl),
            "d": rng.integers(36, 60, rl),
            "c": rng.integers(36, 60, rl),
        })
        haps.append(rng.integers(0, 5, hl))
        pairs.append((i, i))
    batch = P.prepare_batch(reads, haps, pairs, r_pad=48, h_pad=64)
    got = phmm_forward_sweep({k: np.asarray(v) for k, v in batch.items()})
    for i, (ri, hi) in enumerate(pairs):
        r = reads[ri]
        want = O.compute_full_prob(
            r["bases"], haps[hi], r["q"], r["i"], r["d"], r["c"], np.float64)
        assert got[i] == want, (i, got[i], want)


def test_phmm_f32_sweep_vs_reference_fixtures(fixtures_dir):
    """GKL-binary goldens through the float32 numpy sweep — the plain
    reference the CUDA kernel equals bit for bit — with the
    MIN_ACCEPTED routing and the double fallback: every likelihood
    within the golden 1e-5 contract."""
    from genomicsbench_palisade_tpu.ops.phmm_f64 import (
        phmm_fallback_log10, phmm_forward_sweep)

    cases = json.load(open(fixtures_dir / "phmm_golden.json"))
    reads, haps, pairs = [], [], []
    for k, case in enumerate(cases):
        reads.append(
            {
                "bases": O.encode_bases(case["rs"]),
                "q": np.array([ord(c) for c in case["q"]]),
                "i": np.array([ord(c) for c in case["i"]]),
                "d": np.array([ord(c) for c in case["d"]]),
                "c": np.array([ord(c) for c in case["c"]]),
            }
        )
        haps.append(O.encode_bases(case["hap"]))
        pairs.append((k, k))
    batch = P.prepare_batch(reads, haps, pairs)
    raw = phmm_forward_sweep(batch, np.float32)
    assert raw.dtype == np.float32
    fallback = (raw < np.float32(P.MIN_ACCEPTED)) | ~np.isfinite(raw)
    with np.errstate(divide="ignore"):
        got = (np.log10(raw) - np.float32(P._tables_f32()[2])).astype(
            np.float64)
    vals, idx = phmm_fallback_log10(batch, fallback)
    got[idx] = vals
    for bi, case in enumerate(cases):
        assert abs(got[bi] - case["log10"]) < 1e-5, (bi, got[bi], case["log10"])


def test_phmm_fallback_slices_only_testcase_axis():
    """Regression: phmm_fallback_log10 slices every batch array along the
    testcase axis only — fallback indices beyond r_pad must work."""
    rng = np.random.default_rng(41)
    n = 24  # > r_pad below, so old code indexes out of bounds
    reads, haps, pairs = [], [], []
    for k in range(n):
        rl = 6
        reads.append({
            "bases": rng.integers(0, 4, rl),
            "q": np.full(rl, 40),  # high qual + long mismatch -> tiny prob
            "i": np.full(rl, 40),
            "d": np.full(rl, 40),
            "c": np.full(rl, 10),
        })
        haps.append(rng.integers(0, 4, 12))
        pairs.append((k, k))
    batch = P.prepare_batch(reads, haps, pairs, r_pad=8, h_pad=16)
    from genomicsbench_palisade_tpu.ops.phmm_f64 import phmm_fallback_log10

    mask = np.zeros(n, bool)
    mask[[0, n - 1]] = True  # index n-1 = 23 > r_pad = 8
    vals, idx = phmm_fallback_log10(
        {k: np.asarray(v) for k, v in batch.items()}, mask)
    assert list(idx) == [0, n - 1]
    # values match the scalar oracle's double path
    for v, i in zip(vals, idx):
        r, h = pairs[i]
        raw = O.compute_full_prob(
            reads[r]["bases"], haps[h], reads[r]["q"], reads[r]["i"],
            reads[r]["d"], reads[r]["c"], np.float64)
        ctx = O.get_ctx(np.float64)
        want = np.log10(raw) - ctx.log10_initial_constant
        np.testing.assert_array_equal(v, want)


def test_phmm_compact_int8_batch():
    """The int8 wire (compact_batch: base codes and quals as int8, the
    CUDA kernel's input) is exact: the scan on it equals the scan on the
    full-width batch."""
    import jax

    rng = np.random.default_rng(47)
    reads, haps, pairs = [], [], []
    for k in range(128):
        rl = int(rng.integers(8, 40))
        reads.append({
            "bases": rng.integers(0, 4, rl),
            "q": rng.integers(6, 60, rl),
            "i": rng.integers(25, 46, rl),
            "d": rng.integers(25, 46, rl),
            "c": np.full(rl, 10),
        })
        haps.append(rng.integers(0, 4, int(rng.integers(16, 64))))
        pairs.append((k, k))
    full = P.prepare_batch(reads, haps, pairs)
    compact = P.compact_batch(full)
    for k in P.COMPACT_KEYS:
        assert compact[k].dtype == np.int8
        np.testing.assert_array_equal(compact[k], full[k])
    want = np.asarray(P.phmm_forward(
        {k: jax.device_put(v) for k, v in full.items()})[1])
    got = np.asarray(P.phmm_forward(
        {k: jax.device_put(v) for k, v in compact.items()})[1])
    np.testing.assert_array_equal(got, want)


def test_phmm_f64_native_bit_exact():
    """native/phmmf64.cpp (the C double-fallback pass) must be
    BIT-exact with the numpy diagonal sweep and the scalar oracle —
    same per-cell op tree, -ffp-contract=off."""
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops.phmm_f64 import (
        phmm_forward_f64_native, phmm_forward_sweep)

    if not available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(59)
    reads, haps, pairs = [], [], []
    for k in range(40):
        rl = int(rng.integers(5, 120))
        reads.append({"bases": rng.integers(0, 5, rl),
                      "q": rng.integers(6, 60, rl),
                      "i": rng.integers(25, 46, rl),
                      "d": rng.integers(25, 46, rl),
                      "c": np.full(rl, 10)})
        haps.append(rng.integers(0, 5, int(rng.integers(10, 300))))
        pairs.append((k, k))
    batch = P.prepare_batch(reads, haps, pairs)
    bn = {k: np.asarray(v) for k, v in batch.items()}
    want = phmm_forward_sweep(bn)
    got = phmm_forward_f64_native(bn)
    np.testing.assert_array_equal(got, want)
    raw = O.compute_full_prob(reads[3]["bases"], haps[3], reads[3]["q"],
                              reads[3]["i"], reads[3]["d"], reads[3]["c"],
                              np.float64)
    assert raw == got[3]
