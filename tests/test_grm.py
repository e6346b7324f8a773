"""GRM: device matmul path vs a direct numpy oracle + bed roundtrip."""

import numpy as np
import pytest

from genomicsbench_palisade_tpu.io.plink import read_bed, write_bed
from genomicsbench_palisade_tpu.ops.grm import compute_grm, normalize_block_np


def _grm_oracle(geno):
    """Direct per-pair GCTA GRM with missing exclusion (float64)."""
    m, n = geno.shape
    miss = geno == 3
    g = geno.astype(np.float64)
    g[miss] = np.nan
    freqs = np.nanmean(g, axis=1) / 2.0
    var = 2 * freqs * (1 - freqs)
    grm = np.zeros((n, n))
    cnt = np.zeros((n, n))
    for i in range(m):
        if not var[i] > 2**-44:
            continue
        z = (g[i] - 2 * freqs[i]) / np.sqrt(var[i])
        ok = ~np.isnan(z)
        zz = np.where(ok, z, 0.0)
        grm += np.outer(zz, zz)
        cnt += np.outer(ok, ok)
    return grm / np.maximum(cnt, 1), cnt


def test_grm_matches_oracle():
    rng = np.random.default_rng(0)
    m, n = 300, 40
    geno = rng.choice([0, 1, 2], size=(m, n), p=[0.5, 0.3, 0.2]).astype(np.int8)
    geno[rng.random((m, n)) < 0.05] = 3  # missing
    geno[5] = 1  # all-het (degenerate variance check not triggered; var>0)
    geno[6] = 0  # monomorphic -> zero variance -> excluded
    got, got_cnt = compute_grm(geno, block=128)
    want, want_cnt = _grm_oracle(geno)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got_cnt, want_cnt)


def test_bed_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    geno = rng.integers(0, 4, size=(20, 11)).astype(np.int8)
    prefix = str(tmp_path / "toy")
    write_bed(prefix, geno)
    got, fam, bim = read_bed(prefix)
    np.testing.assert_array_equal(got, geno)
    assert len(fam) == 11 and len(bim) == 20


@pytest.mark.parametrize("block", [256, 512])
def test_grm_device_default_precision(block):
    """_grm_device at its default Z^T Z precision, over several variant
    blocks: within the 2e-5 plink2 contract of the float64 oracle,
    counts exact, sums symmetric."""
    import jax

    from genomicsbench_palisade_tpu.ops.grm import _grm_device

    rng = np.random.default_rng(2)
    m, n = 2048, 64
    geno = rng.choice([0, 1, 2], size=(m, n),
                      p=[0.5, 0.3, 0.2]).astype(np.int8)
    geno[rng.random((m, n)) < 0.05] = 3
    want, want_cnt = _grm_oracle(geno)

    miss = geno == 3
    g64 = geno.astype(np.float64)
    g64[miss] = 0.0
    denom = np.maximum((~miss).sum(1).astype(np.float64), 1.0)
    freqs = g64.sum(1) / (2.0 * denom)
    variance = 2.0 * freqs * (1.0 - freqs)
    ok = variance > 1e-13
    isd = np.zeros_like(variance)
    isd[ok] = 1.0 / np.sqrt(variance[ok])
    sums, counts = _grm_device(
        jax.device_put(geno),
        jax.device_put((2 * freqs).astype(np.float32)),
        jax.device_put(isd.astype(np.float32)), jax.device_put(ok),
        block=block)
    got = np.asarray(sums, np.float64) / np.maximum(
        np.asarray(counts, np.float64), 1.0)
    scale = np.maximum(np.abs(want), 1.0)
    assert np.max(np.abs(got - want) / scale) < 2e-5
    np.testing.assert_array_equal(np.asarray(counts), want_cnt)
    # symmetric up to gemm tile-order rounding ((i,j) and (j,i) may
    # associate differently per tile)
    s = np.asarray(sums, np.float64)
    np.testing.assert_allclose(s, s.T, rtol=1e-5, atol=1e-3)
