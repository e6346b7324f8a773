"""Genetic relationship matrix on the device (plink2 --make-grm-bin capability).

Semantics source: benchmarks/grm/2.0/plink2_matrix_calc.cc:3231-3279
(ExpandCenteredVarmaj: normed dosage = (g - 2*alt_freq) / sqrt(2*p*(1-p)),
degenerate variants zeroed), :3668-3704 (GRM = Z^T Z accumulated over
variant blocks — "dsyrk_ does exactly what we want"), missing genotypes
excluded per sample pair via nonmissing counts (grm.N.bin).

Two matmuls per variant block (Z^T Z for sums, V^T V for per-pair
nonmissing counts) with f32 accumulation, variants sharded across devices
with a psum merge (parallel/dp.py pattern).

Precision: plink2 computes Z^T Z in double and the contract is 2e-5.  On
an H100 (700 W) at m=32768, n=2048 (tools/grm_sweep.py) only
Precision.HIGHEST (true f32) meets it: max rel err 6.9e-7, against
3.4e-5 for HIGH/DEFAULT (one TF32 pass), 2.4e-5 for the bf16x3 and
2.6e-5 for the tf32x3 algorithm presets — their dropped low-order terms
bias the diagonal, where every product is positive.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

K_SMALL_EPSILON = 2 ** -44  # plink2 kSmallEpsilon


def normalize_block_np(geno: np.ndarray, freqs: np.ndarray | None = None):
    """geno: [M, N] int8 ALT-dosage counts (0/1/2, 3=missing).

    Returns (z [M,N] f32 normalized w/ missing->0, v [M,N] f32 nonmissing,
    freqs [M]).  When freqs is None, alt frequency is estimated from the
    nonmissing genotypes (plink2 uses the loaded/computed allele freqs).
    """
    miss = geno == 3
    g = geno.astype(np.float64)
    g[miss] = 0.0
    nonmiss = (~miss).astype(np.float64)
    if freqs is None:
        denom = np.maximum(nonmiss.sum(1), 1.0)
        freqs = g.sum(1) / (2.0 * denom)
    variance = 2.0 * freqs * (1.0 - freqs)
    ok = variance > K_SMALL_EPSILON
    inv_stdev = np.zeros_like(variance)
    inv_stdev[ok] = 1.0 / np.sqrt(variance[ok])
    z = (g - 2.0 * freqs[:, None]) * inv_stdev[:, None]
    z[miss] = 0.0
    z[~ok] = 0.0
    v = nonmiss.copy()
    v[~ok] = 0.0  # degenerate variants contribute to neither sums nor counts
    return z.astype(np.float32), v.astype(np.float32), freqs


SUMS_PRECISION = jax.lax.Precision.HIGHEST


@jax.jit
def grm_block_update(grm_sums, grm_counts, z, v):
    """Accumulate one variant block: sums += Z^T Z, counts += V^T V."""
    grm_sums = grm_sums + jnp.dot(
        z.T, z, preferred_element_type=jnp.float32, precision=SUMS_PRECISION)
    grm_counts = grm_counts + jnp.dot(
        v.T, v, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT)
    return grm_sums, grm_counts


@functools.partial(jax.jit, static_argnames=("block", "precision"))
def _grm_device(geno_i8, two_f, inv_stdev, ok, block: int,
                precision=SUMS_PRECISION):
    """On-device normalization + blocked Z^T Z / V^T V (one dispatch).

    geno_i8: [M, N] int8; two_f/inv_stdev/ok: [M] f32/f32/bool computed on
    the host in float64 (plink2's double allele-freq math, exact).
    precision is the Z^T Z matmul's (a lax.Precision or
    DotAlgorithmPreset); see the module docstring for the choice."""
    m, n = geno_i8.shape
    n_blocks = -(-m // block)
    pad = n_blocks * block - m
    geno_p = jnp.pad(geno_i8, ((0, pad), (0, 0)), constant_values=3)
    two_f = jnp.pad(two_f, (0, pad))
    inv_stdev = jnp.pad(inv_stdev, (0, pad))
    ok = jnp.pad(ok, (0, pad))

    def body(carry, idx):
        sums, counts = carry
        g8 = jax.lax.dynamic_slice_in_dim(geno_p, idx * block, block, 0)
        tf = jax.lax.dynamic_slice_in_dim(two_f, idx * block, block, 0)
        isd = jax.lax.dynamic_slice_in_dim(inv_stdev, idx * block, block, 0)
        okb = jax.lax.dynamic_slice_in_dim(ok, idx * block, block, 0)
        miss = g8 == 3
        g = jnp.where(miss, 0.0, g8.astype(jnp.float32))
        z = (g - tf[:, None]) * isd[:, None]
        z = jnp.where(miss | ~okb[:, None], 0.0, z)
        v = jnp.where(miss | ~okb[:, None], 0.0, 1.0)
        sums = sums + jnp.dot(z.T, z, preferred_element_type=jnp.float32,
                              precision=precision)
        # V is 0/1: every product is exact in TF32 or bf16 and the f32
        # accumulator is exact below 2^24 variants, so one low-precision
        # pass (DEFAULT) is bit-correct
        counts = counts + jnp.dot(
            v.T, v, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.DEFAULT)
        return (sums, counts), None

    init = (jnp.zeros((n, n), jnp.float32), jnp.zeros((n, n), jnp.float32))
    (sums, counts), _ = jax.lax.scan(body, init, jnp.arange(n_blocks))
    return sums, counts


def maf_filter(geno: np.ndarray, min_maf: float) -> np.ndarray:
    """Keep-mask for plink2 --maf (plink2_filter.cc:3918-3956).

    Nonmajor allele frequency from founder hardcalls (all samples are
    founders in our inputs; missing excluded), compared against
    min_maf * (1 - kSmallEpsilon) — plink2's float-error guard."""
    miss = geno == 3
    alt = np.where(miss, 0, geno).astype(np.float64).sum(1)
    obs2 = 2.0 * (~miss).sum(1).astype(np.float64)
    af = np.divide(alt, obs2, out=np.full(len(geno), 0.5), where=obs2 > 0)
    nonmajor = np.minimum(af, 1.0 - af)
    k_small_epsilon = 0.00000000000005684341886080801486968994140625
    return nonmajor >= min_maf * (1.0 - k_small_epsilon)


def compute_grm(geno: np.ndarray, block: int = 4096,
                freqs: np.ndarray | None = None):
    """geno: [M, N] int8 (0/1/2 ALT dosage, 3 missing).

    Returns (grm [N,N] f32, counts [N,N] f32): grm[j,k] = sum z_ij z_ik /
    nonmissing-pair count (GCTA/plink2 --make-grm-bin semantics).
    Allele freqs are computed on the host in float64 (plink2's double
    math); normalization + the matmuls run in one device dispatch.
    """
    m, n = geno.shape
    miss = geno == 3
    g64 = geno.astype(np.float64)
    g64[miss] = 0.0
    if freqs is None:
        denom = np.maximum((~miss).sum(1).astype(np.float64), 1.0)
        freqs = g64.sum(1) / (2.0 * denom)
    variance = 2.0 * freqs * (1.0 - freqs)
    ok = variance > K_SMALL_EPSILON
    inv_stdev = np.zeros_like(variance)
    inv_stdev[ok] = 1.0 / np.sqrt(variance[ok])

    sums, counts = _grm_device(
        jnp.asarray(geno),
        jnp.asarray((2.0 * freqs).astype(np.float32)),
        jnp.asarray(inv_stdev.astype(np.float32)),
        jnp.asarray(ok),
        block=block,
    )
    sums = np.asarray(sums)
    counts = np.asarray(counts)
    grm = sums / np.maximum(counts, 1.0)
    return grm.astype(np.float32), counts


def write_grm_bin(prefix: str, grm: np.ndarray, counts: np.ndarray, sample_ids):
    """GCTA/plink binary GRM triple: .grm.bin/.grm.N.bin (f32 lower
    triangle, row-major by (j>=k)) + .grm.id."""
    n = grm.shape[0]
    tril = [(j, k) for j in range(n) for k in range(j + 1)]
    with open(prefix + ".grm.bin", "wb") as f:
        np.array([grm[j, k] for j, k in tril], dtype="<f4").tofile(f)
    with open(prefix + ".grm.N.bin", "wb") as f:
        np.array([counts[j, k] for j, k in tril], dtype="<f4").tofile(f)
    with open(prefix + ".grm.id", "w") as f:
        for sid in sample_ids:
            fid, _, iid = str(sid).partition("\t")
            f.write(f"{fid}\t{iid or fid}\n")
