"""PairHMM engine routing and the CUDA kernel's surroundings.

The kernel itself (native/cuda/phmm_forward.cu) runs only on a GPU; the
test marked `gpu` checks it there against its plain reference, the
float32 numpy sweep.  On the CPU these tests cover what surrounds it:
the reference's arithmetic, the int8 wire it reads, the routing, and
the build command.
"""

import jax
import numpy as np
import pytest

from genomicsbench_palisade_tpu.ops import phmm as P
from genomicsbench_palisade_tpu.ops import phmm_cuda as PC
from genomicsbench_palisade_tpu.ops.oracle import phmm as O
from genomicsbench_palisade_tpu.ops.phmm_f64 import phmm_forward_sweep


def _cases(rng, b, r_lo, r_hi, h_lo, h_hi, sub=True):
    reads, haps, pairs = [], [], []
    for i in range(b):
        hl = int(rng.integers(h_lo, h_hi))
        rl = int(rng.integers(r_lo, min(r_hi, hl)))
        hap = rng.integers(0, 4, hl)
        if sub:  # reads sampled from their haplotype: high likelihoods
            st = int(rng.integers(0, hl - rl + 1))
            read = hap[st:st + rl].copy()
            noise = rng.random(rl) < 0.05
            read[noise] = rng.integers(0, 5, int(noise.sum()))
        else:
            read = rng.integers(0, 5, rl)
        reads.append({"bases": read,
                      **{k: rng.integers(20, 60, rl) for k in "qidc"}})
        haps.append(hap)
        pairs.append((i, i))
    return reads, haps, pairs


@pytest.mark.parametrize("r_pad,h_pad,h_lo,h_hi", [
    (64, 128, 6, 100),
    (128, 512, 320, 473),  # the large-dataset hap bucket
])
def test_f32_sweep_matches_scalar_oracle(r_pad, h_pad, h_lo, h_hi):
    """The kernel's plain reference: the float32 sweep equals the scalar
    float32 oracle bit for bit (no multiply-add contraction)."""
    rng = np.random.default_rng(h_pad)
    reads, haps, pairs = _cases(rng, 6, 5, r_pad - 1, h_lo, h_hi)
    batch = P.prepare_batch(reads, haps, pairs, r_pad=r_pad, h_pad=h_pad)
    got = phmm_forward_sweep(batch, np.float32)
    for i, (ri, hi) in enumerate(pairs):
        r = reads[ri]
        want = O.compute_full_prob(r["bases"], haps[hi], r["q"], r["i"],
                                   r["d"], r["c"], np.float32)
        assert got[i] == want, (i, got[i], want)


def test_f32_sweep_close_to_scan():
    """The XLA scan may contract multiply-adds (it does on CPU and GPU),
    so it agrees with the reference to float32 rounding, not bits."""
    rng = np.random.default_rng(3)
    reads, haps, pairs = _cases(rng, 64, 5, 60, 6, 100, sub=False)
    batch = P.prepare_batch(reads, haps, pairs, r_pad=64, h_pad=128)
    ref = phmm_forward_sweep(batch, np.float32)
    log10, raw, fb = map(np.asarray, P.phmm_forward(batch))
    ok = ~fb
    np.testing.assert_allclose(raw[ok], ref[ok], rtol=1e-4)


def _fake_kernel(calls):
    def fake(compact):
        calls.append(compact)
        return P.phmm_forward(compact)
    return fake


def test_auto_routes_gpu_to_kernel_with_int8_wire(monkeypatch):
    """On a GPU backend phmm_forward_auto hands the kernel the int8 wire
    at the bucket's true batch size (no padding), and returns its
    results unchanged."""
    rng = np.random.default_rng(5)
    reads, haps, pairs = _cases(rng, 37, 5, 30, 6, 60)
    batch = P.prepare_batch(reads, haps, pairs, r_pad=32, h_pad=64)
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(PC, "phmm_forward_cuda", _fake_kernel(calls))
    got = P.phmm_forward_auto(batch)
    assert len(calls) == 1
    wire = calls[0]
    assert set(wire) == set(P.COMPACT_KEYS) | {"rslen", "haplen"}
    for k in P.COMPACT_KEYS:
        assert wire[k].dtype == np.int8 and wire[k].shape[0] == 37
    assert wire["rslen"].dtype == np.int32
    want = P.phmm_forward(batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_auto_runs_scan_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(PC, "phmm_forward_cuda", _fake_kernel(calls))
    rng = np.random.default_rng(6)
    reads, haps, pairs = _cases(rng, 4, 5, 30, 6, 60)
    batch = P.prepare_batch(reads, haps, pairs, r_pad=32, h_pad=64)
    got = P.phmm_forward_auto(batch)
    assert not calls
    np.testing.assert_array_equal(np.asarray(got[1]),
                                  np.asarray(P.phmm_forward(batch)[1]))


def test_auto_kernel_failure_is_raised(monkeypatch):
    """A kernel failure surfaces; nothing falls back to the scan."""
    def broken(compact):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(PC, "phmm_forward_cuda", broken)
    rng = np.random.default_rng(7)
    reads, haps, pairs = _cases(rng, 4, 5, 30, 6, 60)
    batch = P.prepare_batch(reads, haps, pairs, r_pad=32, h_pad=64)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        P.phmm_forward_auto(batch)


def test_auto_rejects_unknown_backend(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    rng = np.random.default_rng(8)
    reads, haps, pairs = _cases(rng, 2, 5, 30, 6, 60)
    batch = P.prepare_batch(reads, haps, pairs, r_pad=32, h_pad=64)
    with pytest.raises(NotImplementedError, match="metal"):
        P.phmm_forward_auto(batch)


def test_nvcc_command_targets_hopper_into_build_dir(monkeypatch):
    monkeypatch.setattr(PC, "_nvcc", lambda: "/cuda/bin/nvcc")
    cmd = PC.nvcc_command(PC.LIBRARY)
    assert cmd[0] == "/cuda/bin/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert jax.ffi.include_dir() in cmd
    assert cmd[-1] == str(PC.SOURCE) and PC.SOURCE.exists()
    assert PC.LIBRARY.parent.parent.name == "build"


@pytest.mark.gpu
def test_cuda_kernel_matches_f32_reference(gpu):
    """On the card: the kernel equals the float32 sweep bit for bit at
    both GenomicsBench buckets, fallback cases included."""
    rng = np.random.default_rng(9)
    for r_pad, h_pad, h_lo, h_hi in ((256, 320, 6, 302), (256, 512, 303, 473)):
        reads, haps, pairs = _cases(rng, 96, 5, 250, h_lo, h_hi)
        r2, h2, _ = _cases(rng, 32, 5, 250, h_lo, h_hi, sub=False)
        reads, haps = reads + r2, haps + h2
        pairs = [(i, i) for i in range(len(reads))]
        batch = P.prepare_batch(reads, haps, pairs, r_pad=r_pad, h_pad=h_pad)
        log10, raw, fb = map(np.asarray,
                             PC.phmm_forward_cuda(P.compact_batch(batch)))
        np.testing.assert_array_equal(raw, phmm_forward_sweep(batch, np.float32))
