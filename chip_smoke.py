"""GPU smoke run: the PairHMM main path and every device engine, on one card.

    python chip_smoke.py                 # one GPU, all phases
    python chip_smoke.py --four-cards    # the 4-device phmm path only

Phases (each prints a PHASE line; any failure makes the exit code 1):

  build     native/ (make) and the CUDA forward kernel (nvcc, sm_90a)
  card      the card's name and power limit, as nvidia-smi reports them
  main      cli/phmm on seeded testfiles in the reference's format at
            GenomicsBench widths (8192 testcases, reads <= 250 bp, haps
            <= 302 bp; 4096 testcases, haps <= 473), results through the
            f64 fallback as the CLI does, compared on a seeded sample of
            256 testcases (fallback cases included) with the oracle's
            float-first/double-fallback likelihoods under GKL's 1e-5
  kernel    the CUDA kernel against what XLA makes of the phmm_forward
            scan at 8192x256x320 and 4096x256x512: GCUPS (median of 7
            after a warm-up, block_until_ready), compile time apart,
            memory_analysis, and the kernel's raw sums against the
            float32 reference bit for bit
  goldens   the repository's reference-golden tests for bsw, chain,
            kmer, fmi, poa, pileup, dbg, abea, grm and phmm run on the
            GPU, plus the tests marked `gpu`
  kmer      the streamed device accumulator on the kmer goldens
  abea      the jnp band-fill scan on all 25 f5c goldens (exact pairs),
            beside the same scan on the CPU backend for comparison
  grm       m=32768 x n=2048 against the float64 GRM at the precision
            ops/grm.py uses, within plink2's 2e-5
  nn        bonito/clair goldens when flax is installed

With --four-cards only the build, card and phmm phases run: run_testcases
on a 4-device mesh (the sharded scan) over the same seeded testfile,
compared with the 1-device results.

The last line of stdout is {"ok": true, "device": {...}} when every phase
passed.  With no GPU, or without the repository beside it, the script
exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

FAILED: list[str] = []


def phase(name):
    """Run fn() as a named phase; a raised exception marks it failed."""
    def deco(fn):
        t0 = time.perf_counter()
        print(f"--- {name}", flush=True)
        try:
            fn()
            print(f"PHASE {name} ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            FAILED.append(name)
            print(f"PHASE {name} FAILED ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        return fn
    return deco


def card_lines() -> list[str]:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


# ---------------------------------------------------------------------------
# seeded testfiles in the reference's format (PairHMMUnitTest.cpp:118-594)
# ---------------------------------------------------------------------------

def _qual(rng, lo, hi, n):
    return "".join(chr(33 + int(q)) for q in rng.integers(lo, hi, n))


def write_testfile(path, rng, n_batches, n_reads, n_haps, hap_len,
                   read_len=250, junk_frac=0.1):
    """Each batch is one region: n_haps candidate haplotypes (the region
    with a few SNPs and short indels, <= hap_len bp) and n_reads reads
    sampled from them with sequencing errors; junk_frac of the reads are
    unrelated sequence (the first of each batch always), whose
    likelihoods underflow into the f64 fallback.  Read-major cross product -> n_reads x n_haps testcases."""
    acgt = np.array(list("ACGT"))
    with open(path, "w") as f:
        for _ in range(n_batches):
            region = rng.integers(0, 4, hap_len)
            haps = []
            for _ in range(n_haps):
                h = region.copy()
                for p in rng.integers(0, hap_len, 3):
                    h[p] = rng.integers(0, 4)
                cut = int(rng.integers(0, 12))
                if cut:  # a deletion keeps every hap <= hap_len
                    at = int(rng.integers(0, hap_len - cut))
                    h = np.concatenate([h[:at], h[at + cut:]])
                haps.append(h)
            f.write(f"{n_reads} {n_haps}\n")
            for ri in range(n_reads):
                rl = int(rng.integers(read_len // 2, read_len + 1))
                if ri == 0 or rng.random() < junk_frac:
                    read = rng.integers(0, 4, rl)
                else:
                    src = haps[int(rng.integers(0, n_haps))]
                    rl = min(rl, len(src))
                    st = int(rng.integers(0, len(src) - rl + 1))
                    read = src[st:st + rl].copy()
                    err = rng.random(rl) < 0.01
                    read[err] = rng.integers(0, 4, int(err.sum()))
                f.write("".join(acgt[read]) + " " + _qual(rng, 10, 41, rl)
                        + " " + "N" * rl + " " + "N" * rl + " "
                        + "+" * rl + "\n")
            for h in haps:
                f.write("".join(acgt[h]) + "\n")


def reference_log10(reads, haps, pairs, r_pad, h_pad):
    """The oracle's likelihoods (compute_likelihood: float32 first, f64
    when the float result is below MIN_ACCEPTED), vectorized: the f32
    numpy sweep and the native f64 pass are bit-identical to the scalar
    oracle (tests/test_phmm_jax.py, tests/test_phmm_cuda_route.py)."""
    from genomicsbench_palisade_tpu.ops import phmm as P
    from genomicsbench_palisade_tpu.ops.phmm_f64 import (
        phmm_fallback_log10, phmm_forward_sweep)

    batch = P.prepare_batch(reads, haps, pairs, r_pad=r_pad, h_pad=h_pad)
    raw = phmm_forward_sweep(batch, np.float32)
    fb = raw < np.float32(P.MIN_ACCEPTED)
    with np.errstate(divide="ignore"):
        out = (np.log10(raw).astype(np.float32)
               - np.float32(P._tables_f32()[2])).astype(np.float64)
    vals, idx = phmm_fallback_log10(batch, fb)
    out[idx] = vals
    return out, fb


def phmm_main_path(path, mesh=None):
    """What cli/phmm does per batch; returns (flat results, flat
    (reads, haps, pairs) testcase list, seconds)."""
    from genomicsbench_palisade_tpu.cli.phmm import run_testcases
    from genomicsbench_palisade_tpu.io.phmm_batch import parse_testfile

    batches = parse_testfile(str(path))
    reads, haps, pairs, results = [], [], [], []
    t0 = time.perf_counter()
    for b in batches:
        results.append(run_testcases(b.reads, b.haps, b.pairs, mesh))
    dt = time.perf_counter() - t0
    for b in batches:
        r0, h0 = len(reads), len(haps)
        reads += b.reads
        haps += b.haps
        pairs += [(r0 + r, h0 + h) for r, h in b.pairs]
    return np.concatenate(results), (reads, haps, pairs), dt


def check_against_oracle(name, got, cases, h_pad, rng, n_sample=256):
    reads, haps, pairs = cases
    # a sample of testcases, a quarter of it from the f64-fallback class
    _, fb_all = reference_log10(reads, haps, pairs[:1024], 256, h_pad)
    fb_idx = np.nonzero(fb_all)[0]
    n_fb = min(len(fb_idx), n_sample // 4)
    assert n_fb > 0, "no f64-fallback testcases in the file"
    pick_fb = rng.choice(fb_idx, n_fb, replace=False)
    rest = np.setdiff1d(np.arange(len(pairs)), pick_fb)
    sel = np.concatenate([pick_fb, rng.choice(rest, n_sample - n_fb,
                                              replace=False)])
    want, fb = reference_log10(reads, haps, [pairs[i] for i in sel], 256,
                               h_pad)
    err = np.abs(got[sel] - want)
    print(f"{name}: oracle sample {len(sel)} testcases "
          f"({int(fb.sum())} f64 fallback), max |dlog10| "
          f"{float(err.max()):.3e} (float-accepted "
          f"{float(err[~fb].max()):.3e}, fallback "
          f"{float(err[fb].max()):.3e})", flush=True)
    assert np.isfinite(got).all(), "non-finite likelihood"
    assert float(err.max()) <= 1e-5, f"{name}: max |dlog10| {err.max()}"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

SHAPES = (  # (name, batches, reads, haps, hap_len, timing b, r_pad, h_pad)
    ("256x320", 8, 32, 32, 302, 8192, 256, 320),
    ("256x512", 4, 32, 32, 473, 4096, 256, 512),
)


def run_build():
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-s", "-C", str(ROOT / "native")],
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"native build failed:\n{r.stderr[-3000:]}"
    t1 = time.perf_counter()
    from genomicsbench_palisade_tpu.ops import phmm_cuda

    phmm_cuda.build()
    phmm_cuda.register()
    print(f"native/ make {t1 - t0:.1f} s, nvcc {time.perf_counter() - t1:.1f} s"
          " (set-up)", flush=True)


def run_main_path(seed):
    from genomicsbench_palisade_tpu.cli import phmm as cli

    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name, nb, nr, nh, hl, _, _, h_pad in SHAPES:
        path = WORK / f"phmm_{name}.txt"
        write_testfile(path, rng, nb, nr, nh, hl)
        t0 = time.perf_counter()
        rc = cli.main(["-f", str(path), "--quiet"])  # the user's entry
        assert rc == 0
        print(f"{name}: cli.phmm.main first run {time.perf_counter() - t0:.2f}"
              " s (includes compiles)", flush=True)
        got, cases, dt = phmm_main_path(path)
        cells = sum((len(cases[0][r]["bases"])) * len(cases[1][h])
                    for r, h in cases[2])
        print(f"{name}: {len(got)} testcases, warm main path {dt:.3f} s, "
              f"{cells / dt / 1e9:.2f} GCUPS end to end (parse excluded)",
              flush=True)
        check_against_oracle(name, got, cases, h_pad, rng)


def run_kernel_vs_scan(seed):
    import jax

    from bench import _synth_phmm_batch
    from genomicsbench_palisade_tpu.ops import phmm as P
    from genomicsbench_palisade_tpu.ops import phmm_cuda as PC
    from genomicsbench_palisade_tpu.ops.phmm_f64 import phmm_forward_sweep
    from tools.bench_all import _timeit

    rng = np.random.default_rng(seed + 1)
    faster = []
    for name, _, _, _, hl, b, r_pad, h_pad in SHAPES:
        batch = _synth_phmm_batch(rng, b, 250, hl, r_pad, h_pad)
        comp = {k: jax.device_put(v) for k, v in P.compact_batch(batch).items()}
        full = {k: jax.device_put(v) for k, v in batch.items()}
        keys = ("rs_row", "q", "i", "d", "c", "hap", "rslen", "haplen")
        t0 = time.perf_counter()
        k_exe = PC._forward.lower(*(comp[k] for k in keys)).compile()
        k_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        s_exe = P.phmm_forward.lower(full).compile()
        s_compile = time.perf_counter() - t0
        out_k = PC.phmm_forward_cuda(comp)
        out_s = P.phmm_forward(full)
        jax.block_until_ready((out_k, out_s))
        tk = _timeit(lambda: PC.phmm_forward_cuda(comp), runs=7)
        ts = _timeit(lambda: P.phmm_forward(full), runs=7)
        cells = b * 250 * hl
        rec = {"shape": [b, r_pad, h_pad], "cells": cells,
               "kernel_ms": tk * 1e3, "xla_scan_ms": ts * 1e3,
               "kernel_gcups": cells / tk / 1e9,
               "xla_scan_gcups": cells / ts / 1e9,
               "speedup": ts / tk,
               "compile_s": {"kernel": k_compile, "xla_scan": s_compile}}
        print(json.dumps(rec), flush=True)
        print(f"{name} kernel memory_analysis: {k_exe.memory_analysis()}")
        print(f"{name} xla scan memory_analysis: {s_exe.memory_analysis()}",
              flush=True)
        # the kernel's raw sums equal the f32 reference bit for bit
        n_chk = 256
        sub = {k: np.asarray(v)[:n_chk] for k, v in batch.items()}
        want = phmm_forward_sweep(sub, np.float32)
        got = np.asarray(out_k[1])[:n_chk]
        assert np.array_equal(got, want), (
            f"{name}: kernel != f32 reference on "
            f"{int((got != want).sum())}/{n_chk}")
        scan = np.asarray(out_s[1])
        kern = np.asarray(out_k[1])
        ok = np.isfinite(scan) & (scan > 0)
        rel = np.abs(kern[ok] - scan[ok]) / scan[ok]
        print(f"{name}: kernel raw == f32 reference on {n_chk}; kernel vs "
              f"XLA scan max rel diff {float(rel.max()):.2e} (the scan "
              f"contracts multiply-adds into FMAs)", flush=True)
        faster.append(tk < ts)
    verdict = "kept" if all(faster) else "REMOVE (slower than XLA)"
    print(f"decision: CUDA kernel {verdict}", flush=True)
    assert all(faster), "kernel not faster than the XLA scan at both shapes"


GOLDEN_TESTS = (
    "tests/test_phmm_cuda_route.py::test_cuda_kernel_matches_f32_reference",
    "tests/test_phmm_jax.py::test_phmm_jax_vs_reference_fixtures",
    "tests/test_bsw_wire.py",
    "tests/test_chain_jax.py::test_chain_vs_reference_fixtures",
    "tests/test_chain_jax.py::test_chain_batched_vs_reference_fixtures",
    "tests/test_chain_big_golden.py",
    "tests/test_kmer_golden.py::test_kmer_device_matches_reference",
    "tests/test_fmi_golden.py",
    "tests/test_poa_golden.py::test_poa_device_matches_reference",
    "tests/test_poa_swov_golden.py::test_swov_device_matches_reference",
    "tests/test_pileup_golden.py",
    "tests/test_dbg_golden.py",
    "tests/test_abea_golden.py::test_abea_device_matches_reference",
    "tests/test_grm_golden.py",
)


def run_goldens():
    import pytest

    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                      "--rootdir", str(ROOT), "-W", "ignore",
                      "--durations", "8",
                      *(str(ROOT / t) for t in GOLDEN_TESTS)])
    assert rc == 0, f"golden tests on the GPU: pytest exit {rc}"


def run_kmer_accumulator():
    from genomicsbench_palisade_tpu.ops import kmer as K

    cases = json.loads((ROOT / "tests/fixtures/kmer_golden.json").read_text())
    for ci, case in enumerate(cases["cases"]):
        got = K.count_kmers_batched(case["reads"], k=case["k"],
                                    min_read_length=case["min_read_length"],
                                    batch_bases=2048, cap=1 << 14)
        assert int(got["total_kmers"]) == case["total_kmers"], ci
        assert int(got["hash_size"]) == case["hash_size"], ci
    print(f"kmer accumulator: {len(cases['cases'])} golden cases exact")


def run_abea_goldens():
    from genomicsbench_palisade_tpu.io import signal as SIG
    from genomicsbench_palisade_tpu.ops import abea as A
    from genomicsbench_palisade_tpu.ops.oracle import events as EO

    sys.path.insert(0, str(ROOT / "tests"))
    from generate_fixtures import _pore_levels

    cases = json.loads((ROOT / "tests/fixtures/abea_golden.json").read_text())
    cases = cases["cases"]
    pore = WORK / "pore_model.tsv"
    WORK.mkdir(parents=True, exist_ok=True)
    with open(pore, "w") as f:
        f.write("kmer\tlevel_mean\tlevel_stdv\n")
        for km, mean in _pore_levels().items():
            f.write(f"{km}\t{mean:.2f}\t1.50\n")
    model = SIG.load_pore_model(str(pore))
    seqs, evs, scales, shifts, wants = [], [], [], [], []
    for case in cases:
        sig = np.array([float(x) for x in case["signal"]], np.float32)
        ev = EO.detect_events(sig)
        sh, sc = EO.estimate_scalings_using_mom(case["seq"], model, ev)
        seqs.append(case["seq"])
        evs.append(np.asarray(ev["mean"], np.float32))
        scales.append(float(sc))
        shifts.append(float(sh))
        wants.append([tuple(p) for p in case["pairs"]])
    import jax

    def scan_alignments():
        return [[tuple(p) for p in g] for g in A.align_events_batch(
            seqs, evs, model, scales, shifts, use_native=False)]

    got = scan_alignments()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = scan_alignments()

    def mismatches(alns):
        return {i: sorted(set(g) ^ set(w))
                for i, (g, w) in enumerate(zip(alns, wants)) if g != w}

    bad, bad_cpu = mismatches(got), mismatches(cpu)
    print(f"abea jnp scan on the GPU: {len(cases) - len(bad)}/{len(cases)} "
          f"goldens identical, differing pairs per case {bad}; the same "
          f"scan on the CPU backend differs on {bad_cpu}", flush=True)
    assert not bad, "abea goldens differ on the GPU"


def run_grm():
    import jax

    from genomicsbench_palisade_tpu.ops import grm as G

    rng = np.random.default_rng(5)
    m, n = 32768, 2048
    geno = rng.choice([0, 1, 2, 3], size=(m, n),
                      p=[0.5, 0.3, 0.15, 0.05]).astype(np.int8)
    miss = geno == 3
    g64 = np.where(miss, 0.0, geno.astype(np.float64))
    freqs = g64.sum(1) / np.maximum(2.0 * (~miss).sum(1), 1.0)
    var = 2.0 * freqs * (1.0 - freqs)
    ok = var > G.K_SMALL_EPSILON
    isd = np.where(ok, 1.0 / np.sqrt(np.where(ok, var, 1.0)), 0.0)
    z64 = (g64 - (2 * freqs)[:, None]) * isd[:, None]
    z64[miss | ~ok[:, None]] = 0.0
    v64 = (~(miss | ~ok[:, None])).astype(np.float64)
    cnt64 = v64.T @ v64
    grm64 = (z64.T @ z64) / np.maximum(cnt64, 1.0)
    dev = (jax.device_put(geno),
           jax.device_put((2 * freqs).astype(np.float32)),
           jax.device_put(isd.astype(np.float32)), jax.device_put(ok))
    from tools.bench_all import _timeit

    def fn():
        return G._grm_device(*dev, block=4096)

    t = _timeit(fn)
    sums, counts = fn()
    grm = np.asarray(sums, np.float64) / np.maximum(
        np.asarray(counts, np.float64), 1.0)
    err = float(np.max(np.abs(grm - grm64) / np.maximum(np.abs(grm64), 1.0)))
    exact = bool(np.array_equal(np.asarray(counts), cnt64.astype(np.float32)))
    print(json.dumps({"grm_precision": str(G.SUMS_PRECISION), "m": m, "n": n,
                      "max_rel_err": err, "counts_exact": exact,
                      "ms": t * 1e3}), flush=True)
    assert err <= 2e-5 and exact, (err, exact)


def run_nn():
    try:
        import flax  # noqa: F401
    except ImportError:
        print("flax is not installed: the bonito/clair goldens wait for a "
              "plain-JAX port (ROADMAP.md)", flush=True)
        return
    import pytest

    rc = pytest.main(["-q", "-p", "no:cacheprovider", "--rootdir", str(ROOT),
                      str(ROOT / "tests/test_bonito_golden.py"),
                      str(ROOT / "tests/test_clair_golden.py")])
    assert rc == 0, f"NN goldens on the GPU: pytest exit {rc}"


def run_four_cards(seed):
    import jax

    from genomicsbench_palisade_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) == 4, jax.devices()
    mesh = make_mesh(4)
    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name, nb, nr, nh, hl, _, _, h_pad in SHAPES:
        path = WORK / f"phmm_{name}.txt"
        write_testfile(path, rng, nb, nr, nh, hl)
        one, cases, dt1 = phmm_main_path(path)
        four, _, dt4 = phmm_main_path(path, mesh)  # warm-up compiles
        four, _, dt4 = phmm_main_path(path, mesh)
        err = np.abs(four - one)
        print(f"{name}: {len(one)} testcases, 1 device (CUDA kernel, first "
              f"pass with compiles) {dt1:.3f} s, 4 devices (sharded scan, "
              f"warm) {dt4:.3f} s; max |dlog10| 4 vs 1 "
              f"{float(err.max()):.3e}", flush=True)
        assert float(err.max()) <= 1e-5
        check_against_oracle(f"{name} 4-device", four, cases, h_pad, rng)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device phmm path and its "
                         "1-device comparison")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    try:
        import genomicsbench_palisade_tpu  # noqa: F401
    except ImportError:
        print("chip_smoke: the repository is not beside this script",
              file=sys.stderr)
        return 2
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    from genomicsbench_palisade_tpu.utils.compile_cache import enable

    enable()
    devices = jax.devices()
    print(f"jax {jax.__version__}: {devices}", flush=True)

    phase("build")(run_build)
    phase("card")(lambda: print("\n".join(card_lines()), flush=True))
    if args.four_cards:
        phase("phmm-4-devices")(lambda: run_four_cards(args.seed))
    else:
        phase("main")(lambda: run_main_path(args.seed))
        phase("kernel")(lambda: run_kernel_vs_scan(args.seed))
        phase("goldens")(run_goldens)
        phase("kmer")(run_kmer_accumulator)
        phase("abea")(run_abea_goldens)
        phase("grm")(run_grm)
        phase("nn")(run_nn)
    if FAILED:
        print(f"chip_smoke: failed phases: {FAILED}", flush=True)
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform,
                                             "kind": d.device_kind,
                                             "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
