"""Benchmark: per-kernel 1-GPU throughput suite.

Prints one JSON line per north-star kernel (bsw pairs/s, chain anchors/s,
kmer Mbases/s, fmi reads/s, ...), then, as the FINAL line, the flagship
PairHMM GCUPS record with every per-kernel number under "per_kernel".

  * native/ is built in-process before anything queries it;
  * the flagship phmm measurement runs FIRST: the CUDA forward kernel at
    the GenomicsBench small envelope (8192 testcases, reads <= 250 bp,
    haps <= 302 bp -> bucket 256x320) and the large-dataset bucket
    (4096 testcases, haps <= 473 -> 256x512, PairHMMUnitTest.cpp:1-34),
    each the median of 5 runs ended by block_until_ready;
  * every record names the device; with no GPU, or when a kernel
    fails, the script exits nonzero.

GCUPS = billions of DP cells (rslen x haplen per testcase) per second,
the reference suite's headline PairHMM metric (BASELINE.md).
"""

import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent


def _build_native():
    """Build native/ (seconds).  Must run before anything imports
    io.native (its loader caches a miss)."""
    r = subprocess.run(["make", "-s", "-C", str(ROOT / "native")],
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise SystemExit(f"native build failed:\n{r.stderr[-2000:]}")


def _synth_phmm_batch(rng, b, rl, hl, r_pad, h_pad):
    """Reads are noisy subsequences of their haplotype (realistic
    likelihood regime)."""
    from genomicsbench_palisade_tpu.ops import phmm as P

    reads, haps, pairs = [], [], []
    for i in range(b):
        hap = rng.integers(0, 4, hl)
        start = rng.integers(0, hl - rl)
        read = hap[start : start + rl].copy()
        noise = rng.random(rl) < 0.05
        read[noise] = rng.integers(0, 4, int(noise.sum()))
        reads.append(
            {
                "bases": read,
                "q": rng.integers(36, 60, rl),
                "i": rng.integers(36, 60, rl),
                "d": rng.integers(36, 60, rl),
                "c": rng.integers(36, 60, rl),
            }
        )
        haps.append(hap)
        pairs.append((i, i))
    return P.prepare_batch(reads, haps, pairs, r_pad=r_pad, h_pad=h_pad)


def _measure_phmm(rng, b, rl, hl, r_pad, h_pad):
    """(GCUPS, f64-fallback fraction) of the CUDA forward kernel."""
    import jax

    from genomicsbench_palisade_tpu.ops import phmm as P
    from genomicsbench_palisade_tpu.ops.phmm_cuda import phmm_forward_cuda
    from bench_all import _timeit

    batch = _synth_phmm_batch(rng, b, rl, hl, r_pad, h_pad)
    batch = {k: jax.device_put(v) for k, v in P.compact_batch(batch).items()}
    fallback_frac = float(np.asarray(phmm_forward_cuda(batch)[2]).mean())
    dt = _timeit(lambda: phmm_forward_cuda(batch))
    return b * rl * hl / dt / 1e9, fallback_frac


def main():
    _build_native()
    import jax

    if jax.default_backend() != "gpu":
        print(json.dumps({"error": "no GPU found", "backend":
                          jax.default_backend()}), file=sys.stderr)
        return 2

    from genomicsbench_palisade_tpu.utils.compile_cache import enable

    enable()
    sys.path.insert(0, str(ROOT / "tools"))
    import bench_all

    rng = np.random.default_rng(0)
    gcups, fb_frac = _measure_phmm(rng, 8192, 250, 302, 256, 320)
    h512, _ = _measure_phmm(rng, 4096, 250, 473, 256, 512)

    others = [f for f in bench_all.BENCHES if f is not bench_all.bench_phmm]
    results, failures = bench_all.run_all(others)
    per_kernel = {r["kernel"]: {k: v for k, v in r.items()
                                if k not in ("kernel", "device")}
                  for r in results if "value" in r}
    print(json.dumps({
        "metric": "phmm_forward_gcups_1gpu",
        "value": round(gcups, 3),
        "unit": "GCUPS",
        "h512_gcups": round(h512, 3),
        "f64_fallback_frac": round(fb_frac, 5),
        "per_kernel": per_kernel,
        "device": bench_all.device_info(),
    }))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
