"""grm block-size / matmul-precision sweep.

Sweeps block sizes and Z^T Z precisions at M >= 32k variants and
measures BOTH throughput and the max relative error of the final GRM vs
a float64 host reference (plink2's double dsyrk semantics,
plink2_matrix_calc.cc:3668-3704) — the contract is 2e-5, which picks
ops/grm.py SUMS_PRECISION.  Prints one JSON line per config, with the
device.  Precision.HIGH is one TF32 pass on a GPU; the tf32x3 preset
exists on the GPU only.

Run: python tools/grm_sweep.py [--m 32768] [--n 2048]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=32768)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    from genomicsbench_palisade_tpu.ops import grm as G
    from genomicsbench_palisade_tpu.utils.compile_cache import enable
    enable()

    rng = np.random.default_rng(5)
    m, n = args.m, args.n
    geno = rng.choice([0, 1, 2, 3], size=(m, n),
                      p=[0.5, 0.3, 0.15, 0.05]).astype(np.int8)
    miss = geno == 3
    g64 = np.where(miss, 0.0, geno.astype(np.float64))
    freqs = g64.sum(1) / np.maximum(2.0 * (~miss).sum(1), 1.0)
    var = 2.0 * freqs * (1.0 - freqs)
    ok = var > G.K_SMALL_EPSILON
    isd = np.where(ok, 1.0 / np.sqrt(np.where(ok, var, 1.0)), 0.0)

    # float64 reference GRM (the plink2 double-dsyrk contract)
    z64 = (g64 - (2 * freqs)[:, None]) * isd[:, None]
    z64[miss | ~ok[:, None]] = 0.0
    v64 = (~(miss | ~ok[:, None])).astype(np.float64)
    sums64 = z64.T @ z64
    counts64 = v64.T @ v64
    grm64 = sums64 / np.maximum(counts64, 1.0)
    scale64 = np.maximum(np.abs(grm64), 1.0)

    dev = (jax.device_put(geno),
           jax.device_put((2 * freqs).astype(np.float32)),
           jax.device_put(isd.astype(np.float32)), jax.device_put(ok))
    flops = 2 * m * n * n * 2

    L = jax.lax
    dev_info = {"platform": jax.devices()[0].platform,
                "kind": jax.devices()[0].device_kind}
    for prec_name, prec in (("HIGHEST", L.Precision.HIGHEST),
                            ("HIGH", L.Precision.HIGH),
                            ("BF16x3", L.DotAlgorithmPreset.BF16_BF16_F32_X3),
                            ("TF32x3", L.DotAlgorithmPreset.TF32_TF32_F32_X3)):
        for block in (2048, 4096, 8192):
            def fn():
                return G._grm_device(*dev, block=block, precision=prec)

            try:
                sums, counts = jax.block_until_ready(fn())
            except Exception as e:  # a preset this backend refuses
                print(json.dumps({"precision": prec_name, "block": block,
                                  "error": repr(e)[:160]}), flush=True)
                continue
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn())
                ts.append(time.perf_counter() - t0)
            dt = float(np.median(ts))
            grm = np.asarray(sums, np.float64) / np.maximum(
                np.asarray(counts, np.float64), 1.0)
            err = float(np.max(np.abs(grm - grm64) / scale64))
            print(json.dumps({
                "precision": prec_name, "block": block,
                "tflops": flops / dt / 1e12, "max_rel_err": err,
                "meets_2e5": bool(err <= 2e-5), "device": dev_info,
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
