"""Device-scaling benchmark harness (SURVEY.md §7 step 7).

Measures reads/s (phmm testcases/s, kmer reads/s) at 1..N local devices
on a batch-sharded mesh, reporting per-point throughput, scaling
efficiency vs 1 device, and the static-shard load-imbalance metric
mirroring the reference's maxTicks/avgTicks (fmi.cpp:362-370).

Usage: python tools/scaling_bench.py [--kernel phmm|kmer] [--devices 1,2,4,8]
On a CPU dev box run with
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
On a multi-GPU host it uses the real devices; the >=80% linear-scaling
target is the BASELINE.json north star.

Prints one JSON line per point plus a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _phmm_batch(b, rng, r_pad=128, h_pad=192):
    from genomicsbench_palisade_tpu.ops import phmm as P

    reads, haps, pairs = [], [], []
    for i in range(b):
        rl = int(rng.integers(60, r_pad - 1))
        hl = int(rng.integers(rl, h_pad))
        hap = rng.integers(0, 4, hl)
        reads.append({
            "bases": hap[:rl].copy(),
            "q": rng.integers(36, 60, rl),
            "i": rng.integers(36, 60, rl),
            "d": rng.integers(36, 60, rl),
            "c": rng.integers(36, 60, rl),
        })
        haps.append(hap)
        pairs.append((i, i))
    batch = P.prepare_batch(reads, haps, pairs, r_pad=r_pad, h_pad=h_pad)
    work = [(len(r["bases"]) + 1) * len(h) for r, h in zip(reads, haps)]
    return batch, work


def bench_phmm(ndev, batch, work, iters=8):
    import jax

    from genomicsbench_palisade_tpu.parallel import dp, mesh as M

    mesh = M.make_mesh(ndev)
    sharded, n = M.shard_batch(batch, mesh)
    out = dp.phmm_forward_sharded(mesh, sharded)
    jax.block_until_ready(out)  # compile
    t0 = time.perf_counter()
    for _ in range(iters):
        out = dp.phmm_forward_sharded(mesh, sharded)
    np.asarray(out[0])
    dt = (time.perf_counter() - t0) / iters
    return n / dt, M.shard_work_imbalance(work, ndev)


def bench_kmer(ndev, bases, lengths, iters=8):
    import jax.numpy as jnp

    from genomicsbench_palisade_tpu.parallel import dp, mesh as M

    mesh = M.make_mesh(ndev)
    sharded, n = M.shard_batch({"b": bases, "l": lengths}, mesh)
    out = dp.count_kmers_sharded(mesh, sharded["b"], sharded["l"])
    int(np.asarray(out["total_kmers"]))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = dp.count_kmers_sharded(mesh, sharded["b"], sharded["l"])
    total = int(np.asarray(out["total_kmers"]))
    dt = (time.perf_counter() - t0) / iters
    return n / dt, M.shard_work_imbalance(lengths, ndev), total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="phmm", choices=("phmm", "kmer"))
    ap.add_argument("--devices", default=None,
                    help="comma list, default 1,2,...,n_local")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)

    import jax

    n_local = len(jax.devices())
    if args.devices:
        points = [int(x) for x in args.devices.split(",")]
    else:
        points, d = [], 1
        while d <= n_local:
            points.append(d)
            d *= 2

    rng = np.random.default_rng(0)
    results = []
    if args.kernel == "phmm":
        batch, work = _phmm_batch(args.batch, rng)
        for nd in points:
            rps, imb = bench_phmm(nd, batch, work, args.iters)
            results.append((nd, rps, imb))
    else:
        reads = ["".join(rng.choice(list("ACGT"), 5500)) for _ in range(args.batch // 8)]
        from genomicsbench_palisade_tpu.ops.kmer import encode_reads_np

        bases, lengths = encode_reads_np(reads)
        for nd in points:
            rps, imb, _tot = bench_kmer(nd, bases.astype(np.int32), lengths, args.iters)
            results.append((nd, rps, imb))

    if jax.devices()[0].platform == "cpu" and n_local > 1:
        print(json.dumps({"note": "virtual CPU mesh: devices share host cores, "
                          "so flat total throughput == ideal; efficiency is "
                          "only meaningful on real devices"}), file=sys.stderr)
    base = results[0][1]
    for nd, rps, imb in results:
        eff = rps / (base * nd)
        print(json.dumps({
            "kernel": args.kernel, "devices": nd,
            "items_per_s": round(rps, 1),
            "scaling_efficiency": round(eff, 3),
            "load_imbalance": round(imb, 4),
        }))
    best = results[-1]
    print(json.dumps({
        "metric": f"{args.kernel}_scaling_eff_{best[0]}dev",
        "value": round(best[1] / (base * best[0]), 3),
        "unit": "fraction_of_linear",
        "vs_baseline": round(best[1] / (base * best[0]) / 0.8, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
