"""Nanopore-realistic abea rehearsal: 10-50 kb reads.

Real f5c inputs are 10-100 kb reads at ~2 events/base, so band counts
reach 10^5 (the reference sizes its band machinery for exactly this:
benchmarks/abea/src/align.c:145-166, f5c.cu:450-497).  All committed
abea fixtures and benches used <=~560 bp reads; this drives the
production fill (native host engine, or the device scan with
--engine device) at long-read scale and prints reads/s, events/s and
fetched bytes as one JSON line.

Parity: the first --parity reads (capped at 15 kb — the cited oracle
walks ~2 s/kb in Python) must decode to EXACTLY the oracle alignment,
including QC drops.

Usage:
  python tools/abea_scale_bench.py                    # 16 reads, 10-50 kb
  python tools/abea_scale_bench.py --smoke            # tiny, CPU-sized
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

K = 6


def synth_model(rng):
    model = {
        "level_mean": rng.normal(90, 12, 4096).astype(np.float32),
        "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32),
    }
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    return model


def synth_read(rng, model, length):
    """Vectorized model-driven read + events (~1.5 events/base).

    Rank convention matches oracle get_kmer_rank (first base is the
    HIGH 2 bits)."""
    codes = rng.integers(0, 4, length)
    seq = "".join("ACGT"[c] for c in codes)
    nk = length - K + 1
    ranks = np.zeros(nk, np.int64)
    for j in range(K):
        ranks = (ranks << 2) | codes[j : nk + j]
    counts = rng.integers(1, 3, nk)
    means = (np.repeat(model["level_mean"][ranks], counts)
             + rng.normal(0, 0.4, int(counts.sum())))
    return seq, means.astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=16)
    ap.add_argument("--len-min", type=int, default=10_000)
    ap.add_argument("--len-max", type=int, default=50_000)
    ap.add_argument("--parity", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--engine", choices=["host", "device"], default="host",
                    help="host = native C++ fill (production default); "
                    "device = jnp band-fill "
                    "scan + host traceback")
    ap.add_argument("--add-100k", action="store_true",
                    help="append one ~100 kb read (f5c's upper regime)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="ABEA_SCALE.json")
    args = ap.parse_args(argv)

    if args.smoke:
        from chain_scale_bench import force_cpu_backend
        force_cpu_backend()
        args.reads = min(args.reads, 2)
        args.len_min, args.len_max = 400, 800
        args.parity = min(args.parity, 2)
    from genomicsbench_palisade_tpu.utils.compile_cache import enable
    enable()

    rng = np.random.default_rng(17)
    model = synth_model(rng)
    lens = np.linspace(args.len_min, args.len_max, args.reads).astype(int)
    if args.parity < args.reads:
        # partial parity: shorten the checked prefix so the Python
        # oracle stays tractable
        lens[: args.parity] = np.linspace(
            args.len_min, min(15_000, args.len_max),
            args.parity).astype(int)
    # else: full-length parity on every read
    t0 = time.perf_counter()
    seqs, evs = [], []
    for ln in lens:
        s, e = synth_read(rng, model, int(ln))
        seqs.append(s)
        evs.append(e)
    if args.add_100k:
        s, e = synth_read(rng, model, 100_000)
        seqs.append(s)
        evs.append(e)
        lens = np.concatenate([lens, [100_000]])
        args.reads += 1
    gen_s = time.perf_counter() - t0
    n_events = int(sum(len(e) for e in evs))
    print(f"[gen] {args.reads} reads, {int(lens.sum()):,} bases, "
          f"{n_events:,} events in {gen_s:.0f} s", file=sys.stderr)

    ones = [1.0] * args.reads
    zeros = [0.0] * args.reads

    if args.engine == "host":
        from genomicsbench_palisade_tpu.ops.abea import (
            align_events_batch_native)

        def run():
            res = align_events_batch_native(seqs, evs, model, ones, zeros)
            if res is None:
                raise SystemExit("native lib not built (make -C native)")
            return res
    else:
        from genomicsbench_palisade_tpu.ops.abea import align_events_batch

        def run():
            return align_events_batch(seqs, evs, model, ones, zeros,
                                      use_native=False)

    t0 = time.perf_counter()
    res = run()
    warm_s = time.perf_counter() - t0
    best = None
    for _ in range(args.reps):
        t0 = time.perf_counter()
        res = run()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)

    aligned = sum(1 for r in res if r)
    print(f"[run] warm {warm_s:.1f} s, best {best:.2f} s, "
          f"{aligned}/{args.reads} aligned", file=sys.stderr)

    # oracle parity on the first --parity reads (exact, incl. QC drops)
    from genomicsbench_palisade_tpu.ops.oracle import abea as AO

    t0 = time.perf_counter()
    n_par = 0
    for i in range(args.parity):
        want = AO.align(seqs[i], evs[i], model, 1.0, 0.0)
        assert res[i] == want, (
            f"read {i} (len {lens[i]}): device != oracle "
            f"({len(res[i])} vs {len(want)} pairs)")
        n_par += 1
    par_s = time.perf_counter() - t0
    print(f"[parity] {n_par}/{args.parity} oracle-exact in {par_s:.0f} s",
          file=sys.stderr)

    out = {
        "tool": "abea_scale_bench",
        "engine": args.engine,
        "reads": args.reads,
        "len_min": int(lens.min()),
        "len_max": int(lens.max()),
        "total_events": n_events,
        "max_bands": int(max(len(e) for e in evs)
                         + max(len(s) for s in seqs) - K + 3),
        "warm_s": round(warm_s, 1),
        "best_s": round(best, 2),
        "reads_per_s": round(args.reads / best, 2),
        "events_per_s": round(n_events / best, 1),
        "aligned": aligned,
        "oracle_parity_reads": n_par,
        "smoke": bool(args.smoke),
    }
    print(json.dumps(out))
    if not args.smoke:
        p = pathlib.Path(args.out)
        hist = json.loads(p.read_text()) if p.exists() else []
        hist.append(out)
        p.write_text(json.dumps(hist, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
