"""Dataset-scale chain rehearsal: the reference's input shape end-to-end.

The reference chain benchmark's small dataset is 1001 calls with n up to
~87,271 anchors per call (benchmarks/chain/src/main.cpp:100-101,
host_data_io.cpp:21; BASELINE.md "chain input scale").  This drives the
SAME path as `cli/chain.py` (parse_chain_dump -> run_calls bucketed
scan batches) on a synthesized 1001-call dump with a log-uniform
call-size distribution topping out at exactly 87,271 anchors, and reports

  - read_s:    dump parse time (the driver's "Read time" analog)
  - warm_s:    first pass (includes per-bucket compiles; persistent cache)
  - kernel_s:  second in-process pass (honest device time)
  - anchors_per_s over the second pass
  - spot parity of every call with n <= parity_cap vs the cited oracle

Bit-parity at the 87k call size itself is already pinned by reference-
built fixtures (tests/fixtures/chain_big_golden.npz, generated by
tests/generate_fixtures.py gen_chain_big); this tool adds the
driver-level throughput artifact at the full dataset shape.

Usage:
  python tools/chain_scale_bench.py --workdir /tmp/chain_scale [--calls 1001]
  python tools/chain_scale_bench.py --smoke   # tiny, on the CPU
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

MAX_N = 87_271  # benchmarks/chain/src/main.cpp:100 reported maximum


def force_cpu_backend(n_devices: int | None = None):
    """--smoke runs on the CPU backend, as tests/conftest.py does.
    n_devices forces a virtual device count (multi-device rehearsals)."""
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    if n_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{n_devices}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


def synth_call(rng, n):
    """Anchors like the reference's minimap2 dumps: x non-decreasing with
    mixed small gaps, y tracking x within a noisy band, occasional
    segment jumps that exercise the max_dist/bw cutoffs."""
    gaps = rng.integers(1, 40, n)
    jumps = rng.random(n) < 0.002
    gaps[jumps] += rng.integers(5_000, 20_000, int(jumps.sum()))
    x = np.cumsum(gaps.astype(np.int64)) + 10_000
    y = np.maximum(x + rng.integers(-400, 400, n), 0)
    return x.astype(np.uint64), y.astype(np.uint64)


def write_dump(path, rng, n_calls, smoke=False):
    sizes = np.round(10 ** rng.uniform(1.8, np.log10(MAX_N), n_calls)
                     ).astype(np.int64)
    if smoke:
        sizes = rng.integers(8, 200, n_calls)
    else:
        sizes[rng.integers(0, n_calls)] = MAX_N  # force the reference max
    with open(path, "w") as f:
        for n in sizes:
            x, y = synth_call(rng, int(n))
            aq = float(rng.uniform(10, 40))
            f.write(f"{n} {aq:.6f} 5000 5000 500 1\n")
            f.write("\n".join(f"{a} {b}" for a, b in zip(x, y)))
            f.write("\nEOR\n")
    return int(sizes.sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/chain_scale")
    ap.add_argument("--calls", type=int, default=1001)
    ap.add_argument("--parity-cap", type=int, default=1500,
                    help="oracle-check every call with n <= this")
    ap.add_argument("--parity-max", type=int, default=8,
                    help="max number of calls to oracle-check")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny calls on the CPU backend")
    ap.add_argument("--out", default="CHAIN_SCALE.json")
    args = ap.parse_args(argv)

    if args.smoke:
        force_cpu_backend()
    from genomicsbench_palisade_tpu.utils.compile_cache import enable
    enable()

    wd = pathlib.Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    dump = wd / ("calls_smoke.txt" if args.smoke else "calls.txt")
    rng = np.random.default_rng(5)
    if not dump.exists():
        t0 = time.perf_counter()
        total = write_dump(dump, rng, args.calls, smoke=args.smoke)
        print(f"[gen] {args.calls} calls / {total:,} anchors in "
              f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)

    from genomicsbench_palisade_tpu.cli.chain import run_calls
    from genomicsbench_palisade_tpu.io.chain_dump import parse_chain_dump

    t0 = time.perf_counter()
    calls = parse_chain_dump(str(dump))
    read_s = time.perf_counter() - t0
    total_anchors = int(sum(c.n for c in calls))
    print(f"[read] {len(calls)} calls / {total_anchors:,} anchors in "
          f"{read_s:.1f} s", file=sys.stderr)

    t0 = time.perf_counter()
    results = run_calls(calls)
    warm_s = time.perf_counter() - t0
    kernel_s = None  # best of 3 in-process passes
    for _ in range(3 if not args.smoke else 1):
        t0 = time.perf_counter()
        results = run_calls(calls)
        dt = time.perf_counter() - t0
        kernel_s = dt if kernel_s is None else min(kernel_s, dt)

    # spot parity vs the cited oracle transcription on small calls
    from genomicsbench_palisade_tpu.ops.oracle import chain as CO

    checked = 0
    for call, (sc, par, pk) in zip(calls, results):
        if not (0 < call.n <= args.parity_cap) or checked >= args.parity_max:
            continue
        res = CO.chain_dp(CO.ChainCall(
            n=call.n, avg_qspan=call.avg_qspan, max_dist_x=call.max_dist_x,
            max_dist_y=call.max_dist_y, bw=call.bw, n_segs=call.n_segs,
            x=call.x, y=call.y))
        assert np.array_equal(np.asarray(sc)[: call.n], res["scores"]), "scores"
        assert np.array_equal(np.asarray(par)[: call.n], res["parents"]), "parents"
        assert np.array_equal(np.asarray(pk)[: call.n], res["peak_scores"]), "peaks"
        checked += 1

    out = {
        "tool": "chain_scale_bench",
        "calls": len(calls),
        "total_anchors": total_anchors,
        "max_call_n": int(max(c.n for c in calls)),
        "read_s": round(read_s, 1),
        "warm_s": round(warm_s, 1),
        "kernel_s": round(kernel_s, 2),
        "anchors_per_s": round(total_anchors / kernel_s, 1),
        "oracle_parity_calls": checked,
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
