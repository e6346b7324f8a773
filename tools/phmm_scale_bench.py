"""End-to-end phmm at the reference dataset shape -> PHMM_SCALE.json.

bench.py times only the device kernel; the reference's GCUPS pays
parsing, per-row probability prep and the float->double fallback
in-loop (IntelPairHmmCSource.cpp:61-85).  This
drives the WHOLE pipeline at the reference driver's dataset shape —
550 batches x <=110 reads x <=37 haps cross product
(benchmarks/phmm/PairHMMUnitTest.cpp:1-34,118-594) — and records the
honest end-to-end GCUPS with the phase split: parse / host prep /
device kernel+fetch / f64 fallback.

Testcases pool ACROSS driver batches into global shape buckets (each
read x hap case is independent, so batch boundaries are a printing
artifact, not a dependency — pooling turns 550 x buckets small device
calls, each with its own launch and fetch, into a handful of large
ones).

Parity: a random sample is checked against the cited float/double
oracle (ops/oracle/phmm.py compute_likelihood) to 1e-5 — GKL's own
unit-test tolerance (PairHmmUnitTest.java:49-55).

The same testfile is the input for tools/ref_baseline.py phmm (GKL AVX
binary) — kept under --workdir.

Usage:
  python tools/phmm_scale_bench.py            # 550 batches, on the GPU
  python tools/phmm_scale_bench.py --smoke    # tiny, CPU
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

QUAL33 = lambda arr: "".join(chr(int(v) + 33) for v in arr)  # noqa: E731


def synth_testfile(path, rng, n_batches=550, max_reads=110, max_haps=37,
                   read_len=(10, 151), hap_len=(50, 473)):
    """Reference-shaped batches.  Reads mix haplotype-sampled (high
    likelihood — the float paths random pairs never reach) and random
    (low likelihood — drives the double-fallback fraction)."""
    with open(path, "w") as f:
        for _ in range(n_batches):
            nr = int(rng.integers(1, max_reads + 1))
            nh = int(rng.integers(1, max_haps + 1))
            f.write(f"{nr} {nh}\n")
            haps = []
            for _ in range(nh):
                hl = int(rng.integers(hap_len[0], hap_len[1] + 1))
                haps.append("".join("ACGT"[c]
                                    for c in rng.integers(0, 4, hl)))
            for _ in range(nr):
                rl = int(rng.integers(read_len[0], read_len[1] + 1))
                if rng.random() < 0.6 and len(haps[0]) > rl:
                    hp = haps[int(rng.integers(nh))]
                    if len(hp) > rl:
                        s = int(rng.integers(0, len(hp) - rl))
                        bases = list(hp[s:s + rl])
                        mut = rng.random(rl) < 0.03
                        for p in np.nonzero(mut)[0]:
                            bases[p] = "ACGT"[int(rng.integers(4))]
                        bases = "".join(bases)
                    else:
                        bases = hp
                        rl = len(bases)
                else:
                    bases = "".join("ACGT"[c]
                                    for c in rng.integers(0, 4, rl))
                q = QUAL33(rng.integers(6, 41, rl))
                iq = QUAL33(rng.integers(30, 46, rl))
                dq = QUAL33(rng.integers(30, 46, rl))
                cq = QUAL33(np.full(rl, 10))
                f.write(f"{bases} {q} {iq} {dq} {cq}\n")
            for hp in haps:
                f.write(hp + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=550)
    ap.add_argument("--parity-sample", type=int, default=128)
    ap.add_argument("--workdir", default="/tmp/phmm_scale")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="PHMM_SCALE.json")
    args = ap.parse_args(argv)

    if args.smoke:
        from chain_scale_bench import force_cpu_backend
        force_cpu_backend()
        args.batches, args.parity_sample = 6, 16
    from genomicsbench_palisade_tpu.utils.compile_cache import enable
    enable()

    wd = pathlib.Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    tf = wd / ("testfile_smoke.txt" if args.smoke else "testfile.txt")
    rng = np.random.default_rng(20260824)
    if not tf.exists():
        t0 = time.perf_counter()
        synth_testfile(tf, rng, n_batches=args.batches,
                       max_reads=8 if args.smoke else 110,
                       max_haps=4 if args.smoke else 37)
        print(f"[gen] {tf} ({tf.stat().st_size/1e6:.1f} MB, "
              f"{time.perf_counter()-t0:.0f} s)", file=sys.stderr)

    from genomicsbench_palisade_tpu.io.bucketing import group_by_buckets
    from genomicsbench_palisade_tpu.io.phmm_batch import parse_testfile
    from genomicsbench_palisade_tpu.ops import phmm as P
    from genomicsbench_palisade_tpu.ops.phmm_f64 import phmm_fallback_log10

    t0 = time.perf_counter()
    batches = parse_testfile(tf)
    parse_s = time.perf_counter() - t0
    print(f"[parse] {parse_s:.1f} s", file=sys.stderr, flush=True)

    # global pool: flat read/hap lists + cross-product pairs
    reads, haps, pairs, owner = [], [], [], []
    for b in batches:
        r0, h0 = len(reads), len(haps)
        reads.extend(b.reads)
        haps.extend(b.haps)
        for (r, h) in b.pairs:
            pairs.append((r0 + r, h0 + h))
            owner.append(b.id)
    n_pairs = len(pairs)
    cells = sum((len(reads[r]["bases"])) * len(haps[h]) for r, h in pairs)
    print(f"[pool] {len(batches)} batches, {n_pairs} testcases, "
          f"{cells/1e9:.2f} Gcells", file=sys.stderr, flush=True)

    results = np.zeros(n_pairs, np.float64)
    t0 = time.perf_counter()
    groups = group_by_buckets(
        pairs, lambda pr: (len(reads[pr[0]]["bases"]) + 1,
                           len(haps[pr[1]])))
    prepped = []
    for (r_pad, h_pad), members in groups.items():
        idxs = np.array([i for i, _ in members])
        sub_pairs = [p for _, p in members]
        batch = P.prepare_batch(reads, haps, sub_pairs,
                                r_pad=r_pad, h_pad=h_pad)
        prepped.append((idxs, {k: np.asarray(v) for k, v in batch.items()}))
        print(f"[prep] bucket ({r_pad},{h_pad}): {len(members)} pairs "
              f"(t={time.perf_counter()-t0:.0f} s)", file=sys.stderr,
              flush=True)
    prep_s = time.perf_counter() - t0

    kernel_s = fallback_s = 0.0
    n_fallback = 0
    for idxs, batch_np in prepped:
        t0 = time.perf_counter()
        log10, _res, fb = map(np.asarray, P.phmm_forward_auto(batch_np))
        dt = time.perf_counter() - t0
        kernel_s += dt
        print(f"[kernel] bucket {batch_np['rs_row'].shape} "
              f"x h{batch_np['hap'].shape[1]}: {dt:.1f} s",
              file=sys.stderr, flush=True)
        out = log10.astype(np.float64)
        t0 = time.perf_counter()
        if fb.any():
            vals, fidx = phmm_fallback_log10(batch_np, fb)
            out[fidx] = vals
            n_fallback += int(fb.sum())
        fallback_s += time.perf_counter() - t0
        results[idxs] = out
    total_s = parse_s + prep_s + kernel_s + fallback_s

    # oracle parity sample (float-first + double fallback, 1e-5)
    from genomicsbench_palisade_tpu.ops.oracle.phmm import compute_likelihood
    # dedicated seed: the sample must not depend on whether the testfile
    # was regenerated this run (rng above advances only in that case)
    sel = np.random.default_rng(20260824).choice(
        n_pairs, min(args.parity_sample, n_pairs), replace=False)
    # Tolerance: GKL's own 1e-5 (PairHmmUnitTest.java:55) is an absolute
    # bound on its small fixture log-likelihoods (|x| ~ a few).  Float-
    # accepted cases here reach |log10| ~ 50+, where one f32 ulp is
    # ~4e-6.  The GPU kernel equals the f32 oracle's raw sums bit for
    # bit, but the CPU route (the XLA scan) contracts multiply-adds into
    # FMAs and lands a few f32 ulps away.  So: 1e-5 or 32 f32 ulps at the
    # result's magnitude, whichever is larger.
    for i in sel:
        r, h = pairs[i]
        want = compute_likelihood(
            reads[r]["bases"], haps[h], reads[r]["q"], reads[r]["i"],
            reads[r]["d"], reads[r]["c"])
        tol = max(1e-5, 32.0 * float(np.spacing(np.float32(abs(want)))))
        assert abs(want - results[i]) < tol, (i, want, results[i], tol)
    print(f"[parity] {len(sel)}/{len(sel)} within max(1e-5, 32 ulp_f32)",
          file=sys.stderr)

    res = {
        "tool": "phmm_scale_bench",
        "batches": len(batches),
        "pairs": n_pairs,
        "gcells": round(cells / 1e9, 2),
        "parse_s": round(parse_s, 2),
        "prep_s": round(prep_s, 2),
        "kernel_s": round(kernel_s, 2),
        "fallback_s": round(fallback_s, 2),
        "end_to_end_s": round(total_s, 2),
        "gcups_end_to_end": round(cells / total_s / 1e9, 2),
        "gcups_kernel_region": round(cells / max(kernel_s, 1e-9) / 1e9, 2),
        "fallback_frac": round(n_fallback / n_pairs, 4),
        "parity_sample": int(len(sel)),
        "smoke": bool(args.smoke),
    }
    print(json.dumps(res))
    if not args.smoke:
        p = pathlib.Path(args.out)
        hist = json.loads(p.read_text()) if p.exists() else []
        hist.append(res)
        p.write_text(json.dumps(hist, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
