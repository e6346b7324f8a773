"""Dataset-scale poa rehearsal at reference-like window shapes.

The reference's poa input is FASTA windows delimited by '>0' headers
with ~0.5-1 kb sequences per window (benchmarks/poa/msa_spoa_omp.cpp:
102-165 slot stride); tools/bench_all.py runs 32
synthetic windows of 6 x 200 bp — an order of magnitude below the real
shape.  This drives the production device lock-step consensus loop
(ops/poa.py msa_consensus_batch, native graph) on reference-class
windows and records seqs/s + the align/add/consensus phase split in
POA_SCALE.json.

Parity: a sample of windows is re-run through the cited-oracle
msa_consensus (ops/oracle/poa.py, itself golden-pinned to the reference
spoa binary) and the consensus strings must match exactly.

Usage:
  python tools/poa_scale_bench.py                  # 64 windows, 10x750bp
  python tools/poa_scale_bench.py --smoke
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def synth_windows(rng, n_win, n_seq, length):
    batches = []
    for _ in range(n_win):
        base = rng.integers(0, 4, length)
        seqs = []
        for _ in range(n_seq):
            s = base.copy()
            mut = rng.random(length) < 0.04
            s[mut] = rng.integers(0, 4, int(mut.sum()))
            # small indel realism: drop a couple of positions
            drop = np.sort(rng.choice(length, 2, replace=False))
            s = np.delete(s, drop)
            seqs.append("".join("ACGT"[c] for c in s))
        batches.append(seqs)
    return batches


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument("--seqs", type=int, default=10)
    ap.add_argument("--len", type=int, default=750, dest="length")
    ap.add_argument("--parity-windows", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--engine", choices=["host", "device"], default="host",
                    help="host = native C++ align engine (production "
                    "default); device = "
                    "device lock-step fill")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="POA_SCALE.json")
    args = ap.parse_args(argv)

    if args.smoke:
        from chain_scale_bench import force_cpu_backend
        force_cpu_backend()
        args.windows, args.seqs, args.length = 4, 4, 120
        args.parity_windows = 2
    from genomicsbench_palisade_tpu.utils.compile_cache import enable
    enable()

    rng = np.random.default_rng(23)
    batches = synth_windows(rng, args.windows, args.seqs, args.length)
    total_seqs = args.windows * args.seqs
    total_bases = sum(len(s) for b in batches for s in b)
    print(f"[gen] {args.windows} windows x {args.seqs} seqs, "
          f"{total_bases:,} bases", file=sys.stderr)

    from genomicsbench_palisade_tpu.ops.poa import (msa_consensus_batch,
                                                    msa_consensus_host)

    def run_engine(tm=None):
        if args.engine == "host":
            res = msa_consensus_host(batches, timings=tm)
            if res is None:
                raise SystemExit("native lib not built (make -C native)")
            return res
        return msa_consensus_batch(batches, timings=tm)

    t0 = time.perf_counter()
    out = run_engine()
    warm_s = time.perf_counter() - t0
    best, timings = None, {}
    for _ in range(args.reps):
        tm = {}
        t0 = time.perf_counter()
        out = run_engine(tm)
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, timings = dt, tm
    assert all(out), "empty consensus"
    print(f"[run] warm {warm_s:.1f} s, best {best:.2f} s "
          f"({timings})", file=sys.stderr)

    # oracle parity on sampled windows (exact consensus strings)
    from genomicsbench_palisade_tpu.ops.oracle.poa import msa_consensus

    sel = rng.choice(args.windows, min(args.parity_windows, args.windows),
                     replace=False)
    t0 = time.perf_counter()
    for wi in sel:
        want = msa_consensus(batches[wi])
        assert out[wi] == want, f"window {wi}: consensus != oracle"
    par_s = time.perf_counter() - t0
    print(f"[parity] {len(sel)}/{len(sel)} oracle-exact in {par_s:.0f} s",
          file=sys.stderr)

    res = {
        "tool": "poa_scale_bench",
        "engine": args.engine,
        "windows": args.windows,
        "seqs_per_window": args.seqs,
        "seq_len": args.length,
        "total_bases": int(total_bases),
        "warm_s": round(warm_s, 1),
        "best_s": round(best, 2),
        "seqs_per_s": round(total_seqs / best, 1),
        "align_s": round(timings.get("align", 0.0), 2),
        "add_s": round(timings.get("add", 0.0), 2),
        "consensus_s": round(timings.get("consensus", 0.0), 2),
        "oracle_parity_windows": int(len(sel)),
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
