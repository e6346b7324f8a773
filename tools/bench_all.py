"""Per-kernel 1-device throughput suite (BASELINE.md north-star metrics).

Prints one JSON line per kernel at reference-like workload shapes:
  phmm  — GCUPS (GenomicsBench small envelope, 250x302)
  bsw   — pairs/s + GCUPS (ref<=256/qer<=128 pairs, w=100 band)
  chain — anchors/s (n=4096-anchor calls, window 64 covers >99.9% of
          predecessor hits at GenomicsBench anchor densities)
  kmer  — bases/s (5.5 kbp reads, k=17)
  fmi   — reads/s (101 bp reads vs a 5 Mbp synthetic index, batch 512)
  poa   — seqs/s (32 windows x 6 seqs x 200 bp, full consensus loop)
  abea  — reads/s (64 x 500 bp model-synthesized nanopore reads)
  pileup — Mbases/s (host counting, 2000 x 300 bp over a 60 kb region)

Device timings are the median of several runs, each ended by
jax.block_until_ready after a warm-up (compile) call.  Every record names
the device it ran on; a kernel that fails makes the suite exit nonzero.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

# scripts run as `python tools/bench_all.py`: the script dir is on sys.path,
# the repo root is not
REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _timeit(fn, runs=5):
    """Median seconds per call over `runs` calls, each ended by
    block_until_ready; one warm-up call first (compiles)."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _timeit_host(fn, iters=1, repeats=3):
    """Best-of-N for host-side paths; fn's return must be fully
    materialized by the call itself."""
    fn()  # warm
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        dt = (time.perf_counter() - t0) / iters
        best = dt if best is None else min(best, dt)
    return best, out


def bench_phmm():
    import jax

    from genomicsbench_palisade_tpu.ops import phmm as P
    from genomicsbench_palisade_tpu.ops.phmm_cuda import phmm_forward_cuda

    rng = np.random.default_rng(0)
    b, rl, hl = 2048, 250, 302
    reads, haps, pairs = [], [], []
    for i in range(b):
        hap = rng.integers(0, 4, hl)
        reads.append({"bases": hap[:rl].copy(), "q": rng.integers(36, 60, rl),
                      "i": rng.integers(36, 60, rl), "d": rng.integers(36, 60, rl),
                      "c": rng.integers(36, 60, rl)})
        haps.append(hap)
        pairs.append((i, i))
    batch = P.prepare_batch(reads, haps, pairs, r_pad=256, h_pad=320)
    batch = {k: jax.device_put(v) for k, v in P.compact_batch(batch).items()}
    dt = _timeit(lambda: phmm_forward_cuda(batch))
    return {"kernel": "phmm", "value": round(b * rl * hl / dt / 1e9, 3),
            "unit": "GCUPS", "batch": b}


def bench_bsw():
    import jax

    from genomicsbench_palisade_tpu.ops import bsw as W

    rng = np.random.default_rng(1)
    b, ql, tl = 8192, 128, 256
    pairs = []
    for _ in range(b):
        t = rng.integers(0, 4, tl)
        q = t[: ql].copy()
        mut = rng.random(ql) < 0.08
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        pairs.append((q, t, int(rng.integers(20, 60))))
    batch = W.prepare_pairs(pairs, q_pad=ql, t_pad=tl)
    batch = {k: jax.device_put(np.asarray(v)) for k, v in batch.items()}
    dt = _timeit(lambda: W.bsw_batch_stacked(batch))
    return {"kernel": "bsw", "value": round(b / dt, 1), "unit": "pairs/s",
            "gcups": round(b * ql * tl / dt / 1e9, 3), "batch": b}


def bench_chain():
    import jax

    from genomicsbench_palisade_tpu.ops import chain as C

    rng = np.random.default_rng(2)
    n, n_calls, w = 4096, 128, 64
    calls = []
    for _ in range(n_calls):
        xs = np.cumsum(rng.integers(1, 40, n)).astype(np.int64)
        ys = np.maximum(xs + rng.integers(-200, 200, n), 0)
        calls.append(C.prepare_call(xs, ys,
                                    avg_qspan=float(rng.uniform(14, 40))))
    stack = {k: np.stack([(c["x_lo"].view(np.int32) if k == "x_lo" else c[k])
                          for c in calls])
             for k in ("x_lo", "qi", "qspan", "st_eff", "gap_table")}
    args = tuple(jax.device_put(stack[k]) for k in
                 ("x_lo", "qi", "qspan", "st_eff", "gap_table"))
    lens = jax.device_put(np.full(n_calls, n, np.int32))
    dt = _timeit(lambda: C.chain_dp_device_batch(
        *args, lens, w, n, 5000, 5000, 500))
    return {"kernel": "chain", "value": round(n * n_calls / dt, 1),
            "unit": "anchors/s", "n": n, "calls": n_calls}


def bench_kmer():
    import jax
    import jax.numpy as jnp

    from genomicsbench_palisade_tpu.ops import kmer as K

    rng = np.random.default_rng(3)
    # 512 reads: enough for the sort-based counter to amortize
    reads = ["".join(rng.choice(list("ACGT"), 5500)) for _ in range(512)]
    bases, lengths = K.encode_reads_np(reads)
    bases_d = jax.device_put(bases.astype(np.int32))
    lengths_d = jax.device_put(lengths)
    total_bases = int(lengths.sum())
    dt = _timeit(lambda: K.count_kmers_device(bases_d, lengths_d))
    return {"kernel": "kmer", "value": round(total_bases / dt / 1e6, 2),
            "unit": "Mbases/s", "reads": len(reads)}


def bench_fmi():
    import jax
    import jax.numpy as jnp

    from genomicsbench_palisade_tpu.index import builder as IB
    from genomicsbench_palisade_tpu.ops import fmi_pipeline as FP

    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 5_000_000).astype(np.uint8)
    didx = IB.build_arrays(genome)
    index = {k: jnp.asarray(v) for k, v in didx.as_device_arrays().items()}
    b, rl = 512, 101
    enc = np.zeros((b, rl), np.int32)
    for i in range(b):
        s = int(rng.integers(0, len(genome) - rl))
        read = genome[s : s + rl].astype(np.int32)
        mut = rng.random(rl) < 0.02
        read[mut] = rng.integers(0, 4, int(mut.sum()))
        enc[i] = read
    rlens = np.full(b, rl, np.int32)
    dt, _ = _timeit_host(lambda: FP.fmi_pipeline_batch(index, enc, rlens),
                         iters=3)
    res = {"kernel": "fmi", "value": round(b / dt, 1), "unit": "reads/s",
           "batch": b, "engine": "device"}
    from genomicsbench_palisade_tpu.io.native import available, fmi_search_native

    if available():
        enc8 = enc.astype(np.int8)
        dt_h, _ = _timeit_host(lambda: fmi_search_native(didx, enc8, rlens),
                               iters=3)
        res["host_reads_per_s"] = round(b / dt_h, 1)
        gs = _bench_fmi_genome_scale()
        if gs is not None:
            res["host_genome_reads_per_s"] = gs
    return res


def _bench_fmi_genome_scale():
    """Host-engine rate on a 64 Mbp index (cache-miss regime).

    The 5 Mbp toy index above is cache-resident, so its host rate (~70k
    reads/s) reflects the serial engine's best case.  The reference's
    headline fmi number is hg38-scale, where every occ row misses — the
    regime the coroutine-interleaved scheduler (native/fmsearch.cpp:454,
    cp_occ > 32 MB) exists for.  64 Mbp gives a 64 MB cp_occ, past the
    threshold and past LLC, while keeping the one-time SA-IS build
    (cached under <repo>/build/) tolerable inside the bench run.
    """
    from genomicsbench_palisade_tpu.index import fmi_index as FI
    from genomicsbench_palisade_tpu.io.native import fmi_search_native

    mbp = 64
    cache = REPO / "build" / f"bench_fmi_idx{mbp}.npz"
    rng = np.random.default_rng(41)
    n = mbp * 1_000_000
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    if not cache.exists():
        from genomicsbench_palisade_tpu.index.builder import (
            build_arrays, save_npz_full)

        cache.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        idx = build_arrays(codes, sa_compression=True)
        save_npz_full(idx, str(cache))
        print(json.dumps({"note": "fmi genome-scale index built+cached",
                          "mbp": mbp,
                          "build_s": round(time.perf_counter() - t0, 1)}),
              file=sys.stderr, flush=True)
    try:
        didx = FI.load_npz(str(cache), idx_dtype=np.int64)
    except Exception:
        return None
    b, rl = 2048, 151
    starts = rng.integers(0, n - rl, b)
    enc = np.stack([codes[s:s + rl] for s in starts]).astype(np.int8)
    sub = rng.random(enc.shape) < 0.01
    enc[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.int8)
    rlens = np.full(b, rl, np.int32)
    dt, _ = _timeit_host(lambda: fmi_search_native(didx, enc, rlens),
                         iters=3)
    return round(b / dt, 1)



def bench_pileup():
    from genomicsbench_palisade_tpu.io.bam import BamRecord
    from genomicsbench_palisade_tpu.ops.pileup import calculate_pileup

    rng = np.random.default_rng(9)
    recs = []
    for i in range(2000):
        ln = 300
        recs.append(BamRecord(
            f"r{i}", 0, 0, int(rng.integers(0, 50000)), 60, [("M", ln)],
            rng.integers(1, 16, ln).astype(np.uint8),
            rng.integers(10, 40, ln).astype(np.uint8), {}))
    dt, out = _timeit_host(lambda: calculate_pileup(recs, 0, 0, 60000))
    assert out["n_cols"] > 0
    return {"kernel": "pileup", "value": round(2000 * 300 / dt / 1e6, 2),
            "unit": "Mbases/s", "reads": 2000, "len": 300}


def bench_dbg():
    """Platypus window assembly throughput (native/dbg.cpp engine):
    colored DBG build + bubble paths per 1.5 kb window, 60x80 bp reads."""
    from genomicsbench_palisade_tpu.io.native import available, dbg_window_native

    if not available():
        return {"kernel": "dbg", "error": "native lib not built"}
    rng = np.random.default_rng(12)
    n_win, w_len, n_reads, r_len = 24, 1500, 60, 80
    wins = []
    for _ in range(n_win):
        ref = "".join(rng.choice(list("ACGT"), w_len))
        reads = []
        for _ in range(n_reads):
            s = int(rng.integers(0, w_len - r_len))
            seq = list(ref[s : s + r_len])
            for pos in np.nonzero(rng.random(r_len) < 0.01)[0]:
                seq[pos] = "ACGT"[rng.integers(0, 4)]
            reads.append(("".join(seq), np.full(r_len, 35, np.uint8), 0))
        wins.append((ref, reads))
    def run():
        n_bub = 0
        for ref, reads in wins:
            _n_nodes, paths = dbg_window_native(ref, 0, reads, 15, 20, 2)
            n_bub += len(paths)
        return n_bub

    dt, n_bub = _timeit_host(run)
    return {"kernel": "dbg", "value": round(n_win * w_len / dt / 1e6, 3),
            "unit": "Mb-ref/s", "windows": n_win, "reads_per_window": n_reads}


def bench_poa():
    from genomicsbench_palisade_tpu.ops.poa import msa_consensus_batch

    rng = np.random.default_rng(6)
    def mk_window(length, n_seq):
        base = "".join(rng.choice(list("ACGT"), length))
        seqs = []
        for _ in range(n_seq):
            s = list(base)
            for pos in np.nonzero(rng.random(length) < 0.05)[0]:
                s[pos] = "ACGT"[rng.integers(0, 4)]
            seqs.append("".join(s))
        return seqs

    w_n, s_n, length = 32, 6, 200
    batches = [mk_window(length, s_n) for _ in range(w_n)]
    dt, out = _timeit_host(lambda: msa_consensus_batch(batches))
    assert all(out)
    res = {"kernel": "poa", "value": round(w_n * s_n / dt, 1),
           "unit": "seqs/s", "windows": w_n, "seqs": s_n, "len": length}
    # production host engine (native/poaalign.cpp) on the same windows
    from genomicsbench_palisade_tpu.ops.poa import msa_consensus_host

    dt_h, out_h = _timeit_host(lambda: msa_consensus_host(batches))
    if out_h is not None:
        assert out_h == out
        res["host_seqs_per_s"] = round(w_n * s_n / dt_h, 1)
    return res


def bench_abea():
    from genomicsbench_palisade_tpu.ops.abea import align_events_batch
    from genomicsbench_palisade_tpu.ops.oracle.abea import get_kmer_rank

    rng = np.random.default_rng(7)
    k = 6
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    b = 64
    seqs, evs = [], []
    for _ in range(b):
        seq = "".join(rng.choice(list("ACGT"), 500))
        raw = []
        for p in range(len(seq) - k + 1):
            r = get_kmer_rank(seq[p : p + k])
            raw.extend(model["level_mean"][r]
                       + rng.normal(0, 0.4, int(rng.integers(1, 3))))
        seqs.append(seq)
        evs.append(np.array(raw, np.float32))
    ones = [1.0] * b
    zeros = [0.0] * b
    dt, res = _timeit_host(
        lambda: align_events_batch(seqs, evs, model, ones, zeros,
                                   use_native=False),
        iters=3)
    assert all(res), "QC-dropped synthetic reads"
    out = {"kernel": "abea", "value": round(b / dt, 1), "unit": "reads/s",
           "b": b, "seq_len": 500}
    # production host engine (native/abeafill.cpp) on the same reads
    from genomicsbench_palisade_tpu.ops.abea import align_events_batch_native

    dt_h, res_h = _timeit_host(
        lambda: align_events_batch_native(seqs, evs, model, ones, zeros),
        iters=3)
    if res_h is not None:
        assert res_h == res
        out["host_reads_per_s"] = round(b / dt_h, 1)
    return out


def bench_grm():
    import jax
    import jax.numpy as jnp

    from genomicsbench_palisade_tpu.ops import grm as G

    rng = np.random.default_rng(5)
    m, n = 32768, 2048  # variants x samples
    geno = rng.choice([0, 1, 2, 3], size=(m, n), p=[0.5, 0.3, 0.15, 0.05]).astype(np.int8)
    # device-resident inputs: measure the normalize+matmul dispatch itself
    miss = geno == 3
    g64 = np.where(miss, 0.0, geno.astype(np.float64))
    freqs = g64.sum(1) / np.maximum(2.0 * (~miss).sum(1), 1.0)
    var = 2.0 * freqs * (1.0 - freqs)
    ok = var > G.K_SMALL_EPSILON
    isd = np.where(ok, 1.0 / np.sqrt(np.where(ok, var, 1.0)), 0.0)
    args = (jax.device_put(geno), jax.device_put((2 * freqs).astype(np.float32)),
            jax.device_put(isd.astype(np.float32)), jax.device_put(ok))
    dt = _timeit(lambda: G._grm_device(*args, block=8192))
    flops = 2 * m * n * n * 2  # Z^T Z and V^T V
    return {"kernel": "grm", "value": round(flops / dt / 1e12, 3),
            "unit": "TFLOP/s", "m": m, "n": n}


BENCHES = (bench_phmm, bench_bsw, bench_chain, bench_kmer, bench_fmi,
           bench_poa, bench_abea, bench_pileup, bench_dbg, bench_grm)


def run_all(benches=BENCHES) -> tuple[list, int]:
    """Runs each bench, printing one JSON line per kernel with the
    device; returns (records, failures)."""
    dev = device_info()
    results, failures = [], 0
    for fn in benches:
        try:
            r = fn()
        except Exception as e:  # record the failure, keep going
            r = {"kernel": fn.__name__, "error": repr(e)[:200]}
        if "error" in r:
            failures += 1
        r["device"] = dev
        results.append(r)
        print(json.dumps(r), flush=True)
    return results, failures


def main():
    _, failures = run_all()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
