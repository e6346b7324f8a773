"""Randomized parity sweep: every engine vs its semantic oracle.

Runs rounds of randomized inputs through each (device-scan | native C++)
path and its Python/oracle spec until --seconds elapses, printing one
line per suite with the pass count.  CPU-only, so it exercises the
exact-semantics layers; chip_smoke.py checks the device kernels on the
GPU.

Usage: python tools/fuzz_parity.py [--seconds 300] [--seed 0]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _force_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")


def fuzz_bsw(rng):
    from genomicsbench_palisade_tpu.ops import bsw as W
    from genomicsbench_palisade_tpu.ops.oracle import bsw as WO

    pairs = []
    for _ in range(8):
        ql, tl = int(rng.integers(1, 90)), int(rng.integers(1, 150))
        pairs.append((rng.integers(0, 5, ql), rng.integers(0, 5, tl),
                      int(rng.integers(0, 120))))
    batch = W.prepare_pairs(pairs, q_pad=128, t_pad=192)
    got = {k: np.asarray(v) for k, v in W.bsw_batch(batch).items()}
    for i, (q, t, h0) in enumerate(pairs):
        want = WO.scalar_banded_swa(q, t, h0)
        for key, val in want.items():
            assert got[key][i] == val, (key, i)


def fuzz_chain(rng):
    from genomicsbench_palisade_tpu.ops import chain as C
    from genomicsbench_palisade_tpu.ops.oracle import chain as CO

    n = int(rng.integers(2, 300))
    xs = np.cumsum(rng.integers(1, 60, n)).astype(np.int64) + 500
    ys = np.maximum(xs + rng.integers(-400, 400, n), 0).astype(np.int64)
    q = float(rng.uniform(3, 45))
    call = CO.ChainCall(n=n, avg_qspan=q, max_dist_x=5000, max_dist_y=5000,
                        bw=500, n_segs=1, x=xs.astype(np.uint64),
                        y=ys.astype(np.uint64))
    want = CO.chain_dp(call)
    prep = C.prepare_call(xs.astype(np.uint64), ys.astype(np.uint64), q)
    scores, parents, peaks = C.chain_call(prep)
    np.testing.assert_array_equal(scores, want["scores"])
    np.testing.assert_array_equal(parents, want["parents"])
    np.testing.assert_array_equal(peaks, want["peak_scores"])


def fuzz_fmi(rng):
    from genomicsbench_palisade_tpu.index.builder import build_arrays
    from genomicsbench_palisade_tpu.io.native import fmi_search_native
    from genomicsbench_palisade_tpu.ops.oracle import fmi as FO

    genome = rng.integers(0, 4, int(rng.integers(200, 3000))).astype(np.uint8)
    didx = build_arrays(genome)
    oidx = FO.build_index("".join("ACGT"[c] for c in genome))
    b, rl = 6, int(rng.integers(25, 80))
    enc = np.full((b, rl), 4, np.int8)
    for i in range(b):
        s = int(rng.integers(0, len(genome) - rl))
        r = genome[s : s + rl].astype(np.int8)
        mut = rng.random(rl) < 0.05
        r[mut] = rng.integers(0, 5, int(mut.sum()))
        enc[i] = r
    out = fmi_search_native(didx, enc, np.full(b, rl, np.int32))
    if out is None:
        return
    allm, n1, n2, n3 = out
    split_len = int(19 * 1.5 + 0.499)
    want_n1 = want_n2 = want_n3 = 0
    for i in range(b):
        er = enc[i].astype(np.int64)
        m1 = FO.get_smems_all_pos(oidx, er, 1, 19)
        want_n1 += len(m1)
        for m in m1:  # reseed in emit order (fmi.cpp phase 2)
            if (m["n"] + 1 - m["m"]) >= split_len and m["s"] <= 10:
                mid = (m["n"] + 1 + m["m"]) >> 1
                want_n2 += len(FO.get_smems_one_pos(
                    oidx, er, mid, m["s"] + 1, 19)[0])
        want_n3 += len(FO.bwt_seed_strategy_one_read(oidx, er, 20, 20))
    assert (n1, n2, n3) == (want_n1, want_n2, want_n3), (
        (n1, n2, n3), (want_n1, want_n2, want_n3))


def fuzz_minimizers(rng):
    from collections import Counter

    from genomicsbench_palisade_tpu.io.native import minimizer_counts_native
    from genomicsbench_palisade_tpu.ops.oracle import kmer as KO

    reads = [rng.integers(0, 4, int(rng.integers(18, 300))).astype(np.uint8)
             for _ in range(int(rng.integers(1, 5)))]
    k = int(rng.choice([7, 15, 17]))
    w = int(rng.choice([1, 3, 5, 8]))
    got = minimizer_counts_native(reads, k, w, 0)
    if got is None:
        return
    want = Counter()
    for codes in reads:
        if len(codes) - k <= 0:
            continue
        for _p, fwd in KO.yield_minimizers(codes, k, w):
            rc = KO.revcomp_code(fwd, k)
            want[min(fwd, rc)] += 1
    assert got == dict(want)


def fuzz_dbg(rng):
    from genomicsbench_palisade_tpu.io.native import dbg_window_native
    from genomicsbench_palisade_tpu.ops.dbg import assemble_window, path_sequence

    ln = int(rng.integers(100, 400))
    ref = "".join(rng.choice(list("ACGTN"), p=[.24, .24, .24, .24, .04],
                             size=ln))
    reads = []
    for _ in range(int(rng.integers(1, 15))):
        s = int(rng.integers(0, max(ln - 50, 1)))
        seq = list(ref[s : s + 50].replace("N", "A"))
        for pos in np.nonzero(rng.random(len(seq)) < 0.06)[0]:
            seq[pos] = "ACGTN"[rng.integers(0, 5)]
        reads.append(("".join(seq), rng.integers(5, 41, len(seq)).astype(np.uint8),
                      0x200 if rng.random() < 0.1 else 0))
    g, bubbles = assemble_window(ref, 1, reads, kmer_size=15,
                                 min_qual=20, min_reads=2)
    nat = dbg_window_native(ref, 1, reads, 15, 20, 2)
    if nat is None:
        return
    assert nat == (len(g.nodes), [path_sequence(p, 15) for p in bubbles])


def fuzz_poa_native(rng):
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops import poa as P
    from genomicsbench_palisade_tpu.ops.oracle.poa import PoaGraph

    if not available():
        return
    base = "".join(rng.choice(list("ACGT"), int(rng.integers(25, 90))))
    seqs = []
    for _ in range(int(rng.integers(2, 6))):
        s = []
        for ch in base:
            u = rng.random()
            if u < 0.05:
                continue
            s.append(ch if u > 0.13 else "ACGT"[rng.integers(0, 4)])
            if u > 0.95:
                s.append("ACGT"[rng.integers(0, 4)])
        seqs.append("".join(s) or "A")
    gn, gp = P.NativePoaGraph(), PoaGraph()
    for s in seqs:
        an = P.align_batch([gn], [s])[0]
        ap = P.align_batch([gp], [s])[0]
        assert an == ap
        gn.add_alignment(an, s)
        gp.add_alignment(ap, s)
    assert gn.n_nodes() == len(gp.nodes)
    assert gn.generate_consensus() == gp.generate_consensus()


def fuzz_ctc(rng):
    from genomicsbench_palisade_tpu.io.native import ctc_beam_native
    from genomicsbench_palisade_tpu.models import bonito as BM

    t = int(rng.integers(2, 50))
    logits = rng.normal(0, float(rng.uniform(0.5, 3.0)), (t, 5))
    lp = np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
                ).astype(np.float32)
    nat = ctc_beam_native(lp, 5, 1e-3)
    if nat is None:
        return
    from genomicsbench_palisade_tpu.io import native as N

    old = N.ctc_beam_native
    N.ctc_beam_native = lambda *a: None
    try:
        py = BM.beam_search_decode(lp)
    finally:
        N.ctc_beam_native = old
    assert "".join(BM.DEFAULT_ALPHABET[c] for c in nat) == py


def fuzz_abea_tb(rng):
    import functools

    import jax

    from genomicsbench_palisade_tpu.ops.abea import (
        _bucket, _prep_read, _traceback_batch, abea_fill_bands)
    from genomicsbench_palisade_tpu.ops.oracle.abea import get_kmer_rank

    k = 6
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    seqs, evs = [], []
    for _ in range(3):
        seq = "".join(rng.choice(list("ACGT"), int(rng.integers(40, 110))))
        raw = []
        for p in range(len(seq) - k + 1):
            r = get_kmer_rank(seq[p : p + k])
            raw.extend(model["level_mean"][r]
                       + rng.normal(0, 0.5, int(rng.integers(1, 3))))
        seqs.append(seq)
        evs.append(np.array(raw, np.float32))
    bw = 100
    e_buck = _bucket(max(len(e) for e in evs))
    k_buck = _bucket(max(len(s) - k + 1 for s in seqs))
    lm = np.asarray(model["level_mean"], np.float32)
    ls = np.asarray(model["level_stdv"], np.float32)
    lls = np.asarray(model["level_log_stdv"], np.float32)
    fill = functools.partial(abea_fill_bands, n_bands_pad=e_buck + k_buck + 2)
    tg, bg, lg, kg = [], [], [], []
    for seq, ev in zip(seqs, evs):
        ev_pad, ranks_pad, lp_consts, trim_vals, kr = _prep_read(
            seq, ev, bw, k, e_buck, k_buck)
        tr, bes, _, lv = jax.jit(fill)(
            ev_pad, ranks_pad, len(ev), len(seq) - k + 1, lm, ls, lls,
            np.float32(1.0), np.float32(0.0), lp_consts, trim_vals)
        nb = len(ev) + len(seq) - k + 1 + 2
        tg.append(np.asarray(tr)[: nb - 2])
        bg.append(np.asarray(bes)[: nb - 2])
        lg.append(np.asarray(lv)[: nb - 2].astype(np.float64))
        kg.append(kr)
    args = (seqs, evs, model, [1.0] * 3, [0.0] * 3, tg, bg, lg, kg, bw, k)
    nat = _traceback_batch(*args, use_native=True)
    py = _traceback_batch(*args, use_native=False)
    assert nat == py


def fuzz_phmm_f32_sweep(rng):
    """The float32 numpy sweep (the CUDA kernel's bit-exact reference)
    vs the scalar f32 oracle, on HIGH-LIKELIHOOD subsequence pairs — the
    data class that exposed padded-row inf/NaN poisoning; random pairs
    never trigger it."""
    from genomicsbench_palisade_tpu.ops import phmm as P
    from genomicsbench_palisade_tpu.ops.oracle import phmm as O
    from genomicsbench_palisade_tpu.ops.phmm_f64 import phmm_forward_sweep

    reads, haps, pairs = [], [], []
    for i in range(4):
        rl = int(rng.integers(8, 60))
        hl = int(rng.integers(rl + 2, 96))
        hap = rng.integers(0, 4, hl)
        start = int(rng.integers(0, hl - rl))
        read = hap[start : start + rl].copy()
        noise = rng.random(rl) < 0.05
        read[noise] = rng.integers(0, 4, int(noise.sum()))
        reads.append({"bases": read,
                      "q": rng.integers(20, 62, rl),
                      "i": rng.integers(20, 62, rl),
                      "d": rng.integers(20, 62, rl),
                      "c": rng.integers(20, 62, rl)})
        haps.append(hap)
        pairs.append((i, i))
    batch = P.prepare_batch(reads, haps, pairs, r_pad=64, h_pad=128)
    got = phmm_forward_sweep(batch, np.float32)
    for i, r in enumerate(reads):
        want = O.compute_full_prob(r["bases"], haps[i], r["q"], r["i"],
                                   r["d"], r["c"], np.float32)
        assert got[i] == want, (i, got[i], want)


def fuzz_kmer_engines(rng):
    """count_kmers (one-shot device) vs count_kmers_batched (streamed
    accumulator) vs count_kmers_host (native hash) — random coverage
    reads with errors + Ns, random batch sizes crossing kmer runs."""
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops import kmer as K

    genome = rng.integers(0, 5, int(rng.integers(8_000, 30_000))
                          ).astype(np.uint8)
    genome = np.where(genome >= 4, 3, genome).astype(np.uint8)
    reads = []
    for _ in range(int(rng.integers(4, 24))):
        ln = int(rng.integers(5_100, 6_500))
        if ln >= len(genome):
            ln = len(genome) - 1
        s = int(rng.integers(0, len(genome) - ln))
        r = genome[s : s + ln].copy()
        mut = rng.random(ln) < 0.01
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append(r)
    want = K.count_kmers(reads)
    got_b = K.count_kmers_batched(
        reads, batch_bases=int(rng.integers(8_000, 40_000)), cap=1 << 18)
    assert got_b == want, (got_b, want)
    if available():
        got_h = K.count_kmers_host(reads)
        assert got_h == want, (got_h, want)


def fuzz_poa_align_engine(rng):
    """Native convex align engine (poaalign.cpp) vs oracle, all types."""
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops.oracle import poa as PO
    from genomicsbench_palisade_tpu.ops.poa import NativePoaGraph

    if not available():
        return
    base = "".join(rng.choice(list("ACGT"), int(rng.integers(20, 120))))
    g, gn = PO.PoaGraph(), NativePoaGraph()
    for _ in range(int(rng.integers(2, 5))):
        s = "".join(ch for ch in base if rng.random() > 0.08) or "A"
        at = ("nw", "sw", "ov")[int(rng.integers(3))]
        a_or = PO.convex_align(s, g, align_type=at)
        assert gn.align(s, align_type=at) == a_or
        grow = a_or if at == "nw" else PO.convex_align(s, g)
        g.add_alignment(grow, s)
        gn.add_alignment(grow, s)


def fuzz_abea_fill(rng):
    """Native banded fill (abeafill.cpp) vs oracle incl. QC drops."""
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops.abea import align_events_batch_native
    from genomicsbench_palisade_tpu.ops.oracle import abea as AO

    if not available():
        return
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    seq = "".join(rng.choice(list("ACGT"), int(rng.integers(40, 300))))
    ev = []
    for i in range(len(seq) - 5):
        r = AO.get_kmer_rank(seq[i:i + 6])
        lv = model["level_mean"][r]
        noise = 0.5 if rng.random() < 0.8 else 20.0
        ev.extend(lv + rng.normal(0, noise, int(rng.integers(1, 4))))
    ev = np.asarray(ev, np.float32)
    sc = float(rng.uniform(0.85, 1.15))
    sh = float(rng.uniform(-3, 3))
    got = align_events_batch_native([seq], [ev], model, [sc], [sh])[0]
    assert got == AO.align(seq, ev, model, sc, sh)


def fuzz_phmm_f64(rng):
    """Native C double pass vs the numpy sweep (bit-exact)."""
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops import phmm as P
    from genomicsbench_palisade_tpu.ops.phmm_f64 import (
        phmm_forward_f64_native, phmm_forward_sweep)

    if not available():
        return
    reads, haps, pairs = [], [], []
    for k in range(8):
        rl = int(rng.integers(4, 100))
        reads.append({"bases": rng.integers(0, 5, rl),
                      "q": rng.integers(6, 60, rl),
                      "i": rng.integers(20, 50, rl),
                      "d": rng.integers(20, 50, rl),
                      "c": rng.integers(5, 30, rl)})
        haps.append(rng.integers(0, 5, int(rng.integers(5, 250))))
        pairs.append((k, k))
    batch = P.prepare_batch(reads, haps, pairs)
    bn = {k: np.asarray(v) for k, v in batch.items()}
    np.testing.assert_array_equal(phmm_forward_f64_native(bn),
                                  phmm_forward_sweep(bn))


def fuzz_pileup_region(rng):
    """Fused native region pileup vs the record-object path on a
    synthetic indexed BAM (random cigars incl. I/D/S, both strands)."""
    import pathlib
    import tempfile

    from genomicsbench_palisade_tpu.io import bam as B
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops.pileup import (
        calculate_pileup, calculate_pileup_region)

    if not available():
        return
    ref_len = int(rng.integers(300, 2000))
    idx16 = {c: i for i, c in enumerate(B.SEQ_NT16_STR)}
    genome = "".join(rng.choice(list("ACGT"), ref_len))
    rows = []
    n = int(rng.integers(5, 40))
    positions = np.sort(rng.integers(0, max(1, ref_len - 80), n))
    for i, p in enumerate(positions):
        L = int(rng.integers(20, 70))
        seq = list(genome[p:p + L])
        cig = [("M", len(seq))]
        u = rng.random()
        if u < 0.3 and len(seq) > 12:
            at = int(rng.integers(4, len(seq) - 4))
            ins = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 5))))
            seq = seq[:at] + list(ins) + seq[at:]
            cig = [("M", at), ("I", len(ins)), ("M", len(seq) - at - len(ins))]
        elif u < 0.5 and len(seq) > 14:
            x = int(rng.integers(4, len(seq) // 2))
            d = int(rng.integers(1, 5))
            seq = seq[:x] + seq[x + d:]
            cig = [("M", x), ("D", d), ("M", len(seq) - x)]
        elif u < 0.65 and len(seq) > 10:
            sc = int(rng.integers(1, 5))
            cig = [("S", sc), ("M", len(seq) - sc)]
        rows.append(B.BamRecord(
            name=f"r{i}", flag=16 if rng.random() < 0.5 else 0, ref_id=0,
            pos=int(p), mapq=int(rng.integers(0, 60)),
            cigar=cig,
            seq_nt16=np.array([idx16[c] for c in seq], np.uint8),
            qual=rng.integers(1, 40, len(seq)).astype(np.uint8), tags={}))
    with tempfile.TemporaryDirectory() as td:
        bam = pathlib.Path(td) / "f.bam"
        B.write_bam(str(bam), [("tig1", ref_len)], rows)
        B.build_bai(str(bam))
        index = B.read_bai(str(bam) + ".bai")
        beg = int(rng.integers(0, ref_len // 2))
        end = int(rng.integers(beg + 50, ref_len + 1))
        _refs, recs = B.read_bam_region(str(bam), "tig1", beg, end,
                                        index=index)
        want = calculate_pileup(recs, 0, beg, end)
        got = calculate_pileup_region(str(bam), "tig1", beg, end,
                                      index=index)
        np.testing.assert_array_equal(got["major"], want["major"])
        np.testing.assert_array_equal(got["minor"], want["minor"])
        np.testing.assert_array_equal(got["matrix"], want["matrix"])


SUITES = [
    ("bsw", fuzz_bsw), ("chain", fuzz_chain), ("fmi", fuzz_fmi),
    ("minimizers", fuzz_minimizers), ("dbg", fuzz_dbg),
    ("poa-native", fuzz_poa_native), ("ctc-beam", fuzz_ctc),
    ("abea-tb", fuzz_abea_tb), ("phmm-f32", fuzz_phmm_f32_sweep),
    ("kmer-engines", fuzz_kmer_engines),
    ("poa-align-engine", fuzz_poa_align_engine),
    ("abea-fill", fuzz_abea_fill), ("phmm-f64", fuzz_phmm_f64),
    ("pileup-region", fuzz_pileup_region),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    _force_cpu()
    rng = np.random.default_rng(args.seed)
    counts = {name: 0 for name, _ in SUITES}
    deadline = time.time() + args.seconds
    failures = 0
    while time.time() < deadline:
        for name, fn in SUITES:
            try:
                fn(rng)
                counts[name] += 1
            except Exception as e:  # noqa: BLE001 — report and continue
                failures += 1
                print(f"FAIL {name}: {type(e).__name__}: {str(e)[:200]}")
            if time.time() >= deadline:
                break
    for name, c in counts.items():
        print(f"OK   {name}: {c} rounds")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
