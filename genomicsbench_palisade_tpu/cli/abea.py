"""abea driver: `python -m genomicsbench_palisade_tpu.cli.abea
--reads <fasta> --raw <signals.npz|.fast5> --model <pore_model.tsv>`,
or the f5c surface `-b <reads.bam> -g <genome.fa> -r <reads.fastq>`
(scripts/run-gpu.sh:32 `f5c eventalign -b ... -g ... -r ... -B 3.7M`).

Reproduces the f5c eventalign pipeline the reference benchmarks
(benchmarks/abea/src/main.c:70 meth_main -> f5c.c event_db/align_db ->
align.c / align.cu): per read, detect events from the raw signal
(events.c getevents), estimate shift/scale by method of moments
(align.c:49-95), run the adaptive banded event alignment (the
engines in ops.abea), and emit the eventalign TSV plus stderr timers.

Without -b/-g, pairs are emitted in read coordinates.  With -b/-g the
full eventalign mode runs: postalign + WLS recalibration + QC gates
(f5c.c scaling_single:1263-1330), reference-space profile-HMM realign
(eventalign.c realign_read:1942), and the verbatim
emit_event_alignment_tsv columns — all golden-tested byte-exact against
the reference-built harness (tests/test_eventalign.py).  The reference
reads signals from fast5 via a readdb index; this driver takes signals
keyed by read name (--raw npz always, fast5 when h5py is present).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..io.fastq import read_sequences
from ..io.signal import load_pore_model, load_signals_fast5, load_signals_npz
from ..ops import abea as A
from ..ops import eventalign as PE
from ..ops.oracle import events as E
from ..ops.oracle.abea import KMER_SIZE


def emit_read(name, seq, events, shift, scale, pairs, model, out):
    from ..ops.oracle.abea import get_kmer_rank

    for kmer_idx, event_idx in pairs:
        kmer = seq[kmer_idx:kmer_idx + KMER_SIZE]
        rank = get_kmer_rank(kmer)
        ev = events[event_idx]
        std_level = (ev["mean"] - shift - scale * model["level_mean"][rank]) / (
            scale * model["level_stdv"][rank]
        )
        out.write(
            f"{name}\t{kmer_idx}\t{kmer}\t{event_idx}\t"
            f"{ev['mean']:.2f}\t{ev['stdv']:.3f}\t{ev['length']:.0f}\t"
            f"{kmer}\t{model['level_mean'][rank]:.2f}\t"
            f"{model['level_stdv'][rank]:.2f}\t{std_level:.2f}\n"
        )
    return len(pairs)


def eventalign_bam(args, model, signals, out):
    """Full f5c eventalign mode (-b/-g): BAM-driven realign to the
    reference with the f5c TSV columns + stderr entry summary
    (f5c.c:1677, meth_main.c:613-615)."""
    from ..io import bam as B
    from ..ops.oracle import eventalign as EA

    genome = {}
    for name, seq, _q in read_sequences(args.genome):
        genome[str(name).split(None, 1)[0]] = seq.upper()
    reads = {}
    for name, seq, _q in read_sequences(args.reads):
        reads[str(name).split(None, 1)[0]] = seq
    region_start = region_end = -1
    if args.window:
        # f5c -w: hts_parse_reg semantics — 0-based begin, end exclusive;
        # the bounds also clip the realign (f5c.c:353, eventalign.c:1404)
        ctg, _, span = args.window.partition(":")
        refs, records = B.read_bam(args.bam, parse_tags=True)
        ref_names = [r[0] for r in refs]
        if span:
            b, _, e = span.partition("-")
            region_start = int(b) - 1
            region_end = int(e) if e else (1 << 62)
        try:  # indexed region access when a .bai is present
            records = B.read_bam_region(
                args.bam, ctg, max(region_start, 0),
                region_end if region_end != -1 else (1 << 62),
                parse_tags=True)
        except (FileNotFoundError, OSError):
            rid = ref_names.index(ctg)
            records = [
                r for r in records
                if r.ref_id == rid
                and (region_end == -1 or r.pos < region_end)
                and r.pos + B._cigar_ref_len(r.cigar) > max(region_start, 0)]
    else:
        refs, records = B.read_bam(args.bam, parse_tags=True)
        ref_names = [r[0] for r in refs]

    out.write(EA.emit_tsv_header(args.print_read_names))
    t0 = time.perf_counter()
    total = qc_fail = no_calib = no_aln = bad_sig = 0
    read_index = 0
    n_rows = 0
    summary_fp = open(args.summary, "w") if args.summary else None

    # pass 1: per-read host prep (events + MoM), collecting the batch for
    # ONE device ABEA dispatch per shape bucket (ops.abea batches/buckets)
    work = []
    for rec in records:
        read_idx = read_index  # every record consumes an index (f5c.c:713)
        read_index += 1
        if rec.flag & 0x4 or rec.mapq < args.min_mapq:
            continue
        if rec.flag & 0x100 and args.secondary != "yes":
            continue
        total += 1
        seq = reads.get(rec.name)
        sig = signals.get(rec.name)
        if seq is None or sig is None:
            bad_sig += 1
            continue
        events = E.getevents(np.asarray(sig, np.float32))
        if len(events) < 2 or len(seq) < KMER_SIZE + 1:
            no_aln += 1
            continue
        shift, scale = PE.estimate_scalings_mom_fast(seq, model, events)
        work.append((rec, read_idx, seq, events, float(shift), float(scale)))

    all_pairs = A.align_events_batch(
        [w[2] for w in work], [w[3]["mean"] for w in work], model,
        [w[5] for w in work], [w[4] for w in work]) if work else []

    for (rec, read_idx, seq, events, _shift, _scale), pairs in zip(
            work, all_pairs):
        status, sc, b2e, epb = PE.scaling_read_fast(seq, events, pairs,
                                                     model)
        if status & EA.FAILED_ALIGNMENT:
            no_aln += 1
            continue
        if status & EA.FAILED_CALIBRATION:
            no_calib += 1
            continue
        if status & EA.FAILED_QUALITY_CHK:
            qc_fail += 1
            continue
        contig = ref_names[rec.ref_id]
        ref_len = B._cigar_ref_len(rec.cigar)
        ref_segment = genome[contig][rec.pos:rec.pos + ref_len]
        # hot path: raw realign arrays -> vectorized emit, no dict layer
        # (the summary path still needs the dict-format alignments)
        lines = alignments = None
        if summary_fp is None:
            res = PE.realign_read_arrays(
                rec, ref_segment, rec.pos, len(seq), events, sc, model,
                b2e, epb, region_start=region_start, region_end=region_end)
            if res is not None:
                rp, ei, st, ref_seq = res
                blk = PE.emit_tsv_text_arrays(
                    events, model, sc, rp, ei, st, ref_seq, rec.pos,
                    rec.is_reverse, read_idx, rec.name, contig,
                    args.sample_rate,
                    print_read_names=args.print_read_names,
                    scale_events=args.scale_events)
                if blk is not None:
                    text, k = blk
                    out.write(text)
                    n_rows += k
                    continue
                lines = PE.emit_tsv_lines_arrays(
                    events, model, sc, rp, ei, st, ref_seq, rec.pos,
                    rec.is_reverse, read_idx, rec.name, contig,
                    args.sample_rate,
                    print_read_names=args.print_read_names,
                    scale_events=args.scale_events)
        if lines is None:
            alignments = PE.realign_read(
                rec, ref_segment, rec.pos, len(seq), events, sc, model,
                b2e, epb, read_idx,
                region_start=region_start, region_end=region_end)
            lines = PE.emit_tsv_lines_fast(
                events, model, sc, alignments, read_idx, rec.name, contig,
                args.sample_rate, print_read_names=args.print_read_names,
                scale_events=args.scale_events)
        for line in lines:
            out.write(line)
            n_rows += 1
        if summary_fp is not None and alignments:
            s = EA.summarize_alignment(events, model, sc, alignments,
                                       args.sample_rate,
                                       nm=rec.tags.get("NM", 0))
            summary_fp.write(
                f"{read_idx}\t{rec.name}\t.\tdna\ttemplate\t"
                f"{s['num_events']}\t{s['num_steps']}\t{s['num_skips']}\t"
                f"{s['num_stays']}\t"
                f"{s['sum_duration'] / args.sample_rate:.2f}\t"
                f"{float(sc['shift']):.3f}\t{float(sc['scale']):.3f}\t"
                f"0.000\t{float(sc['var']):.3f}\n")
    if summary_fp is not None:
        summary_fp.close()
    runtime = time.perf_counter() - t0
    print(f"[eventalign] total entries: {total}, qc fail: {qc_fail}, "
          f"could not calibrate: {no_calib}, no alignment: {no_aln}, "
          f"bad fast5: {bad_sig}", file=sys.stderr)
    print(f"[eventalign] {n_rows} TSV rows", file=sys.stderr)
    print(f"Kernel time: {runtime:.3f} sec", file=sys.stderr)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="abea")
    ap.add_argument("--reads", "-r", required=True,
                    help="FASTA/FASTQ of read sequences")
    ap.add_argument("--raw", required=True,
                    help=".npz (name->signal pA) or .fast5 raw signals")
    ap.add_argument("--model", required=True, help="pore model TSV (nanopolish format)")
    ap.add_argument("-b", "--bam", default=None,
                    help="alignments; enables full eventalign mode")
    ap.add_argument("-g", "--genome", default=None, help="reference FASTA")
    ap.add_argument("-B", "--max-bases", default=None,
                    help="accepted for f5c CLI parity (batching is automatic)")
    ap.add_argument("-K", "--batchsize", type=int, default=512,
                    help="accepted for f5c CLI parity")
    ap.add_argument("-w", "--window", default=None,
                    help="limit to region ctg[:start-end] (f5c -w; uses the "
                         ".bai index when present)")
    ap.add_argument("--min-mapq", type=int, default=20)
    ap.add_argument("--secondary", choices=("yes", "no"), default="no",
                    help="process secondary alignments (f5c --secondary)")
    ap.add_argument("--sample-rate", type=float, default=4000.0)
    ap.add_argument("--summary", default=None, help="per-read summary TSV")
    ap.add_argument("--print-read-names", action="store_true")
    ap.add_argument("--scale-events", action="store_true")
    ap.add_argument("-o", "--output", default="-")
    ap.add_argument("-t", "--threads", type=int, default=1, help="ignored (device-parallel)")
    args = ap.parse_args(argv)

    from ..utils.compile_cache import enable as _enable_cache
    _enable_cache()

    model = load_pore_model(args.model)
    if args.raw.endswith(".fast5"):
        signals = load_signals_fast5(args.raw)
    else:
        signals = load_signals_npz(args.raw)

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    if args.bam is not None:
        if args.genome is None:
            ap.error("-b requires -g <genome.fa>")
        rc = eventalign_bam(args, model, signals, out)
        if out is not sys.stdout:
            out.close()
        return rc
    out.write("contig\tposition\treference_kmer\tevent_index\t"
              "event_level_mean\tevent_stdv\tevent_length\tmodel_kmer\t"
              "model_mean\tmodel_stdv\tstandardized_level\n")

    n_aligned = n_reads = 0
    t0 = time.perf_counter()
    # host: event detection + MoM scaling per read; device: ONE vmapped
    # band fill per shape bucket (ops.abea.align_events_batch)
    names, seqs, evs, shifts, scales = [], [], [], [], []
    for name, seq, _q in read_sequences(args.reads):
        if name not in signals:
            print(f"WARNING: no raw signal for read {name}, skipped", file=sys.stderr)
            continue
        n_reads += 1
        events = E.getevents(signals[name])
        if len(events) < 2 or len(seq) < KMER_SIZE + 1:
            continue
        shift, scale = PE.estimate_scalings_mom_fast(seq, model, events)
        names.append(name)
        seqs.append(seq)
        evs.append(events)
        shifts.append(float(shift))
        scales.append(float(scale))
    all_pairs = A.align_events_batch(
        seqs, [e["mean"] for e in evs], model, scales, shifts)
    for name, seq, events, shift, scale, pairs in zip(
            names, seqs, evs, shifts, scales, all_pairs):
        n_aligned += emit_read(name, seq, events, shift, scale, pairs, model, out)
    runtime = time.perf_counter() - t0

    if out is not sys.stdout:
        out.close()
    print(f"[eventalign] {n_reads} reads, {n_aligned} aligned event-kmer pairs",
          file=sys.stderr)
    print(f"Kernel time: {runtime:.3f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
