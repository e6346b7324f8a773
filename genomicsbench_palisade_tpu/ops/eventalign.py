"""Production f5c eventalign-mode postprocessing (host path).

The semantics ground truth is ops/oracle/eventalign.py (byte-exact vs the
reference-built goldens in tests/fixtures/eventalign_golden.json); this
module runs the same chain with the hot profile-HMM realign dispatched to
the native engine (native/eventalign.cpp) when built, reconstructing the
kmer strings from positions — for non-rc reads model_kmer == ref_kmer, for
rc reads model_kmer == revcomp(ref_kmer), and B states emit N^k
(eventalign.c:1468-1501).
"""

from __future__ import annotations

import numpy as np

from ..io.native import eventalign_realign_native
from .oracle import eventalign as EA
from .oracle.abea import KMER_SIZE

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def realign_read_arrays(record, ref_segment, ref_offset, read_length,
                        events, sc, model, b2e, events_per_base,
                        region_start=-1, region_end=-1):
    """Native profile-HMM realign, raw-array interface: returns
    (ref_positions i64, event_indices i64, states bytes, ref_seq str)
    or None when the native engine is absent.  The hot CLI path feeds
    these straight to emit_tsv_lines_arrays, skipping the ~800-dict/
    read event_alignment interface realign_read builds."""
    ref_seq = EA.disambiguate(ref_segment)
    segments = EA.get_aligned_segments(record, 1)
    max_kmer_idx = read_length - KMER_SIZE
    trimmed = []
    for seg in segments:
        if region_start != -1 and region_end != -1:
            seg = EA.trim_aligned_pairs_to_ref_region(
                seg, region_start, region_end)
        trimmed.append(EA.trim_aligned_pairs_to_kmer(seg, max_kmer_idx))
    ref_codes = np.frombuffer(
        ref_seq.encode().translate(bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))),
        np.uint8)
    res = eventalign_realign_native(
        ref_codes, ref_offset, trimmed, record.is_reverse, read_length,
        events["mean"], sc, model, b2e, events_per_base)
    if res is None:
        return None
    rp, ei, st = res
    return rp, ei, st, ref_seq


def realign_read(record, ref_segment, ref_offset, read_length, events, sc,
                 model, b2e, events_per_base, read_idx,
                 region_start=-1, region_end=-1, use_native=None):
    """align_read_to_ref with native dispatch; returns the oracle's
    event_alignment dict list."""
    if use_native is not False:
        res = realign_read_arrays(
            record, ref_segment, ref_offset, read_length, events, sc,
            model, b2e, events_per_base, region_start, region_end)
        if res is not None:
            rp, ei, st, ref_seq = res
            rc = record.is_reverse
            out = []
            for ref_position, event_idx, state in zip(
                    rp.tolist(), ei.tolist(), st.decode()):
                ref_kmer = ref_seq[ref_position - ref_offset:
                                   ref_position - ref_offset + KMER_SIZE]
                if state == "B":
                    model_kmer = "N" * KMER_SIZE
                elif rc:
                    model_kmer = EA.reverse_complement(ref_kmer)
                else:
                    model_kmer = ref_kmer
                out.append({"ref_position": ref_position,
                            "ref_kmer": ref_kmer, "read_idx": read_idx,
                            "event_idx": event_idx, "rc": rc,
                            "model_kmer": model_kmer, "hmm_state": state})
            return out
        if use_native:
            raise RuntimeError("native eventalign engine not built")
    return EA.align_read_to_ref(
        record, ref_segment, ref_offset, read_length, events, sc, model,
        b2e, events_per_base, read_idx, region_start, region_end)


def emit_tsv_lines_fast(events, model, sc, alignments, read_index,
                        read_name, ref_name, sample_rate,
                        print_read_names=False, scale_events=False):
    """Vectorized emit_event_alignment_tsv — byte-identical to the
    oracle's emit_tsv_lines (tests + the 25 reference-built goldens
    assert it) but with the per-row float op tree computed as
    elementwise f32/f64 arrays and kmer ranks decoded in one translate
    pass.  The per-row Python loop was most of the eventalign CLI's
    wall time."""
    n = len(alignments)
    if n == 0:
        return []
    lm = np.asarray(model["level_mean"], np.float32)
    ls = np.asarray(model["level_stdv"], np.float32)
    ev_mean = np.asarray(events["mean"], np.float32)
    ev_stdv = np.asarray(events["stdv"], np.float32)
    ev_len = np.asarray(events["length"], np.float32)

    eidx = np.fromiter((ea["event_idx"] for ea in alignments), np.int64, n)
    is_b = np.fromiter((ea["hmm_state"] == "B" for ea in alignments),
                       bool, n)
    kblob = "".join(ea["model_kmer"] for ea in alignments).encode()
    codes = np.frombuffer(
        kblob.translate(bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))),
        np.uint8).reshape(n, KMER_SIZE)
    codes = np.where(codes > 3, 0, codes)  # non-ACGT -> 0 (oracle .get)
    shifts = (2 * (KMER_SIZE - 1 - np.arange(KMER_SIZE))).astype(np.int64)
    ranks = (codes.astype(np.int64) << shifts[None, :]).sum(1)

    event_mean = ev_mean[eidx]
    event_stdv = ev_stdv[eidx]
    event_duration = (ev_len[eidx]
                      / np.float32(sample_rate)).astype(np.float32)
    model_mean = np.zeros(n, np.float32)
    model_stdv = np.zeros(n, np.float32)
    if scale_events:
        event_mean = ((event_mean - np.float32(sc["shift"]))
                      / np.float32(sc["scale"])).astype(np.float32)
        model_mean = np.where(is_b, np.float32(0.0), lm[ranks])
        model_stdv = np.where(is_b, np.float32(0.0), ls[ranks])
    else:
        model_mean = np.where(
            is_b, np.float32(0.0),
            (np.float32(sc["scale"]) * lm[ranks]
             + np.float32(sc["shift"])).astype(np.float32))
        model_stdv = np.where(
            is_b, np.float32(0.0),
            (ls[ranks] * np.float32(sc["var"])).astype(np.float32))
    with np.errstate(divide="ignore", invalid="ignore"):
        standard_level = (
            (event_mean - model_mean).astype(np.float32).astype(np.float64)
            / (np.sqrt(np.float64(sc["var"]))
               * model_stdv.astype(np.float64))).astype(np.float32)

    who = read_name if print_read_names else str(int(read_index))
    em = event_mean.astype(np.float64).tolist()
    es = event_stdv.astype(np.float64).tolist()
    ed = event_duration.astype(np.float64).tolist()
    mm = model_mean.astype(np.float64).tolist()
    ms = model_stdv.astype(np.float64).tolist()
    sl = standard_level.astype(np.float64).tolist()
    ei_l = eidx.tolist()
    return [
        f"{ref_name}\t{ea['ref_position']}\t{ea['ref_kmer']}\t{who}\tt\t"
        f"{ei_l[i]}\t{em[i]:.2f}\t{es[i]:.3f}\t{ed[i]:.5f}\t"
        f"{ea['model_kmer']}\t{mm[i]:.2f}\t{ms[i]:.2f}\t{sl[i]:.2f}\n"
        for i, ea in enumerate(alignments)
    ]


def _emit_cols(events, model, sc, rp, ei, st, ref_seq, ref_offset, rc,
               sample_rate, scale_events):
    """Shared column builder for the array emit paths: returns
    (km, mk [n,K] ascii u8, eidx i64, em/es/ed/mm/ms/sl f64 arrays)
    or None when a kmer would overrun the segment."""
    n = int(rp.shape[0])
    pos = rp.astype(np.int64) - np.int64(ref_offset)
    refbytes = np.frombuffer(ref_seq.encode(), np.uint8)
    if int(pos.min()) < 0 or int(pos.max()) + KMER_SIZE > refbytes.size:
        return None
    km = refbytes[pos[:, None] + np.arange(KMER_SIZE)]  # [n, K] ascii
    is_b = np.frombuffer(st, np.uint8) == ord("B")
    if rc:
        comp = np.zeros(256, np.uint8)
        comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(
            b"TGCA", np.uint8)
        mk = comp[km][:, ::-1]
    else:
        mk = km
    if is_b.any():
        mk = np.where(is_b[:, None], np.uint8(ord("N")), mk)

    # rank decode == emit_tsv_lines_fast: ACGT -> 0..3, anything else 0
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = lut[mk]
    shifts = (2 * (KMER_SIZE - 1 - np.arange(KMER_SIZE))).astype(np.int64)
    ranks = (codes.astype(np.int64) << shifts[None, :]).sum(1)

    lm = np.asarray(model["level_mean"], np.float32)
    ls = np.asarray(model["level_stdv"], np.float32)
    ev_mean = np.asarray(events["mean"], np.float32)
    ev_stdv = np.asarray(events["stdv"], np.float32)
    ev_len = np.asarray(events["length"], np.float32)
    eidx = ei.astype(np.int64)

    event_mean = ev_mean[eidx]
    event_stdv = ev_stdv[eidx]
    event_duration = (ev_len[eidx]
                      / np.float32(sample_rate)).astype(np.float32)
    if scale_events:
        event_mean = ((event_mean - np.float32(sc["shift"]))
                      / np.float32(sc["scale"])).astype(np.float32)
        model_mean = np.where(is_b, np.float32(0.0), lm[ranks])
        model_stdv = np.where(is_b, np.float32(0.0), ls[ranks])
    else:
        model_mean = np.where(
            is_b, np.float32(0.0),
            (np.float32(sc["scale"]) * lm[ranks]
             + np.float32(sc["shift"])).astype(np.float32))
        model_stdv = np.where(
            is_b, np.float32(0.0),
            (ls[ranks] * np.float32(sc["var"])).astype(np.float32))
    with np.errstate(divide="ignore", invalid="ignore"):
        standard_level = (
            (event_mean - model_mean).astype(np.float32).astype(np.float64)
            / (np.sqrt(np.float64(sc["var"]))
               * model_stdv.astype(np.float64))).astype(np.float32)
    return (km, mk, eidx,
            event_mean.astype(np.float64), event_stdv.astype(np.float64),
            event_duration.astype(np.float64),
            model_mean.astype(np.float64), model_stdv.astype(np.float64),
            standard_level.astype(np.float64))


def emit_tsv_lines_arrays(events, model, sc, rp, ei, st, ref_seq,
                          ref_offset, rc, read_index, read_name, ref_name,
                          sample_rate, print_read_names=False,
                          scale_events=False):
    """emit_tsv_lines_fast fed by realign_read_arrays' raw output: the
    kmer columns come from vectorized byte ops over the reference
    segment (gather + complement LUT) instead of a 98k-dict walk with
    per-row reverse_complement — byte-identical (same kmer text, same
    rank decode, same float op tree; tests pin it against the dict
    path on every golden case).  Returns None when a kmer would
    overrun the segment — the dict path emits the oracle's short-kmer
    text there, so the caller falls back."""
    n = int(rp.shape[0])
    if n == 0:
        return []
    cols = _emit_cols(events, model, sc, rp, ei, st, ref_seq, ref_offset,
                      rc, sample_rate, scale_events)
    if cols is None:
        return None
    km, mk, eidx, em_a, es_a, ed_a, mm_a, ms_a, sl_a = cols
    who = read_name if print_read_names else str(int(read_index))
    em = em_a.tolist()
    es = es_a.tolist()
    ed = ed_a.tolist()
    mm = mm_a.tolist()
    ms = ms_a.tolist()
    sl = sl_a.tolist()
    ei_l = eidx.tolist()
    rp_l = rp.tolist()
    kblob = km.tobytes().decode()
    mkblob = mk.tobytes().decode() if mk is not km else kblob
    K = KMER_SIZE
    return [
        f"{ref_name}\t{rp_l[i]}\t{kblob[i*K:i*K+K]}\t{who}\tt\t"
        f"{ei_l[i]}\t{em[i]:.2f}\t{es[i]:.3f}\t{ed[i]:.5f}\t"
        f"{mkblob[i*K:i*K+K]}\t{mm[i]:.2f}\t{ms[i]:.2f}\t{sl[i]:.2f}\n"
        for i in range(n)
    ]


def emit_tsv_text_arrays(events, model, sc, rp, ei, st, ref_seq,
                         ref_offset, rc, read_index, read_name, ref_name,
                         sample_rate, print_read_names=False,
                         scale_events=False):
    """The whole read's TSV as ONE string via the native block
    formatter (gt_eventalign_emit) — byte-identical to
    emit_tsv_lines_arrays joined.  Returns (text, n_rows), or None on
    segment overrun / native lib absent (caller falls back)."""
    from ..io.native import eventalign_emit_native

    n = int(rp.shape[0])
    if n == 0:
        return "", 0
    cols = _emit_cols(events, model, sc, rp, ei, st, ref_seq, ref_offset,
                      rc, sample_rate, scale_events)
    if cols is None:
        return None
    km, mk, eidx, em_a, es_a, ed_a, mm_a, ms_a, sl_a = cols
    who = read_name if print_read_names else str(int(read_index))
    text = eventalign_emit_native(
        rp, eidx, km.tobytes(), mk.tobytes(), KMER_SIZE,
        em_a, es_a, ed_a, mm_a, ms_a, sl_a, ref_name, who)
    if text is None:
        return None
    return text, n


def scaling_read_fast(sequence, events, pairs, model):
    """EA.scaling_read with the native postalign + recalibrate + QC
    pass (gt_eventalign_scaling — double sums in the oracle's
    sequential order, bit-exact; tests assert status/scalings/b2e/epb
    equality).  Falls back to the oracle when the lib isn't built."""
    import ctypes

    from ..io.native import _load

    lib = _load()
    if not lib:
        return EA.scaling_read(sequence, events, pairs, model)
    if not getattr(lib, "_ea_scaling_ready", False):
        lib.gt_eventalign_scaling.restype = ctypes.c_int32
        lib.gt_eventalign_scaling.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p] * 3 + [ctypes.c_void_p] * 2
            + [ctypes.c_void_p])
        lib._ea_scaling_ready = True
    n_kmers = len(sequence) - KMER_SIZE + 1
    codes = np.frombuffer(
        sequence.encode().translate(
            bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))), np.uint8)
    codes = np.ascontiguousarray(np.where(codes > 3, 0, codes))
    if pairs:
        pk = np.ascontiguousarray([p[0] for p in pairs], np.int32)
        pe = np.ascontiguousarray([p[1] for p in pairs], np.int32)
    else:
        pk = np.zeros(0, np.int32)
        pe = np.zeros(0, np.int32)
    ev_mean = np.ascontiguousarray(events["mean"], np.float32)
    lm = np.ascontiguousarray(model["level_mean"], np.float32)
    ls = np.ascontiguousarray(model["level_stdv"], np.float32)
    sc_out = np.zeros(4, np.float32)
    b2e = np.full((max(n_kmers, 1), 2), -1, np.int32)
    epb = np.zeros(1, np.float64)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.gt_eventalign_scaling(
        p(codes), len(sequence), p(pk), p(pe), len(pk), p(ev_mean),
        p(lm), p(ls), p(sc_out), p(b2e), p(epb))
    if rc == 2:  # FAILED_ALIGNMENT: oracle returns b2e=None, epb=0.0
        return EA.FAILED_ALIGNMENT, None, None, 0.0
    if rc == 1:
        return EA.FAILED_CALIBRATION, None, b2e, float(epb[0])
    sc = {"shift": sc_out[0], "scale": sc_out[1], "var": sc_out[2],
          "log_var": sc_out[3]}
    if rc == 4:
        return EA.FAILED_QUALITY_CHK, sc, b2e, float(epb[0])
    return 0, sc, b2e, float(epb[0])


def estimate_scalings_mom_fast(sequence, model, events):
    """estimate_scalings_using_mom with the native sequential-double
    pass (gt_mom_scalings, bit-exact; falls back to the oracle)."""
    import ctypes

    from ..io.native import _load

    lib = _load()
    if not lib:
        from .oracle import events as EV

        return EV.estimate_scalings_using_mom(sequence, model, events)
    if not getattr(lib, "_mom_ready", False):
        lib.gt_mom_scalings.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])
        lib._mom_ready = True
    codes = np.frombuffer(
        sequence.encode().translate(
            bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))), np.uint8)
    codes = np.ascontiguousarray(np.where(codes > 3, 0, codes))
    ev_mean = np.ascontiguousarray(events["mean"], np.float32)
    lm = np.ascontiguousarray(model["level_mean"], np.float32)
    out = np.zeros(2, np.float32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.gt_mom_scalings(p(codes), len(sequence), p(ev_mean), len(ev_mean),
                        p(lm), p(out))
    return out[0], out[1]
