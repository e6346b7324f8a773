"""Native convex align engine (native/poaalign.cpp) vs the oracle.

The host dual-engine (gt_poa_align / gt_poa_msa_window) must produce
IDENTICAL alignments to ops/oracle/poa.convex_align — same matrix
values, max-cell choice, traceback priority and repair loops — across
all three spoa AlignmentTypes, and identical consensus through full
multi-round MSA runs.  It is the production default in cli/poa.py,
so every divergence is a correctness bug, not a tolerance.

Also pins the engine against the same reference-binary golden fixtures
as the oracle (poa_swov_golden.json / poa_golden.json paths exercised
via the oracle equivalence above).
"""

import json
import pathlib

import numpy as np
import pytest

from genomicsbench_palisade_tpu.ops.oracle import poa as PO

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def _native_graph():
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops.poa import NativePoaGraph

    if not available():
        pytest.skip("native lib not built")
    return NativePoaGraph()


def _mutate(rng, s, rate=0.12):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate * 0.4:
            continue
        if r < rate * 0.7:
            out.append("ACGT"[rng.integers(4)])
            out.append(ch)
        elif r < rate:
            out.append("ACGT"[rng.integers(4)])
        else:
            out.append(ch)
    return "".join(out)


@pytest.mark.parametrize("align_type", ["nw", "sw", "ov"])
def test_native_align_matches_oracle_fuzz(align_type):
    rng = np.random.default_rng(101)
    for trial in range(12):
        base = "".join(rng.choice(list("ACGT"),
                                  int(rng.integers(25, 140))))
        seqs = [_mutate(rng, base) for _ in range(int(rng.integers(2, 7)))]
        g = PO.PoaGraph()
        gn = _native_graph()
        for s in seqs:
            a_or = PO.convex_align(s, g, align_type=align_type)
            a_nat = gn.align(s, align_type=align_type)
            assert a_nat == a_or, f"trial {trial} {align_type}"
            # grow both graphs with the NW alignment (driver behavior)
            grow = (a_or if align_type == "nw"
                    else PO.convex_align(s, g))
            g.add_alignment(grow, s)
            gn.add_alignment(grow, s)


def test_native_msa_window_matches_oracle_consensus():
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops.poa import msa_consensus_host

    if not available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(6):
        base = "".join(rng.choice(list("ACGT"), int(rng.integers(40, 160))))
        batches.append([_mutate(rng, base)
                        for _ in range(int(rng.integers(2, 8)))])
    got = msa_consensus_host(batches, timings=(tm := {}))
    want = [PO.msa_consensus(b) for b in batches]
    assert got == want
    assert tm["align"] > 0


def test_native_msa_window_edge_cases():
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops.poa import msa_consensus_host

    if not available():
        pytest.skip("native lib not built")
    # single-seq window, identical seqs, empty batch list entry
    batches = [["ACGTACGT"], ["TTTT", "TTTT", "TTTT"], []]
    got = msa_consensus_host(batches)
    assert got[0] == "ACGTACGT"
    assert got[1] == "TTTT"
    assert got[2] == ""


def test_native_align_nonstandard_params():
    """Non-default scoring (different open/extend mix) through both
    engines — the params path is not hardcoded to the driver defaults."""
    rng = np.random.default_rng(31)
    params = (3, -2, -9, -1, -14, -3)
    p = PO.PoaParams(*params)
    for _ in range(4):
        base = "".join(rng.choice(list("ACGT"), 60))
        seqs = [_mutate(rng, base) for _ in range(4)]
        g = PO.PoaGraph()
        gn = _native_graph()
        for s in seqs:
            a_or = PO.convex_align(s, g, p)
            a_nat = gn.align(s, params)
            assert a_nat == a_or
            g.add_alignment(a_or, s)
            gn.add_alignment(a_or, s)


def test_native_swov_golden_fixtures():
    """Reference-binary golden alignments (spoa kSW/kOV) through the
    NATIVE engine directly — same fixtures as test_poa_swov_golden."""
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops.poa import NativePoaGraph

    if not available():
        pytest.skip("native lib not built")
    with open(FIXTURES / "poa_swov_golden.json") as f:
        cases = json.load(f)["cases"]
    for ci, case in enumerate(cases):
        for align_type in ("sw", "ov"):
            want = case[align_type]
            gn = NativePoaGraph()
            for si, seq in enumerate(case["seqs"]):
                aln = gn.align(seq, align_type=align_type)
                assert [list(pr) for pr in aln] == want["alignments"][si], (
                    f"case {ci} seq {si} {align_type}")
                gn.add_alignment(aln, seq)
            assert gn.generate_consensus() == want["consensus"], (
                f"case {ci} {align_type} consensus")


def test_native_msa_extended_alphabet():
    """spoa codes any byte (graph.cpp coder/decoder); the native engine
    must agree with the oracle beyond ACGT (N, gaps, IUPAC chars)."""
    from genomicsbench_palisade_tpu.io.native import available
    from genomicsbench_palisade_tpu.ops.poa import msa_consensus_host

    if not available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(91)
    for _ in range(4):
        base = "".join(rng.choice(list("ACGTN-RY"),
                                  int(rng.integers(20, 80))))
        seqs = ["".join(ch for ch in base if rng.random() > 0.1) or "A"
                for _ in range(4)]
        assert msa_consensus_host([seqs])[0] == PO.msa_consensus(seqs)
