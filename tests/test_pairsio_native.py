"""Native pairsio (native/pairsio.cpp) parity vs the pure-numpy paths.

The bsw dataset-scale driver leans on three native single-pass loops:
structural parse of the 3-line pair format (reference loadPairs,
benchmarks/bsw/main_banded.cpp:148-202), 2-bit wire-row packing, and raw
int8 row padding.  Each must be bit-identical to the numpy formulation
it replaces (io/pairs.py, ops/bsw.py pack_codes_2bit).
"""

import unittest.mock as mock

import numpy as np
import pytest

from genomicsbench_palisade_tpu.io import native as N
from genomicsbench_palisade_tpu.io import pairs as P
from genomicsbench_palisade_tpu.ops.bsw import pack_codes_2bit


@pytest.fixture(autouse=True)
def _native_lib():
    if not N.available():
        pytest.skip("native lib not built")


def _synth_file(tmp_path, n=400, terminated=False, seed=3):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        tl = int(rng.integers(1, 70))
        ql = int(rng.integers(1, 50))
        t = rng.integers(0, 5, tl)
        q = rng.integers(0, 5, ql)
        h0 = int(rng.integers(-40, 120))
        recs.append(b"%d %d %d\n%s\n%s" % (
            h0, tl, ql,
            (t + 48).astype(np.uint8).tobytes(),
            (q + 48).astype(np.uint8).tobytes()))
    data = b"\n".join(recs) + (b"\n" if terminated else b"")
    f = tmp_path / "pairs.txt"
    f.write_bytes(data)
    return str(f)


@pytest.mark.parametrize("terminated", [True, False])
def test_parse_soa_native_matches_numpy(tmp_path, terminated):
    path = _synth_file(tmp_path, terminated=terminated)
    got = P.parse_pairs_soa(path)
    with mock.patch.object(N, "parse_pairs_struct_native",
                           lambda buf: None):
        want = P.parse_pairs_soa(path)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_parse_soa_native_max_pairs(tmp_path):
    path = _synth_file(tmp_path, n=50, terminated=True)
    got = P.parse_pairs_soa(path, max_pairs=7)
    assert len(got["h0"]) == 7
    full = P.parse_pairs_soa(path)
    for k in ("h0", "q_len", "t_len", "q_off", "t_off"):
        assert np.array_equal(got[k], full[k][:7])


def test_pack_rows_native_matches_numpy():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 5000).astype(np.int8)
    n, pad = 64, 48
    ln = rng.integers(0, pad + 1, n).astype(np.int32)
    off = rng.integers(0, len(codes) - pad, n).astype(np.int64)
    rows, bad = N.bsw_pack_rows_native(codes, off, ln, pad)
    assert bad == 0
    raw = np.zeros((n, pad), np.uint8)
    for i in range(n):
        raw[i, : ln[i]] = codes[off[i]: off[i] + ln[i]]
    assert np.array_equal(rows, pack_codes_2bit(raw))


def test_pack_rows_native_flags_ambiguous():
    codes = np.array([0, 1, 2, 3, 4, 0, 1, 2], np.int8)
    _rows, bad = N.bsw_pack_rows_native(
        codes, np.array([0], np.int64), np.array([8], np.int32), 8)
    assert bad == 1
    # bias mode: raw ASCII digits with bias 48 behave like decoded codes
    ascii_codes = (codes + 48).astype(np.int8)
    _rows2, bad2 = N.bsw_pack_rows_native(
        ascii_codes, np.array([0], np.int64), np.array([8], np.int32), 8,
        bias=48)
    assert bad2 == 1
    assert np.array_equal(_rows, _rows2)


def test_pad_rows_native_matches_numpy():
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 5, 3000).astype(np.int8)
    n, pad = 32, 40
    ln = rng.integers(0, pad + 1, n).astype(np.int32)
    off = rng.integers(0, len(codes) - pad, n).astype(np.int64)
    got = N.bsw_pad_rows_native(codes, off, ln, pad)
    want = np.full((n, pad), 4, np.int8)
    for i in range(n):
        want[i, : ln[i]] = codes[off[i]: off[i] + ln[i]]
    assert np.array_equal(got, want)


def test_score_pairs_soa_matches_scan():
    """End-to-end: the native-prepped SoA scoring path must equal the
    golden-pinned scan engine on mixed pairs (incl. ambiguous bases that
    force the raw fallback chunks)."""
    from genomicsbench_palisade_tpu.cli.bsw import score_pairs_soa
    from genomicsbench_palisade_tpu.ops import bsw as W

    rng = np.random.default_rng(7)
    pairs = []
    for i in range(96):
        tl = int(rng.integers(12, 60))
        ql = int(rng.integers(8, min(tl, 40)))
        hi = 5 if i % 3 == 0 else 4  # every 3rd pair has ambiguous bases
        t = rng.integers(0, hi, tl)
        q = rng.integers(0, hi, ql)
        pairs.append((q.astype(np.int8), t.astype(np.int8),
                      int(rng.integers(-5, 60))))
    n = len(pairs)
    q_len = np.array([len(q) for q, _, _ in pairs], np.int32)
    t_len = np.array([len(t) for _, t, _ in pairs], np.int32)
    h0 = np.array([h for _, _, h in pairs], np.int32)
    codes = np.concatenate([np.asarray(a, np.int8)
                            for q, t, _ in pairs for a in (q, t)])
    sizes = np.empty(2 * n, np.int64)
    sizes[0::2] = q_len
    sizes[1::2] = t_len
    offs = np.concatenate(([0], np.cumsum(sizes[:-1])))
    soa = {"codes": codes, "q_off": offs[0::2], "q_len": q_len,
           "t_off": offs[1::2], "t_len": t_len, "h0": h0}
    got = score_pairs_soa(soa)
    want = W.bsw_batch(W.prepare_pairs(pairs))
    for k in got:
        assert np.array_equal(got[k], np.asarray(want[k])), k
