"""bsw driver dispatch: the stacked scan, the 2-bit wire and the SoA
parser, against the plain scan, the oracle and the reference goldens."""

import numpy as np

from genomicsbench_palisade_tpu.ops import bsw as W


def _random_pairs(rng, b, ql_max=60, tl_max=90):
    pairs = []
    for _ in range(b):
        ql = int(rng.integers(5, ql_max))
        tl = int(rng.integers(5, tl_max))
        t = rng.integers(0, 5, tl)  # incl. ambiguous
        q = rng.integers(0, 5, ql)
        if rng.random() < 0.7 and tl >= ql:  # related pair
            q = t[:ql].copy()
            mut = rng.random(ql) < 0.15
            q[mut] = rng.integers(0, 4, int(mut.sum()))
        pairs.append((q, t, int(rng.integers(1, 80))))
    return pairs


def test_score_pairs_raw_route_matches_scan():
    """cli score_pairs on pairs with ambiguous bases (codes >= 4, which
    the 2-bit wire cannot carry) takes the raw-codes route and matches
    the scan engine bit-exactly."""
    from genomicsbench_palisade_tpu.cli.bsw import score_pairs

    rng = np.random.default_rng(0)
    pairs = _random_pairs(rng, 128)
    batch = W.prepare_pairs(pairs, q_pad=64, t_pad=96)
    want = {k: np.asarray(v) for k, v in W.bsw_batch(batch).items()}
    got = score_pairs(pairs)
    for key in W.OUT_ORDER:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_bsw_stacked_matches_oracle():
    """bsw_batch_stacked (the driver's dispatch) vs the scalar oracle."""
    from genomicsbench_palisade_tpu.ops.oracle import bsw as WO

    rng = np.random.default_rng(1)
    pairs = _random_pairs(rng, 128)
    batch = W.prepare_pairs(pairs, q_pad=64, t_pad=96)
    got = np.asarray(W.bsw_batch_stacked(batch))
    for i, (q, t, h0) in enumerate(pairs):
        want = WO.scalar_banded_swa(q, t, h0, WO.DEFAULT_PARAMS)
        for row, key in enumerate(W.OUT_ORDER):
            assert got[row, i] == want[key], (i, key)


def test_bsw_scan_vs_reference_fixtures_production_padding(fixtures_dir):
    """All 300 reference-binary golden cases through the stacked scan at
    the driver's bucket padding (q_pad/t_pad 512, batch a multiple of
    128 as score_pairs_soa chunks it)."""
    import json

    cases = json.load(open(fixtures_dir / "bsw_golden.json"))
    pairs = [(np.array(c["query"]), np.array(c["target"]), c["h0"])
             for c in cases]
    while len(pairs) % 128:
        pairs.append(pairs[0])
    batch = W.prepare_pairs(pairs, q_pad=512, t_pad=512)
    got = np.asarray(W.bsw_batch_stacked(batch))
    for i, c in enumerate(cases):
        for row, key in enumerate(W.OUT_ORDER):
            assert int(got[row, i]) == c["out"][key], (i, key)


def test_bsw_packed_wire_matches_raw():
    """2-bit wire format (pack on host, unpack on device) is bit-exact vs
    the raw int8 path."""
    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(128):
        ql = int(rng.integers(5, 60))
        tl = int(rng.integers(5, 90))
        t = rng.integers(0, 4, tl)  # plain bases only: the packable class
        q = t[: min(ql, tl)].copy() if rng.random() < 0.5 else rng.integers(0, 4, ql)
        pairs.append((q.astype(np.int8), t.astype(np.int8), int(rng.integers(1, 80))))

    ql = np.array([len(q) for q, _, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t, _ in pairs], np.int32)
    h0 = np.array([h for _, _, h in pairs], np.int32)
    q_pad, t_pad = 64, 96
    raw_q = np.full((128, q_pad), 4, np.int8)
    raw_t = np.full((128, t_pad), 4, np.int8)
    pk_q = np.zeros((128, q_pad), np.uint8)
    pk_t = np.zeros((128, t_pad), np.uint8)
    for i, (q, t, _) in enumerate(pairs):
        raw_q[i, : len(q)] = q
        raw_t[i, : len(t)] = t
        pk_q[i, : len(q)] = q
        pk_t[i, : len(t)] = t

    # host pack -> device unpack round-trips to the exact raw padded array
    import jax.numpy as jnp

    up_q = np.asarray(W.unpack_codes_2bit(
        jnp.asarray(W.pack_codes_2bit(pk_q)), q_pad, jnp.asarray(ql)))
    np.testing.assert_array_equal(up_q, raw_q.astype(np.int32))

    raw_batch = {"query": raw_q, "target": raw_t,
                 "qlen": ql, "tlen": tl, "h0": h0}
    packed_batch = {"qpack": W.pack_codes_2bit(pk_q),
                    "tpack": W.pack_codes_2bit(pk_t),
                    "qlen": ql, "tlen": tl, "h0": h0}
    want = np.asarray(W.bsw_batch_stacked(raw_batch))
    got = np.asarray(W.bsw_batch_stacked(packed_batch, q_pad, t_pad))
    np.testing.assert_array_equal(got, want)


def test_score_pairs_packed_route_end_to_end():
    """cli score_pairs on a packable pair set matches the scan engine —
    exercises the production packed dispatch path."""
    from genomicsbench_palisade_tpu.cli.bsw import score_pairs

    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(40):
        ql = int(rng.integers(5, 30))
        tl = int(rng.integers(8, 40))
        pairs.append((rng.integers(0, 4, ql).astype(np.int8),
                      rng.integers(0, 4, tl).astype(np.int8),
                      int(rng.integers(1, 50))))
    batch = W.prepare_pairs(pairs, q_pad=32, t_pad=64)
    want = {k: np.asarray(v)[: len(pairs)]
            for k, v in W.bsw_batch(batch).items()}
    got = score_pairs(pairs)
    for key in W.OUT_ORDER:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_parse_pairs_soa_matches_list_parser(tmp_path):
    """SoA parser (vectorized h0 digits) is record-exact vs parse_pairs,
    including negative h0, trailing fields, and an unterminated last line."""
    from genomicsbench_palisade_tpu.io.pairs import parse_pairs, parse_pairs_soa

    rng = np.random.default_rng(3)
    rows = []
    for i in range(257):
        ql = int(rng.integers(1, 40))
        tl = int(rng.integers(1, 60))
        t = rng.integers(0, 5, tl, dtype=np.int8)
        q = rng.integers(0, 5, ql, dtype=np.int8)
        h0 = int(rng.integers(0, 12345)) * (-1 if i % 11 == 0 else 1)
        head = b"%d" % h0 if i % 3 else b"%d %d %d" % (h0, tl, ql)
        rows.append(b"%s\n%s\n%s\n" % (
            head, (t + 48).astype(np.uint8).tobytes(),
            (q + 48).astype(np.uint8).tobytes()))
    blob = b"".join(rows)[:-1]  # strip final newline: EOF-terminated record
    p = tmp_path / "pairs.txt"
    p.write_bytes(blob)

    want = parse_pairs(str(p))
    soa = parse_pairs_soa(str(p))
    assert len(soa["h0"]) == len(want) == 257
    for i, (q, t, h0) in enumerate(want):
        assert int(soa["h0"][i]) == h0, i
        np.testing.assert_array_equal(
            soa["codes"][soa["q_off"][i]: soa["q_off"][i] + soa["q_len"][i]], q)
        np.testing.assert_array_equal(
            soa["codes"][soa["t_off"][i]: soa["t_off"][i] + soa["t_len"][i]], t)

    got = parse_pairs_soa(str(p), max_pairs=10)
    assert len(got["h0"]) == 10
