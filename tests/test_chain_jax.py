"""chain JAX kernel: exact integer parity vs fixtures and the oracle."""

import json

import numpy as np

from genomicsbench_palisade_tpu.ops import chain as C
from genomicsbench_palisade_tpu.ops.oracle import chain as CO


def test_chain_vs_reference_fixtures(fixtures_dir):
    calls = json.load(open(fixtures_dir / "chain_golden.json"))
    for call in calls[:12]:  # keep CI fast; full set checked offline
        x = np.array([int(v) for v in call["x"]], dtype=np.uint64)
        y = np.array([int(v) for v in call["y"]], dtype=np.uint64)
        prep = C.prepare_call(
            x, y, call["avg_qspan"], call["max_dist_x"], call["max_dist_y"], call["bw"]
        )
        scores, parents, _ = C.chain_call(prep)
        np.testing.assert_array_equal(scores, call["scores"])
        np.testing.assert_array_equal(parents, call["parents"])


def test_chain_break_path_dense():
    """Dense anchors triggering the max_skip break on ~95% of anchors."""
    rng = np.random.default_rng(123)
    n = 600
    pos = np.cumsum(rng.integers(0, 4, n)).astype(np.uint64)
    qpos = (pos.astype(np.int64) + rng.integers(-30, 30, n)).clip(0).astype(np.uint64)
    span = rng.integers(10, 20, n).astype(np.uint64)
    y = (span << np.uint64(32)) | (qpos & np.uint64(0xFFFFFFFF))
    call = CO.ChainCall(
        n=n, avg_qspan=float(span.mean()), max_dist_x=5000, max_dist_y=5000,
        bw=500, n_segs=1, x=pos, y=y,
    )
    want = CO.chain_dp(call)
    prep = C.prepare_call(pos, y, call.avg_qspan)
    scores, parents, peaks = C.chain_call(prep)
    np.testing.assert_array_equal(scores, want["scores"])
    np.testing.assert_array_equal(parents, want["parents"])
    np.testing.assert_array_equal(peaks, want["peak_scores"])


def test_chain_tiny_and_gap_table():
    # single anchor and two-anchor chains
    for xs, ys in [
        ([100], [(15 << 32) | 50]),
        ([100, 150], [(15 << 32) | 50, (15 << 32) | 100]),
        ([100, 100], [(15 << 32) | 50, (15 << 32) | 60]),  # dr == 0 skip
    ]:
        x = np.array(xs, dtype=np.uint64)
        y = np.array(ys, dtype=np.uint64)
        call = CO.ChainCall(n=len(xs), avg_qspan=20.0, max_dist_x=5000,
                            max_dist_y=5000, bw=500, n_segs=1, x=x, y=y)
        want = CO.chain_dp(call)
        prep = C.prepare_call(x, y, 20.0)
        scores, parents, peaks = C.chain_call(prep)
        np.testing.assert_array_equal(scores, want["scores"])
        np.testing.assert_array_equal(parents, want["parents"])


def test_chain_calls_batched_matches_single():
    """Batched (vmapped) calls == per-call results, mixed sizes + empty."""
    import numpy as np
    from genomicsbench_palisade_tpu.ops import chain as C

    rng = np.random.default_rng(7)
    calls = []
    for n in (0, 37, 200, 64):
        if n == 0:
            calls.append({"n": 0})
            continue
        xs = np.cumsum(rng.integers(1, 50, n)).astype(np.int64)
        ys = (xs + rng.integers(-300, 300, n)).astype(np.int64)
        calls.append(C.prepare_call(xs, ys, avg_qspan=20.0))
    batched = C.chain_calls_batched(calls, w=64)
    for c, got in zip(calls, batched):
        if c["n"] == 0:
            assert got[0].size == 0
            continue
        want = C.chain_call(c, w=64, n_pad=200)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_chain_batched_exact_quarter_qspans():
    """A batch mixing ordinary avg_qspans with exact-quarter ones
    (25.0/50.0 — the class where the reference's 0.01f double rounding
    wobbles) runs as one vmapped batch, every call exact vs its
    single-call scan."""
    rng = np.random.default_rng(11)
    qspans = [20.1, 25.0, 18.7, 50.0, 23.3]
    calls = []
    for q in qspans:
        n = 200
        xs = np.cumsum(rng.integers(1, 40, n)).astype(np.int64) + 500
        ys = np.maximum(xs + rng.integers(-200, 200, n), 0)
        calls.append(C.prepare_call(xs, ys, avg_qspan=q))
    want = [C.chain_call(c, w=64, n_pad=256) for c in calls]
    got = C.chain_calls_batched(calls, w=64)
    for g, w_ in zip(got, want):
        for oi in range(3):
            np.testing.assert_array_equal(g[oi], w_[oi])


def test_anchor_bucket_and_window():
    """Power-of-two anchor buckets (reference-scale 87k calls -> 131072)
    and windows rounded up from w_need, clamped to [16, max_iter + 16]."""
    assert C.pad_anchor_bucket(0) == 64
    assert C.pad_anchor_bucket(64) == 64
    assert C.pad_anchor_bucket(65) == 128
    assert C.pad_anchor_bucket(87000) == 131072
    assert C.window_for({"w_need": 0}) == 16
    assert C.window_for({"w_need": 17}) == 32
    assert C.window_for({"w_need": 300}) == 512
    assert C.window_for({"w_need": 10**6}) == C.MAX_ITER + 16


def test_chain_batched_padding_parity():
    """A call padded into a larger bucket (n_pad 256 > n 250) with a
    narrow window through the vmapped batch equals the unpadded
    single-call scan."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n = 250
    x = (np.cumsum(rng.integers(1, 40, n)) + 1000).astype(np.uint64)
    y = (x.astype(np.int64) + rng.integers(-200, 200, n)).astype(np.uint64)
    call = C.prepare_call(x, y, 22.5)
    n_pad, w = 256, 16

    def p(a, f=0):
        return np.pad(a, (0, n_pad - len(a)), constant_values=f)

    nn = np.array([n], np.int32)
    ws, wp, wk = C.chain_dp_device_batch(
        jnp.asarray(np.stack([p(call["x_lo"].view(np.int32))])),
        jnp.asarray(np.stack([p(call["qi"])])),
        jnp.asarray(np.stack([p(call["qspan"])])),
        jnp.asarray(np.stack([p(call["st_eff"])])),
        jnp.asarray(np.stack([call["gap_table"]])), jnp.asarray(nn),
        w, n_pad, call["max_dist_x"], call["max_dist_y"], call["bw"])
    sc, par, pk = C.chain_call(call, w=w)
    np.testing.assert_array_equal(np.asarray(ws)[0, :n], sc)
    np.testing.assert_array_equal(np.asarray(wp)[0, :n], par)
    np.testing.assert_array_equal(np.asarray(wk)[0, :n], pk)


def test_chain_batched_vs_reference_fixtures(fixtures_dir):
    """All reference-binary goldens through one vmapped batch at a
    shared (n_pad, w) bucket — the single-call test pins only 12."""
    import json

    calls = json.load(open(fixtures_dir / "chain_golden.json"))
    preps = []
    for call in calls:
        x = np.array([int(v) for v in call["x"]], dtype=np.uint64)
        y = np.array([int(v) for v in call["y"]], dtype=np.uint64)
        preps.append(C.prepare_call(x, y, call["avg_qspan"],
                                    call["max_dist_x"], call["max_dist_y"],
                                    call["bw"]))
    got = C.chain_calls_batched(preps)
    for i, (call, (sc, par, _pk)) in enumerate(zip(calls, got)):
        np.testing.assert_array_equal(sc, call["scores"],
                                      err_msg=f"call {i} scores")
        np.testing.assert_array_equal(par, call["parents"],
                                      err_msg=f"call {i} parents")
