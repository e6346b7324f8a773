"""Bucketed chain dispatch (cli/chain.run_calls -> ops/chain
chain_calls_batched): calls of mixed sizes share vmapped scan batches per
(n_pad, window) bucket.  Parity vs the per-call scan, call by call."""

import numpy as np

from genomicsbench_palisade_tpu.cli.chain import run_calls
from genomicsbench_palisade_tpu.io.chain_dump import ChainCallInput as ChainCall
from genomicsbench_palisade_tpu.ops import chain as C


def _mk_calls(rng, sizes, qspans, steps_fn=None, dy_fn=None):
    """Returns (prepared calls, raw ChainCall records)."""
    preps, raws = [], []
    for n, q in zip(sizes, qspans):
        steps = (steps_fn(rng, n) if steps_fn else
                 rng.integers(1, 40, n).astype(np.int64))
        xs = np.sort(np.cumsum(steps) + 500)
        dy = dy_fn(rng, n) if dy_fn else rng.integers(-200, 200, n)
        ys = np.maximum(xs + dy, 0)
        preps.append(C.prepare_call(xs, ys, avg_qspan=float(q)))
        raws.append(ChainCall(n=n, avg_qspan=float(q), max_dist_x=5000,
                              max_dist_y=5000, bw=500, n_segs=1,
                              x=xs.astype(np.uint64),
                              y=ys.astype(np.uint64)))
    return preps, raws


def _assert_same(got, want):
    for g, w_ in zip(got, want):
        for oi in range(3):
            np.testing.assert_array_equal(g[oi], w_[oi])


def test_bucketed_calls_match_scan():
    """8 mixed-size calls, exact-quarter avg_qspan 25.0 among them (the
    double-rounding class): bucketed results equal the per-call scan,
    including call-local parent indices."""
    rng = np.random.default_rng(12)
    sizes = [40, 170, 90, 200, 55, 130, 75, 160]
    qspans = [20.1, 18.7, 25.0, 23.3, 31.9, 19.87, 14.2, 27.6]
    preps, raws = _mk_calls(rng, sizes, qspans)
    want = [C.chain_call(c) for c in preps]
    _assert_same(run_calls(raws), want)


def test_bucketed_empty_and_single():
    """Degenerate inputs: empty calls short-circuit, a single call runs
    as a batch of one."""
    rng = np.random.default_rng(3)
    preps, raws = _mk_calls(rng, [0, 60], [20.0, 20.0])
    assert preps[0]["n"] == 0
    out = run_calls(raws)
    assert out[0][0].shape == (0,)
    _assert_same([out[1]], [C.chain_call(preps[1])])


def test_batched_calls_straddling_buckets():
    """Calls whose sizes fall on both sides of a power-of-two bucket
    edge, run in one shared n_pad, equal the per-call scan."""
    rng = np.random.default_rng(7)
    preps, _ = _mk_calls(rng, [100, 180, 256, 257], [19.5, 22.25, 21.0, 20.5])
    want = [C.chain_call(c, w=256, n_pad=512) for c in preps]
    _assert_same(C.chain_calls_batched(preps, w=256, n_pad=512), want)


def test_bucketed_large_coordinate_jumps():
    """x jumps past u16, qi jumps past i16 in both directions: the int32
    window arithmetic and the bucketed batch stay exact."""
    def steps_fn(rng, n):
        s = rng.integers(1, 40, n).astype(np.int64)
        s[rng.random(n) < 0.05] = 70_000
        return s

    def dy_fn(rng, n):
        dy = rng.integers(-200, 200, n).astype(np.int64)
        dy[rng.random(n) < 0.05] = 60_000
        dy[rng.random(n) < 0.05] = -50_000
        return dy

    rng = np.random.default_rng(77)
    preps, raws = _mk_calls(rng, (96, 150), (19.87, 19.87), steps_fn, dy_fn)
    want = [C.chain_call(c) for c in preps]
    _assert_same(run_calls(raws), want)
