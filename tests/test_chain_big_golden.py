"""Reference-binary golden parity for chain at reference call sizes.

fixtures/chain_big_golden.npz holds calls up to 87k anchors (the
reference's max call size, benchmarks/chain/src/main.cpp:100) with
scores/parents produced by the minimap2-acceleration scalar testbed —
the origin of the fork's chain benchmark, same max_skip=25 plaintext
semantics (tools/minimap2-acceleration/kernel/scalar/src/
host_kernel.cpp:38 vs benchmarks/chain/src/host_kernel.cpp:66).

These sizes run the windowed-scan path at reference scale.
"""

import pathlib

import numpy as np
import pytest

from genomicsbench_palisade_tpu.ops import chain as C

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURES / "chain_big_golden.npz")


def test_chain_scan_path_at_reference_scale(golden):
    n_cases = int(golden["n_cases"])
    for ci in range(n_cases):
        xs = golden[f"x{ci}"]
        ys = golden[f"y{ci}"]
        call = C.prepare_call(xs, ys, float(golden[f"qspan{ci}"]))
        sc, par, _pk = C.chain_call(call)
        n = len(xs)
        np.testing.assert_array_equal(
            np.asarray(sc)[:n], golden[f"scores{ci}"],
            err_msg=f"case {ci} (n={n}) scores")
        np.testing.assert_array_equal(
            np.asarray(par)[:n], golden[f"parents{ci}"],
            err_msg=f"case {ci} (n={n}) parents")
