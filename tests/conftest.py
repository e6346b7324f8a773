"""Test configuration.

Tests run on the CPU backend unless JAX_PLATFORMS says otherwise, with an
8-device virtual CPU mesh so the sharding and collective paths run as
__graft_entry__.dryrun_multichip runs them.  Tests that need the GPU
carry the `gpu` marker and the `gpu` fixture, which skips them when JAX
finds no GPU; on a machine with a card they run with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

Must run before jax is imported anywhere.
"""

import fcntl
import os
import subprocess

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import pathlib  # noqa: E402

import pytest  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

# ---------------------------------------------------------------------------
# slow-test split: `pytest -m "not slow"` is the core loop; the full
# suite (dominated by dataset-scale cases) stays the CI gate.  Centralised here instead of
# per-file decorators so the core-loop budget is auditable in one place.
# Every component family keeps at least one unmarked test (fmi via
# test_fmi_jax small cases, poa via test_poa small cases, phmm via the
# fixture suites, abea via eventalign[16] + CLI tests, ...).
# ---------------------------------------------------------------------------

SLOW_TESTS = {
    "test_fmi_golden.py::test_fmi_reference_golden",
    "test_poa_golden.py::test_poa_device_matches_reference",
    "test_poa_golden.py::test_poa_oracle_matches_reference",
    "test_multiprocess.py::test_two_process_distributed_parity",
    "test_parallel.py::test_chain_halo_sharded_matches_single",
    "test_parallel.py::test_kmer_sharded_matches_oracle",
    "test_parallel.py::test_fmi_pipeline_index_sharded",
    "test_parallel.py::test_sharded_index_files_roundtrip_and_search",
    "test_parallel.py::test_fmi_sharded_index_search",
    "test_parallel.py::test_profiling_roi",
    "test_parallel.py::test_scaling_harness_runs",
    "test_models.py::test_clair_forward_shapes",
    "test_poa_swov_golden.py::test_swov_device_matches_reference",
    "test_scale_tools.py::test_abea_scale_smoke",
    "test_scale_tools.py::test_poa_scale_smoke",
    "test_scale_tools.py::test_kmer_scale_smoke",
    "test_abea_golden.py::test_abea_oracle_matches_reference",
    "test_poa.py::test_jax_alignment_matches_oracle",
    "test_poa.py::test_jax_consensus_end_to_end",
    "test_poa.py::test_native_graph_full_run_matches_python",
    "test_kmer_golden.py::test_kmer_device_matches_reference",
    "test_fmi_jax.py::test_full_pipeline_matches_oracle",
    "test_fmi_jax.py::test_fmi_cli_host_engine_matches_device",
    "test_nn_cli.py::test_call_var_cli_reference_flags",
    "test_nn_cli.py::test_call_var_cli",
    "test_nn_cli.py::test_call_var_cli_h5",
    "test_nn_cli.py::test_basecall_cli",
}

# parametrized cases marked individually (one representative stays fast)
SLOW_NODEIDS = {
    f"test_eventalign.py::test_eventalign_golden[{ci}]"
    for ci in (17, 18, 20, 21, 24)
}


def pytest_collection_modifyitems(config, items):
    for it in items:
        key = it.nodeid.rsplit("tests/", 1)[-1]
        if key.split("[", 1)[0] in SLOW_TESTS or key in SLOW_NODEIDS:
            it.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def fixtures_dir():
    return FIXTURES


NATIVE = pathlib.Path(__file__).resolve().parents[1] / "native"


def pytest_configure(config):
    """Build native/ once before collection.  Every xdist worker runs
    this; the file lock makes one of them build and the others find the
    library up to date (make is a no-op then).  A failed build leaves
    the native-engine tests to skip."""
    with open(NATIVE / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-s", "-C", str(NATIVE)],
                           capture_output=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired):
            pass


@pytest.fixture
def gpu():
    """The GPU device, or a skip when JAX has none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
