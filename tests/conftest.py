"""Test harness: run everything on a virtual 8-device CPU mesh.

Sharding semantics are validated on host-platform virtual devices
(SURVEY.md §4), and the GPU kernel runs in Pallas interpret mode.  Tests
that need the card are marked ``gpu`` and take the ``gpu`` fixture, which
skips them unless JAX sees an NVIDIA GPU; run them on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.  Any other run
is pinned to the CPU here, whatever platform JAX would pick by default.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# 8 virtual-device collectives on a small host: other load (or the
# suite's own workers) can starve a device thread past
# XLA's default 20 s warn / 40 s TERMINATE rendezvous timeouts, which
# kills the whole pytest process as an unattributable `Fatal Python
# error` instead of failing one test.  Raise them so a genuinely stuck
# collective surfaces as ONE identifiable hanging test (killed by the
# suite's outer `timeout`), not a suite-wide abort.  (CLAUDE.md;
# scripts/bench_backend_1m.py applies the same mitigation.)
if "xla_cpu_collective_call" not in flags:
    flags += (
        " --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
        " --xla_cpu_collective_call_terminate_timeout_seconds=3600"
    )
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402
import pytest  # noqa: E402

if not any(p in os.environ.get("JAX_PLATFORMS", "") for p in ("cuda", "gpu")):
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(__file__))  # for `oracle` imports


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (full suite; ~2x the default time)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(
        reason="slow test — run with --runslow for the full suite"
    )
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture
def gpu():
    """The first GPU; skips the test (decided here, at run time) unless JAX
    sees one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: on the card run "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")
    return dev
