"""Test configuration: CPU backend with 8 virtual devices + float64.

Multi-device sharding tests run on a virtual CPU mesh
(xla_force_host_platform_device_count), the standard way to validate pjit/
shard_map layouts without several cards. Pallas kernels run in interpret
mode here (core/backend.py); tests that need the card carry the ``gpu``
marker and skip. x64 is enabled so solver parity tests
can hit the reference's 1e-6 tolerances
(test/PointCloudRegistrationTest.cc:71,115) — the reference solves in double.
"""
import os

# Force CPU (tests never take the card; on-card checks run through
# chip_smoke.py). jax may already be imported by the time this file runs,
# so the env var alone can be too late — update jax.config directly too.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.default_backend() == "cpu", "tests must run on the virtual CPU mesh"
assert jax.device_count() == 8, "expected 8 virtual CPU devices for sharding tests"


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return 0


def pytest_sessionstart(session):
    # The suite JIT-compiles thousands of XLA:CPU executables across the 8
    # virtual devices; each holds several code/guard mappings and the
    # kernel's default vm.max_map_count (65530) is exhausted around the
    # ~200th test — LLVM then SIGSEGVs inside backend_compile_and_load
    # (diagnosed round 5: maps 33k -> 55k within minutes, then a fatal
    # crash at the same test in four consecutive full runs). Raise the
    # limit when the container allows it; the watermark fixture below is
    # the portable guard.
    try:
        with open("/proc/sys/vm/max_map_count", "w") as f:
            f.write("1048576")
    except OSError:
        pass


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _bound_jit_code_mappings():
    """Drop compiled-executable caches when the process nears the kernel
    mapping limit (see pytest_sessionstart). Costs a recompile of later
    tests' programs; a segfault costs the whole suite."""
    yield
    if _map_count() > 40_000:
        import gc

        jax.clear_caches()
        gc.collect()
