"""Test environment: local CPU with a virtual 8-device mesh.

Tests follow the reference's cheap-crypto strategy (SURVEY.md §4): small
rings, no security, CPU.  Full-fidelity parameters run on the GPU through
bench.py and chip_smoke.py.  The 8 virtual CPU devices back the mesh tests
(tests/test_multichip.py).

Tests that need the card carry the `gpu` marker and request the `gpu`
fixture, which skips them without one.  chip_smoke.py runs them inside its
own process on the card; that process has already started JAX on the GPU,
so this file then leaves the platform alone.
"""

import os
import sys

import pytest

_bridge = sys.modules.get("jax._src.xla_bridge")
ON_DEVICE = _bridge is not None and _bridge.backends_are_initialized()

if not ON_DEVICE:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    # CPU runs must NOT use the persistent compilation cache at all:
    # XLA:CPU AOT executables SEGFAULT on reload in this jaxlib even
    # same-host (the loader rejects its own "+prefer-no-scatter" tuning
    # pseudo-features, seen as crashes inside
    # compilation_cache.get_executable_and_time).  CPU compiles are
    # seconds each — correctness over startup speed.
    jax.config.update("jax_enable_compilation_cache", False)
    _CPUS = jax.devices("cpu")
    assert len(_CPUS) == 8, _CPUS
    jax.config.update("jax_default_device", _CPUS[0])


def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture
def gpu():
    """The GPU device, or a skip when this process has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on "
                    "the card")
    return dev
