"""Test environment: the CPU backend with 32 fake devices, by default.

Multi-device sharding tests run on a virtual CPU mesh
(``--xla_force_host_platform_device_count``), the standard way to exercise
``shard_map``/``ppermute`` layouts without several accelerators. The
platform defaults to ``cpu`` only when ``JAX_PLATFORMS`` is unset, so
``JAX_PLATFORMS=cuda python -m pytest -m gpu`` runs the card's tests on
the card (tests marked ``gpu`` skip elsewhere, see the ``gpu`` fixture).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    # 32 fake devices: most tests slice an 8-device mesh out of these, the
    # multi-device hardening tests (test_parallel.py) go up to D=16/32.
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=32").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless the first JAX device is a GPU (decided here, when the
    test runs — never at import or collection time)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def reference_data_dir():
    """The reference repo's dataset directory, if mounted."""
    import pathlib

    p = pathlib.Path("/root/reference/main_project/data")
    if not p.is_dir():
        pytest.skip("reference data not available")
    return p
