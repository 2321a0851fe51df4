"""Test configuration: run the suite on a virtual 8-device CPU mesh in float64.

Sharding/halo tests exercise a ``jax.sharding.Mesh`` built from 8 virtual CPU
devices (``--xla_force_host_platform_device_count=8``), and the numerical oracles
run in float64 (``jax_enable_x64``) to expose the reference's convergence
orders. These settings must land before the first ``import jax``.

Tests marked ``gpu`` (``tests/test_gpu.py``) need a GPU and skip elsewhere; the
``gpu_device`` fixture decides that at run time. ``LSM_GPU_TESTS=1`` leaves the
platform to JAX so they can reach the card:
``LSM_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu.py``.
"""

import os

_GPU_MODE = os.environ.get("LSM_GPU_TESTS") == "1"

if not _GPU_MODE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The GPU the ``gpu``-marked tests run on; skips when there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (first device is {dev.platform})")
    return dev


def convergence_orders(errors, ns):
    """Observed convergence orders from an N-sweep (reference helper
    ``_convergence_orders``, ``test/test-levelsetequation.jl:8-10``)."""
    errors = [float(e) for e in errors]
    return [
        np.log(errors[i] / errors[i + 1]) / np.log(ns[i + 1] / ns[i])
        for i in range(len(ns) - 1)
    ]
