"""Test config.

The suite runs on the CPU by default, with 8 virtual devices for the
sharding tests; Pallas kernels then run in interpret mode. Tests marked
``gpu`` need the card and skip elsewhere; on a machine with one, run them
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.

Oracle strategy mirrors the reference (SURVEY.md §4): numpy oracles in
deepfusion_tpu.ops.ref play MKL-DNN's role.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="session")
def _kernel_mode():
    """Kernels run compiled on a GPU and in the Pallas interpreter on the
    CPU backend."""
    from deepfusion_tpu.utils import env
    env.set_interpret_kernels(jax.default_backend() == "cpu")
    yield


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
