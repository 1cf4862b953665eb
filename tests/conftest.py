"""Test configuration: the CPU backend with 8 virtual devices, so the full
suite (sharding tests included) runs without an accelerator.

Must run before anything imports jax — pytest imports conftest first.
``RAYTRACER_TESTS_ON_GPU=1`` leaves the platform alone so the tests
marked ``gpu`` can run on a card.
"""

import os
import sys

ON_GPU = os.environ.get("RAYTRACER_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
# no persistent compile cache: CLI tests call enable_persistent_cache()
# in-process, so the suite gets no cross-process reuse from it and would
# only pay for serializing every executable it compiles
os.environ["RAYTRACER_TPU_CACHE"] = "off"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU (decided at run time,
    never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card with RAYTRACER_TESTS_ON_GPU=1)")
