"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Unit tests exercise the jitted code paths on the host CPU with 8
virtual devices, so multi-device sharding logic is tested without
accelerators.  ATPU_TEST_PLATFORM picks another platform explicitly:
``ATPU_TEST_PLATFORM=cuda python -m pytest -m gpu tests/`` runs the
tests marked ``gpu`` on a card (they skip elsewhere, decided by the
``gpu`` fixture).
"""

import os
import sys

import pytest

os.environ["JAX_PLATFORMS"] = os.environ.get(
    "ATPU_TEST_PLATFORM", "cpu")
# an installed pytest plugin may import jax BEFORE this conftest runs,
# freezing the jax_platforms flag; backends are not initialized yet at
# conftest time, so updating the live config still takes
if "jax" in sys.modules:
    sys.modules["jax"].config.update(
        "jax_platforms", os.environ["JAX_PLATFORMS"])
# unit tests default to the numpy analysis backend (byte-identical to
# jax by the contraction-immune kernel spec) so the suite isn't
# dominated by one-off jit compiles; jax-path tests opt in explicitly
os.environ.setdefault("ATPU_FLAC_BACKEND", "numpy")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_DIR = "/root/reference"


def reference_available():
    return os.path.isdir(os.path.join(REFERENCE_DIR, "test"))


@pytest.fixture
def gpu():
    """skips the test unless JAX's default backend is a GPU"""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (ATPU_TEST_PLATFORM=cuda on a card)")
    return jax.devices()[0]
