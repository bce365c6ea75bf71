"""Test configuration.

Tests run on CPU (``JAX_PLATFORMS=cpu``) with 8 virtual devices, so
multi-device sharding paths are exercised without a GPU.  Tests marked
``gpu`` need the card and skip here; ``chip_smoke.py`` runs them on it.
These env vars must be set before jax is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# the config update pins the platform even where a GPU plugin is installed;
# chip_smoke.py runs the ``gpu`` tests with JAX_PLATFORMS=cuda
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


@pytest.fixture()
def rng(request):
    # Per-test deterministic stream, independent of which other tests ran:
    # a session-scoped generator makes every assertion depend on suite order.
    import zlib

    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


# Real-ONT smoke fixture (280 COI reads).  We read it from the mounted
# reference checkout rather than duplicating the data in this repo; tests
# using it skip when the mount is absent.
SAMPLE_FASTQ = "/root/reference/test/sample_h1.fastq"


@pytest.fixture(scope="session")
def sample_fastq():
    if not os.path.isfile(SAMPLE_FASTQ):
        pytest.skip("reference sample_h1.fastq not available")
    return SAMPLE_FASTQ
