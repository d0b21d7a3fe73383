"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Tests run hermetically on the CPU (whatever JAX_PLATFORMS says) with a
forced 8-device host platform, so sharding tests exercise real
multi-device code paths.  The GPU is exercised by chip_smoke.py.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(__file__))

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def oracle():
    """Path to the reference binary built from /root/reference, or skip."""
    from helpers.synth import REF_COLATE, have_oracle

    if not have_oracle():
        pytest.skip("reference oracle binary not built (/tmp/refbin/Colate)")
    return REF_COLATE


@pytest.fixture(scope="session")
def fixture_small(tmp_path_factory):
    from helpers.synth import make_fixture

    root = tmp_path_factory.mktemp("synth_small")
    return make_fixture(str(root), n_per_chrom=3000, seed=21)
