"""Test configuration.

Tests run on a virtual 8-device CPU mesh (SURVEY.md §4: multi-host tests
via fake-device meshes substitute for the reference's shared-directory
cluster simulation, ``Controller.py:22-32``), whatever accelerator the
machine has.  The platform is set through ``jax.config`` before the
first backend use, so it holds even where JAX was imported earlier.
What needs the GPU is checked by ``chip_smoke.py`` on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
