"""Shared test fixtures.

Tests run on a virtual 8-device CPU mesh, so the multi-device sharding
logic is exercised without GPUs (the env vars must be set before JAX is
imported).  Tests marked ``gpu`` need a CUDA GPU and take the ``gpu``
fixture, which skips them elsewhere; run them on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
Mirrors the reference's fixture strategy (its ``tests/conftest.py``): tiny
seeded synthetic networks, no mocks — everything runs the real code.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# Persistent compilation cache, keyed per host CPU: XLA:CPU AOT blobs
# embed the build host's feature set and can SIGILL/segfault when loaded
# on a different machine (tame/utils/cache.py).
from tame.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache(jax)

from tame.models import StaticAMEModel, TemporalAMEModel  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless the default backend is a CUDA GPU (decided when the
    test runs, never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU: run with JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/ on the card")


@pytest.fixture
def seed():
    return 42


@pytest.fixture
def small_network_params():
    return {"n_nodes": 10, "latent_dim": 2, "seed": 42}


@pytest.fixture
def temporal_network_params():
    return {"n_nodes": 10, "n_time": 5, "latent_dim": 2,
            "ar_coefficient": 0.8, "seed": 42}


@pytest.fixture
def static_model(small_network_params):
    return StaticAMEModel(**small_network_params)


@pytest.fixture
def temporal_model(temporal_network_params):
    return TemporalAMEModel(**temporal_network_params)


@pytest.fixture
def static_data(static_model):
    Y, A, M = static_model.generate_data(return_latents=True)
    return {"model": static_model, "Y": Y, "A": A, "M": M}


@pytest.fixture
def temporal_data(temporal_model):
    Y, X = temporal_model.generate_data(return_latents=True)
    return {"model": temporal_model, "Y": Y, "X": X}


@pytest.fixture
def mock_history():
    """Hand-written history for diagnostics/plot tests without running
    inference (reference ``conftest.py:81-87``)."""
    return {
        "elbo": [-1000.0, -900.0, -850.0, -830.0, -825.0],
        "reconstruction_error": [0.5, 0.4, 0.35, 0.33, 0.32],
    }


@pytest.fixture
def rng_key(seed):
    return jax.random.PRNGKey(seed)
