"""tame — a JAX probabilistic-inference framework for temporal
Additive-and-Multiplicative-Effects (AME) network models.

A ground-up JAX/XLA/pjit re-design with the capabilities of the reference
package ``Alfieriek/Python-Temporal-AME-SVI``: temporal AME generative
models with AR(1) latent dynamics, naive and structured mean-field CAVI
engines, HMC/SMC posterior backends, identifiability alignment, metrics,
diagnostics, visualization and reproducible experiment harnesses — all
batched, jit-compiled and shardable over GPU device meshes.

Quick start
-----------
>>> from tame.models import TemporalAMEModel
>>> from tame.inference import TemporalAMEStructuredMFVI
>>> model = TemporalAMEModel(n_nodes=15, n_time=10, latent_dim=2)
>>> Y, X_true = model.generate_data(return_latents=True)
>>> vi = TemporalAMEStructuredMFVI(model, factorization="good",
...                                learning_rate=0.7)
>>> history = vi.fit(max_iter=150, verbose=False)
>>> X_est = vi.get_variational_means()
"""

__version__ = "0.1.0"

from tame.config import InferenceConfig, MeshConfig, ModelConfig
from tame.models import BaseAMEModel, StaticAMEModel, TemporalAMEModel
from tame.inference import (
    TemporalAMECaviVI,
    TemporalAMENaiveMFVI,
    TemporalAMEStructuredMFVI,
)

__all__ = [
    "ModelConfig",
    "InferenceConfig",
    "MeshConfig",
    "BaseAMEModel",
    "StaticAMEModel",
    "TemporalAMEModel",
    "TemporalAMECaviVI",
    "TemporalAMENaiveMFVI",
    "TemporalAMEStructuredMFVI",
]
