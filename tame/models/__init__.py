"""AME generative models (static and temporal), batched JAX."""

from tame.models.base import BaseAMEModel
from tame.models.likelihoods import (
    BernoulliDyadic,
    GaussianDyadic,
    NegativeBinomialDyadic,
    PoissonDyadic,
    get_family,
)
from tame.models.params import AMEParams, build_params
from tame.models.static_ame import StaticAMEModel, sample_static
from tame.models.temporal_ame import (
    TemporalAMEModel,
    random_dyad_mask,
    sample,
    sample_latents,
    sample_observations,
)

__all__ = [
    "AMEParams",
    "BaseAMEModel",
    "BernoulliDyadic",
    "GaussianDyadic",
    "NegativeBinomialDyadic",
    "PoissonDyadic",
    "build_params",
    "get_family",
    "random_dyad_mask",
    "StaticAMEModel",
    "TemporalAMEModel",
    "sample",
    "sample_latents",
    "sample_observations",
    "sample_static",
]
