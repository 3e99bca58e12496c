"""Temporal AME model: functional sampling core + reference-compatible class.

The generative process (reference ``src/models/temporal_ame.py:147-220``):

    X_i^0 ~ N(0, Sigma0),  X_i^t = Phi X_i^{t-1} + eps_t,  eps_t ~ N(0, Q)
    Y_ij^t = mu_ij^t + e,  e ~ N(0, R),  sampled once per unordered dyad.

Design: the AR(1) chain is one ``lax.scan`` over T vectorized over
all nodes; dyad noise is a single batched sample pushed through the Cholesky
factor of R and mirrored with :func:`tame.ops.dyad.symmetrize_dyads` — no
Python loops anywhere (contrast the reference's n*T and T*n^2/2 loops at
``temporal_ame.py:187-216``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array

from tame.config import ModelConfig
from tame.models.base import BaseAMEModel
from tame.models.params import AMEParams, build_params
from tame.ops import dyad as dyad_ops


# ---------------------------------------------------------------------------
# Functional core
# ---------------------------------------------------------------------------

def sample_latents(params: AMEParams, key: Array, n: int, T: int) -> Array:
    """Ancestral sampling of the AR(1) latent chain for all nodes at once.

    Returns
    -------
    X : (n, T, d)
    """
    d = params.d
    L0 = jnp.linalg.cholesky(params.Sigma0)
    LQ = jnp.linalg.cholesky(params.Q)
    k0, kp = jax.random.split(key)
    x0 = jax.random.normal(k0, (n, d)) @ L0.T                  # (n, d)
    eps = jax.random.normal(kp, (T - 1, n, d)) @ LQ.T if T > 1 else \
        jnp.zeros((0, n, d))

    def step(x_prev, e):
        x = x_prev @ params.Phi.T + e
        return x, x

    _, xs = jax.lax.scan(step, x0, eps)
    X = jnp.concatenate([x0[None], xs], axis=0)                # (T, n, d)
    return jnp.swapaxes(X, 0, 1)                               # (n, T, d)


def sample_observations(params: AMEParams, key: Array, X: Array,
                        family=None) -> Array:
    """Sample the dyadic observation tensor given latents.

    Default (Gaussian): one batched normal draw for every ordered
    (i, j, t) dyad slot, correlated through chol(R), then mirrored to
    enforce reciprocity.  ``family`` (:mod:`tame.models.likelihoods`,
    e.g. ``"poisson"``/``"bernoulli"``) swaps the observation model —
    counts/binary ties through the same bilinear predictor.

    Returns
    -------
    Y : (n, n, T, 2) with zero diagonal and Y[i,j,t,1] == Y[j,i,t,0].
    """
    n, T, d = X.shape
    r = params.r
    mu = dyad_ops.dyadic_mean_temporal(X, r)                   # (n, n, T, 2)
    if family is not None and getattr(family, "name", family) != "gaussian":
        from tame.models.likelihoods import get_family

        return get_family(family).sample(key, params, mu)
    LR = jnp.linalg.cholesky(params.R)
    noise = jax.random.normal(key, (n, n, T, 2)) @ LR.T
    return dyad_ops.symmetrize_dyads(mu + noise)


def sample(params: AMEParams, key: Array, n: int, T: int,
           family=None) -> Tuple[Array, Array]:
    """Sample (Y, X) from the temporal AME model (``family`` selects the
    dyadic observation model; default Gaussian)."""
    kx, ky = jax.random.split(key)
    X = sample_latents(params, kx, n, T)
    Y = sample_observations(params, ky, X, family=family)
    return Y, X


def random_dyad_mask(key: Array, n: int, T: int,
                     missing_frac: float) -> Array:
    """Random missing-at-random dyad observation mask.

    Each unordered dyad (i, j) at each time t is observed with probability
    ``1 - missing_frac``; the mask is symmetric (both directions of a dyad
    are stored in one ``Y[i, j, t]`` entry, so they are observed together)
    with zero diagonal.  Feed to ``fit_cavi(..., mask=...)`` / the engine
    classes' ``mask=`` — missing-data support the reference lacks (its
    update loops assume a complete network, ``naive_mf.py:324-374``).

    Returns a float32 ``(n, n, T)`` array of {0.0, 1.0}.
    """
    u = jax.random.uniform(key, (n, n, T))
    upper = jnp.triu(jnp.ones((n, n)), k=1)[:, :, None]
    keep = (u > missing_frac).astype(jnp.float32) * upper
    return keep + jnp.swapaxes(keep, 0, 1)


# ---------------------------------------------------------------------------
# Reference-compatible class surface
# ---------------------------------------------------------------------------

class TemporalAMEModel(BaseAMEModel):
    """Temporal AME model with AR(1) dynamics (batched JAX).

    Mirrors the reference class surface (``temporal_ame.py:25-362``): same
    constructor keywords, ``generate_data``, ``compute_mean``,
    ``get_states_at_time``, the reconstruction/contribution metrics, and the
    ``Phi/Q/R/Sigma/Psi/X/Y`` attributes.  Differences (deliberate):

    * randomness is keyed (``jax.random``), so the ``seed`` argument actually
      controls the sample — the reference's constructor seeding is broken
      (reference ``static_ame.py:89`` passes ``seed`` into a ``sigma`` slot);
    * all sampling and metrics are batched jit-compiled JAX.
    """

    def __init__(
        self,
        n_nodes: int,
        n_time: int,
        latent_dim: int = 2,
        ar_coefficient: float = 0.8,
        rho_additive: float = 0.5,
        rho_multiplicative: float = 0.3,
        rho_dyadic: float = 0.5,
        process_noise_scale: float = 0.1,
        seed: int = 42,
    ):
        self.config = ModelConfig(
            n_nodes=n_nodes,
            n_time=n_time,
            latent_dim=latent_dim,
            ar_coefficient=ar_coefficient,
            rho_additive=rho_additive,
            rho_multiplicative=rho_multiplicative,
            rho_dyadic=rho_dyadic,
            process_noise_scale=process_noise_scale,
            seed=seed,
        )
        self.params = build_params(self.config)
        self.n = n_nodes
        self.T = n_time
        self.r = latent_dim
        self.d = self.config.d
        self.ar_coefficient = ar_coefficient
        self.process_noise_scale = process_noise_scale
        self.rho_additive = rho_additive
        self.rho_multiplicative = rho_multiplicative
        self.rho_dyadic = rho_dyadic
        self.seed = seed
        self._key = jax.random.PRNGKey(seed)

        self.X: Optional[Array] = None
        self.Y: Optional[Array] = None

    # -- parameter matrices (reference attribute names) --------------------
    @property
    def Sigma(self) -> Array:
        return self.params.Sigma

    @property
    def Psi(self) -> Array:
        return self.params.Psi

    @property
    def R(self) -> Array:
        return self.params.R

    @property
    def R_inv(self) -> Array:
        return self.params.R_inv

    @property
    def Phi(self) -> Array:
        return self.params.Phi

    @property
    def Q(self) -> Array:
        return self.params.Q

    # -- data generation ---------------------------------------------------
    def generate_data(self, return_latents: bool = False, key=None):
        """Generate (and store) a synthetic dataset.

        Equivalent of reference ``temporal_ame.py:147-220``.  Consecutive
        calls consume fresh PRNG subkeys so repeated generation yields new
        data; pass ``key`` to override.
        """
        if key is None:
            self._key, key = jax.random.split(self._key)
        Y, X = sample(self.params, key, self.n, self.T)
        Y = jax.block_until_ready(Y)
        self.Y, self.X = Y, X
        if return_latents:
            return Y, X
        return Y

    def compute_mean(self, A: Array, M: Array) -> Array:
        """Snapshot mean structure (reference ``static_ame.py:189-238``)."""
        return dyad_ops.dyadic_mean_static(jnp.asarray(A), jnp.asarray(M),
                                           self.r)

    def get_states_at_time(self, t: int) -> Tuple[Array, Array]:
        """(A_t, M_t) slices of the stored latents
        (reference ``temporal_ame.py:222-253``)."""
        if self.X is None:
            raise ValueError("No data generated yet. Call generate_data() first.")
        if t < 0 or t >= self.T:
            raise ValueError(f"Time index {t} out of bounds [0, {self.T}).")
        return self.X[:, t, :2], self.X[:, t, 2:]

    # -- metrics -----------------------------------------------------------
    def compute_temporal_reconstruction_error(self, X_est: Array) -> float:
        """Model-level reconstruction MSE (reference
        ``temporal_ame.py:255-291``; per-dyad normalization n(n-1)T)."""
        if self.Y is None:
            raise ValueError("No data generated yet. Call generate_data() first.")
        mu = dyad_ops.dyadic_mean_temporal(jnp.asarray(X_est), self.r)
        return float(dyad_ops.masked_sq_error_temporal(self.Y, mu))

    def compute_state_prediction_error(self, X_est: Array) -> float:
        """Mean squared error in state space (reference
        ``temporal_ame.py:293-313``)."""
        if self.X is None:
            raise ValueError("No data generated yet. Call generate_data() first.")
        return float(jnp.mean((self.X - jnp.asarray(X_est)) ** 2))

    def compute_additive_contribution(self, A: Array) -> float:
        return float(dyad_ops.additive_contribution(jnp.asarray(A)))

    def compute_multiplicative_contribution(self, M: Array) -> float:
        return float(dyad_ops.multiplicative_contribution(jnp.asarray(M)))

    def compute_temporal_additive_contribution(self, X: Array) -> Array:
        """Per-time additive variance contribution (reference
        ``temporal_ame.py:315-338``), vmapped over T."""
        X = jnp.asarray(X)
        return jax.vmap(
            lambda A: dyad_ops.additive_contribution(A)
        )(jnp.swapaxes(X[:, :, :2], 0, 1))

    def compute_temporal_multiplicative_contribution(self, X: Array) -> Array:
        """Per-time multiplicative variance contribution (reference
        ``temporal_ame.py:340-362``), vmapped over T."""
        X = jnp.asarray(X)
        return jax.vmap(
            lambda M: dyad_ops.multiplicative_contribution(M)
        )(jnp.swapaxes(X[:, :, 2:], 0, 1))
