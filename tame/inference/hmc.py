"""Hamiltonian Monte Carlo for the temporal AME posterior.

Design (no counterpart in the reference; mandated by the north star):
the leapfrog integrator runs on the full latent tensor (n, T, d) with
batched gradient evaluations (each gradient is the O(n^2 T) einsum stack of
``tame.inference.logprob``); chains are ``vmap``-ed and shard over the
``batch`` mesh axis.

Adaptation:
* step size — Nesterov dual averaging toward a target acceptance rate
  (Hoffman & Gelman 2014, Algorithm 5 parameters);
* diagonal mass matrix — either identity, adapted from warmup-sample
  variances, or (the framework-native trick) preconditioned with the
  variational variances of a short CAVI fit (``precondition_from_cavi``),
  which matches the posterior scale per (node, time, dim) without spending
  warmup on covariance estimation.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array


class HMCState(NamedTuple):
    position: Array
    logdensity: Array
    grad: Array


class DualAveragingState(NamedTuple):
    log_eps: Array
    log_eps_avg: Array
    grad_avg: Array
    mu: Array
    count: Array


class HMCSamples(NamedTuple):
    positions: Array        # (num_samples, *position_shape)
    accept_prob: Array      # (num_samples,) mean MH accept probability
    step_size: Array        # final adapted step size
    logdensities: Array     # (num_samples,)


def _leapfrog(logdensity_fn: Callable, position: Array, momentum: Array,
              grad: Array, step_size: Array, inv_mass: Array,
              num_steps: int) -> Tuple[Array, Array, Array, Array]:
    """Velocity-Verlet integration of Hamiltonian dynamics; returns
    (position, momentum, logdensity, grad) at the trajectory end."""

    def body(carry, _):
        pos, mom, g = carry
        mom = mom + 0.5 * step_size * g
        pos = pos + step_size * inv_mass * mom
        logp, g = jax.value_and_grad(logdensity_fn)(pos)
        mom = mom + 0.5 * step_size * g
        return (pos, mom, g), logp

    (position, momentum, grad), logps = jax.lax.scan(
        body, (position, momentum, grad), None, length=num_steps)
    return position, momentum, logps[-1], grad


def _kinetic(momentum: Array, inv_mass: Array) -> Array:
    return 0.5 * jnp.sum(momentum * inv_mass * momentum)


def hmc_kernel(logdensity_fn: Callable, state: HMCState, key: Array,
               step_size: Array, inv_mass: Array, num_leapfrog: int
               ) -> Tuple[HMCState, Array]:
    """One HMC transition; returns (new_state, accept_probability)."""
    k_mom, k_acc = jax.random.split(key)
    # momentum ~ N(0, M) with M = 1 / inv_mass
    momentum = (jax.random.normal(k_mom, state.position.shape)
                / jnp.sqrt(inv_mass))
    energy0 = -state.logdensity + _kinetic(momentum, inv_mass)

    pos, mom, logp, grad = _leapfrog(
        logdensity_fn, state.position, momentum, state.grad, step_size,
        inv_mass, num_leapfrog)
    energy1 = -logp + _kinetic(mom, inv_mass)

    delta = energy0 - energy1
    delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
    accept_prob = jnp.minimum(1.0, jnp.exp(delta))
    accept = jax.random.uniform(k_acc) < accept_prob

    new_state = HMCState(
        position=jnp.where(accept, pos, state.position),
        logdensity=jnp.where(accept, logp, state.logdensity),
        grad=jnp.where(accept, grad, state.grad),
    )
    return new_state, accept_prob


def _da_init(step_size: Array) -> DualAveragingState:
    return DualAveragingState(
        log_eps=jnp.log(step_size),
        log_eps_avg=jnp.log(step_size),
        grad_avg=jnp.asarray(0.0),
        mu=jnp.log(10.0 * step_size),
        count=jnp.asarray(0.0),
    )


def _da_update(da: DualAveragingState, accept_prob: Array,
               target: float = 0.8, gamma: float = 0.05, t0: float = 10.0,
               kappa: float = 0.75) -> DualAveragingState:
    count = da.count + 1.0
    w = 1.0 / (count + t0)
    grad_avg = (1.0 - w) * da.grad_avg + w * (target - accept_prob)
    log_eps = da.mu - jnp.sqrt(count) / gamma * grad_avg
    eta = count ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * da.log_eps_avg
    return DualAveragingState(log_eps=log_eps, log_eps_avg=log_eps_avg,
                              grad_avg=grad_avg, mu=da.mu, count=count)


@functools.partial(jax.jit,
                   static_argnames=("logdensity_fn", "num_warmup",
                                    "num_samples", "num_leapfrog",
                                    "target_accept", "thin"))
def run_hmc(logdensity_fn: Callable, init_position: Array, key: Array, *,
            num_warmup: int = 200, num_samples: int = 200,
            num_leapfrog: int = 16, initial_step_size: float = 0.01,
            inv_mass: Optional[Array] = None, target_accept: float = 0.8,
            thin: int = 1, logdensity_args: tuple = ()) -> HMCSamples:
    """Run one HMC chain: dual-averaging warmup, then sampling.

    ``inv_mass`` is a per-coordinate inverse mass (posterior variance
    scale); defaults to identity.  vmap over (init_position, key) for
    multiple chains.

    ``logdensity_args``: extra DATA operands forwarded to
    ``logdensity_fn(x, *logdensity_args)``.  Pass the observation tensor
    (and mask) here rather than closing over them — closed-over arrays
    are baked into the compiled program as constants, which bloats the
    executable and its compile time.
    """
    if logdensity_args:
        base_fn = logdensity_fn
        logdensity_fn = lambda x: base_fn(x, *logdensity_args)  # noqa: E731
    if inv_mass is None:
        inv_mass = jnp.ones_like(init_position)

    logp, grad = jax.value_and_grad(logdensity_fn)(init_position)
    state = HMCState(position=init_position, logdensity=logp, grad=grad)

    # -- warmup: adapt step size ------------------------------------------
    def warm_body(carry, k):
        state, da = carry
        state, accept_prob = hmc_kernel(
            logdensity_fn, state, k, jnp.exp(da.log_eps), inv_mass,
            num_leapfrog)
        da = _da_update(da, accept_prob, target=target_accept)
        return (state, da), None

    k_warm, k_sample = jax.random.split(key)
    (state, da), _ = jax.lax.scan(
        warm_body, (state, _da_init(jnp.asarray(initial_step_size))),
        jax.random.split(k_warm, num_warmup))
    step_size = jnp.exp(da.log_eps_avg)

    # -- sampling ----------------------------------------------------------
    def sample_body(state, k):
        def inner(state, kk):
            state, accept_prob = hmc_kernel(
                logdensity_fn, state, kk, step_size, inv_mass, num_leapfrog)
            return state, accept_prob

        state, aps = jax.lax.scan(inner, state, jax.random.split(k, thin))
        return state, (state.position, aps.mean(), state.logdensity)

    _, (positions, accept_probs, logps) = jax.lax.scan(
        sample_body, state, jax.random.split(k_sample, num_samples))
    return HMCSamples(positions=positions, accept_prob=accept_probs,
                      step_size=step_size, logdensities=logps)


def precondition_from_cavi(Y, params, structure: str = "full",
                           warm_iters: int = 50, learning_rate: float = 0.5,
                           seed: int = 0, mask=None):
    """Run a short CAVI fit and return ``(init_position, inv_mass)``:
    the variational means as the chain start and the variational variances
    as the diagonal inverse mass.  CAVI costs a handful of iterations and
    removes the need for covariance adaptation during warmup.  ``mask``
    makes the warm fit a masked (missing-data) fit so hidden entries of
    ``Y`` are never read."""
    from tame.inference import cavi

    n, _, T, _ = Y.shape
    d = params.d
    init = cavi.init_state(jax.random.PRNGKey(seed), n, T, d, structure,
                           0.1, 0.5)
    out = cavi.fit_cavi(Y, params, init, structure=structure,
                        update_mode="jacobi", max_iter=warm_iters,
                        learning_rate=learning_rate, mask=mask)
    variances = jnp.diagonal(out.X_cov, axis1=-2, axis2=-1)  # (n, T, d)
    return out.X_mean, jnp.clip(variances, 1e-6, None)


class TemporalAMEHMC:
    """HMC posterior sampler with the reference-compatible class feel.

    Chains are vmapped; shard them over the ``batch`` mesh axis for
    multi-chip scaling (see ``tame.parallel``).
    """

    def __init__(self, model, num_chains: int = 4, num_leapfrog: int = 16,
                 seed: int = 0, precondition: bool = True,
                 mask=None, family=None):
        if model.Y is None:
            raise ValueError(
                "Model has no data. Call model.generate_data() first.")
        self.model = model
        self.Y = jnp.asarray(model.Y)
        self.num_chains = num_chains
        self.num_leapfrog = num_leapfrog
        self.seed = seed
        # Declared dyadic likelihood family (tame.models.likelihoods).
        # Non-Gaussian families skip CAVI preconditioning (the warm fit
        # is the GAUSSIAN conjugate update; its covariances are not a
        # meaningful mass matrix for counts/binary ties).
        if family is not None:
            from tame.models.likelihoods import get_family

            family = get_family(family)
            if family.name != "gaussian":
                precondition = False
        self.family = family
        self.precondition = precondition

        from tame.inference.logprob import log_joint, make_logdensity_fn
        from tame.inference.logprob import precompute

        # Optional (n, n, T) dyad observation mask: the target becomes
        # the missing-data posterior (observed dyads only), matching the
        # masked CAVI engines' surface.
        self.mask = None if mask is None else jnp.asarray(mask)
        self._logdensity = make_logdensity_fn(model.params, self.Y,
                                              obs_mask=self.mask,
                                              family=self.family)
        # Pure variant + data operands for the jitted samplers: Y (and
        # the mask) must travel as ARGUMENTS, not closure constants —
        # closures are baked into the compile RPC (CLAUDE.md ~100MB cap).
        consts = precompute(model.params)
        params = model.params
        fam = self.family
        if self.mask is None:
            self._pure_logdensity = (
                lambda x, Y: log_joint(params, Y, x, consts, family=fam))
            self._ld_args = (self.Y,)
        else:
            m = self.mask * (1.0 - jnp.eye(self.Y.shape[0],
                                           dtype=self.Y.dtype)[:, :, None])
            self._pure_logdensity = (
                lambda x, Y, om: log_joint(params, Y, x, consts,
                                           obs_mask=om, family=fam))
            self._ld_args = (self.Y, m)

    def sample(self, num_warmup: int = 200, num_samples: int = 200,
               thin: int = 1, mesh=None) -> HMCSamples:
        """Run ``num_chains`` chains; returns stacked samples with leading
        axes (chains, num_samples).

        With ``mesh`` (a ``tame.parallel`` mesh), chain inits and keys are
        placed on the ``batch`` axis and GSPMD runs each device's chains
        locally — data parallelism over independent chains, no collectives
        (``num_chains`` must be divisible by the batch-axis size)."""
        key = jax.random.PRNGKey(self.seed)
        k_init, k_chains = jax.random.split(key)

        if self.precondition:
            center, inv_mass = precondition_from_cavi(
                self.Y, self.model.params, seed=self.seed,
                mask=self.mask)
        else:
            center = jnp.zeros((self.model.n, self.model.T, self.model.d))
            inv_mass = jnp.ones_like(center)

        inits = center[None] + 0.01 * jax.random.normal(
            k_init, (self.num_chains,) + center.shape)
        keys = jax.random.split(k_chains, self.num_chains)
        inits, keys = _shard_chains(mesh, inits, keys)

        run = functools.partial(
            run_hmc, self._pure_logdensity,
            num_warmup=num_warmup, num_samples=num_samples,
            num_leapfrog=self.num_leapfrog, inv_mass=inv_mass, thin=thin,
            logdensity_args=self._ld_args)
        out = jax.vmap(lambda pos, k: run(pos, k))(inits, keys)
        # Diagnostics are computed lazily in diagnostics(): the R-hat/ESS
        # pass copies the whole sample stack to the host, which must not
        # tax production sample() calls at sharded-chain scale.
        self._last_sample = out
        self.last_diagnostics = None
        return out

    def diagnostics(self):
        """Convergence report of the most recent :meth:`sample` call:
        max split-R-hat, min/median ESS, log-density R-hat (see
        :func:`tame.utils.diagnostics.chain_diagnostics`).  Computed on
        first call and cached until the next :meth:`sample`."""
        return _lazy_diagnostics(self)


def _lazy_diagnostics(sampler):
    """Shared lazy diagnostics accessor for HMC/NUTS engine classes."""
    if getattr(sampler, "last_diagnostics", None) is not None:
        return sampler.last_diagnostics
    out = getattr(sampler, "_last_sample", None)
    if out is None:
        raise RuntimeError("call sample() first")
    C, N = out.positions.shape[:2]
    if C < 2 or N < 4:
        raise RuntimeError(
            f"chain diagnostics need >= 2 chains and >= 4 draws to "
            f"estimate split-R-hat; got {C} chain(s) x {N} draw(s)")
    from tame.utils.diagnostics import chain_diagnostics

    sampler.last_diagnostics = chain_diagnostics(out.positions,
                                                 out.logdensities)
    return sampler.last_diagnostics


def _shard_chains(mesh, inits, keys):
    """Place (chains, ...) stacks on a mesh's ``batch`` axis (no-op when
    ``mesh`` is None)."""
    if mesh is None:
        return inits, keys
    from tame.parallel import chain_sharding

    return (jax.device_put(inits, chain_sharding(mesh, inits.ndim)),
            jax.device_put(keys, chain_sharding(mesh, keys.ndim)))
