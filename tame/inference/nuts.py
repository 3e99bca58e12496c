"""No-U-Turn Sampler (iterative, non-recursive) for the temporal AME
posterior.

A NUTS built for compiled accelerator code: the recursive doubling of
Hoffman & Gelman (2014) is replaced by the iterative checkpoint-stack
scheme (cf. Phan & Pradhan, "Iterative NUTS"), so the whole sampler is
``lax.while_loop``s with static shapes — no Python recursion, no dynamic
tree allocation, jit/vmap-able over chains.

U-turn bookkeeping inside a 2^depth subtree (1-indexed leapfrog steps k):

* odd  k — store (z_k, v_k) at checkpoint slot ``popcount((k-1)/2)``;
* even k — with ``t = trailing_zeros(k)`` and ``pc = popcount(k/2)``, the
  balanced subtrees ending at k have their start states in slots
  ``[pc-1, pc+t-2]``; check the original endpoint criterion
  ``dot(z_k - z_a, v_a) < 0 or dot(z_k - z_a, v_k) < 0`` against each.

At most ``max_depth+1`` checkpoints are ever live.  Candidate draws use
progressive multinomial sampling over leaf weights ``exp(-energy)``; the
trajectory stops on sub-tree U-turn, whole-trajectory U-turn, or
divergence.  Step size comes from the shared dual-averaging warmup
(``tame.inference.hmc``); the diagonal mass matrix can be CAVI-
preconditioned exactly like HMC.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array

from tame.inference.hmc import (
    HMCSamples,
    _da_init,
    _da_update,
    precondition_from_cavi,
)


class _NutsCarry(NamedTuple):
    # trajectory edges (z, velocity-scaled momentum grad frame)
    z_left: Array
    r_left: Array
    grad_left: Array
    z_right: Array
    r_right: Array
    grad_right: Array
    # progressive candidate
    z_cand: Array
    logp_cand: Array
    log_sum_w: Array
    # control
    depth: Array
    turning: Array
    diverging: Array
    sum_accept: Array   # for dual averaging (mean MH accept proxy)
    n_leaf: Array
    key: Array


def _popcount(x: Array) -> Array:
    x = x.astype(jnp.uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24).astype(jnp.int32)


def _trailing_zeros(x: Array) -> Array:
    """Number of trailing zero bits of a positive int32."""
    return _popcount((x & -x) - 1)


def _dot(a: Array, b: Array) -> Array:
    return jnp.sum(a * b)


@functools.partial(jax.jit, static_argnames=("logdensity_fn", "max_depth"))
def nuts_kernel(logdensity_fn: Callable, position: Array, key: Array,
                step_size: Array, inv_mass: Array, max_depth: int = 8):
    """One NUTS transition.  Returns (new_position, new_logp, stats dict)."""
    k_mom, k_dir, k_inner = jax.random.split(key, 3)
    logp0, grad0 = jax.value_and_grad(logdensity_fn)(position)
    momentum = jax.random.normal(k_mom, position.shape) / jnp.sqrt(inv_mass)
    energy0 = -logp0 + 0.5 * _dot(momentum, inv_mass * momentum)

    nckpt = max_depth + 1
    z_ck = jnp.zeros((nckpt,) + position.shape, position.dtype)
    v_ck = jnp.zeros_like(z_ck)

    def leapfrog(z, r, grad, eps):
        r = r + 0.5 * eps * grad
        z = z + eps * inv_mass * r
        logp, grad = jax.value_and_grad(logdensity_fn)(z)
        r = r + 0.5 * eps * grad
        return z, r, logp, grad

    def build_subtree(carry, direction, depth, key):
        """Integrate 2^depth leapfrog steps from the trajectory edge in
        ``direction``; returns updated edge, subtree candidate/weight and
        termination flags."""
        eps = direction * step_size
        n_steps = jnp.left_shift(jnp.asarray(1, jnp.int32), depth)

        z0 = jnp.where(direction > 0, carry.z_right, carry.z_left)
        r0 = jnp.where(direction > 0, carry.r_right, carry.r_left)
        g0 = jnp.where(direction > 0, carry.grad_right, carry.grad_left)

        init = dict(
            k=jnp.asarray(1, jnp.int32), z=z0, r=r0, grad=g0,
            z_cand=z0, logp_cand=jnp.asarray(-jnp.inf, position.dtype),
            log_w=jnp.asarray(-jnp.inf, position.dtype),
            z_ck=z_ck, v_ck=v_ck,
            turning=jnp.asarray(False), diverging=jnp.asarray(False),
            sum_acc=jnp.asarray(0.0, position.dtype),
            key=key,
        )

        def cond(st):
            return jnp.logical_and(
                st["k"] <= n_steps,
                jnp.logical_not(st["turning"] | st["diverging"]))

        def body(st):
            z, r, logp, grad = leapfrog(st["z"], st["r"], st["grad"], eps)
            energy = -logp + 0.5 * _dot(r, inv_mass * r)
            delta = energy0 - energy
            delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
            diverging = delta < -1000.0
            accept_proxy = jnp.minimum(1.0, jnp.exp(delta))

            # progressive multinomial within the subtree
            log_w_new = jnp.logaddexp(st["log_w"], delta)
            key, k_acc = jax.random.split(st["key"])
            take = (jnp.log(jax.random.uniform(k_acc))
                    < delta - log_w_new)
            z_cand = jnp.where(take, z, st["z_cand"])
            logp_cand = jnp.where(take, logp, st["logp_cand"])

            # Checkpoint bookkeeping.  Velocities are direction-signed:
            # leftward integration (eps < 0) visits states in reverse time
            # order, and multiplying v by the direction makes the
            # Hoffman-Gelman endpoint criterion read identically in both
            # frames (dz in integration order against dir * forward-v).
            v = direction * (inv_mass * r)
            k_idx = st["k"]
            is_odd = (k_idx % 2) == 1
            slot = _popcount((k_idx - 1) // 2)
            z_ck_new = jnp.where(
                is_odd, st["z_ck"].at[slot].set(z), st["z_ck"])
            v_ck_new = jnp.where(
                is_odd, st["v_ck"].at[slot].set(v), st["v_ck"])

            pc = _popcount(k_idx // 2)
            tz = _trailing_zeros(jnp.maximum(k_idx, 1))
            lo = pc - 1
            hi = pc + tz - 2  # inclusive

            def check_slot(s, turning):
                za = z_ck_new[s]
                va = v_ck_new[s]
                dz = z - za
                turn = jnp.logical_or(_dot(dz, va) < 0.0,
                                      _dot(dz, v) < 0.0)
                return jnp.logical_or(turning, turn)

            def run_checks(turning):
                return jax.lax.fori_loop(
                    lo, hi + 1,
                    lambda s, t: check_slot(s, t), turning)

            turning = jnp.where(
                jnp.logical_and(jnp.logical_not(is_odd), hi >= lo),
                run_checks(st["turning"]), st["turning"])

            return dict(k=k_idx + 1, z=z, r=r, grad=grad, z_cand=z_cand,
                        logp_cand=logp_cand, log_w=log_w_new,
                        z_ck=z_ck_new, v_ck=v_ck_new, turning=turning,
                        diverging=jnp.logical_or(st["diverging"],
                                                 diverging),
                        sum_acc=st["sum_acc"] + accept_proxy, key=key)

        st = jax.lax.while_loop(cond, body, init)
        return st

    def outer_cond(carry):
        return jnp.logical_and(
            carry.depth < max_depth,
            jnp.logical_not(carry.turning | carry.diverging))

    def outer_body(carry):
        key, k_dir, k_sub, k_swap = jax.random.split(carry.key, 4)
        direction = jnp.where(jax.random.bernoulli(k_dir), 1.0, -1.0)
        st = build_subtree(carry, direction, carry.depth, k_sub)

        # new edge on the integrated side
        z_left = jnp.where(direction > 0, carry.z_left, st["z"])
        r_left = jnp.where(direction > 0, carry.r_left, st["r"])
        g_left = jnp.where(direction > 0, carry.grad_left, st["grad"])
        z_right = jnp.where(direction > 0, st["z"], carry.z_right)
        r_right = jnp.where(direction > 0, st["r"], carry.r_right)
        g_right = jnp.where(direction > 0, st["grad"], carry.grad_right)

        subtree_ok = jnp.logical_not(st["turning"] | st["diverging"])
        # progressive sampling across subtrees (biased-progressive form)
        log_sum_new = jnp.logaddexp(carry.log_sum_w, st["log_w"])
        take = jnp.logical_and(
            subtree_ok,
            jnp.log(jax.random.uniform(k_swap))
            < st["log_w"] - carry.log_sum_w)
        z_cand = jnp.where(take, st["z_cand"], carry.z_cand)
        logp_cand = jnp.where(take, st["logp_cand"], carry.logp_cand)
        log_sum_w = jnp.where(subtree_ok, log_sum_new, carry.log_sum_w)

        # whole-trajectory U-turn (velocity frame)
        dz = z_right - z_left
        v_l = inv_mass * r_left
        v_r = inv_mass * r_right
        traj_turn = jnp.logical_or(_dot(dz, v_l) < 0.0,
                                   _dot(dz, v_r) < 0.0)

        return _NutsCarry(
            z_left=z_left, r_left=r_left, grad_left=g_left,
            z_right=z_right, r_right=r_right, grad_right=g_right,
            z_cand=z_cand, logp_cand=logp_cand, log_sum_w=log_sum_w,
            depth=carry.depth + 1,
            turning=st["turning"] | traj_turn,
            diverging=carry.diverging | st["diverging"],
            sum_accept=carry.sum_accept + st["sum_acc"],
            n_leaf=carry.n_leaf + st["k"] - 1,
            key=key)

    carry0 = _NutsCarry(
        z_left=position, r_left=momentum, grad_left=grad0,
        z_right=position, r_right=momentum, grad_right=grad0,
        z_cand=position, logp_cand=logp0,
        log_sum_w=jnp.asarray(0.0, position.dtype),  # initial leaf w=1
        depth=jnp.asarray(0, jnp.int32),
        turning=jnp.asarray(False), diverging=jnp.asarray(False),
        sum_accept=jnp.asarray(0.0, position.dtype),
        n_leaf=jnp.asarray(0, jnp.int32), key=k_inner)

    out = jax.lax.while_loop(outer_cond, outer_body, carry0)
    accept_stat = out.sum_accept / jnp.maximum(out.n_leaf, 1)
    stats = {"accept_prob": accept_stat,
             "depth": out.depth,
             "n_leapfrog": out.n_leaf,
             "diverging": out.diverging}
    return out.z_cand, out.logp_cand, stats


@functools.partial(jax.jit,
                   static_argnames=("logdensity_fn", "num_warmup",
                                    "num_samples", "max_depth",
                                    "target_accept"))
def run_nuts(logdensity_fn: Callable, init_position: Array, key: Array, *,
             num_warmup: int = 200, num_samples: int = 200,
             max_depth: int = 8, initial_step_size: float = 0.01,
             inv_mass: Optional[Array] = None,
             target_accept: float = 0.8,
             logdensity_args: tuple = ()) -> HMCSamples:
    """Run one NUTS chain: dual-averaging warmup then sampling.

    Returns :class:`tame.inference.hmc.HMCSamples` (positions, accept
    statistic, final step size, log densities).  vmap over (init, key) for
    multiple chains.  ``logdensity_args``: data operands forwarded to
    ``logdensity_fn(x, *args)`` (see :func:`tame.inference.hmc.run_hmc`).
    """
    if logdensity_args:
        base_fn = logdensity_fn
        logdensity_fn = lambda x: base_fn(x, *logdensity_args)  # noqa: E731
    if inv_mass is None:
        inv_mass = jnp.ones_like(init_position)

    def warm_body(carry, k):
        pos, da = carry
        pos, _, stats = nuts_kernel(logdensity_fn, pos, k,
                                    jnp.exp(da.log_eps), inv_mass,
                                    max_depth)
        da = _da_update(da, stats["accept_prob"], target=target_accept)
        return (pos, da), None

    k_warm, k_sample = jax.random.split(key)
    (pos, da), _ = jax.lax.scan(
        warm_body, (init_position, _da_init(jnp.asarray(initial_step_size))),
        jax.random.split(k_warm, num_warmup))
    step_size = jnp.exp(da.log_eps_avg)

    def sample_body(pos, k):
        pos, logp, stats = nuts_kernel(logdensity_fn, pos, k, step_size,
                                       inv_mass, max_depth)
        return pos, (pos, stats["accept_prob"], logp)

    _, (positions, accept, logps) = jax.lax.scan(
        sample_body, pos, jax.random.split(k_sample, num_samples))
    return HMCSamples(positions=positions, accept_prob=accept,
                      step_size=step_size, logdensities=logps)


class TemporalAMENUTS:
    """NUTS posterior sampler with CAVI preconditioning (class surface
    matches :class:`tame.inference.hmc.TemporalAMEHMC`)."""

    def __init__(self, model, num_chains: int = 4, max_depth: int = 8,
                 seed: int = 0, precondition: bool = True,
                 mask=None, family=None):
        if model.Y is None:
            raise ValueError(
                "Model has no data. Call model.generate_data() first.")
        self.model = model
        self.Y = jnp.asarray(model.Y)
        self.num_chains = num_chains
        self.max_depth = max_depth
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
        # Pure variant + data operands (see TemporalAMEHMC.__init__).
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
               mesh=None) -> HMCSamples:
        """Run ``num_chains`` chains; ``mesh`` shards them over the
        ``batch`` axis (see :meth:`TemporalAMEHMC.sample`)."""
        from tame.inference.hmc import _shard_chains

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
            run_nuts, self._pure_logdensity, num_warmup=num_warmup,
            num_samples=num_samples, max_depth=self.max_depth,
            inv_mass=inv_mass, logdensity_args=self._ld_args)
        out = jax.vmap(lambda p, k: run(p, k))(inits, keys)
        # Lazily diagnosed — see TemporalAMEHMC.sample.
        self._last_sample = out
        self.last_diagnostics = None
        return out

    def diagnostics(self):
        """Convergence report of the most recent :meth:`sample` call
        (see :meth:`TemporalAMEHMC.diagnostics`); computed on first call
        and cached until the next :meth:`sample`."""
        from tame.inference.hmc import _lazy_diagnostics

        return _lazy_diagnostics(self)
