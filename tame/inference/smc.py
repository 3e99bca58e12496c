"""Sequential Monte Carlo (tempered-likelihood) for the temporal AME
posterior.

Design (no counterpart in the reference; mandated by the north star):
N particles over the full latent tensor (n, T, d) move through a
geometric likelihood-tempering schedule ``beta: 0 -> 1``.  Every stage is
batched over particles (vmap); particles shard over the ``batch`` mesh axis,
where resampling becomes an all-gather of particle weights plus a gathered
index select.

Stages:
1. init — particles from the AR(1) prior (ancestral sampling, batched);
2. reweight — incremental weights ``dbeta * loglik`` per particle;
3. resample — systematic resampling whenever ESS < threshold * N;
4. move — MCMC steps targeting ``prior * lik^beta``: by default
   Hamiltonian moves (leapfrog with a diagonal mass from the
   per-coordinate proposal scales, optionally the CAVI posterior
   scales); ``move_kernel="rwm"`` selects the earlier random-walk
   Metropolis.

The move kernel matters enormously for the EVIDENCE estimate: in the
(n T d)-dimensional latent space, random-walk moves at any fixed scale
have vanishing acceptance (measured ~0.01 at n=16, i.e. 256 dims), the
particle population cannot track the tempered path, and the
log-evidence estimator collapses to a gross underestimate (measured
~5500 nats BELOW the exact variational lower bound — an impossible
value).  Gradient-based moves fix this: with Hamiltonian moves the same
schedule's estimate lands ABOVE the exact ELBO, as log p(Y) must
(``SMC_BENCH.json``; ``tests/test_mcmc.py::TestEvidence``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array

from tame.models.params import AMEParams
from tame.models.temporal_ame import sample_latents
from tame.inference.logprob import log_likelihood, log_prior, precompute


class SMCResult(NamedTuple):
    particles: Array          # (N, n, T, d) final equally-weighted particles
    log_weights: Array        # (N,) final log weights (normalized)
    ess_history: Array        # (max_stages,) ESS (NaN past n_stages)
    accept_history: Array     # (max_stages,) mean MH acceptance in moves
    log_evidence: Array       # SMC estimate of log p(Y)
    beta_history: Array = jnp.nan   # (max_stages,) realized temperatures
    n_stages: Array = 0             # stages actually run
    n_resamples: Array = 0          # resampling events


def systematic_resample(key: Array, log_weights: Array) -> Array:
    """Systematic resampling: returns parent indices (N,)."""
    N = log_weights.shape[0]
    w = jax.nn.softmax(log_weights)
    positions = (jax.random.uniform(key) + jnp.arange(N)) / N
    cumsum = jnp.cumsum(w)
    return jnp.searchsorted(cumsum, positions)


def effective_sample_size(log_weights: Array) -> Array:
    w = jax.nn.softmax(log_weights)
    return 1.0 / jnp.sum(w ** 2)


@functools.partial(jax.jit, static_argnames=("num_particles", "num_stages",
                                             "num_moves", "family",
                                             "move_kernel",
                                             "num_leapfrog", "schedule"))
def run_smc(params: AMEParams, Y: Array, key: Array, *,
            num_particles: int = 256, num_stages: int = 200,
            num_moves: int = 3, step_scale: float = 0.5,
            ess_threshold: float = 0.5,
            proposal_scale: Optional[Array] = None,
            obs_mask: Optional[Array] = None,
            move_kernel: str = "hmc", num_leapfrog: int = 10,
            schedule: str = "adaptive",
            resume_from: Optional[SMCResult] = None,
            max_new_stages: Optional[int] = None,
            family=None) -> SMCResult:
    """Run tempered SMC; see module docstring.

    ``proposal_scale``: per-coordinate move scale (n, T, d) — the RWM
    proposal sd / the HMC diagonal mass ``M = proposal_scale^-2``;
    defaults to the stationary prior marginal scale (pass the CAVI
    posterior scales for production use, cf. ``TemporalAMESMC``).
    ``obs_mask`` targets the missing-data posterior (observed dyads
    only; the surface shared with the masked CAVI engines and
    HMC/NUTS).  ``move_kernel``: ``"hmc"`` (default; ``num_leapfrog``
    steps per move, step size ``step_scale`` in mass-preconditioned
    coordinates) or ``"rwm"``.

    ``schedule``: ``"adaptive"`` (default) chooses each temperature
    increment by bisection so the incremental-weight ESS stays at
    ``ess_threshold * N`` (Del Moral et al. 2012 adaptive tempering) —
    ``num_stages`` is then the BUFFER/maximum; the result's
    ``n_stages`` says how many ran and the histories are NaN-padded
    past it.  A fixed schedule lets the ESS collapse at whatever stage
    the likelihood turns on and the evidence estimate degrades
    catastrophically (measured; see module docstring).  ``"linear"``
    reproduces the fixed ``linspace`` schedule.

    ``resume_from``/``max_new_stages`` segment the sweep across
    multiple calls: pass a previous call's ``SMCResult`` (same
    ``num_stages`` buffer) to continue its run, optionally bounding the
    stages THIS call may add — the population, weights, evidence
    accumulator, temperature and histories all carry over on device.
    Use for checkpointed long runs, or to keep individual device
    dispatches short.  Each call draws fresh
    move randomness from ``key``, so a segmented run equals an
    unsegmented one in distribution, not bitwise — pass a distinct
    ``key`` per segment.
    """
    if move_kernel not in ("hmc", "rwm"):
        raise ValueError(f"unknown move_kernel {move_kernel!r}; choose "
                         "from ('hmc', 'rwm')")
    if schedule not in ("adaptive", "linear"):
        raise ValueError(f"unknown schedule {schedule!r}; choose from "
                         "('adaptive', 'linear')")
    consts = precompute(params)
    n, _, T, _ = Y.shape
    d = params.d

    if proposal_scale is None:
        prior_std = jnp.sqrt(jnp.diag(params.Sigma0))       # (d,)
        proposal_scale = jnp.broadcast_to(prior_std, (n, T, d))

    k_init, k_stages = jax.random.split(key)
    if resume_from is None:
        particles = jax.vmap(
            lambda k: sample_latents(params, k, n, T)
        )(jax.random.split(k_init, num_particles))           # (N, n, T, d)
    else:
        particles = resume_from.particles

    loglik = jax.vmap(
        lambda X: log_likelihood(params, Y, X, consts, obs_mask=obs_mask,
                                 family=family))
    logpri = jax.vmap(lambda X: log_prior(params, X, consts))

    def tempered_logp(X, beta):
        return (log_prior(params, X, consts)
                + beta * log_likelihood(params, Y, X, consts,
                                        obs_mask=obs_mask,
                                        family=family))

    def rwm_move(key, X, beta):
        """One random-walk MH step on a single particle."""
        k_prop, k_acc = jax.random.split(key)
        prop = X + step_scale * proposal_scale * jax.random.normal(
            k_prop, X.shape)
        logp_old = tempered_logp(X, beta)
        logp_new = tempered_logp(prop, beta)
        accept = (jnp.log(jax.random.uniform(k_acc))
                  < (logp_new - logp_old))
        return jnp.where(accept, prop, X), accept.astype(jnp.float32)

    def hmc_move(key, X, beta):
        """One Hamiltonian move on a single particle: ``num_leapfrog``
        leapfrog steps with diagonal mass ``M = proposal_scale^-2``
        (i.e. leapfrog in the preconditioned coordinates
        ``z = X / proposal_scale`` with scalar step ``step_scale``)."""
        k_mom, k_acc = jax.random.split(key)
        grad_fn = jax.grad(lambda x: tempered_logp(x, beta))
        # momentum ~ N(0, M); kinetic = 0.5 p' M^-1 p
        p0 = jax.random.normal(k_mom, X.shape) / proposal_scale
        kin = lambda p: 0.5 * jnp.sum((p * proposal_scale) ** 2)  # noqa: E731
        logp_old = tempered_logp(X, beta)
        h_old = -logp_old + kin(p0)

        eps = step_scale

        def leap(carry, _):
            x, p = carry
            p = p + 0.5 * eps * grad_fn(x)
            x = x + eps * (proposal_scale ** 2) * p
            p = p + 0.5 * eps * grad_fn(x)
            return (x, p), None

        (x_new, p_new), _ = jax.lax.scan(leap, (X, p0), None,
                                         length=num_leapfrog)
        h_new = -tempered_logp(x_new, beta) + kin(p_new)
        # guard non-finite trajectories (diverged leapfrog -> reject)
        log_acc = jnp.where(jnp.isfinite(h_new), h_old - h_new, -jnp.inf)
        accept = jnp.log(jax.random.uniform(k_acc)) < log_acc
        return (jnp.where(accept, x_new, X),
                accept.astype(jnp.float32))

    mh_move = hmc_move if move_kernel == "hmc" else rwm_move

    def choose_dbeta(log_weights, ll, beta):
        """Largest temperature increment keeping the reweighted ESS at
        the target (bisection; Del Moral et al. adaptive tempering)."""
        target = ess_threshold * num_particles
        hi0 = 1.0 - beta

        def ess_at(db):
            return effective_sample_size(log_weights + db * ll)

        def bisect(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= target
            return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

        lo, hi = jax.lax.fori_loop(0, 30, bisect,
                                   (jnp.asarray(0.0), hi0))
        # if even the full remaining step keeps ESS above target, finish
        return jnp.where(ess_at(hi0) >= target, hi0,
                         jnp.maximum(lo, hi0 * 1e-6))

    max_stages = num_stages
    if resume_from is not None:
        stage0 = resume_from.n_stages
    else:
        stage0 = jnp.asarray(0)
    if max_new_stages is not None:
        stage_cap = jnp.minimum(jnp.asarray(max_stages),
                                stage0 + max_new_stages)
    else:
        stage_cap = jnp.asarray(max_stages)

    def cond(carry):
        (particles, lw, logev, beta, stage, nres, ess_h, acc_h,
         beta_h, k) = carry
        return jnp.logical_and(beta < 1.0, stage < stage_cap)

    def body(carry):
        (particles, lw, logev, beta, stage, nres, ess_h, acc_h,
         beta_h, k) = carry
        k, k_res, k_move = jax.random.split(k, 3)

        # 2. reweight (adaptive or fixed increment)
        ll = loglik(particles)
        remaining = 1.0 - beta
        if schedule == "adaptive":
            dbeta = choose_dbeta(lw, ll, beta)
        else:
            dbeta = jnp.minimum(remaining, 1.0 / num_stages)
        # the final linear stage may need to close exactly on 1.0
        beta = jnp.minimum(beta + dbeta, 1.0)
        incr = dbeta * ll
        new_lw = lw + incr
        # evidence increment: log mean exp of incremental weights under
        # the previous normalized weights
        logev = logev + (jax.nn.logsumexp(new_lw)
                         - jax.nn.logsumexp(lw))
        lw = new_lw
        ess = effective_sample_size(lw)

        # 3. conditional systematic resample.  Adaptive mode also
        # resamples after every ESS-LIMITED step (dbeta < remaining):
        # the bisection lands ESS right AT the threshold, and carrying
        # those weights forward stalls the next bisection at a
        # micro-step (the threshold comparison alone is a coin flip at
        # the boundary).
        do_resample = ess < ess_threshold * num_particles
        if schedule == "adaptive":
            do_resample = jnp.logical_or(do_resample,
                                         dbeta < remaining)
        idx = systematic_resample(k_res, lw)
        particles = jnp.where(do_resample, particles[idx], particles)
        lw = jnp.where(do_resample, jnp.zeros_like(lw), lw)
        nres = nres + do_resample.astype(jnp.int32)

        # 4. move: num_moves MCMC steps per particle
        def move_body(ps, kk):
            keys = jax.random.split(kk, num_particles)
            ps, acc = jax.vmap(mh_move, in_axes=(0, 0, None))(keys, ps,
                                                              beta)
            return ps, acc.mean()

        particles, accs = jax.lax.scan(
            move_body, particles, jax.random.split(k_move, num_moves))

        ess_h = ess_h.at[stage].set(ess)
        acc_h = acc_h.at[stage].set(accs.mean())
        beta_h = beta_h.at[stage].set(beta)
        return (particles, lw, logev, beta, stage + 1, nres, ess_h,
                acc_h, beta_h, k)

    nanbuf = jnp.full((max_stages,), jnp.nan)
    if resume_from is None:
        carry = (particles, jnp.zeros(num_particles), jnp.asarray(0.0),
                 jnp.asarray(0.0), jnp.asarray(0), jnp.asarray(0),
                 nanbuf, nanbuf, nanbuf, k_stages)
    else:
        r = resume_from
        # normalized log weights carry over unchanged: ESS, softmax and
        # the evidence increments are all invariant to the constant
        beta_now = jnp.where(
            stage0 > 0, r.beta_history[jnp.maximum(stage0 - 1, 0)], 0.0)
        carry = (particles, r.log_weights, r.log_evidence,
                 beta_now, stage0, r.n_resamples,
                 r.ess_history, r.accept_history, r.beta_history,
                 k_stages)
    (particles, log_weights, log_evidence, beta, n_stages, nres,
     ess_hist, acc_hist, beta_hist, _) = jax.lax.while_loop(cond, body,
                                                            carry)

    log_weights = log_weights - jax.nn.logsumexp(log_weights)
    return SMCResult(particles=particles, log_weights=log_weights,
                     ess_history=ess_hist, accept_history=acc_hist,
                     log_evidence=log_evidence, beta_history=beta_hist,
                     n_stages=n_stages, n_resamples=nres)


class TemporalAMESMC:
    """SMC posterior sampler with the reference-compatible class feel."""

    def __init__(self, model, num_particles: int = 256,
                 num_stages: int = 200, num_moves: int = 3,
                 seed: int = 0,
                 precondition: bool = True, mask=None, family=None):
        if model.Y is None:
            raise ValueError(
                "Model has no data. Call model.generate_data() first.")
        self.model = model
        self.Y = jnp.asarray(model.Y)
        self.num_particles = num_particles
        self.num_stages = num_stages
        self.num_moves = num_moves
        self.seed = seed
        # Declared dyadic likelihood family (tame.models.likelihoods);
        # non-Gaussian families skip the (Gaussian) CAVI preconditioner.
        if family is not None:
            from tame.models.likelihoods import get_family

            family = get_family(family)
            if family.name != "gaussian":
                precondition = False
        self.family = family
        self.precondition = precondition
        # Optional dyad observation mask (missing-data posterior).
        self.mask = None if mask is None else jnp.asarray(mask)

    def sample(self, mesh=None, stages_per_call=None) -> SMCResult:
        """Run the tempered-SMC sweep.

        With ``mesh``, the particle population is sharded over the
        ``batch`` axis: tempering/reweighting/moves are particle-local on
        each device, the ESS and evidence reductions become ``psum``-style
        collectives, and the systematic-resampling gather
        (``particles[idx]``) is lowered by GSPMD to an all-gather +
        local index-select — the collective pattern the north star asks
        for (resampling via all-gather).

        ``stages_per_call`` splits the sweep into bounded device
        dispatches carried on device (``run_smc(resume_from=...)``) —
        use on hosts that kill long single dispatches (CLAUDE.md) or
        for very long adaptive schedules."""
        proposal_scale = None
        if self.precondition:
            from tame.inference.hmc import precondition_from_cavi

            _, variances = precondition_from_cavi(
                self.Y, self.model.params, seed=self.seed,
                mask=self.mask)
            proposal_scale = jnp.sqrt(variances)
        key = jax.random.PRNGKey(self.seed)
        if mesh is not None:
            from tame.parallel import chain_sharding, replicated

            Y = jax.device_put(self.Y, replicated(mesh))
            out_shardings = SMCResult(
                particles=chain_sharding(mesh, 4),
                log_weights=chain_sharding(mesh, 1),
                ess_history=replicated(mesh),
                accept_history=replicated(mesh),
                log_evidence=replicated(mesh),
                beta_history=replicated(mesh),
                n_stages=replicated(mesh),
                n_resamples=replicated(mesh),
            )
            run = jax.jit(
                functools.partial(run_smc,
                                  num_particles=self.num_particles,
                                  num_stages=self.num_stages,
                                  num_moves=self.num_moves,
                                  family=self.family),
                out_shardings=out_shardings)
            Yd = Y
        else:
            run = functools.partial(run_smc,
                                    num_particles=self.num_particles,
                                    num_stages=self.num_stages,
                                    num_moves=self.num_moves,
                                    family=self.family)
            Yd = self.Y
        if stages_per_call is None:
            out = run(self.model.params, Yd, key,
                      proposal_scale=proposal_scale,
                      obs_mask=self.mask)
            self._warn_if_partial(out)
            return out
        import numpy as np

        res, seg = None, 0
        while True:
            res = jax.block_until_ready(run(
                self.model.params, Yd, jax.random.fold_in(key, seg),
                proposal_scale=proposal_scale, obs_mask=self.mask,
                resume_from=res, max_new_stages=stages_per_call))
            seg += 1
            ns = int(res.n_stages)
            if ns >= self.num_stages or \
                    float(np.asarray(res.beta_history)[ns - 1]) >= 1.0:
                self._warn_if_partial(res)
                return res

    @staticmethod
    def _warn_if_partial(result: SMCResult) -> None:
        """The adaptive schedule stops at the stage BUFFER if beta has
        not reached 1 — the particles then target a tempered posterior
        and ``log_evidence`` is partial.  Surface that loudly instead
        of letting a too-small ``num_stages`` silently corrupt
        downstream comparisons."""
        import numpy as np

        ns = int(result.n_stages)
        if ns == 0:
            return
        beta = float(np.asarray(result.beta_history)[ns - 1])
        if beta < 1.0:
            print(f"WARNING: SMC exhausted its {ns}-stage buffer at "
                  f"beta={beta:.4f} < 1 — the log-evidence is PARTIAL "
                  "and the particles target a tempered posterior; "
                  "raise num_stages (the adaptive schedule needs more "
                  "room) or continue with "
                  "run_smc(resume_from=result).", flush=True)

    def posterior_mean(self, result: SMCResult) -> Array:
        w = jax.nn.softmax(result.log_weights)
        return jnp.einsum("p,pntd->ntd", w, result.particles)
