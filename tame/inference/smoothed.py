"""Smoothed CAVI: per-node joint-trajectory variational family.

A strictly tighter family than anything in the reference: instead of
independent per-(node, time) Gaussians coupled through neighbor means
(Gauss–Seidel in t), each node's whole trajectory is one joint Gaussian

    q(X) = prod_i q(X_i^{0:T-1}),

whose exact coordinate update — given the other nodes' means — is the
block-tridiagonal system solved by
:func:`tame.ops.tridiag.block_tridiag_smoother` (AR(1) forward-backward
smoothing):

    D_t = P_obs[t] + [t=0] Sigma0^-1 + [t>0] Q^-1 + [t<T-1] Phi' Q^-1 Phi
    O   = -Phi' Q^-1        (precision block (t, t+1))
    b_t = eta_obs[t]        (temporal coupling handled exactly, not via
                             neighbor means)

The ELBO gains exact cross-time terms: transition expectations use the
lag-1 cross-covariances and the entropy uses the trajectory log
determinant from the smoother.  Damping applies to the means only (the
implied joint of damped covariance mixtures is not well-defined);
covariances are refreshed from each solve.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from tame.inference import cavi
from tame.models.params import AMEParams
from tame.ops import dyad as dyad_ops
from tame.ops.dyad import HIGHEST
from tame.ops.tridiag import block_tridiag_smoother

_LOG2PI = 1.8378770664093453


class SmoothedState(NamedTuple):
    X_mean: Array    # (n, T, d)
    X_cov: Array     # (n, T, d, d)   marginal covariances
    X_cross: Array   # (n, T-1, d, d) Cov(X_t, X_{t+1}) per node
    logdets: Array   # (n,)           logdet of each node's joint precision


class SmoothedFitResult(NamedTuple):
    state: SmoothedState
    elbo_history: Array
    mse_history: Array
    n_iter: Array
    converged: Array
    diverged: Array
    # Convergence carry at exit (cf. cavi.FitResult): feed back as
    # carry_elbo/carry_patience of a follow-up call to continue a fit in
    # segments with BITWISE-identical stopping behavior.
    last_elbo: Array = jnp.nan
    pat_count: Array = 0


def init_smoothed_state(key: Array, n: int, T: int, d: int,
                        init_scale: float = 0.1) -> SmoothedState:
    X_mean = jax.random.normal(key, (n, T, d)) * init_scale
    eye = jnp.eye(d)
    X_cov = jnp.broadcast_to(eye * 0.5, (n, T, d, d))
    X_cross = jnp.zeros((n, max(T - 1, 0), d, d))
    # logdet of 0.5 I per time step, independent blocks
    logdets = jnp.full((n,), -T * d * jnp.log(0.5))
    return SmoothedState(X_mean=X_mean, X_cov=jnp.asarray(X_cov),
                         X_cross=X_cross, logdets=logdets)


def warm_init_smoothed_state(Y: Array, params: AMEParams,
                             obs_mask: Array | None = None
                             ) -> SmoothedState:
    """Data-driven warm start for the smoothed family: the closed-form
    centroid decomposition of :func:`tame.inference.cavi.warm_init_state`
    (two-way additive fit + top-r SVD subspace, broadcast over T, masked
    averages normalized by observed counts) with the smoothed family's
    deterministic covariance scheme.  Deterministic — no key needed."""
    warm = cavi.warm_init_state(Y, params, structure="full",
                                obs_mask=obs_mask)
    n, T, d = warm.X_mean.shape
    eye = jnp.eye(d)
    X_cov = jnp.broadcast_to(eye * 0.5, (n, T, d, d))
    X_cross = jnp.zeros((n, max(T - 1, 0), d, d))
    logdets = jnp.full((n,), -T * d * jnp.log(0.5))
    return SmoothedState(X_mean=warm.X_mean, X_cov=jnp.asarray(X_cov),
                         X_cross=X_cross, logdets=logdets)


def smoothed_step(state: SmoothedState, obs: cavi.ObsConstants,
                  pri: cavi.PriorMatrices, params: AMEParams, lr: Array,
                  corrected: bool = True,
                  parallel: bool = False,
                  mask: Array | None = None) -> SmoothedState:
    """One simultaneous update: every node's trajectory re-solved exactly
    against the other nodes' current means.

    ``parallel=True`` uses the time-parallel associative-
    scan smoother (:func:`tame.ops.ptridiag.parallel_block_tridiag_
    smoother`, O(log T) depth) — the long-context lever when T is large.
    """
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    _, _, U, V = dyad_ops.split_state(state.X_mean, r)

    if mask is None:
        D_obs = cavi._obs_precision(U, V, params.R_inv)
    else:  # missing-data fit: per-node masked partner statistics
        D_obs = cavi._masked_obs_precision(mask, U, V, params.R_inv)
    b = cavi._obs_nat_param(obs, state.X_mean, r, params.R_inv,
                            corrected, mask=mask)         # (n, T, d)

    if parallel:
        from tame.ops.ptridiag import parallel_block_tridiag_smoother

        out = jax.vmap(lambda Ji, bi: parallel_block_tridiag_smoother(
            Ji, bi, params.Phi, params.Q, params.Sigma0))(D_obs, b)
    else:
        D = D_obs + cavi._prior_precision(pri, T)[None]  # (n, T, d, d)
        O = -pri.Qinv_Phi.T                              # -Phi' Q^-1
        out = jax.vmap(
            lambda Di, bi: block_tridiag_smoother(Di, O, bi))(D, b)
    X_mean = lr * out.mean + (1.0 - lr) * state.X_mean
    return SmoothedState(X_mean=X_mean.astype(state.X_mean.dtype),
                         X_cov=out.cov, X_cross=out.cross_cov,
                         logdets=out.logdet)


def smoothed_step_block(state: SmoothedState, obs: cavi.ObsConstants,
                        pri: cavi.PriorMatrices, params: AMEParams,
                        lr: Array, num_blocks: int,
                        corrected: bool = True,
                        parallel: bool = False,
                        mask=None) -> SmoothedState:
    """Block Gauss-Seidel smoothed update: node blocks re-solved in
    sequence, each block's trajectories solved EXACTLY against the
    freshest other-node means.

    Rationale mirrors ``cavi.cavi_step_block``: the simultaneous
    (:func:`smoothed_step`) update is Jacobi over nodes, whose effective
    spectral radius grows with the node coupling — at n = 2000 it
    oscillates at lr ~ 0.8 and never meets the tolerance rule.  A few
    sequential blocks restore stability; at lr = 1 each phase is an
    EXACT block coordinate-ascent step of the smoothed family.  The
    assembly mirrors ``cavi_step_block`` (fresh global statistics per
    phase, one concatenated mask pass when masked) with the
    block-tridiagonal trajectory solve in place of the per-time solve
    and no neighbor-mean prior coupling (time handled exactly).
    """
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    if n % num_blocks != 0:
        raise ValueError(f"num_blocks={num_blocks} must divide n={n}")
    bs = n // num_blocks
    p, q = params.R_inv[0, 0], params.R_inv[0, 1]
    c = jnp.asarray(n - 1, state.X_mean.dtype)
    prior_D = cavi._prior_precision(pri, T)                # (T, d, d)
    O = -pri.Qinv_Phi.T

    W0r = obs.W0.reshape(num_blocks, bs, n, T)
    W1r = obs.W1.reshape(num_blocks, bs, n, T)
    eta_ar = obs.eta_a.reshape(num_blocks, bs, T)
    eta_br = obs.eta_b.reshape(num_blocks, bs, T)
    Mr = None if mask is None else mask.reshape(num_blocks, bs, n, T)

    def update_block(b, carry):
        X_mean, X_cov, X_cross, logdets = carry
        _, _, U, V = dyad_ops.split_state(X_mean, r)       # (n, T, r)
        start = b * bs
        Ub = jax.lax.dynamic_slice_in_dim(U, start, bs, 0)
        Vb = jax.lax.dynamic_slice_in_dim(V, start, bs, 0)

        if Mr is not None:
            C = cavi.block_mask_contract(Mr, b, cavi._masked_panel(U, V))
            D_obs = cavi._masked_P_from_C(C, params.R_inv, r)
        else:
            # Fresh global sufficient statistics (cheap: O(n T r^2)).
            sU = U.sum(0)[None] - Ub
            sV = V.sum(0)[None] - Vb
            GUU = jnp.einsum("jtk,jtl->tkl", U, U,
                             preferred_element_type=jnp.float32,
                             precision=HIGHEST)[None] \
                - Ub[..., :, None] * Ub[..., None, :]
            GVV = jnp.einsum("jtk,jtl->tkl", V, V,
                             preferred_element_type=jnp.float32,
                             precision=HIGHEST)[None] \
                - Vb[..., :, None] * Vb[..., None, :]
            GVU = jnp.einsum("jtk,jtl->tkl", V, U,
                             preferred_element_type=jnp.float32,
                             precision=HIGHEST)[None] \
                - Vb[..., :, None] * Ub[..., None, :]
            D_obs = cavi._P_from_partner_stats(
                c, sU, sV, GUU, GVV, GVU, params.R_inv)

        W0b = jax.lax.dynamic_index_in_dim(W0r, b, 0, keepdims=False)
        W1b = jax.lax.dynamic_index_in_dim(W1r, b, 0, keepdims=False)
        etaU = cavi._eta_contract(W0b, V)
        etaV = cavi._eta_contract(W1b, U)
        eta_a_b = jax.lax.dynamic_index_in_dim(eta_ar, b, 0, False)
        eta_b_b = jax.lax.dynamic_index_in_dim(eta_br, b, 0, False)
        if corrected:
            a_all = X_mean[..., 0]
            b_all = X_mean[..., 1]
            cc = p * b_all + q * a_all
            ddc = q * b_all + p * a_all
            if Mr is not None:
                Cc = cavi.block_mask_contract(Mr, b, jnp.concatenate(
                    [cc[..., None], ddc[..., None], cc[..., None] * V,
                     ddc[..., None] * U], axis=-1))
                eta_a_b = eta_a_b - Cc[..., 0]
                eta_b_b = eta_b_b - Cc[..., 1]
                etaU = etaU - Cc[..., 2:2 + r]
                etaV = etaV - Cc[..., 2 + r:]
            else:
                cb = jax.lax.dynamic_slice_in_dim(cc, start, bs, 0)
                db = jax.lax.dynamic_slice_in_dim(ddc, start, bs, 0)
                eta_a_b = eta_a_b - (cc.sum(0)[None] - cb)
                eta_b_b = eta_b_b - (ddc.sum(0)[None] - db)
                cV = jnp.einsum("jt,jtr->tr", cc, V,
                                precision=HIGHEST)[None] \
                    - cb[..., None] * Vb
                dU = jnp.einsum("jt,jtr->tr", ddc, U,
                                precision=HIGHEST)[None] \
                    - db[..., None] * Ub
                etaU = etaU - cV
                etaV = etaV - dU
        bvec = jnp.concatenate(
            [eta_a_b[..., None], eta_b_b[..., None], etaU, etaV], axis=-1)

        if parallel:
            from tame.ops.ptridiag import parallel_block_tridiag_smoother

            out = jax.vmap(lambda Ji, bi: parallel_block_tridiag_smoother(
                Ji, bi, params.Phi, params.Q, params.Sigma0))(D_obs, bvec)
        else:
            D = D_obs + prior_D[None]
            out = jax.vmap(
                lambda Di, bi: block_tridiag_smoother(Di, O, bi))(D, bvec)

        mu_old = jax.lax.dynamic_slice_in_dim(X_mean, start, bs, 0)
        X_mean = jax.lax.dynamic_update_slice_in_dim(
            X_mean, lr * out.mean + (1.0 - lr) * mu_old, start, 0)
        X_cov = jax.lax.dynamic_update_slice_in_dim(
            X_cov, out.cov, start, 0)
        X_cross = jax.lax.dynamic_update_slice_in_dim(
            X_cross, out.cross_cov, start, 0)
        logdets = jax.lax.dynamic_update_slice_in_dim(
            logdets, out.logdet, start, 0)
        return X_mean, X_cov, X_cross, logdets

    X_mean, X_cov, X_cross, logdets = jax.lax.fori_loop(
        0, num_blocks, update_block,
        (state.X_mean, state.X_cov, state.X_cross, state.logdets))
    return SmoothedState(X_mean=X_mean.astype(state.X_mean.dtype),
                         X_cov=X_cov, X_cross=X_cross, logdets=logdets)


def smoothed_elbo(Y: Array, params: AMEParams, pri: cavi.PriorMatrices,
                  state: SmoothedState, mu_dyadic: Array | None = None,
                  obs_mask: Array | None = None) -> Array:
    """ELBO with exact cross-time transition terms and trajectory entropy.

    Likelihood uses the same plug-in + trace-correction convention as the
    structured engines (reference ``structured_mf.py:141-148``) so values
    are comparable to Good SMF.
    """
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    if obs_mask is not None:
        # Sanitize BEFORE the residual (cf. cavi.compute_elbo): NaN-coded
        # missing entries must never be read.
        obs_mask = obs_mask * (
            1.0 - jnp.eye(n, dtype=obs_mask.dtype)[:, :, None])
        Y = jnp.where(obs_mask[..., None] > 0, Y, 0.0)
    if mu_dyadic is None:
        mu_dyadic = dyad_ops.dyadic_mean_temporal(state.X_mean, r)

    resid = Y - mu_dyadic
    p_, q_ = params.R_inv[0, 0], params.R_inv[0, 1]
    e0, e1 = resid[..., 0], resid[..., 1]
    quad = p_ * (e0 * e0 + e1 * e1) + 2.0 * q_ * (e0 * e1)
    if obs_mask is None:
        mask = dyad_ops.offdiag_mask(n)[:, :, None]
        mask_stats = None
    else:  # observed dyads only (cf. cavi._elbo_from_quad mask_stats)
        mask = obs_mask
        mask_stats = (0.5 * jnp.sum(obs_mask),
                      obs_mask.astype(jnp.float32).sum(1))
    quad_sum = 0.5 * jnp.sum(quad * mask)
    return smoothed_elbo_from_quad(quad_sum, params, pri, state,
                                   mask_stats=mask_stats)


def smoothed_elbo_from_quad(quad_sum: Array, params: AMEParams,
                            pri: cavi.PriorMatrices, state: SmoothedState,
                            mask_stats=None) -> Array:
    """Smoothed ELBO given the precomputed likelihood quadratic form
    ``sum_{i<j,t} resid' R^-1 resid`` (cf. ``cavi._elbo_from_quad``); all
    remaining terms depend only on the variational state."""
    n, T, d = state.X_mean.shape
    tr_cov = jnp.trace(state.X_cov, axis1=-2, axis2=-1)
    if mask_stats is None:
        n_dyads = n * (n - 1) // 2 * T
        wsum = (n - 1) * jnp.sum(tr_cov)
    else:
        n_dyads = mask_stats[0]
        wsum = jnp.sum(mask_stats[1] * tr_cov)
    log_lik = -0.5 * (quad_sum + n_dyads * (pri.logdet_R + 2.0 * _LOG2PI))
    corr = 0.1 * jnp.trace(params.R_inv) / d * wsum
    log_lik = log_lik - 0.5 * corr
    prior0, priort, entropy = smoothed_prior_entropy(params, pri, state)
    return log_lik + prior0 + priort + entropy


def smoothed_prior_entropy(params: AMEParams, pri: cavi.PriorMatrices,
                           state: SmoothedState) -> tuple:
    """The likelihood-independent ELBO terms of the smoothed family:
    ``(prior0, priort, entropy)`` with exact cross-time transition
    expectations and the joint-trajectory entropy — shared by the
    Gaussian smoothed engine and the non-Gaussian smoothed E-steps
    (:mod:`tame.inference.family_smoothed`)."""
    n, T, d = state.X_mean.shape
    # initial prior
    mu0 = state.X_mean[:, 0]
    quad0 = jnp.einsum("ia,ab,ib->", mu0, pri.Sigma0_inv, mu0,
                       precision=HIGHEST)
    trace0 = jnp.einsum("ab,iba->", pri.Sigma0_inv, state.X_cov[:, 0],
                        precision=HIGHEST)
    prior0 = -0.5 * (quad0 + trace0
                     + n * (pri.logdet_Sigma0 + d * _LOG2PI))

    # transitions with exact cross-covariances:
    # E[(x_t - Phi x_{t-1})' Q^-1 (x_t - Phi x_{t-1})] =
    #   resid-quad(means) + tr(Q^-1 Sig_t) + tr(Phi'Q^-1 Phi Sig_{t-1})
    #   - 2 tr(Q^-1 Phi C_{t-1,t})
    if T > 1:
        residt = state.X_mean[:, 1:] - jnp.matmul(
            state.X_mean[:, :-1], params.Phi.T, precision=HIGHEST)
        quadt = jnp.einsum("ita,ab,itb->", residt, pri.Q_inv, residt,
                           precision=HIGHEST)
        tr_t = jnp.einsum("ab,itba->", pri.Q_inv, state.X_cov[:, 1:],
                          precision=HIGHEST)
        tr_prev = jnp.einsum("ab,itba->", pri.PhiT_Qinv_Phi,
                             state.X_cov[:, :-1], precision=HIGHEST)
        tr_cross = jnp.einsum("ab,itba->", pri.Qinv_Phi, state.X_cross,
                              precision=HIGHEST)
        priort = -0.5 * (quadt + tr_t + tr_prev - 2.0 * tr_cross
                         + n * (T - 1) * (pri.logdet_Q + d * _LOG2PI))
    else:
        priort = jnp.asarray(0.0, state.X_mean.dtype)

    # entropy of the joint trajectories: 0.5 (Td (1+log 2 pi) - logdet P)
    entropy = 0.5 * (n * T * d * (1.0 + _LOG2PI)
                     - jnp.sum(state.logdets))
    return prior0, priort, entropy


def fit_cavi_smoothed(Y: Array, params: AMEParams, init: SmoothedState, *,
                      max_iter: int = 100, learning_rate=0.8,
                      tolerance=1e-4, patience: int = 3,
                      corrected: bool = True,
                      smoother: str = "auto",
                      update_mode: str = "auto", num_blocks=None,
                      mixed_precision: bool = False,
                      diag_mode: str = "exact",
                      carry_elbo=None, carry_patience=0,
                      mask: Array | None = None) -> SmoothedFitResult:
    """``smoother`` selects the trajectory solver: ``"sequential"`` is
    the O(T)-depth scan (``tame.ops.tridiag``), ``"parallel"`` the
    O(log T)-depth associative-scan smoother (``tame.ops.ptridiag``,
    Särkkä & García-Fernández 2021) — exact to float32 tolerance.
    ``"auto"`` resolves to sequential; ``"parallel"`` remains available
    for latency-bound regimes (tiny n, very long T).

    ``mixed_precision``/``diag_mode`` select the same production fast
    path as ``cavi.fit_cavi``: bf16 dyad-weight (and mask) storage with
    f32 accumulation, and sufficient-statistics ELBO/MSE diagnostics
    (``"stats"``) instead of the O(n^2 T) residual pass — masked or
    dense.  The smoothed family is the EM E-step, so its at-scale cost
    bounds hyperparameter learning; these flags keep it on the same
    HBM budget as the CAVI engines.

    ``update_mode``: ``"jacobi"`` is the simultaneous update
    (:func:`smoothed_step` — every node against the previous iterate);
    ``"block"`` the block-Gauss-Seidel variant
    (:func:`smoothed_step_block` — stable at lr ~ 1 for any n, the
    production choice at scale); ``"auto"`` (default) picks block once
    n >= 256 (below that jacobi converges fine and keeps the
    historical trajectories).

    ``carry_elbo``/``carry_patience`` seed the convergence bookkeeping
    from a prior segment's ``SmoothedFitResult.last_elbo``/``.pat_count``
    so a fit run in segments (engine in-fit checkpointing) stops at
    EXACTLY the same iteration as the uninterrupted fit (cf.
    ``cavi.fit_cavi``)."""
    if diag_mode not in ("exact", "stats"):
        raise ValueError(f"unknown diag_mode: {diag_mode!r}")
    if smoother not in ("auto", "sequential", "parallel"):
        raise ValueError(f"unknown smoother: {smoother!r}")
    if update_mode not in ("auto", "jacobi", "block"):
        raise ValueError(f"unknown update_mode: {update_mode!r}")
    buf = 64
    while buf < max_iter:
        buf *= 2
    n = Y.shape[0]
    if mask is not None:
        mask = jnp.asarray(mask, Y.dtype)
        mask = mask * (1.0 - jnp.eye(n, dtype=Y.dtype)[:, :, None])
    if smoother == "auto":
        smoother = "sequential"
    if update_mode == "auto":
        update_mode = "block" if n >= 256 else "jacobi"
    if update_mode == "block" and num_blocks is None:
        # Largest divisor of n that is <= 16 (cf. cavi.fit_cavi).
        num_blocks = next(k for k in range(min(16, n), 0, -1)
                          if n % k == 0)
    return _fit_smoothed_impl(Y, params, init, jnp.asarray(max_iter),
                              jnp.asarray(learning_rate, Y.dtype),
                              jnp.asarray(tolerance, Y.dtype),
                              jnp.asarray(-jnp.inf if carry_elbo is None
                                          else carry_elbo, Y.dtype),
                              jnp.asarray(carry_patience),
                              buf_size=buf, patience=patience,
                              corrected=corrected,
                              parallel=(smoother == "parallel"),
                              update_mode=update_mode,
                              num_blocks=num_blocks,
                              mixed_precision=mixed_precision,
                              diag_mode=diag_mode,
                              mask=mask)


@functools.partial(jax.jit, static_argnames=("buf_size", "patience",
                                             "corrected", "parallel",
                                             "mixed_precision",
                                             "diag_mode",
                                             "update_mode", "num_blocks"))
def _fit_smoothed_impl(Y, params, init, max_iter, lr, tol,
                       carry_elbo, carry_patience, *,
                       buf_size: int, patience: int,
                       corrected: bool,
                       parallel: bool = False,
                       update_mode: str = "jacobi",
                       num_blocks=None,
                       mixed_precision: bool = False,
                       diag_mode: str = "exact",
                       mask=None) -> SmoothedFitResult:
    n, _, T, _ = Y.shape
    d = init.X_mean.shape[-1]
    r = (d - 2) // 2
    # where (not multiplication): NaN-coded missing entries must not
    # poison the weights or diagnostics (cf. cavi._fit_cavi_impl).
    mask_c = mask
    if mask is not None:
        Y = jnp.where(mask[..., None] > 0, Y, 0.0)
        if mixed_precision:
            mask_c = mask.astype(jnp.bfloat16)
    obs = cavi.precompute_obs_constants(
        Y, params.R_inv,
        w_dtype=jnp.bfloat16 if mixed_precision else None)
    pri = cavi.precompute_priors(params)
    dc = (cavi.precompute_diag_constants(Y)
          if diag_mode == "stats" else None)
    if mask is not None:
        mask_stats = (0.5 * jnp.sum(mask),
                      mask.astype(jnp.float32).sum(1))
        n_obs = jnp.maximum(jnp.sum(mask), 1.0)
    else:
        mask_stats = None

    def cond(carry):
        state, it, prev, pat, conv, div, eh, mh = carry
        running = jnp.logical_not(jnp.logical_or(conv, div))
        return jnp.logical_and(it < max_iter, running)

    def diagnostics(state):
        """Likelihood residual statistics -> (elbo, mse); same four-way
        dispatch as cavi._fit_cavi_impl (stats expansion or exact
        residual pass, dense or masked)."""
        if diag_mode == "stats" and mask is not None:
            sq, cross = cavi._masked_residual_stats(
                dc, obs, state.X_mean, r, params.R_inv, mask_c)
        elif diag_mode == "stats":
            sq, cross = cavi._residual_stats_from_moments(
                dc, obs, state.X_mean, r, params.R_inv)
        elif mask is not None:
            fwd = dyad_ops.dyadic_fwd_temporal(state.X_mean, r)
            e0 = (Y[..., 0] - fwd) * mask
            sq = jnp.sum(e0 * e0)
            cross = jnp.einsum("ijt,jit->", e0, e0,
                               preferred_element_type=jnp.float32,
                               precision=HIGHEST)
        else:
            fwd = dyad_ops.dyadic_fwd_temporal(state.X_mean, r)
            sq, cross = dyad_ops.residual_stats_from_fwd(Y, fwd)
        p_, q_ = params.R_inv[0, 0], params.R_inv[0, 1]
        quad_sum = p_ * sq + q_ * cross
        elbo = smoothed_elbo_from_quad(quad_sum, params, pri, state,
                                       mask_stats=mask_stats)
        if mask is not None:
            mse = 2.0 * sq / n_obs
        else:
            mse = 2.0 * sq / (n * (n - 1) * T)
        return elbo, mse

    def body(carry):
        state, it, prev, pat, conv, div, eh, mh = carry
        if update_mode == "block":
            state = smoothed_step_block(state, obs, pri, params, lr,
                                        num_blocks, corrected,
                                        parallel=parallel, mask=mask_c)
        else:
            state = smoothed_step(state, obs, pri, params, lr, corrected,
                                  parallel=parallel, mask=mask_c)
        elbo, mse = diagnostics(state)
        eh = eh.at[it].set(elbo)
        mh = mh.at[it].set(mse)
        rel = jnp.abs(elbo - prev) / (jnp.abs(prev) + 1e-8)
        # A finite prev (fresh: -inf; segmented fits: the carry) is the
        # "have a previous evaluation" signal, so a continued segment
        # checks convergence from its very first iteration.
        small = jnp.logical_and(jnp.isfinite(prev), rel < tol)
        pat = jnp.where(small, pat + 1, 0)
        conv = pat >= patience
        div = jnp.logical_not(jnp.isfinite(elbo))
        return state, it + 1, elbo, pat, conv, div, eh, mh

    nanbuf = jnp.full((buf_size,), jnp.nan, Y.dtype)
    carry = (init, jnp.asarray(0), carry_elbo.astype(Y.dtype),
             carry_patience, jnp.asarray(False), jnp.asarray(False),
             nanbuf, nanbuf)
    state, it, last, pat, conv, div, eh, mh = jax.lax.while_loop(cond, body,
                                                                 carry)
    return SmoothedFitResult(state=state, elbo_history=eh, mse_history=mh,
                             n_iter=it, converged=conv, diverged=div,
                             last_elbo=last, pat_count=pat)


class TemporalAMESmoothedVI:
    """Engine class for the smoothed (joint-trajectory) family.

    Same ``fit`` surface as the other engines — including warm init
    (``init_mode='warm'``) and segmented in-fit checkpointing with
    bitwise-identical resume (``checkpoint_every``/``resume``, cf.
    :class:`tame.inference.engine.TemporalAMECaviVI`); ``X_cov`` holds
    marginal covariances, ``X_cross`` the lag-1 cross-covariances.
    """

    structure = "smoothed"

    def __init__(self, model, learning_rate: float = 0.8,
                 init_scale: float = 0.1, seed: int = 42,
                 corrected: bool = True, init_mode: str = "random",
                 update_mode: str = "auto", num_blocks=None,
                 mixed_precision: bool = False, diag_mode: str = "exact",
                 mask=None):
        if model.Y is None:
            raise ValueError(
                "Model has no data. Call model.generate_data() first.")
        self.model = model
        self.Y = jnp.asarray(model.Y)
        self.n, self.T, self.d, self.r = (model.n, model.T, model.d,
                                          model.r)
        self.lr = learning_rate
        self.seed = seed
        self.corrected = corrected
        self.update_mode = update_mode
        self.num_blocks = num_blocks
        self.mixed_precision = mixed_precision
        self.diag_mode = diag_mode
        # Missing-data support: (n, n, T) dyad observation mask (shared
        # surface with the other engines; see cavi.fit_cavi).
        self.mask = None if mask is None else jnp.asarray(mask)
        self.params = model.params
        self.history = {"elbo": [], "reconstruction_error": []}
        self._carry_elbo = None
        self._carry_pat = 0
        self._converged = False
        self._diverged = False
        if init_mode == "warm":
            st = warm_init_smoothed_state(self.Y, self.params,
                                          obs_mask=self.mask)
        elif init_mode == "random":
            st = init_smoothed_state(jax.random.PRNGKey(seed), self.n,
                                     self.T, self.d, init_scale)
        else:
            raise ValueError(f"unknown init_mode '{init_mode}'")
        self._state = st

    @property
    def X_mean(self):
        return self._state.X_mean

    @property
    def X_cov(self):
        return self._state.X_cov

    @property
    def X_cross(self):
        return self._state.X_cross

    def fit(self, max_iter: int = 100, tolerance: float = 1e-4,
            verbose: bool = True, check_every: int = 10,
            checkpoint_every=None, ckpt_dir=None, resume: bool = False):
        """Run smoothed CAVI to convergence.

        ``checkpoint_every``/``ckpt_dir``/``resume`` mirror the CAVI
        engine (``engine.TemporalAMECaviVI.fit``): the compiled loop runs
        in segments, each followed by an async checkpoint + progress
        line; the convergence carry threads through segments so a
        segmented (or killed-and-resumed) fit stops at EXACTLY the same
        iteration as the uninterrupted one.
        """
        import numpy as np

        if resume:
            if ckpt_dir is None:
                raise ValueError("resume=True requires ckpt_dir")
            import os

            if os.path.exists(os.fspath(ckpt_dir)):
                self.load_checkpoint(ckpt_dir)

        done = len(self.history["elbo"])
        budget = max_iter - done if resume else max_iter
        if budget <= 0:
            return self.history
        segment = checkpoint_every or budget
        if not (resume and done > 0):
            self._carry_elbo = None
            self._carry_pat = 0
            self._converged = False
            self._diverged = False
        seg_start = done
        ckptr = None
        if checkpoint_every and ckpt_dir is not None:
            from tame.io.async_ckpt import AsyncCheckpointer

            ckptr = AsyncCheckpointer()
        while budget > 0 and not (self._converged or self._diverged):
            seg = min(segment, budget)
            result = jax.block_until_ready(fit_cavi_smoothed(
                self.Y, self.params, self._state, max_iter=seg,
                learning_rate=self.lr, tolerance=tolerance,
                corrected=self.corrected, mask=self.mask,
                update_mode=self.update_mode,
                num_blocks=self.num_blocks,
                mixed_precision=self.mixed_precision,
                diag_mode=self.diag_mode,
                carry_elbo=self._carry_elbo,
                carry_patience=self._carry_pat))
            self._state = result.state
            n_iter = int(result.n_iter)
            eh = np.asarray(result.elbo_history)[:n_iter]
            mh = np.asarray(result.mse_history)[:n_iter]
            self.history["elbo"].extend(float(v) for v in eh)
            self.history["reconstruction_error"].extend(
                float(v) for v in mh)
            self._converged = bool(result.converged)
            self._diverged = bool(result.diverged)
            self._carry_elbo = float(result.last_elbo)
            self._carry_pat = int(result.pat_count)
            budget -= n_iter

            if checkpoint_every:
                if ckptr is not None:
                    ckptr.save(ckpt_dir, self._checkpoint_state())
                if verbose and n_iter:
                    total = len(self.history["elbo"])
                    print(f"Iter {total - 1:4d} | "
                          f"ELBO: {eh[-1]:10.2f} | MSE: {mh[-1]:.6f}"
                          + (" | checkpointed" if ckpt_dir else ""),
                          flush=True)
        if ckptr is not None:
            ckptr.wait()

        n_total = len(self.history["elbo"])
        if self._diverged:
            print(f"WARNING: {self.__class__.__name__} halted at "
                  f"iteration {n_total - 1}: ELBO became non-finite "
                  "(try a smaller learning_rate).")
        if verbose and not checkpoint_every:
            eh_all = self.history["elbo"]
            mh_all = self.history["reconstruction_error"]
            for it in range(seg_start, n_total):
                if (it - seg_start) % check_every == 0 \
                        or it == n_total - 1:
                    print(f"Iter {it:4d} | ELBO: {eh_all[it]:10.2f} | "
                          f"MSE: {mh_all[it]:.6f}")
        return self.history

    def get_variational_means(self):
        return self.X_mean

    def get_variational_covariances(self):
        return self.X_cov

    def predict_forward(self, n_steps: int = 1):
        """AR(1) forward forecast from the last smoothed state means
        (reference ``naive_mf.py:386-396``), via one ``lax.scan``."""
        Phi = self.params.Phi

        def step(x, _):
            x = x @ Phi.T
            return x, x

        _, preds = jax.lax.scan(step, self.X_mean[:, -1], None,
                                length=n_steps)
        return jnp.swapaxes(preds, 0, 1)  # (n, n_steps, d)

    def _checkpoint_state(self):
        import numpy as np

        return {
            "X_mean": self._state.X_mean,
            "X_cov": self._state.X_cov,
            "X_cross": self._state.X_cross,
            "logdets": self._state.logdets,
            "history": {
                "elbo": np.asarray(self.history["elbo"]),
                "reconstruction_error": np.asarray(
                    self.history["reconstruction_error"]),
            },
            "structure": self.structure,
            "learning_rate": self.lr,
            "seed": self.seed,
            "carry_elbo": self._carry_elbo,
            "carry_pat": self._carry_pat,
            "converged": bool(self._converged),
            "diverged": bool(self._diverged),
        }

    def save_checkpoint(self, ckpt_dir) -> None:
        """Checkpoint the full smoothed-fit state (means, marginal and
        lag-1 cross covariances, logdets, history, convergence carry) for
        restart."""
        from tame.io import save_checkpoint

        save_checkpoint(ckpt_dir, self._checkpoint_state())

    def load_checkpoint(self, ckpt_dir) -> None:
        """Restore a checkpoint saved by :meth:`save_checkpoint`; a
        subsequent ``fit`` continues from the restored state."""
        import numpy as np

        from tame.io import load_checkpoint

        state = load_checkpoint(ckpt_dir)
        if state.get("structure", "smoothed") != "smoothed":
            raise ValueError(
                f"checkpoint structure '{state.get('structure')}' is not "
                "'smoothed'")
        self._state = SmoothedState(
            X_mean=jnp.asarray(state["X_mean"]),
            X_cov=jnp.asarray(state["X_cov"]),
            X_cross=jnp.asarray(state["X_cross"]),
            logdets=jnp.asarray(state["logdets"]))
        self.history = {
            "elbo": list(np.asarray(state["history"]["elbo"]).tolist()),
            "reconstruction_error": list(np.asarray(
                state["history"]["reconstruction_error"]).tolist()),
        }
        self._carry_elbo = state.get("carry_elbo")
        self._carry_pat = int(state.get("carry_pat", 0))
        self._converged = bool(state.get("converged", False))
        self._diverged = bool(state.get("diverged", False))
