"""CAVI for BINARY dynamic networks via the Jaakkola-Jordan bound.

The Gaussian engine's closed-form coordinate updates are the Gaussian
conjugacy; binary ties ``y_ij ~ Bernoulli(sigmoid(m_ij))`` with the
bilinear predictor ``m_ij = a_i + b_j + U_i . V_j`` have no conjugate
update — the reference has nothing for binary data at all, and until
this module the framework supported it sampler-only
(``tame.models.likelihoods.BernoulliDyadic`` + NUTS/SMC).

The Jaakkola & Jordan (2000) bound makes each Bernoulli term quadratic:

    log sigmoid(z) >= z/2 - lam(xi) z^2 + kappa(xi),
    log p(y|m) = y m - log(1 + e^m)
              >= (y - 1/2) m - lam(xi) m^2 + xi/2 - log(1 + e^xi)
                 + lam(xi) xi^2

with ``lam(xi) = tanh(xi/2) / (4 xi)`` and a per-dyad variational
parameter ``xi_ij^t``, tight at ``xi^2 = E_q[m^2]`` (its own closed-form
update).  Under the bound every dyad contributes a GAUSSIAN-shaped term
with per-dyad precision ``2 lam_ij`` — so the whole CAVI machinery
applies with the constant dyad weights replaced by iteration-dependent
weighted contractions:

    node i's observation precision (sender side, from m_ij):
        blocks over [a, U]:  counts -> sum_j 2 lam_ij,
        sums -> (2 lam @ V)_i,  Grams -> (2 lam @ VV-panel)_i
    receiver side (from m_ji): the transposed contractions over [b, V].
    The two directions touch DISJOINT coordinate blocks of x_i (a, U vs
    b, V) — binary directions are conditionally independent, the
    rho = 0 structure of the Gaussian engine.

    natural parameter: (y - 1/2) minus the bound's partner-offset pull
    ``2 lam * offset`` (the exact analog of the Gaussian engine's
    ``corrected=True`` offsets).

Because ``lam`` changes every iteration, the per-iteration cost is
genuinely O(n^2 T r) (three observation-sized tensor contractions + the
xi update) — there is no constant-weight precompute as in the Gaussian
case.  Missing data: an ``(n, n, T)`` mask zeroes hidden dyads in every
sum (masked entries of Y are never read).

The objective reported per iteration is the BOUND (a true ELBO lower
bound): JJ likelihood terms + the shared AR(1) prior expectations +
Gaussian entropy (``cavi.state_prior_terms`` / ``cavi.gaussian_entropy``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array

from tame.inference import cavi
from tame.models.params import AMEParams
from tame.ops import dyad as dyad_ops
from tame.ops.dyad import HIGHEST


class BernoulliFitResult(NamedTuple):
    X_mean: Array        # (n, T, d)
    X_cov: Array         # (n, T, d, d)
    elbo_history: Array  # (buf,) the JJ bound value (NaN past stopping)
    accuracy_history: Array  # (buf,) plug-in tie-prediction accuracy
    n_iter: Array
    converged: Array
    diverged: Array
    # Convergence carry at exit (cf. cavi.FitResult): feed back as
    # carry_elbo/carry_patience of a follow-up call to continue a fit in
    # segments with BITWISE-identical stopping behavior.
    last_elbo: Array = jnp.nan
    pat_count: Array = 0


def solve_direct(P: Array, eta: Array) -> tuple:
    """``mu = P^-1 eta`` via the direct Cholesky solve, covariance with
    RELATIVE symmetrize-jitter.

    The Gaussian engines' ``cavi._solve_full`` reproduces the
    reference's quirk of computing the mean THROUGH the jittered
    covariance (``structured_mf.py:266-279``) with a fixed absolute
    1e-6 jitter — harmless at parity scales (covariances ~0.1) but
    catastrophic for the weighted engines: heavy-count Poisson dyads
    produce pseudo-precisions ~1e5, covariances ~1e-5, and the absolute
    jitter then perturbs the mean update by ~10% — measured to turn the
    exact natural-gradient ASCENT direction into descent (f64 check:
    g' P^-1 g = +1.2e6 while the jittered-path direction gave -1.8e6),
    stalling every n >= 128 Poisson fit.  The non-Gaussian engines have
    no parity constraint, so they use the direct solve and scale the
    covariance jitter to each block's own diagonal magnitude.
    """
    from tame.ops.cholesky import batched_spd_solve_inv

    mu, cov_raw = batched_spd_solve_inv(P, eta)
    cov = 0.5 * (cov_raw + jnp.swapaxes(cov_raw, -1, -2))
    scale = jnp.mean(jnp.diagonal(cov, axis1=-2, axis2=-1),
                     axis=-1)[..., None, None]
    eye = jnp.eye(cov.shape[-1], dtype=cov.dtype)
    return mu, cov + 1e-6 * jnp.abs(scale) * eye


def _lam(xi: Array) -> Array:
    """Jaakkola-Jordan lambda(xi) = tanh(xi/2)/(4 xi), lambda(0) = 1/8."""
    safe = jnp.maximum(jnp.abs(xi), 1e-6)
    return jnp.tanh(safe / 2.0) / (4.0 * safe)


def _predictor_moments(state: cavi.CaviState, r: int):
    """Plug-in predictor ``m_ij`` (n, n, T) and its posterior variance
    under the mean-field factors (the exact bilinear formula, including
    the second-order ``tr(S_i[UU] S_j[VV])`` term)."""
    mu, S = state.X_mean, state.X_cov
    n, T, d = mu.shape
    a, b, U, V = dyad_ops.split_state(mu, r)
    m = dyad_ops.dyadic_fwd_temporal(mu, r)                  # (n, n, T)

    A = S[..., 0, 0]                                         # (n, T)
    Ar = S[..., 1, 1]
    B = S[..., 0, 2:2 + r]                                   # (n, T, r)
    Br = S[..., 1, 2 + r:]
    C = S[..., 2:2 + r, 2:2 + r]                             # (n, T, r, r)
    Cr = S[..., 2 + r:, 2 + r:]
    hi = HIGHEST
    # var(m_ij) = var_i([1, V_j] block) + var_j([1, U_i] block)
    #             + tr(C_i Cr_j)
    var = (A[:, None] + Ar[None]
           + 2.0 * jnp.einsum("itr,jtr->ijt", B, V, precision=hi)
           + jnp.einsum("jtr,itrs,jts->ijt", V, C, V, precision=hi)
           + 2.0 * jnp.einsum("jtr,itr->ijt", Br, U, precision=hi)
           + jnp.einsum("itr,jtrs,its->ijt", U, Cr, U, precision=hi)
           + jnp.einsum("itrs,jtrs->ijt",
                        C, jnp.swapaxes(Cr, -1, -2), precision=hi))
    return m, var


def _contract(L: Array, Z: Array) -> Array:
    """einsum("ijt,jtk->itk") with f32 accumulation."""
    return jnp.einsum("ijt,jtk->itk", L, Z,
                      preferred_element_type=jnp.float32, precision=HIGHEST)


def weighted_obs_terms(mu: Array, r: int, w: Array,
                       s: Array, cov: Optional[Array] = None) -> tuple:
    """Observation precision and natural parameter of a quadratic
    pseudo-likelihood over directed dyads.

    Every bound/surrogate-based engine (Jaakkola-Jordan Bernoulli, CVI
    Poisson — mean-field or smoothed) reduces each directed dyad to
    ``s_ij m_ij - (w_ij / 2) E[m_ij^2]``-shaped terms with per-dyad
    precision ``w`` and linear coefficient ``s`` (both (n, n, T),
    pre-gated by the observation mask).  Given the current means ``mu``
    (n, T, d) this assembles, per (node, time):

    * ``P_obs``: sender-side contractions of ``w`` against
      ``[1 | V_j | V_j V_j']`` filling the [a, U] blocks, receiver-side
      transposed contractions against ``[1 | U_i | U_i U_i']`` filling
      [b, V] (the two directions touch disjoint blocks — conditional
      independence of directions, the rho = 0 structure);
    * ``eta_obs``: ``s`` minus the pseudo-precision pull of the partner
      offsets (``w b_j`` sender side / ``w a_i`` receiver side),
      contracted against the partner factors.

    ``cov`` (the current (n, T, d, d) covariances) enables the
    SECOND-ORDER terms: ``Var_q(m_ij)`` depends on node i's own
    parameters not only through its covariance blocks but also through
    the PARTNER-covariance quadratic forms ``U_i' Cov_j[VV] U_i`` and
    ``2 Cov_j[b,V] . U_i`` — so the exact per-node derivatives of the
    expected/bounded likelihood gain, relative to the means-only
    assembly:

        P[UU block]  += sum_j w_ij Cov_j[VV]      (and VV <- Cov[UU]
                                                   on the receiver side)
        eta[U]       -= sum_j w_ij Cov_j[b, V]    (the Cov_j[VV] U_i
                                                   gradient term cancels
                                                   against the new
                                                   precision's mean pull)

    each one extra aggregated ``w`` contraction against an (r + r^2)-
    column partner panel.  Omitting them (cov=None) biases the fixed
    point slightly AND — when weights are large, e.g. Poisson dyads
    with heavy-tailed counts — can turn the update into a DESCENT
    direction of the exact objective (measured: the n >= 128 Poisson
    fit stalls with every proposal rejected; with the correction it
    converges).  Mean-field engines pass their covariances; the
    smoothed engines pass marginal covariances.

    Returns ``(P_obs, eta_obs)`` WITHOUT prior terms — the caller adds
    its own (per-time precision for mean-field engines, the
    block-tridiagonal chain for smoothed ones).
    """
    n, T, d = mu.shape
    a, b, U, V = dyad_ops.split_state(mu, r)
    VV = (V[..., :, None] * V[..., None, :]).reshape(n, T, r * r)
    UU = (U[..., :, None] * U[..., None, :]).reshape(n, T, r * r)
    wt = jnp.swapaxes(w, 0, 1)
    if cov is not None:
        # partner panels: Cov[b, V] / Cov[VV] for the sender side,
        # Cov[a, U] / Cov[UU] for the receiver side
        CbV = cov[..., 1, 2 + r:]
        CVV = cov[..., 2 + r:, 2 + r:].reshape(n, T, r * r)
        CaU = cov[..., 0, 2:2 + r]
        CUU = cov[..., 2:2 + r, 2:2 + r].reshape(n, T, r * r)
        Cs = _contract(w, jnp.concatenate(
            [jnp.ones((n, T, 1)), V, VV + CVV, CbV], axis=-1))
        Cr_ = _contract(wt, jnp.concatenate(
            [jnp.ones((n, T, 1)), U, UU + CUU, CaU], axis=-1))
    else:
        Cs = _contract(w, jnp.concatenate(
            [jnp.ones((n, T, 1)), V, VV], axis=-1))
        Cr_ = _contract(wt, jnp.concatenate(
            [jnp.ones((n, T, 1)), U, UU], axis=-1))

    P = jnp.zeros((n, T, d, d))
    P = P.at[..., 0, 0].set(Cs[..., 0])
    P = P.at[..., 1, 1].set(Cr_[..., 0])
    sWV = Cs[..., 1:1 + r]
    P = P.at[..., 0, 2:2 + r].set(sWV).at[..., 2:2 + r, 0].set(sWV)
    sWU = Cr_[..., 1:1 + r]
    P = P.at[..., 1, 2 + r:].set(sWU).at[..., 2 + r:, 1].set(sWU)
    P = P.at[..., 2:2 + r, 2:2 + r].set(
        Cs[..., 1 + r:1 + r + r * r].reshape(n, T, r, r))
    P = P.at[..., 2 + r:, 2 + r:].set(
        Cr_[..., 1 + r:1 + r + r * r].reshape(n, T, r, r))

    S_ = s - w * b[None, :, :]
    W_ = s - w * a[:, None, :]
    eta_U = _contract(S_, V)
    eta_V = _contract(jnp.swapaxes(W_, 0, 1), U)
    if cov is not None:
        eta_U = eta_U - Cs[..., 1 + r + r * r:]
        eta_V = eta_V - Cr_[..., 1 + r + r * r:]
    eta = jnp.concatenate([
        S_.sum(1)[..., None],                               # eta_a
        W_.sum(0)[..., None],                               # eta_b
        eta_U,
        eta_V,
    ], axis=-1)
    return P, eta


def bernoulli_step(state: cavi.CaviState, y0: Array, offd: Array,
                   pri: cavi.PriorMatrices, params: AMEParams,
                   lr: Array) -> tuple:
    """One simultaneous (Jacobi) JJ-bound coordinate update.

    ``y0``: (n, n, T) binary directed adjacency (y0[i, j] = tie i -> j),
    pre-zeroed at the diagonal and at masked entries; ``offd`` the
    off-diagonal/observation gate.  Returns ``(new_state, bound,
    accuracy)`` — the bound and plug-in accuracy are evaluated at the
    INCOMING state's xi-optimal bound (free by-products of the update's
    moment computation).
    """
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2

    # -- xi update (closed form: xi^2 = E[m^2]) + bound value -------------
    m, var = _predictor_moments(state, r)
    Em2 = m * m + var
    xi = jnp.sqrt(jnp.maximum(Em2, 1e-12))
    lam = _lam(xi) * offd                                    # (n, n, T)

    resid = (y0 - 0.5) * offd
    bound = jnp.sum(offd * (resid * m - lam * Em2 + xi / 2.0
                            - jax.nn.softplus(xi) + lam * xi * xi))
    prior0, priort = cavi.state_prior_terms(params, pri, state)
    bound = bound + prior0 + priort + cavi.gaussian_entropy(state)
    acc = (jnp.sum(offd * ((m > 0) == (y0 > 0.5)))
           / jnp.maximum(jnp.sum(offd), 1.0))

    # -- weighted observation terms (precision 2 lam, coeff y - 1/2) ------
    P, eta = weighted_obs_terms(state.X_mean, r, 2.0 * lam, resid,
                                cov=state.X_cov)
    P = P + cavi._prior_precision(pri, T)[None]
    eta = eta + cavi._prior_nat_param(pri, state.X_mean)

    mu_new, cov_new = solve_direct(P, eta)
    X_mean = lr * mu_new + (1.0 - lr) * state.X_mean
    X_cov = lr * cov_new + (1.0 - lr) * state.X_cov
    return cavi.CaviState(X_mean=X_mean, X_cov=X_cov), bound, acc


def fit_cavi_bernoulli(Y: Array, params: AMEParams,
                       init: cavi.CaviState, *,
                       max_iter: int = 200, learning_rate=0.8,
                       tolerance=1e-5, patience: int = 3,
                       carry_elbo=None, carry_patience=0,
                       mask: Optional[Array] = None
                       ) -> BernoulliFitResult:
    """Fit the JJ-bound CAVI to a binary network inside one compiled
    loop (tolerance/patience stopping on the bound, cf.
    ``cavi.fit_cavi``).

    ``Y``: the (n, n, T, 2) reciprocal layout produced by
    ``sample(..., family="bernoulli")`` /
    ``tame.models.likelihoods.BernoulliDyadic`` (only component 0 — the
    full ordered adjacency — is read).  ``mask``: optional (n, n, T)
    observation gate (missing dyads are never read).

    ``carry_elbo``/``carry_patience`` seed the convergence bookkeeping
    from a prior segment's ``last_elbo``/``pat_count`` so a fit run in
    segments (engine in-fit checkpointing) stops at EXACTLY the same
    iteration as the uninterrupted fit (cf. ``cavi.fit_cavi``).
    """
    buf = 64
    while buf < max_iter:
        buf *= 2
    return _fit_bernoulli_impl(Y, params, init, jnp.asarray(max_iter),
                               jnp.asarray(learning_rate, jnp.float32),
                               jnp.asarray(tolerance, jnp.float32),
                               jnp.asarray(-jnp.inf if carry_elbo is None
                                           else carry_elbo, jnp.float32),
                               jnp.asarray(carry_patience),
                               buf_size=buf, patience=patience,
                               mask=mask)


@functools.partial(jax.jit, static_argnames=("buf_size", "patience"))
def _fit_bernoulli_impl(Y, params, init, max_iter, lr, tol,
                        carry_elbo, carry_patience, *,
                        buf_size: int, patience: int,
                        mask=None) -> BernoulliFitResult:
    n, _, T, _ = Y.shape
    offd = jnp.broadcast_to(dyad_ops.offdiag_mask(n)[:, :, None],
                            (n, n, T))
    if mask is not None:
        offd = offd * jnp.asarray(mask, jnp.float32)
    # where (not multiplication): NaN-coded missing entries stay unread
    y0 = jnp.where(offd > 0, Y[..., 0], 0.0)
    pri = cavi.precompute_priors(params)

    def cond(carry):
        state, it, prev, pat, conv, div, eh, ah = carry
        running = jnp.logical_not(jnp.logical_or(conv, div))
        return jnp.logical_and(it < max_iter, running)

    def body(carry):
        state, it, prev, pat, conv, div, eh, ah = carry
        state, bound, acc = bernoulli_step(state, y0, offd, pri, params,
                                           lr)
        eh = eh.at[it].set(bound)
        ah = ah.at[it].set(acc)
        rel = jnp.abs(bound - prev) / (jnp.abs(prev) + 1e-8)
        small = jnp.logical_and(jnp.isfinite(prev), rel < tol)
        pat = jnp.where(small, pat + 1, 0)
        conv = pat >= patience
        div = jnp.logical_not(jnp.isfinite(bound))
        return state, it + 1, bound, pat, conv, div, eh, ah

    nanbuf = jnp.full((buf_size,), jnp.nan, jnp.float32)
    carry = (init, jnp.asarray(0), carry_elbo, carry_patience,
             jnp.asarray(False), jnp.asarray(False), nanbuf, nanbuf)
    state, it, last, pat, conv, div, eh, ah = jax.lax.while_loop(
        cond, body, carry)
    return BernoulliFitResult(X_mean=state.X_mean, X_cov=state.X_cov,
                              elbo_history=eh, accuracy_history=ah,
                              n_iter=it, converged=conv, diverged=div,
                              last_elbo=last, pat_count=pat)


class TemporalAMEBernoulliVI:
    """Engine class for binary dynamic networks (JJ-bound CAVI); same
    surface feel as the Gaussian engines — including segmented in-fit
    checkpointing with bitwise-identical resume
    (``checkpoint_every``/``resume``, cf.
    :class:`tame.inference.smoothed.TemporalAMESmoothedVI`).
    ``model.Y`` must hold binary data in the reciprocal layout (e.g.
    from ``sample_observations(..., family="bernoulli")``)."""

    structure = "bernoulli"

    # Stability guideline (cf. CLAUDE.md's jacobi lr-vs-n note): this
    # engine only has the simultaneous (Jacobi) update, but unlike the
    # Gaussian engine its per-dyad weights are BOUNDED by the JJ
    # lambda <= 1/8, which caps the node-coupling growth; the default
    # lr = 0.8 is measured stable through n = 1000
    # (scripts/binary_scale_probe.py).  If a very large fit oscillates
    # (ELBO ringing), lower lr toward 0.5, or use the joint-trajectory
    # binary family (tame.inference.fit_smoothed_family), whose guarded
    # loop backs off automatically.

    def __init__(self, model, learning_rate: float = 0.8,
                 init_scale: float = 0.1, seed: int = 42,
                 init_mode: str = "random", mask=None):
        if model.Y is None:
            raise ValueError(
                "Model has no data. Call model.generate_data() first.")
        self.model = model
        self.Y = jnp.asarray(model.Y)
        self.n, self.T, self.d, self.r = (model.n, model.T, model.d,
                                          model.r)
        self.lr = learning_rate
        self.seed = seed
        self.mask = None if mask is None else jnp.asarray(mask)
        self.params = model.params
        self.history = {"elbo": [], "accuracy": []}
        self._carry_elbo = None
        self._carry_pat = 0
        self._converged = False
        self._diverged = False
        if init_mode == "warm":
            # Logit linearization sigmoid(m) ~ 1/2 + m/4 around 0 makes
            # 4 (y - 1/2) pseudo-Gaussian observations of the predictor;
            # the Gaussian closed-form warm start (two-way additive fit
            # + top-r subspace) then lands the JJ fit inside the basin.
            st = cavi.warm_init_state(4.0 * (self.Y - 0.5), self.params,
                                      structure="full",
                                      obs_mask=self.mask)
        elif init_mode == "random":
            st = cavi.init_state(jax.random.PRNGKey(seed), self.n,
                                 self.T, self.d, "full", init_scale, 0.5)
        else:
            raise ValueError(f"unknown init_mode '{init_mode}'")
        self.X_mean = st.X_mean
        self.X_cov = st.X_cov

    def fit(self, max_iter: int = 200, tolerance: float = 1e-5,
            verbose: bool = True, check_every: int = 10,
            checkpoint_every=None, ckpt_dir=None, resume: bool = False):
        """Run JJ-bound CAVI to convergence.

        ``checkpoint_every``/``ckpt_dir``/``resume`` mirror the other
        engines: the compiled loop runs in segments, each followed by an
        async checkpoint + progress line; the convergence carry threads
        through segments so a segmented (or killed-and-resumed) fit
        stops at EXACTLY the same iteration as the uninterrupted one.
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
            out = jax.block_until_ready(fit_cavi_bernoulli(
                self.Y, self.params,
                cavi.CaviState(X_mean=self.X_mean, X_cov=self.X_cov),
                max_iter=seg, learning_rate=self.lr,
                tolerance=tolerance, mask=self.mask,
                carry_elbo=self._carry_elbo,
                carry_patience=self._carry_pat))
            self.X_mean, self.X_cov = out.X_mean, out.X_cov
            k = int(out.n_iter)
            eh = np.asarray(out.elbo_history)[:k]
            ah = np.asarray(out.accuracy_history)[:k]
            self.history["elbo"].extend(float(v) for v in eh)
            self.history["accuracy"].extend(float(v) for v in ah)
            self._converged = bool(out.converged)
            self._diverged = bool(out.diverged)
            self._carry_elbo = float(out.last_elbo)
            self._carry_pat = int(out.pat_count)
            budget -= k
            if checkpoint_every:
                if ckptr is not None:
                    ckptr.save(ckpt_dir, self._checkpoint_state())
                if verbose and k:
                    total = len(self.history["elbo"])
                    print(f"Iter {total - 1:4d} | bound: {eh[-1]:10.2f} "
                          f"| acc: {ah[-1]:.4f}"
                          + (" | checkpointed" if ckpt_dir else ""),
                          flush=True)
        if ckptr is not None:
            ckptr.wait()

        if verbose and not checkpoint_every:
            eh_all = self.history["elbo"]
            ah_all = self.history["accuracy"]
            n_total = len(eh_all)
            for it in range(seg_start, n_total):
                if (it - seg_start) % check_every == 0 \
                        or it == n_total - 1:
                    print(f"Iter {it:4d} | bound: {eh_all[it]:10.2f} | "
                          f"acc: {ah_all[it]:.4f}")
        return self.history

    def _checkpoint_state(self):
        import numpy as np

        return {
            "X_mean": self.X_mean,
            "X_cov": self.X_cov,
            "history": {
                "elbo": np.asarray(self.history["elbo"]),
                "accuracy": np.asarray(self.history["accuracy"]),
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
        """Checkpoint the fit state (variational parameters, history,
        convergence carry) for restart."""
        from tame.io import save_checkpoint

        save_checkpoint(ckpt_dir, self._checkpoint_state())

    def load_checkpoint(self, ckpt_dir) -> None:
        """Restore a checkpoint saved by :meth:`save_checkpoint`; a
        subsequent ``fit`` continues from the restored state."""
        import numpy as np

        from tame.io import load_checkpoint

        state = load_checkpoint(ckpt_dir)
        if state.get("structure", "bernoulli") != "bernoulli":
            raise ValueError(
                f"checkpoint structure '{state.get('structure')}' is "
                "not 'bernoulli'")
        self.X_mean = jnp.asarray(state["X_mean"])
        self.X_cov = jnp.asarray(state["X_cov"])
        self.history = {
            "elbo": list(np.asarray(state["history"]["elbo"]).tolist()),
            "accuracy": list(np.asarray(
                state["history"]["accuracy"]).tolist()),
        }
        self._carry_elbo = state.get("carry_elbo")
        self._carry_pat = int(state.get("carry_pat", 0))
        self._converged = bool(state.get("converged", False))
        self._diverged = bool(state.get("diverged", False))

    def predict_proba(self) -> Array:
        """Posterior plug-in tie probabilities (n, n, T)."""
        m = dyad_ops.dyadic_fwd_temporal(self.X_mean, self.r)
        return jax.nn.sigmoid(m)

    def predict_forward(self, n_steps: int = 1) -> Array:
        """AR(1) forward forecast of the latent means (n, n_steps, d)
        from the last fitted time step (cf. the Gaussian engines /
        reference ``naive_mf.py:386-396``)."""
        Phi = self.params.Phi

        def step(x, _):
            x = x @ Phi.T
            return x, x

        _, preds = jax.lax.scan(step, self.X_mean[:, -1], None,
                                length=n_steps)
        return jnp.swapaxes(preds, 0, 1)

    def predict_proba_forward(self, n_steps: int = 1) -> Array:
        """Forecast tie probabilities (n, n, n_steps): the plug-in
        sigmoid of the AR(1)-propagated predictor."""
        Xf = self.predict_forward(n_steps)
        return jax.nn.sigmoid(dyad_ops.dyadic_fwd_temporal(Xf, self.r))

    def get_variational_means(self) -> Array:
        return self.X_mean

    def get_variational_covariances(self) -> Array:
        return self.X_cov
