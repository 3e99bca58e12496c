"""Block-tridiagonal Gaussian solves: exact AR(1) forward-backward
smoothing.

The CAVI factors of the reference (and of ``tame.inference.cavi``) treat
every (node, time) marginal independently, coupling times only through
neighbor *means* — Gauss–Seidel in t.  The exact conditional posterior of a
node's whole trajectory given the other nodes is a Gaussian whose precision
is block tridiagonal:

    D_t = P_obs[t] + prior_diag[t]          (d x d diagonal blocks)
    O   = -Phi' Q^-1                         (constant super-diagonal block)

This module solves that system exactly — the "AR(1) forward-backward
smoothing" kernel of the north star — returning trajectory means, marginal
covariances and lag-1 cross-covariances:

    forward  (block Thomas / Cholesky elimination):
        S_1 = D_1,          S_t = D_t - O' S_{t-1}^-1 O
        c_1 = b_1,          c_t = b_t - O' S_{t-1}^-1 c_{t-1}
    backward (RTS-style):
        mu_T = S_T^-1 c_T,      mu_t  = S_t^-1 (c_t - O mu_{t+1})
        Sig_T = S_T^-1,         Sig_t = S_t^-1 + G_t Sig_{t+1} G_t'
        C_{t,t+1} = -G_t Sig_{t+1}          with  G_t = S_t^-1 O

Everything is ``lax.scan`` over T and ``vmap`` over nodes; the sequential
depth is T (50 at the north-star scale) of tiny d x d ops, with all nodes
in parallel.

**Time-parallel variant.**  A first associative-scan attempt linearized
the forward Riccati recursion to 2d x 2d transfer-matrix products via
the homogeneous representation ``S_t = U_t V_t^-1`` — measured
(2026-08-19) to be numerically unusable: the prefix products' condition
number grows exponentially (cond(V) ~ 3e9 by t=50 on typical CAVI
systems), and renormalization cannot fix a conditioning failure.  The
numerically sound O(log T)-depth formulation — the conditional-Gaussian
element parametrization of Särkkä & García-Fernández (2021) — is
implemented in :mod:`tame.ops.ptridiag` and validated against this
solver to float32 tolerance at T up to 512; it stays opt-in
(``smoother="parallel"``) — see the ptridiag module notes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from tame.ops.dyad import HIGHEST


class SmootherResult(NamedTuple):
    mean: Array        # (T, d)
    cov: Array         # (T, d, d)    marginal covariances
    cross_cov: Array   # (T-1, d, d)  Cov(X_t, X_{t+1})
    logdet: Array      # scalar: logdet of the full T*d precision


def _solve_psd(A: Array, B: Array) -> Array:
    """A^-1 B for a small SPD block (Cholesky)."""
    chol = jnp.linalg.cholesky(A)
    return jax.scipy.linalg.cho_solve((chol, True), B)


def block_tridiag_smoother(D: Array, O: Array, b: Array) -> SmootherResult:
    """Solve one block-tridiagonal Gaussian system.

    Parameters
    ----------
    D : (T, d, d) diagonal precision blocks (SPD).
    O : (d, d) constant coupling block between consecutive times
        (the (t, t+1) block of the precision).
    b : (T, d) natural parameters.

    Returns
    -------
    :class:`SmootherResult` with means, marginal and lag-1 covariances and
    the log determinant of the full precision.
    """
    T, d, _ = D.shape
    eye = jnp.eye(d, dtype=D.dtype)

    # -- forward elimination ----------------------------------------------
    def fwd(carry, inputs):
        S_prev_inv, c_prev = carry
        D_t, b_t = inputs
        # O' S_{t-1}^-1
        Ot_Sinv = jnp.matmul(O.T, S_prev_inv, precision=HIGHEST)
        S_t = D_t - jnp.matmul(Ot_Sinv, O, precision=HIGHEST)
        c_t = b_t - jnp.matmul(Ot_Sinv, c_prev[..., None],
                               precision=HIGHEST)[..., 0]
        S_t_inv = _solve_psd(S_t, eye)
        return (S_t_inv, c_t), (S_t, S_t_inv, c_t)

    S1_inv = _solve_psd(D[0], eye)
    (_, _), (S_rest, S_inv_rest, c_rest) = jax.lax.scan(
        fwd, (S1_inv, b[0]), (D[1:], b[1:]))
    S = jnp.concatenate([D[0][None], S_rest], axis=0)
    S_inv = jnp.concatenate([S1_inv[None], S_inv_rest], axis=0)
    c = jnp.concatenate([b[0][None], c_rest], axis=0)

    # -- log determinant ---------------------------------------------------
    chols = jnp.linalg.cholesky(S)
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chols, axis1=-2, axis2=-1)))

    # -- backward substitution --------------------------------------------
    G = jnp.matmul(S_inv, O, precision=HIGHEST)      # (T, d, d); G_T unused

    def bwd(carry, inputs):
        mu_next, Sig_next = carry
        S_inv_t, c_t, G_t = inputs
        mu_t = jnp.matmul(
            S_inv_t, (c_t - jnp.matmul(O, mu_next[..., None],
                                       precision=HIGHEST)[..., 0])[..., None],
            precision=HIGHEST)[..., 0]
        GS = jnp.matmul(G_t, Sig_next, precision=HIGHEST)
        Sig_t = S_inv_t + jnp.matmul(GS, G_t.T, precision=HIGHEST)
        cross_t = -GS                               # Cov(X_t, X_{t+1})
        return (mu_t, Sig_t), (mu_t, Sig_t, cross_t)

    mu_T = jnp.matmul(S_inv[-1], c[-1][..., None],
                      precision=HIGHEST)[..., 0]
    Sig_T = S_inv[-1]
    (_, _), (mu_rest, Sig_rest, cross_rest) = jax.lax.scan(
        bwd, (mu_T, Sig_T), (S_inv[:-1], c[:-1], G[:-1]), reverse=True)
    mean = jnp.concatenate([mu_rest, mu_T[None]], axis=0)
    cov = jnp.concatenate([Sig_rest, Sig_T[None]], axis=0)
    return SmootherResult(mean=mean, cov=cov, cross_cov=cross_rest,
                          logdet=logdet)


def dense_precision(D: Array, O: Array) -> Array:
    """Materialize the full (T d, T d) precision (testing / tiny T only)."""
    T, d, _ = D.shape
    P = jnp.zeros((T * d, T * d), dtype=D.dtype)
    for t in range(T):
        P = P.at[t * d:(t + 1) * d, t * d:(t + 1) * d].set(D[t])
        if t + 1 < T:
            P = P.at[t * d:(t + 1) * d, (t + 1) * d:(t + 2) * d].set(O)
            P = P.at[(t + 1) * d:(t + 2) * d, t * d:(t + 1) * d].set(O.T)
    return P
