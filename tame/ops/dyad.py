"""Vectorized dyadic-tensor operations for the AME family.

All operations are full-tensor (no Python loops over nodes/dyads/time) so XLA
can fuse them and hand the contractions to the matrix units.  These replace the
reference's nested dyad loops (``static_ame.py:176-187``,
``temporal_ame.py:200-216``, ``naive_mf.py:120-131``).

Conventions
-----------
* Latent state ``X``: shape ``(n, T, d)`` with layout
  ``[a, b, U_1..U_r, V_1..V_r]`` (reference ``temporal_ame.py:119-120``).
* Observations ``Y``: shape ``(n, n, T, 2)`` with
  ``Y[i, j, t] = [y_ij^t, y_ji^t]``, zero diagonal and reciprocity
  ``Y[i, j, t, 1] == Y[j, i, t, 0]`` (reference ``temporal_ame.py:159-216``).
* Static shapes use ``(n, n, 2)`` / ``(n, d)`` analogously.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

# GPU float32 matmuls may default to TF32 (10-bit mantissa);
# statistics/metrics need true float32.
HIGHEST = jax.lax.Precision.HIGHEST


def split_state(X: Array, r: int):
    """Split a state tensor ``(..., d)`` into (a, b, U, V)."""
    a = X[..., 0]
    b = X[..., 1]
    U = X[..., 2:2 + r]
    V = X[..., 2 + r:]
    return a, b, U, V


def dyadic_mean_static(A: Array, M: Array, r: int) -> Array:
    """Mean structure for one snapshot.

    ``mu[i, j] = [a_i + b_j + U_i.V_j,  a_j + b_i + U_j.V_i]`` — a broadcast
    add plus one ``U @ V^T`` matmul (reference ``static_ame.py:189-238``).

    Parameters
    ----------
    A : (n, 2) additive effects.   M : (n, 2r) multiplicative effects.

    Returns
    -------
    mu : (n, n, 2)
    """
    a, b = A[:, 0], A[:, 1]
    U, V = M[:, :r], M[:, r:]
    fwd = (a[:, None] + b[None, :]) + jnp.matmul(U, V.T, precision=HIGHEST)
    return jnp.stack([fwd, fwd.T], axis=-1)


def dyadic_mean_temporal(X: Array, r: int) -> Array:
    """Mean structure for all time steps at once.

    Parameters
    ----------
    X : (n, T, d) latent states.

    Returns
    -------
    mu : (n, n, T, 2) with ``mu[i, j, t] = [a_i+b_j+U_i.V_j, a_j+b_i+U_j.V_i]``
    evaluated at time t.
    """
    a, b, U, V = split_state(X, r)
    additive = a[:, None, :] + b[None, :, :]                    # (n, n, T)
    mult = jnp.einsum("itr,jtr->ijt", U, V, precision=HIGHEST,
                      preferred_element_type=jnp.float32)       # (n, n, T)
    fwd = additive + mult
    return jnp.stack([fwd, jnp.swapaxes(fwd, 0, 1)], axis=-1)


def dyadic_fwd_temporal(X: Array, r: int) -> Array:
    """Forward half of the dyadic mean: ``fwd[i,j,t] = a_i + b_j + U_i.V_j``.

    Under the reciprocity invariant ``Y[i,j,t,1] == Y[j,i,t,0]`` (guaranteed
    by the generative model, reference ``temporal_ame.py:209-216``) every
    dyadic residual statistic is a function of ``e0 = Y[...,0] - fwd`` alone,
    since ``mu[...,1] = fwd^T`` and ``Y[...,1] = Y^T[...,0]`` — so the fit
    loop's diagnostics never need the stacked ``(n, n, T, 2)`` tensor.
    """
    a, b, U, V = split_state(X, r)
    additive = a[:, None, :] + b[None, :, :]                    # (n, n, T)
    mult = jnp.einsum("itr,jtr->ijt", U, V, precision=HIGHEST,
                      preferred_element_type=jnp.float32)       # (n, n, T)
    return additive + mult


def residual_stats_from_fwd(Y: Array, fwd: Array) -> tuple[Array, Array]:
    """Sufficient statistics of the dyadic residuals from the forward half.

    Returns ``(sq, cross)`` with

        sq    = sum_{i != j, t} e0[i,j,t]^2
        cross = sum_{i != j, t} e0[i,j,t] * e0[j,i,t]

    where ``e0 = Y[..., 0] - fwd`` masked off-diagonal.  These determine both
    the ELBO quadratic form (``p*sq + q*cross`` summed over unordered dyads)
    and the reconstruction MSE (``2*sq / (n (n-1) T)``) — half the HBM
    traffic of materializing the full stacked mean.
    """
    n = Y.shape[0]
    e0 = (Y[..., 0] - fwd) * offdiag_mask(n)[:, :, None]
    sq = jnp.sum(e0 * e0)
    cross = jnp.einsum("ijt,jit->", e0, e0,
                       preferred_element_type=jnp.float32, precision=HIGHEST)
    return sq, cross


def offdiag_mask(n: int, dtype=jnp.float32) -> Array:
    """(n, n) mask that zeroes the diagonal."""
    return 1.0 - jnp.eye(n, dtype=dtype)


def symmetrize_dyads(D: Array) -> Array:
    """Impose the reciprocity layout on a raw upper-triangle dyad tensor.

    Given ``D`` of shape ``(n, n, ..., 2)`` whose upper triangle holds sampled
    dyads ``[y_ij, y_ji]``, produce ``Y`` with ``Y[i,j] = D[i,j]`` for i<j,
    ``Y[j,i] = D[i,j][::-1]`` and zero diagonal — the vectorized equivalent of
    the reference's mirror writes (``temporal_ame.py:209-216``).
    """
    n = D.shape[0]
    i = jnp.arange(n)
    upper = (i[:, None] < i[None, :])
    shape = (n, n) + (1,) * (D.ndim - 2)
    upper = upper.reshape(shape)
    swapped = jnp.swapaxes(D, 0, 1)[..., ::-1]
    lower = (i[:, None] > i[None, :]).reshape(shape)
    return jnp.where(upper, D, jnp.where(lower, swapped, 0.0))


def masked_sq_error_temporal(Y: Array, mu: Array) -> Array:
    """Off-diagonal squared-error sum, reference model-level normalization.

    ``sum_{i != j, t} ||Y[i,j,t] - mu[i,j,t]||^2 / (n (n-1) T)`` — this is the
    per-*dyad* (2-component) normalization used by the fit history
    (reference ``temporal_ame.py:279-291``), which is 2x the per-entry MSE.
    """
    n, _, T, _ = Y.shape
    mask = offdiag_mask(n)[:, :, None, None]
    err = ((Y - mu) ** 2) * mask
    return jnp.sum(err) / (n * (n - 1) * T)


def masked_sq_error_static(Y: Array, mu: Array) -> Array:
    """Static analog of :func:`masked_sq_error_temporal`
    (reference ``static_ame.py:264-275``: divides by n(n-1))."""
    n = Y.shape[0]
    mask = offdiag_mask(n)[:, :, None]
    err = ((Y - mu) ** 2) * mask
    return jnp.sum(err) / (n * (n - 1))


def additive_contribution(A: Array, exclude_diagonal: bool = True) -> Array:
    """Variance of the additive component a_i + b_j over pairs
    (reference ``static_ame.py:277-300``)."""
    n = A.shape[0]
    additive = A[:, 0][:, None] + A[:, 1][None, :]
    if exclude_diagonal:
        mask = offdiag_mask(n)
        return jnp.sum((additive ** 2) * mask) / (n * (n - 1))
    return jnp.mean(additive ** 2)


def multiplicative_contribution(M: Array, exclude_diagonal: bool = True) -> Array:
    """Variance of the multiplicative component U_i . V_j over pairs
    (reference ``static_ame.py:302-325``)."""
    n = M.shape[0]
    r = M.shape[1] // 2
    mult = jnp.matmul(M[:, :r], M[:, r:].T, precision=HIGHEST)
    if exclude_diagonal:
        mask = offdiag_mask(n)
        return jnp.sum((mult ** 2) * mask) / (n * (n - 1))
    return jnp.mean(mult ** 2)
