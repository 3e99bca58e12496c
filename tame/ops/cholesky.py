"""Batched small-SPD solve, inverse and log-determinant: the CAVI
coordinate-update hot op.

Every CAVI iteration solves n*T independent d x d SPD systems (d = 2 + 2r,
typically 4-10): ``cov = P^-1`` and ``mu = P^-1 eta`` (reference
``naive_mf.py:266-274``, ``structured_mf.py:266-279`` do this one tiny
torch solve at a time).

The Cholesky factorization, the triangular solves and the inverse are
unrolled over the static ``d`` in plain ``jax.numpy``: every scalar step
of the algorithm is one elementwise operation across the whole batch,
which sits on the trailing axis.  XLA fuses the unrolled code into
elementwise loops that read each system once, instead of dispatching a
batched library factorization plus two triangular solves for 10 x 10
matrices.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp
from jax import Array


def _sub_products(acc, terms):
    """``acc - sum(a * b)`` over ``terms``, skipping exact zeros (``None``
    factors); ``acc=None`` is an exact zero too."""
    for a, b in terms:
        if b is None:
            continue
        acc = -(a * b) if acc is None else acc - a * b
    return acc


def unrolled_cholesky(P, d: int):
    """Cholesky ``P = L L'`` of SPD matrices given entry by entry.

    ``P[i][j]`` are equally shaped arrays, one matrix per element.
    Returns ``(L, inv_diag, logdet)``: the lower factor ``L[i][k]``
    (``k <= i``), ``1 / L[k][k]`` and ``log det P``.
    """
    L = [[None] * d for _ in range(d)]
    inv_diag = [None] * d
    logdet = None
    for k in range(d):
        acc = _sub_products(P[k][k], [(L[k][m], L[k][m]) for m in range(k)])
        term = jnp.log(acc)                       # log(L_kk^2)
        logdet = term if logdet is None else logdet + term
        L[k][k] = jnp.sqrt(acc)
        inv_diag[k] = 1.0 / L[k][k]
        for i in range(k + 1, d):
            acc = _sub_products(P[i][k],
                                [(L[i][m], L[k][m]) for m in range(k)])
            L[i][k] = acc * inv_diag[k]
    return L, inv_diag, logdet


def unrolled_solve(L, inv_diag, rhs: List[Optional[Array]], d: int):
    """``L L' x = rhs`` by forward and backward substitution; ``None``
    entries of ``rhs`` are exact zeros (the unit vectors of the
    inverse)."""
    y = [None] * d
    for i in range(d):
        acc = _sub_products(rhs[i], [(L[i][m], y[m]) for m in range(i)])
        y[i] = None if acc is None else acc * inv_diag[i]
    x = [None] * d
    for i in reversed(range(d)):
        acc = _sub_products(y[i],
                            [(L[m][i], x[m]) for m in range(i + 1, d)])
        x[i] = acc * inv_diag[i]
    return x


def unrolled_inverse(L, inv_diag, d: int):
    """``P^-1`` entry by entry (``inv[i][j]``), one solve per unit
    column."""
    inv = [[None] * d for _ in range(d)]
    for j in range(d):
        col = unrolled_solve(L, inv_diag,
                             [1.0 if i == j else None for i in range(d)], d)
        for i in range(d):
            inv[i][j] = col[i]
    return inv


def _entries(P: Array, d: int):
    """(..., d, d) -> nested list of (B,) arrays, batch on the trailing
    axis of a (d, d, B) view."""
    Pt = jnp.moveaxis(P.reshape(-1, d, d), 0, -1)
    return [[Pt[i, j] for j in range(d)] for i in range(d)]


def batched_spd_solve_inv(P: Array, eta: Array) -> Tuple[Array, Array]:
    """Solve ``mu = P^-1 eta`` and compute ``cov = P^-1`` for a batch of
    small SPD systems.

    Accepts any leading batch shape: P (..., d, d), eta (..., d).
    """
    batch_shape = P.shape[:-2]
    d = P.shape[-1]
    L, inv_diag, _ = unrolled_cholesky(_entries(P, d), d)
    et = jnp.moveaxis(eta.reshape(-1, d), 0, -1)
    mu = unrolled_solve(L, inv_diag, [et[i] for i in range(d)], d)
    inv = unrolled_inverse(L, inv_diag, d)
    mu = jnp.stack(mu, axis=-1)
    cov = jnp.stack([jnp.stack(row, axis=-1) for row in inv], axis=-2)
    return mu.reshape(*batch_shape, d), cov.reshape(*batch_shape, d, d)


def batched_spd_solve(P: Array, eta: Array) -> Array:
    """Solve ``mu = P^-1 eta`` only (naive-MF path: the covariance comes
    from ``1/diag(P)``, reference ``naive_mf.py:266-274``)."""
    batch_shape = P.shape[:-2]
    d = P.shape[-1]
    L, inv_diag, _ = unrolled_cholesky(_entries(P, d), d)
    et = jnp.moveaxis(eta.reshape(-1, d), 0, -1)
    mu = unrolled_solve(L, inv_diag, [et[i] for i in range(d)], d)
    return jnp.stack(mu, axis=-1).reshape(*batch_shape, d)


def batched_logdet_spd(P: Array) -> Array:
    """Log-determinant of a batch of small SPD matrices (..., d, d) ->
    (...) — the ELBO entropy term, n*T factorizations per evaluation."""
    batch_shape = P.shape[:-2]
    d = P.shape[-1]
    _, _, logdet = unrolled_cholesky(_entries(P, d), d)
    return logdet.reshape(batch_shape)
