"""Time-parallel exact AR(1) smoothing via associative scans.

:func:`tame.ops.tridiag.block_tridiag_smoother` solves the per-node
block-tridiagonal trajectory system with a forward/backward ``lax.scan`` —
sequential depth T.  This module delivers the same solution in O(log T)
depth using the conditional-Gaussian-element parametrization of the
parallel Kalman filter/smoother (Särkkä & García-Fernández, "Temporal
Parallelization of Bayesian Smoothers", IEEE TAC 2021): each time step
becomes an associative element, ``jax.lax.associative_scan`` combines
them, and the smoothed marginals drop out of the prefix/suffix products.

This is the numerically sound formulation that the transfer-matrix
attempt documented in ``tridiag.py:33-49`` is not: every combine works
with *covariance-form* conditional Gaussians (PSD matrices plus solves
against ``I + C J`` whose eigenvalues are >= 1), so the exponential
blow-up of homogeneous prefix products never appears.  Validated against
the sequential solver to float32 tolerance at T up to 2048 —
11 combine levels, including the weak-information/high-phi corner
(tests).

It is OPT-IN (``smoother="parallel"``): its combine steps cost batched
d x d solves plus the associative scan's gather/layout work, so it pays
off only in latency-bound regimes (tiny node batches, very long T).
``scripts/kernel_bench.py`` times it against the scan on the GPU
(PERF.md).

Inputs are the model quantities, not raw precision blocks: per-time
observation information ``J_t = P_obs[t]`` (PSD) and information vector
``eta_t``, plus the AR(1) prior ``(Phi, Q, Sigma0)``.  The implied joint
precision is exactly the block-tridiagonal system

    D_t = J_t + [t=0] Sigma0^-1 + [t>0] Q^-1 + [t<T-1] Phi' Q^-1 Phi
    O   = -Phi' Q^-1

of the sequential solver (equivalence pinned by tests).

The filter scan element for step k >= 1 carries ``(A, b, C, eta, J)``
with ``p(x_k | x_{k-1}, y_k) = N(A x_{k-1} + b, C)`` and the
back-propagated likelihood ``p(y_k | x_{k-1}) ~ exp(eta'x - x'Jx/2)``:

    Lam = Q^-1 + J_k            A = Lam^-1 Q^-1 Phi     C = Lam^-1
    b = Lam^-1 eta_k            eta = A' eta_k
    J = Phi'Q^-1 Phi - (Q^-1 Phi)' Lam^-1 (Q^-1 Phi)

The smoother scan element carries the affine RTS backward map
``(G_t, g_t, L_t)`` with ``m_t|T = G_t m_{t+1|T} + g_t`` and
``P_t|T = G_t P_{t+1|T} G_t' + L_t``; the lag-1 cross-covariances are
``Cov(x_t, x_{t+1} | Y) = G_t P_{t+1|T}`` and the joint-precision log
determinant is ``-(logdet P_T|T + sum_t logdet L_t)`` (the backward
factorization of the joint covariance).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from tame.ops.dyad import HIGHEST
from tame.ops.tridiag import SmootherResult


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


def _mv(a, v):
    return jnp.matmul(a, v[..., None], precision=HIGHEST)[..., 0]


def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


class _FilterElem(NamedTuple):
    A: Array    # (..., d, d)
    b: Array    # (..., d)
    C: Array    # (..., d, d)
    eta: Array  # (..., d)
    J: Array    # (..., d, d)


def _filter_combine(e1: _FilterElem, e2: _FilterElem) -> _FilterElem:
    """Associative combine of conditional-Gaussian filter elements
    (Särkkä & García-Fernández 2021, Lemma 8)."""
    d = e1.A.shape[-1]
    eye = jnp.eye(d, dtype=e1.A.dtype)
    M = eye + _mm(e1.C, e2.J)          # eigenvalues >= 1: safe to solve
    Minv_A1 = jnp.linalg.solve(M, e1.A)
    Minv_C1 = jnp.linalg.solve(M, e1.C)
    bc = e1.b + _mv(e1.C, e2.eta)
    Minv_bc = jnp.linalg.solve(M, bc[..., None])[..., 0]
    A = _mm(e2.A, Minv_A1)
    b = _mv(e2.A, Minv_bc) + e2.b
    C = _sym(_mm(_mm(e2.A, Minv_C1), jnp.swapaxes(e2.A, -1, -2)) + e2.C)
    # (I + J2 C1) = M' for symmetric C/J
    Mt = jnp.swapaxes(M, -1, -2)
    rhs_eta = e2.eta - _mv(e2.J, e1.b)
    eta = _mv(jnp.swapaxes(e1.A, -1, -2),
              jnp.linalg.solve(Mt, rhs_eta[..., None])[..., 0]) + e1.eta
    J = _sym(_mm(jnp.swapaxes(e1.A, -1, -2),
                 jnp.linalg.solve(Mt, _mm(e2.J, e1.A))) + e1.J)
    return _FilterElem(A=A, b=b, C=C, eta=eta, J=J)


class _SmoothElem(NamedTuple):
    E: Array  # (..., d, d)
    g: Array  # (..., d)
    L: Array  # (..., d, d)


def _smooth_combine(e1: _SmoothElem, e2: _SmoothElem) -> _SmoothElem:
    """Associative combine of affine RTS backward maps, oriented for
    ``associative_scan(..., reverse=True)``: the scan hands the
    already-combined LATER suffix as ``e1`` and the element closer to t
    as ``e2``, and the composed map applies e2 after e1's suffix."""
    return _SmoothElem(
        E=_mm(e2.E, e1.E),
        g=_mv(e2.E, e1.g) + e2.g,
        L=_sym(_mm(_mm(e2.E, e1.L), jnp.swapaxes(e2.E, -1, -2)) + e2.L))


def parallel_block_tridiag_smoother(Pobs: Array, eta: Array, Phi: Array,
                                    Q: Array, Sigma0: Array
                                    ) -> SmootherResult:
    """Exact trajectory smoothing in O(log T) depth.

    Parameters
    ----------
    Pobs : (T, d, d) per-time observation information (PSD).
    eta : (T, d) per-time observation information vectors.
    Phi, Q, Sigma0 : AR(1) prior (transition, process noise, initial).

    Returns the same :class:`tame.ops.tridiag.SmootherResult` as
    :func:`block_tridiag_smoother` on the implied block-tridiagonal
    system (means, marginal covariances, lag-1 cross-covariances,
    log-determinant of the joint precision).
    """
    T, d, _ = Pobs.shape
    dtype = Pobs.dtype
    eye = jnp.eye(d, dtype=dtype)
    Q_inv = jnp.linalg.inv(Q)
    S0_inv = jnp.linalg.inv(Sigma0)
    QinvPhi = _mm(Q_inv, Phi)
    PhiT_Qinv_Phi = _mm(jnp.swapaxes(Phi, -1, -2), QinvPhi)

    if T == 1:
        P = S0_inv + Pobs[0]
        chol = jnp.linalg.cholesky(P)
        cov = jax.scipy.linalg.cho_solve((chol, True), eye)
        mean = _mv(cov, eta[0])
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
        return SmootherResult(mean=mean[None], cov=_sym(cov)[None],
                              cross_cov=jnp.zeros((0, d, d), dtype),
                              logdet=logdet)

    # -- filter elements ---------------------------------------------------
    # k = 0: absorb the initial prior directly.
    P11 = jnp.linalg.inv(S0_inv + Pobs[0])
    e0 = _FilterElem(A=jnp.zeros((d, d), dtype), b=_mv(P11, eta[0]),
                     C=_sym(P11), eta=jnp.zeros((d,), dtype),
                     J=jnp.zeros((d, d), dtype))
    # k >= 1
    Lam = Q_inv[None] + Pobs[1:]                        # (T-1, d, d)
    chol = jnp.linalg.cholesky(Lam)
    Lam_inv = jax.scipy.linalg.cho_solve(
        (chol, True), jnp.broadcast_to(eye, Lam.shape))
    A = _mm(Lam_inv, QinvPhi[None])
    b = _mv(Lam_inv, eta[1:])
    C = _sym(Lam_inv)
    eta_el = _mv(jnp.swapaxes(A, -1, -2), eta[1:])
    J_el = _sym(PhiT_Qinv_Phi[None]
                - _mm(jnp.swapaxes(QinvPhi, -1, -2)[None],
                      _mm(Lam_inv, QinvPhi[None])))
    elems = _FilterElem(
        A=jnp.concatenate([e0.A[None], A]),
        b=jnp.concatenate([e0.b[None], b]),
        C=jnp.concatenate([e0.C[None], C]),
        eta=jnp.concatenate([e0.eta[None], eta_el]),
        J=jnp.concatenate([e0.J[None], J_el]))

    filt = jax.lax.associative_scan(_filter_combine, elems)
    m_f = filt.b                                       # (T, d)   m_t|t
    P_f = filt.C                                       # (T, d, d) P_t|t

    # -- smoothing gains + backward conditional moments (parallel in t) ----
    m_p = _mv(jnp.broadcast_to(Phi, (T - 1, d, d)), m_f[:-1])  # m_{t+1|t}
    P_p = _sym(_mm(_mm(Phi[None], P_f[:-1]),
                   jnp.swapaxes(Phi, -1, -2)[None]) + Q[None])
    # G_t = P_t|t Phi' P_{t+1|t}^-1  (solve from the symmetric side)
    G = jnp.swapaxes(jnp.linalg.solve(P_p, _mm(Phi[None], P_f[:-1])),
                     -1, -2)
    g = m_f[:-1] - _mv(G, m_p)
    L = _sym(P_f[:-1] - _mm(_mm(G, P_p), jnp.swapaxes(G, -1, -2)))

    selems = _SmoothElem(
        E=jnp.concatenate([G, jnp.zeros((1, d, d), dtype)]),
        g=jnp.concatenate([g, m_f[-1:]]),
        L=jnp.concatenate([L, P_f[-1:]]))
    sm = jax.lax.associative_scan(_smooth_combine, selems, reverse=True)
    mean = sm.g                                        # (T, d)
    cov = sm.L                                         # (T, d, d)
    cross = _mm(G, cov[1:])                            # Cov(x_t, x_{t+1})

    # logdet of the joint precision from the backward factorization:
    # det Cov_joint = det P_T|T * prod_t det L_t
    sign_T, ld_T = jnp.linalg.slogdet(P_f[-1])
    sign_L, ld_L = jnp.linalg.slogdet(L)
    logdet = -(ld_T + jnp.sum(ld_L))
    return SmootherResult(mean=mean, cov=cov, cross_cov=cross,
                          logdet=logdet)
