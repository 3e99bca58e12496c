"""Batched damped-CAVI engine for the temporal AME family.

One generic coordinate-ascent engine parameterized by a covariance-structure
policy replaces the reference's two near-duplicate classes
(``src/inference/naive_mf.py``, ``src/inference/structured_mf.py``):

* ``"diag"``  — naive mean field: mean solved with the *full* precision, but
  only ``1/diag(P)`` kept as variances (reference quirk, ``naive_mf.py:266-274``);
* ``"full"``  — "good" structured MF: full d x d covariance per factor
  (``structured_mf.py:266-279``);
* ``"block"`` — "bad" structured MF: invert, then zero the additive x
  multiplicative cross blocks (``structured_mf.py:267-273``).

Formulation
-----------
The reference's hottest loop builds, for every (i, j, t), a 2 x d Jacobian
``J = [e_a + V_j | e_b + U_j]`` and accumulates ``J' R^-1 J`` and
``J' R^-1 y`` (``naive_mf.py:324-374``) — O(n^2 T) Python iterations.  Because
J is affine in (U_j, V_j), the j-sums collapse into *global sufficient
statistics* per time step:

    with R^-1 = [[p, q], [q, p]]   (R is exchangeable, so p = R^-1[0,0]):

    P_obs[i,t] blocks:
        [a,a] = p (n-1)          [b,b] = p (n-1)      [a,b] = q (n-1)
        [a,U] = p (sV - V_i)     [a,V] = q (sU - U_i)
        [b,U] = q (sV - V_i)     [b,V] = p (sU - U_i)
        [U,U] = p (GVV - V_i V_i')    [V,V] = p (GUU - U_i U_i')
        [U,V] = q (GVU - V_i U_i')
    where sU = sum_j U_j, GUU = sum_j U_j U_j', GVU = sum_j V_j U_j'.

    eta_obs[i,t] = [ sum_j W0_ij,  sum_j W1_ij,  (W0 @ V)_i,  (W1 @ U)_i ]
    with W0 = p Y[...,0] + q Y[...,1] and W1 = q Y[...,0] + p Y[...,1].

W0/W1 and their row-sums depend only on the data — computed once per fit.
The per-iteration cost is two (n,n,T)x(n,T,r) matrix contractions, O(nT) d x d
assembly, and one batched d x d solve: O(n^2 T r) FLOPs instead of O(n^2 T)
interpreted Python.

Like the reference, the natural parameter omits the other-node offsets from
``y`` (acknowledged simplification at ``naive_mf.py:372-373``); this defines
the reference's fixed point and is reproduced for parity.

This engine is GAUSSIAN-ONLY by construction: the closed-form coordinate
updates above ARE the Gaussian conjugacy.  Other dyadic observation
families (``tame.models.likelihoods``: Poisson counts, Bernoulli ties)
go through the sampler backends (HMC/NUTS/SMC via
``make_logdensity_fn(family=...)``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array

from tame.models.params import AMEParams
from tame.ops import dyad as dyad_ops
from tame.ops.cholesky import (
    batched_logdet_spd,
    batched_spd_solve,
    batched_spd_solve_inv,
)
from tame.ops.dyad import HIGHEST

_LOG2PI = 1.8378770664093453  # log(2 * pi)


class ObsConstants(NamedTuple):
    """Data-dependent quantities that are constant across CAVI iterations."""

    W0: Array      # (n, n, T)  p*y_ij + q*y_ji
    W1: Array      # (n, n, T)  q*y_ij + p*y_ji
    eta_a: Array   # (n, T)     row-sums of W0
    eta_b: Array   # (n, T)     row-sums of W1


class PriorMatrices(NamedTuple):
    """Precomputed prior/transition matrices (all (d, d))."""

    Sigma0_inv: Array
    Q_inv: Array
    Qinv_Phi: Array        # Q^-1 Phi
    PhiT_Qinv_Phi: Array   # Phi' Q^-1 Phi
    logdet_Sigma0: Array
    logdet_Q: Array
    logdet_R: Array


class CaviState(NamedTuple):
    X_mean: Array  # (n, T, d)
    X_cov: Array   # (n, T, d, d)


def precompute_obs_constants(Y: Array, R_inv: Array,
                             w_dtype=None) -> ObsConstants:
    """Dyad weights and their row sums; constant across CAVI iterations.

    ``w_dtype=jnp.bfloat16`` stores the (n, n, T) weight tensors — the
    engine's dominant HBM traffic — in half precision; the row sums (and
    everything downstream) stay float32.
    """
    p, q = R_inv[0, 0], R_inv[0, 1]
    W0 = p * Y[..., 0] + q * Y[..., 1]
    W1 = q * Y[..., 0] + p * Y[..., 1]
    eta_a, eta_b = W0.sum(1), W1.sum(1)
    if w_dtype is not None:
        W0, W1 = W0.astype(w_dtype), W1.astype(w_dtype)
    return ObsConstants(W0=W0, W1=W1, eta_a=eta_a, eta_b=eta_b)


def _eta_contract(W: Array, Z: Array) -> Array:
    """The engine's dominant contraction ``einsum("ijt,jtr->itr")``.

    float32 weights are pinned to true float32 (``Precision.HIGHEST``): the
    GPU's default float32 matmul may run in TF32, whose 10-bit mantissa
    loses too much on these data-sized sums.  bfloat16 weights
    (mixed-precision mode) run one bf16 tensor-core pass with float32
    accumulation: half the HBM traffic, and the rounding enters only
    through the *stored* weights, bounded by bf16's ~0.4 % relative error
    on the data.
    """
    if W.dtype == jnp.bfloat16:
        return jnp.einsum("ijt,jtr->itr", W, Z.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    return jnp.einsum("ijt,jtr->itr", W, Z,
                      preferred_element_type=jnp.float32, precision=HIGHEST)


def precompute_priors(params: AMEParams) -> PriorMatrices:
    Q_inv = jnp.linalg.inv(params.Q)
    Sigma0_inv = jnp.linalg.inv(params.Sigma0)
    return PriorMatrices(
        Sigma0_inv=Sigma0_inv,
        Q_inv=Q_inv,
        Qinv_Phi=Q_inv @ params.Phi,
        PhiT_Qinv_Phi=params.Phi.T @ Q_inv @ params.Phi,
        logdet_Sigma0=jnp.linalg.slogdet(params.Sigma0)[1],
        logdet_Q=jnp.linalg.slogdet(params.Q)[1],
        logdet_R=jnp.linalg.slogdet(params.R)[1],
    )


class DiagConstants(NamedTuple):
    """Data statistics for the sufficient-statistics diagnostics path."""

    sum_y0_sq: Array    # scalar  sum_{ij,t} y0^2       (diag(Y) = 0)
    sum_y0_y0T: Array   # scalar  sum_{ij,t} y0_ij y0_ji
    row_y0: Array       # (n, T)  sum_j y0_ij
    col_y0: Array       # (n, T)  sum_i y0_ij


def precompute_diag_constants(Y: Array) -> DiagConstants:
    y0 = Y[..., 0]
    return DiagConstants(
        sum_y0_sq=jnp.sum(y0 * y0),
        sum_y0_y0T=jnp.einsum("ijt,jit->", y0, y0,
                              preferred_element_type=jnp.float32,
                              precision=HIGHEST),
        row_y0=y0.sum(1),
        col_y0=y0.sum(0),
    )


def _data_mean_cross_terms(obs: ObsConstants, U: Array, V: Array,
                           R_inv: Array) -> Tuple[Array, Array]:
    """Data-mean cross terms ``A = sum y0_ij u_ij``,
    ``B = sum y0_ij u_ji`` (``u_ij = U_i . V_j``) from ONE pass over W0.

    Reciprocity makes ``W1 = W0'`` (``W1[i,j] = q y0_ij + p y0_ji =
    W0[j,i]``), so the second scalar of the 2x2 recovery system

        s1 = sum_i U_i . (W0 V)_i = p A + q B
        s3 = sum_i U_i . (W1 V)_i = sum_i V_i . (W0 U)_i = q A + p B

    rides the SAME W0 contraction with the panel ``[V | U]`` — one
    observation-sized pass instead of two (or instead of the padded-copy
    dual-contraction kernel this replaced).  p^2 != q^2 whenever R is PD
    with |rho_dyadic| < 1.
    """
    p, q = R_inv[0, 0], R_inv[0, 1]
    r = U.shape[-1]
    out = _eta_contract(obs.W0, jnp.concatenate([V, U], axis=-1))
    s1 = jnp.sum(U * out[..., :r])
    s3 = jnp.sum(V * out[..., r:])
    denom = p * p - q * q
    A = (p * s1 - q * s3) / denom
    B = (p * s3 - q * s1) / denom
    return A, B


def _residual_stats_from_moments(dc: DiagConstants, obs: ObsConstants,
                                 X_mean: Array, r: int, R_inv: Array
                                 ) -> Tuple[Array, Array]:
    """Dyadic residual statistics WITHOUT any O(n^2 T) pass.

    Expands ``sum e0^2`` and ``sum e0_ij e0_ji`` (``e0 = y0 - m``,
    ``m_ij = a_i + b_j + U_i.V_j``) into data constants plus global moments
    of the variational means.  The only O(n^2 T r) work is ONE contraction
    pass over ``W0`` (see :func:`_data_mean_cross_terms`), from which the
    data-mean cross terms ``A = sum y0_ij u_ij`` and
    ``B = sum y0_ij u_ji`` are recovered.  Everything else is
    O(n T (r^2 + 1)) elementwise work — the diagnostics pass costs ~one
    eta-class matmul instead of reading observation-sized tensors.

    Returns ``(sum_offdiag e0^2, sum_offdiag e0_ij e0_ji)`` — the same
    statistics as :func:`tame.ops.dyad.residual_stats_from_fwd` up to
    summation order.
    """
    a, b, U, V = dyad_ops.split_state(X_mean, r)          # (n,T), (n,T,r)
    A, B = _data_mean_cross_terms(obs, U, V, R_inv)

    # -- per-time global moments (all O(n T r^2)) ---------------------------
    alpha = a.sum(0)                                      # (T,)
    beta = b.sum(0)
    Sa2 = jnp.sum(a * a, 0)
    Sb2 = jnp.sum(b * b, 0)
    Sab = jnp.sum(a * b, 0)
    sU = U.sum(0)                                         # (T, r)
    sV = V.sum(0)
    wU = jnp.einsum("it,itr->tr", a, U, precision=HIGHEST)
    wV = jnp.einsum("it,itr->tr", a, V, precision=HIGHEST)
    zU = jnp.einsum("it,itr->tr", b, U, precision=HIGHEST)
    zV = jnp.einsum("it,itr->tr", b, V, precision=HIGHEST)
    GUU = jnp.einsum("itk,itl->tkl", U, U,
                     preferred_element_type=jnp.float32, precision=HIGHEST)
    GVV = jnp.einsum("itk,itl->tkl", V, V,
                     preferred_element_type=jnp.float32, precision=HIGHEST)
    GVU = jnp.einsum("itk,itl->tkl", V, U,
                     preferred_element_type=jnp.float32, precision=HIGHEST)

    n = a.shape[0]
    u_ii = jnp.sum(U * V, -1)                             # (n, T)
    m_ii = a + b + u_ii
    Smii2 = jnp.sum(m_ii * m_ii)

    # sum_ij m_ij^2 (full) = sum (a_i+b_j)^2 + 2 sum (a_i+b_j) u_ij + sum u^2
    sum_ab_sq = jnp.sum(n * (Sa2 + Sb2) + 2.0 * alpha * beta)
    cross_m = jnp.sum(wU * sV) + jnp.sum(zV * sU)         # sum (a_i+b_j) u_ij
    Su2 = jnp.einsum("tkl,tkl->", GUU, GVV, precision=HIGHEST)
    sum_m_sq = sum_ab_sq + 2.0 * cross_m + Su2 - Smii2

    # sum_ij m_ij m_ji (full)
    sum_ab_cross = jnp.sum(alpha * alpha + beta * beta + 2.0 * n * Sab)
    cross_mT = jnp.sum(wV * sU) + jnp.sum(zU * sV)        # sum (a_i+b_j) u_ji
    SuuT = jnp.einsum("tkl,tlk->", GVU, GVU, precision=HIGHEST)
    sum_m_mT = sum_ab_cross + 2.0 * cross_mT + SuuT - Smii2

    # data x additive terms from the precomputed row/col sums
    y_ab = jnp.sum(a * dc.row_y0) + jnp.sum(b * dc.col_y0)
    y_abT = jnp.sum(a * dc.col_y0) + jnp.sum(b * dc.row_y0)

    sq = dc.sum_y0_sq - 2.0 * (y_ab + A) + sum_m_sq
    cross = dc.sum_y0_y0T - 2.0 * (y_abT + B) + sum_m_mT
    return sq, cross


def _masked_residual_stats(dc: DiagConstants, obs: ObsConstants,
                           X_mean: Array, r: int, R_inv: Array,
                           mask: Array) -> Tuple[Array, Array]:
    """Masked analog of :func:`_residual_stats_from_moments`: dyadic
    residual statistics over OBSERVED dyads without any O(n^2 T) read of
    observation-sized float tensors.

    With ``Y`` zeroed at masked entries (the fit invariant), the data-side
    constants (``sum_y0_sq``, ``row_y0``, ...) and the A/B data-mean cross
    terms are automatically restricted to observed dyads — identical to
    the dense expansion.  Only the model-side moments change: the mask is
    not rank-one, so ``sum_obs m_ij^2`` / ``sum_obs m_ij m_ji`` cannot
    collapse into global moments.  But every term is bilinear in per-node
    features, so both reduce to ONE eta-class contraction of the mask
    against a (4 + 5r + 2r^2)-column feature panel:

        sum_j M_ij f(i) . g(j)  =  f(i) . (M g)_i

    summed over (i, t).  Cost: one (n, n, T) mask pass — the same HBM
    class as a single dyad-weight contraction — vs the O(n^2 T)
    elementwise residual pass of ``diag_mode='exact'``.  No reference
    counterpart (complete networks only, ``naive_mf.py:324-374``).

    CONTRACT: ``mask`` must be SYMMETRIC (``fit_cavi`` docstring — both
    directions of an unordered dyad live in one ``Y[i, j, t]`` entry and
    are observed together).  The cross-term re-summation here (the
    ``2 a b cnt`` expansion and ``y_abT``) exploits that symmetry; an
    asymmetric mask would silently skew these stats-mode diagnostics
    while the update path still ran.
    """
    a, b, U, V = dyad_ops.split_state(X_mean, r)          # (n,T), (n,T,r)
    n, T = a.shape

    # -- data-mean cross terms: same single-pass recovery as dense ---------
    A, B = _data_mean_cross_terms(obs, U, V, R_inv)
    y_ab = jnp.sum(a * dc.row_y0) + jnp.sum(b * dc.col_y0)
    y_abT = jnp.sum(a * dc.col_y0) + jnp.sum(b * dc.row_y0)

    # -- masked partner statistics: one contraction, K columns -------------
    VV = (V[..., :, None] * V[..., None, :]).reshape(n, T, r * r)
    OVU = (V[..., :, None] * U[..., None, :]).reshape(n, T, r * r)
    Z = jnp.concatenate([
        jnp.ones_like(a)[..., None], a[..., None], b[..., None],
        (b * b)[..., None],
        U, V, a[..., None] * V, b[..., None] * V, b[..., None] * U,
        VV, OVU], axis=-1)                                # (n, T, K)
    C = _eta_contract(mask, Z)                           # (m g)_i panels
    cnt, Ma, Mb, Mb2 = C[..., 0], C[..., 1], C[..., 2], C[..., 3]
    o = 4
    MU = C[..., o:o + r]
    MV = C[..., o + r:o + 2 * r]
    MaV = C[..., o + 2 * r:o + 3 * r]
    MbV = C[..., o + 3 * r:o + 4 * r]
    MbU = C[..., o + 4 * r:o + 5 * r]
    o += 5 * r
    MVV = C[..., o:o + r * r]
    MOVU = C[..., o + r * r:]

    UUo = (U[..., :, None] * U[..., None, :]).reshape(n, T, r * r)
    OUV = (U[..., :, None] * V[..., None, :]).reshape(n, T, r * r)
    U_MV = jnp.sum(U * MV, -1)                            # (n, T)

    # sum_obs m_ij^2: per-i expansion of (a_i + b_j + U_i.V_j)^2
    sum_m_sq = jnp.sum(a * a * cnt + 2.0 * a * Mb + Mb2
                       + 2.0 * a * U_MV
                       + 2.0 * jnp.sum(U * MbV, -1)
                       + jnp.sum(UUo * MVV, -1))
    # sum_obs m_ij m_ji: nine bilinear terms (M symmetric: the b_j a_j
    # term re-sums to a.b counts, doubling the a_i b_i term)
    sum_m_mT = jnp.sum(a * Ma + 2.0 * a * b * cnt + b * Mb
                       + a * jnp.sum(V * MU, -1)
                       + jnp.sum(V * MbU, -1)
                       + jnp.sum(U * MaV, -1)
                       + b * U_MV
                       + jnp.sum(OUV * MOVU, -1))

    sq = dc.sum_y0_sq - 2.0 * (y_ab + A) + sum_m_sq
    cross = dc.sum_y0_y0T - 2.0 * (y_abT + B) + sum_m_mT
    return sq, cross


# ---------------------------------------------------------------------------
# Observation-term assembly (all nodes & times at once)
# ---------------------------------------------------------------------------

def _obs_precision(U: Array, V: Array, R_inv: Array) -> Array:
    """Observation precision ``sum_{j != i} J' R^-1 J`` for every (i, t).

    Parameters
    ----------
    U, V : (n, T, r) current variational means of the latent positions.

    Returns
    -------
    P_obs : (n, T, d, d)
    """
    n, T, r = U.shape
    c = jnp.asarray(n - 1, U.dtype)

    # Global sums over j, then subtract node i's own contribution.
    sU = U.sum(0)[None] - U                                   # (n, T, r)
    sV = V.sum(0)[None] - V
    GUU = jnp.einsum("jtk,jtl->tkl", U, U,
                     preferred_element_type=jnp.float32, precision=HIGHEST)[None] \
        - U[..., :, None] * U[..., None, :]                   # (n, T, r, r)
    GVV = jnp.einsum("jtk,jtl->tkl", V, V,
                     preferred_element_type=jnp.float32, precision=HIGHEST)[None] \
        - V[..., :, None] * V[..., None, :]
    GVU = jnp.einsum("jtk,jtl->tkl", V, U,
                     preferred_element_type=jnp.float32, precision=HIGHEST)[None] \
        - V[..., :, None] * U[..., None, :]
    return _P_from_partner_stats(c, sU, sV, GUU, GVV, GVU, R_inv)


def block_mask_contract(Mr: Array, b, Z: Array) -> Array:
    """Contract block ``b``'s mask rows ``Mr[b]`` (``(bs, n, T)``) against
    a feature panel ``Z`` (``(n, T, K)``).  Shared by the CAVI and
    smoothed block steps."""
    Mb = jax.lax.dynamic_index_in_dim(Mr, b, 0, keepdims=False)
    return _eta_contract(Mb, Z)


def _masked_panel(U: Array, V: Array) -> Array:
    """The (n, T, 1 + 2r + 3r^2) feature panel whose masked partner sums
    assemble the observation precision: ones (counts), U, V, and the
    outer-product columns UU / VV / VU.  ONE concatenated contraction:
    XLA does not merge separate dots over the same operand, so issuing
    counts/sums/Grams as six einsums would read the (m, n, T) mask six
    times — the mask pass, not the panel width, is the cost at scale."""
    n, T, r = U.shape
    UU = (U[..., :, None] * U[..., None, :]).reshape(n, T, r * r)
    VV = (V[..., :, None] * V[..., None, :]).reshape(n, T, r * r)
    VU = (V[..., :, None] * U[..., None, :]).reshape(n, T, r * r)
    ones = jnp.ones((n, T, 1), U.dtype)
    return jnp.concatenate([ones, U, V, UU, VV, VU], axis=-1)


def _P_from_partner_stats(cnt, sU, sV, GUU, GVV, GVU,
                          R_inv: Array) -> Array:
    """Assemble the observation precision from partner statistics
    (counts, partner sums, partner Grams) — the ONE place the d x d slot
    layout lives.  Shared by the dense global-stats paths
    (:func:`_obs_precision`, the block steps) and the masked panel path
    (:func:`_masked_P_from_C`); ``cnt`` may be a scalar (complete
    network: n - 1) or per-(row, time)."""
    m, T, r = sU.shape
    d = 2 + 2 * r
    p, q = R_inv[0, 0], R_inv[0, 1]
    P = jnp.zeros((m, T, d, d), sU.dtype)
    P = P.at[..., 0, 0].set(p * cnt).at[..., 1, 1].set(p * cnt)
    P = P.at[..., 0, 1].set(q * cnt).at[..., 1, 0].set(q * cnt)
    P = P.at[..., 0, 2:2 + r].set(p * sV).at[..., 2:2 + r, 0].set(p * sV)
    P = P.at[..., 0, 2 + r:].set(q * sU).at[..., 2 + r:, 0].set(q * sU)
    P = P.at[..., 1, 2:2 + r].set(q * sV).at[..., 2:2 + r, 1].set(q * sV)
    P = P.at[..., 1, 2 + r:].set(p * sU).at[..., 2 + r:, 1].set(p * sU)
    P = P.at[..., 2:2 + r, 2:2 + r].set(p * GVV)
    P = P.at[..., 2 + r:, 2 + r:].set(p * GUU)
    P = P.at[..., 2:2 + r, 2 + r:].set(q * GVU)
    P = P.at[..., 2 + r:, 2:2 + r].set(q * jnp.swapaxes(GVU, -1, -2))
    return P


def _masked_P_from_C(C: Array, R_inv: Array, r: int) -> Array:
    """Assemble the masked observation precision from the contracted
    panel ``C = mask @ _masked_panel(U, V)``; see
    :func:`_masked_obs_precision`."""
    m, T = C.shape[:2]
    cnt = C[..., 0]                                          # (m, T)
    sU = C[..., 1:1 + r]                                     # (m, T, r)
    sV = C[..., 1 + r:1 + 2 * r]
    o = 1 + 2 * r
    GUU = C[..., o:o + r * r].reshape(m, T, r, r)
    GVV = C[..., o + r * r:o + 2 * r * r].reshape(m, T, r, r)
    GVU = C[..., o + 2 * r * r:].reshape(m, T, r, r)
    return _P_from_partner_stats(cnt, sU, sV, GUU, GVV, GVU, R_inv)


def _masked_obs_precision(Mr, U: Array, V: Array, R_inv: Array) -> Array:
    """Observation precision ``sum_{j observed} J' R^-1 J`` under a dyad
    mask, for a row-slice of nodes.

    The complete-network assembly (:func:`_obs_precision`) collapses the
    j-sums into GLOBAL statistics minus the self term; with missing dyads
    the sums become per-node masked contractions: counts, masked partner
    sums, and masked partner Grams — one concatenated-panel contraction
    (:func:`_masked_panel`).  No reference counterpart: the reference
    supports complete networks only.

    Parameters
    ----------
    Mr : (m, n, T) mask rows (1 = observed; diag 0).
    U, V : (n, T, r) current variational means.

    Returns
    -------
    P_obs : (m, T, d, d)
    """
    C = _eta_contract(Mr, _masked_panel(U, V))
    return _masked_P_from_C(C, R_inv, U.shape[-1])


def _obs_nat_param(obs: ObsConstants, X_mean: Array, r: int,
                   R_inv: Array, corrected: bool,
                   mask: Optional[Array] = None) -> Array:
    """Observation natural parameter for every (i, t): (n, T, d).

    The U/V slots are matrix contractions of the constant dyad weights against
    the current means; diagonal terms vanish because Y[i,i] = 0.

    ``corrected=False`` reproduces the reference's acknowledged
    simplification (``naive_mf.py:372-373``): eta uses the raw ``y`` without
    subtracting the other node's additive offsets, which biases the fixed
    point (final demo-config MSE ~0.47, matching the measured reference).
    ``corrected=True`` subtracts the offsets ``o_j = [b_j, a_j]`` —
    in sufficient-statistics form, with c_j = p b_j + q a_j and
    d_j = q b_j + p a_j:

        eta_a[i] -= sum_{j!=i} c_j           eta_U[i] -= sum_{j!=i} c_j V_j
        eta_b[i] -= sum_{j!=i} d_j           eta_V[i] -= sum_{j!=i} d_j U_j

    — the exact CAVI coordinate update, converging to a better optimum.
    """
    a, b, U, V = dyad_ops.split_state(X_mean, r)
    eta_a, eta_b = obs.eta_a, obs.eta_b
    etaU = _eta_contract(obs.W0, V)
    etaV = _eta_contract(obs.W1, U)
    if corrected:
        p, q = R_inv[0, 0], R_inv[0, 1]
        c = p * b + q * a                                   # (n, T)
        dd = q * b + p * a
        if mask is not None:
            # Missing dyads: offset sums run over observed partners only
            # — one concatenated-panel mask pass (cf.
            # _masked_obs_precision).
            C = _eta_contract(mask, jnp.concatenate(
                [c[..., None], dd[..., None], c[..., None] * V,
                 dd[..., None] * U], axis=-1))
            r_ = V.shape[-1]
            eta_a = eta_a - C[..., 0]
            eta_b = eta_b - C[..., 1]
            etaU = etaU - C[..., 2:2 + r_]
            etaV = etaV - C[..., 2 + r_:]
        else:
            eta_a = eta_a - (c.sum(0)[None] - c)
            eta_b = eta_b - (dd.sum(0)[None] - dd)
            cV = jnp.einsum("jt,jtr->tr", c, V,
                            precision=HIGHEST)[None] - c[..., None] * V
            dU = jnp.einsum("jt,jtr->tr", dd, U,
                            precision=HIGHEST)[None] - dd[..., None] * U
            etaU = etaU - cV
            etaV = etaV - dU
    return jnp.concatenate(
        [eta_a[..., None], eta_b[..., None], etaU, etaV], axis=-1)


def _prior_precision(pri: PriorMatrices, T: int) -> Array:
    """Time-indexed prior precision terms: (T, d, d).

    t = 0 gets the initial-state prior; t > 0 the backward transition Q^-1;
    t < T-1 the forward coupling Phi' Q^-1 Phi (reference
    ``naive_mf.py:245-264``).
    """
    t = jnp.arange(T)
    is0 = (t == 0)[:, None, None]
    has_prev = (t > 0)[:, None, None]
    has_next = (t < T - 1)[:, None, None]
    return (is0 * pri.Sigma0_inv + has_prev * pri.Q_inv
            + has_next * pri.PhiT_Qinv_Phi)


def _prior_nat_param(pri: PriorMatrices, X_mean: Array) -> Array:
    """Neighbor-mean coupling terms of the natural parameter: (n, T, d)."""
    n, T, d = X_mean.shape
    t = jnp.arange(T)
    has_prev = (t > 0)[None, :, None]
    has_next = (t < T - 1)[None, :, None]
    mu_prev = jnp.pad(X_mean[:, :-1], ((0, 0), (1, 0), (0, 0)))
    mu_next = jnp.pad(X_mean[:, 1:], ((0, 0), (0, 1), (0, 0)))
    # Q^-1 Phi mu_prev  and  Phi' Q^-1 mu_next  (batched as v @ A')
    eta_prev = jnp.matmul(mu_prev, pri.Qinv_Phi.T, precision=HIGHEST)
    eta_next = jnp.matmul(mu_next, pri.Qinv_Phi, precision=HIGHEST)  # (Phi' Q^-1)' = Q^-1 Phi
    return has_prev * eta_prev + has_next * eta_next


# ---------------------------------------------------------------------------
# Structure policies
# ---------------------------------------------------------------------------

def _solve_diag(P: Array, eta: Array) -> Tuple[Array, Array]:
    """Naive-MF policy: full-precision mean solve, diagonal variances
    ``1 / (diag(P) + 1e-8)`` (reference ``naive_mf.py:266-274``)."""
    mu = batched_spd_solve(P, eta)
    var = 1.0 / (jnp.diagonal(P, axis1=-2, axis2=-1) + 1e-8)
    cov = var[..., None] * jnp.eye(P.shape[-1], dtype=P.dtype)
    return mu, cov


def _finalize_cov(cov: Array) -> Array:
    """Symmetrize + jitter (reference ``structured_mf.py:276-277``)."""
    cov = 0.5 * (cov + jnp.swapaxes(cov, -1, -2))
    return cov + 1e-6 * jnp.eye(cov.shape[-1], dtype=cov.dtype)


def _solve_full(P: Array, eta: Array) -> Tuple[Array, Array]:
    """Good-SMF policy: Sigma = P^-1, mean from the *projected* covariance
    (reference ``structured_mf.py:266-279``)."""
    _, cov_raw = batched_spd_solve_inv(P, eta)
    cov = _finalize_cov(cov_raw)
    mu = jnp.matmul(cov, eta[..., None], precision=HIGHEST)[..., 0]
    return mu, cov


def _solve_block(P: Array, eta: Array) -> Tuple[Array, Array]:
    """Bad-SMF policy: invert, zero additive x multiplicative cross blocks
    *post-inversion*, then symmetrize/jitter and take the mean from the
    truncated covariance (reference ``structured_mf.py:267-279``)."""
    _, cov_raw = batched_spd_solve_inv(P, eta)
    d = P.shape[-1]
    mask = jnp.zeros((d, d), dtype=bool)
    mask = mask.at[:2, 2:].set(True).at[2:, :2].set(True)
    cov = jnp.where(mask, 0.0, cov_raw)
    cov = _finalize_cov(cov)
    mu = jnp.matmul(cov, eta[..., None], precision=HIGHEST)[..., 0]
    return mu, cov


_SOLVERS = {"diag": _solve_diag, "full": _solve_full, "block": _solve_block}


# ---------------------------------------------------------------------------
# ELBO
# ---------------------------------------------------------------------------

def compute_elbo(Y: Array, params: AMEParams, pri: PriorMatrices,
                 state: CaviState, structure: str,
                 mu_dyadic: Array | None = None,
                 obs_mask: Array | None = None) -> Array:
    """ELBO with the reference's exact term structure.

    * expected log-likelihood is a plug-in at the means
      (``naive_mf.py:114-132``); for the structured policies it adds the
      heuristic ``0.1 (tr S_i + tr S_j) tr(R^-1) / d`` correction
      (``structured_mf.py:141-148``) — ELBOs are therefore *not* comparable
      across structures, as in the reference;
    * Gaussian initial/transition priors with trace terms
      (``naive_mf.py:134-182``);
    * Gaussian entropy (``naive_mf.py:184-191``).
    """
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    if obs_mask is None:
        m = dyad_ops.offdiag_mask(n)[:, :, None]
        mask_stats = None
    else:
        # Zero the mask diagonal defensively (cf. fit_cavi) and sanitize Y
        # BEFORE the residual: NaN-coded missing entries — the common
        # real-data encoding and the repo invariant — must never be read,
        # and 0 * NaN = NaN would poison the quad sum through a bare
        # mask multiplication.
        m = obs_mask * (1.0 - jnp.eye(n, dtype=obs_mask.dtype)[:, :, None])
        Y = jnp.where(m[..., None] > 0, Y, 0.0)
        mask_stats = (0.5 * jnp.sum(m), m.astype(jnp.float32).sum(1))
    if mu_dyadic is None:
        mu_dyadic = dyad_ops.dyadic_mean_temporal(state.X_mean, r)

    # -- expected log likelihood (sum over unordered dyads i < j and t) ----
    # R is exchangeable, so the quad form collapses to
    # p (e0^2 + e1^2) + 2 q e0 e1 — pure elementwise work XLA fuses with
    # the residual computation (no (n,n,T,2,2) contraction machinery).
    resid = Y - mu_dyadic
    p_, q_ = params.R_inv[0, 0], params.R_inv[0, 1]
    e0, e1 = resid[..., 0], resid[..., 1]
    quad = p_ * (e0 * e0 + e1 * e1) + 2.0 * q_ * (e0 * e1)
    quad_sum = 0.5 * jnp.sum(quad * m)  # i<j sum = half the off-diag sum
    return _elbo_from_quad(quad_sum, params, pri, state, structure,
                           mask_stats=mask_stats)


def state_prior_terms(params: AMEParams, pri: PriorMatrices,
                      state: CaviState) -> Tuple[Array, Array]:
    """Expected initial-state and transition log-prior terms of the
    ELBO, ``(prior0, priort)`` — shared by the Gaussian and the
    bound-based (binary) engines; see :func:`_elbo_from_quad`."""
    n, T, d = state.X_mean.shape
    mu0 = state.X_mean[:, 0]
    quad0 = jnp.einsum("ia,ab,ib->i", mu0, pri.Sigma0_inv, mu0,
                       preferred_element_type=jnp.float32, precision=HIGHEST)
    trace0 = jnp.einsum("ab,iba->i", pri.Sigma0_inv, state.X_cov[:, 0],
                        preferred_element_type=jnp.float32, precision=HIGHEST)
    prior0 = -0.5 * jnp.sum(quad0 + trace0
                            + pri.logdet_Sigma0 + d * _LOG2PI)

    if T > 1:
        residt = state.X_mean[:, 1:] - jnp.matmul(
            state.X_mean[:, :-1], params.Phi.T, precision=HIGHEST)
        quadt = jnp.einsum("ita,ab,itb->it", residt, pri.Q_inv, residt,
                           preferred_element_type=jnp.float32,
                           precision=HIGHEST)
        tracet = jnp.einsum("ab,itba->it", pri.Q_inv, state.X_cov[:, 1:],
                            preferred_element_type=jnp.float32,
                            precision=HIGHEST)
        priort = -0.5 * jnp.sum(quadt + tracet
                                + pri.logdet_Q + d * _LOG2PI)
    else:
        priort = jnp.asarray(0.0, state.X_mean.dtype)
    return prior0, priort


def gaussian_entropy(state: CaviState) -> Array:
    """Entropy of the per-(node, time) Gaussian factors."""
    d = state.X_mean.shape[-1]
    logdets = batched_logdet_spd(state.X_cov)                  # (n, T)
    return 0.5 * jnp.sum(logdets + d * (1.0 + _LOG2PI))


def _elbo_from_quad(quad_sum: Array, params: AMEParams, pri: PriorMatrices,
                    state: CaviState, structure: str,
                    mask_stats=None) -> Array:
    """ELBO given the precomputed likelihood quadratic form
    ``sum_{i<j,t} resid' R^-1 resid``; all remaining terms depend only on
    the variational state.

    ``mask_stats`` (missing-data fits): ``(n_obs_dyads, cnt)`` with the
    number of observed unordered dyad-times and the per-(node, time)
    observed-partner counts ``(n, T)`` — the likelihood normalization and
    the structured trace correction then run over observed dyads only.
    """
    n, T, d = state.X_mean.shape
    if mask_stats is None:
        n_dyads = n * (n - 1) // 2 * T
    else:
        n_dyads = mask_stats[0]
    log_lik = -0.5 * (quad_sum + n_dyads * (pri.logdet_R + 2.0 * _LOG2PI))

    tr_cov = jnp.trace(state.X_cov, axis1=-2, axis2=-1)        # (n, T)
    if structure in ("full", "block"):
        # sum_{i<j observed} (tr S_i + tr S_j) = sum_i cnt_i tr S_i
        wsum = (jnp.sum(mask_stats[1] * tr_cov) if mask_stats is not None
                else (n - 1) * jnp.sum(tr_cov))
        corr = 0.1 * jnp.trace(params.R_inv) / d * wsum
        log_lik = log_lik - 0.5 * corr

    prior0, priort = state_prior_terms(params, pri, state)

    # -- entropy -----------------------------------------------------------
    logdets = batched_logdet_spd(state.X_cov)                      # (n, T)
    entropy = 0.5 * jnp.sum(logdets + d * (1.0 + _LOG2PI))

    return log_lik + prior0 + priort + entropy


# ---------------------------------------------------------------------------
# One CAVI step
# ---------------------------------------------------------------------------

def cavi_step_jacobi(state: CaviState, obs: ObsConstants, pri: PriorMatrices,
                     params: AMEParams, structure: str, lr: Array,
                     corrected: bool = False,
                     mask: Optional[Array] = None) -> CaviState:
    """Simultaneous (Jacobi) update of every q(X_i^t) factor.

    All factors read the previous iterate; same fixed points as the
    reference's Gauss-Seidel sweep under the damped update
    ``new = lr * closed_form + (1 - lr) * old`` (``naive_mf.py:277-281``).

    ``mask`` (n, n, T; symmetric, zero diagonal) restricts the observation
    terms to observed dyads — missing-data support beyond the reference
    (its loops assume a complete network, ``naive_mf.py:324-374``).  The
    dyad weights in ``obs`` must have been masked at precompute time.
    """
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    _, _, U, V = dyad_ops.split_state(state.X_mean, r)

    if mask is None:
        P_obs = _obs_precision(U, V, params.R_inv)
    else:
        P_obs = _masked_obs_precision(mask, U, V, params.R_inv)
    P = P_obs + _prior_precision(pri, T)[None]
    eta = (_obs_nat_param(obs, state.X_mean, r, params.R_inv, corrected,
                          mask=mask)
           + _prior_nat_param(pri, state.X_mean))

    mu_new, cov_new = _SOLVERS[structure](P, eta)
    X_mean = lr * mu_new + (1.0 - lr) * state.X_mean
    X_cov = lr * cov_new + (1.0 - lr) * state.X_cov
    return CaviState(X_mean=X_mean, X_cov=X_cov)


def cavi_step_block(state: CaviState, obs: ObsConstants,
                    pri: PriorMatrices, params: AMEParams, structure: str,
                    lr: Array, num_blocks: int,
                    corrected: bool = False,
                    mask: Optional[Array] = None) -> CaviState:
    """Block Gauss-Seidel: nodes split into ``num_blocks`` groups updated in
    sequence, each group reading the freshest global state; all (node, time)
    factors within a group update simultaneously.

    Rationale: pure Jacobi's effective spectral radius grows with the node
    coupling (every node moves against every other's stale mean), forcing
    damping lr = O(1/n) at scale; a handful of sequential blocks restores
    near-Gauss-Seidel stability while keeping (n / num_blocks) * T parallel
    factor updates per phase — ample device parallelism at production
    sizes.  Total FLOPs per sweep match Jacobi (each W-row contraction
    happens once).
    """
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    if n % num_blocks != 0:
        raise ValueError(f"num_blocks={num_blocks} must divide n={n}")
    bs = n // num_blocks
    solver = _SOLVERS[structure]
    prior_P = _prior_precision(pri, T)[None]                   # (1, T, d, d)
    p, q = params.R_inv[0, 0], params.R_inv[0, 1]
    c = jnp.asarray(n - 1, state.X_mean.dtype)

    # Static reshape of the dyad weights to expose the block axis: rows of
    # block b are W0r[b] with shape (bs, n, T).
    W0r = obs.W0.reshape(num_blocks, bs, n, T)
    W1r = obs.W1.reshape(num_blocks, bs, n, T)
    eta_ar = obs.eta_a.reshape(num_blocks, bs, T)
    eta_br = obs.eta_b.reshape(num_blocks, bs, T)
    Mr = None if mask is None else mask.reshape(num_blocks, bs, n, T)

    def update_block(b, carry):
        X_mean, X_cov = carry
        _, _, U, V = dyad_ops.split_state(X_mean, r)           # (n, T, r)

        start = b * bs
        Ub = jax.lax.dynamic_slice_in_dim(U, start, bs, 0)     # (bs, T, r)
        Vb = jax.lax.dynamic_slice_in_dim(V, start, bs, 0)

        if Mr is not None:
            C = block_mask_contract(Mr, b, _masked_panel(U, V))
            P = _masked_P_from_C(C, params.R_inv, r) + prior_P
        else:
            # Fresh global sufficient statistics (cheap: O(n T r^2)).
            sU_all = U.sum(0)                                  # (T, r)
            sV_all = V.sum(0)
            GUU_all = jnp.einsum("jtk,jtl->tkl", U, U,
                                 preferred_element_type=jnp.float32,
                                 precision=HIGHEST)
            GVV_all = jnp.einsum("jtk,jtl->tkl", V, V,
                                 preferred_element_type=jnp.float32,
                                 precision=HIGHEST)
            GVU_all = jnp.einsum("jtk,jtl->tkl", V, U,
                                 preferred_element_type=jnp.float32,
                                 precision=HIGHEST)

            sU = sU_all[None] - Ub
            sV = sV_all[None] - Vb
            GUU = GUU_all[None] - Ub[..., :, None] * Ub[..., None, :]
            GVV = GVV_all[None] - Vb[..., :, None] * Vb[..., None, :]
            GVU = GVU_all[None] - Vb[..., :, None] * Ub[..., None, :]
            P = _P_from_partner_stats(c, sU, sV, GUU, GVV, GVU,
                                      params.R_inv) + prior_P

        W0b = jax.lax.dynamic_index_in_dim(W0r, b, 0, keepdims=False)
        W1b = jax.lax.dynamic_index_in_dim(W1r, b, 0, keepdims=False)
        etaU = _eta_contract(W0b, V)
        etaV = _eta_contract(W1b, U)
        eta_a_b = jax.lax.dynamic_index_in_dim(eta_ar, b, 0, False)
        eta_b_b = jax.lax.dynamic_index_in_dim(eta_br, b, 0, False)
        if corrected:
            a_all = X_mean[..., 0]                         # (n, T)
            b_all = X_mean[..., 1]
            cc = p * b_all + q * a_all
            ddc = q * b_all + p * a_all
            if Mr is not None:
                # one mask pass (cf. _masked_obs_precision)
                Cc = block_mask_contract(Mr, b, jnp.concatenate(
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
        eta = jnp.concatenate(
            [eta_a_b[..., None], eta_b_b[..., None], etaU, etaV], axis=-1)
        eta = eta + jax.lax.dynamic_slice_in_dim(
            _prior_nat_param(pri, X_mean), start, bs, 0)

        mu_new, cov_new = solver(P, eta)
        mu_old = jax.lax.dynamic_slice_in_dim(X_mean, start, bs, 0)
        cov_old = jax.lax.dynamic_slice_in_dim(X_cov, start, bs, 0)
        X_mean = jax.lax.dynamic_update_slice_in_dim(
            X_mean, lr * mu_new + (1.0 - lr) * mu_old, start, 0)
        X_cov = jax.lax.dynamic_update_slice_in_dim(
            X_cov, lr * cov_new + (1.0 - lr) * cov_old, start, 0)
        return X_mean, X_cov

    X_mean, X_cov = jax.lax.fori_loop(0, num_blocks, update_block,
                                      (state.X_mean, state.X_cov))
    return CaviState(X_mean=X_mean, X_cov=X_cov)


def cavi_step_seq(state: CaviState, obs: ObsConstants, pri: PriorMatrices,
                  params: AMEParams, structure: str, lr: Array) -> CaviState:
    """Gauss–Seidel sweep: nodes in order, times in order within a node,
    each update reading the freshest neighbor means — the reference's exact
    trajectory semantics (``naive_mf.py:193-282``), compiled with
    ``lax.fori_loop`` over nodes and ``lax.scan`` over time.
    """
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    solver = _SOLVERS[structure]
    p, q = params.R_inv[0, 0], params.R_inv[0, 1]
    prior_P = _prior_precision(pri, T)                        # (T, d, d)

    def update_node(i, carry):
        X_mean, X_cov = carry
        _, _, U, V = dyad_ops.split_state(X_mean, r)          # (n, T, r)
        Ui, Vi = U[i], V[i]                                   # (T, r)

        sU = U.sum(0) - Ui
        sV = V.sum(0) - Vi
        GUU = jnp.einsum("jtk,jtl->tkl", U, U, precision=HIGHEST) - Ui[:, :, None] * Ui[:, None, :]
        GVV = jnp.einsum("jtk,jtl->tkl", V, V, precision=HIGHEST) - Vi[:, :, None] * Vi[:, None, :]
        GVU = jnp.einsum("jtk,jtl->tkl", V, U, precision=HIGHEST) - Vi[:, :, None] * Ui[:, None, :]

        c = jnp.asarray(n - 1, X_mean.dtype)
        P = _P_from_partner_stats(c, sU[None], sV[None], GUU[None],
                                  GVV[None], GVU[None], params.R_inv)[0]
        P = P + prior_P

        etaU = jnp.einsum("jt,jtr->tr", obs.W0[i], V, precision=HIGHEST)
        etaV = jnp.einsum("jt,jtr->tr", obs.W1[i], U, precision=HIGHEST)
        eta_obs = jnp.concatenate(
            [obs.eta_a[i][:, None], obs.eta_b[i][:, None], etaU, etaV],
            axis=-1)                                          # (T, d)

        mu_old = X_mean[i]                                    # (T, d)
        cov_old = X_cov[i]                                    # (T, d, d)
        mu_next = jnp.concatenate([mu_old[1:], jnp.zeros((1, d))], axis=0)
        has_next = (jnp.arange(T) < T - 1)[:, None]

        def time_step(mu_prev, inputs):
            t_idx, P_t, eta_t, mu_old_t, cov_old_t, mu_next_t, has_next_t = inputs
            eta_t = (eta_t
                     + jnp.where(t_idx > 0, mu_prev @ pri.Qinv_Phi.T, 0.0)
                     + has_next_t * (mu_next_t @ pri.Qinv_Phi))
            mu_new, cov_new = solver(P_t, eta_t)
            mu_upd = lr * mu_new + (1.0 - lr) * mu_old_t
            cov_upd = lr * cov_new + (1.0 - lr) * cov_old_t
            return mu_upd, (mu_upd, cov_upd)

        t_ids = jnp.arange(T)
        _, (mu_i, cov_i) = jax.lax.scan(
            time_step, jnp.zeros(d, X_mean.dtype),
            (t_ids, P, eta_obs, mu_old, cov_old, mu_next,
             has_next.astype(X_mean.dtype)))
        X_mean = X_mean.at[i].set(mu_i)
        X_cov = X_cov.at[i].set(cov_i)
        return X_mean, X_cov

    X_mean, X_cov = jax.lax.fori_loop(0, n, update_node,
                                      (state.X_mean, state.X_cov))
    return CaviState(X_mean=X_mean, X_cov=X_cov)


def cavi_step_block_wrapper(state, obs, pri, params, structure, lr, *,
                            num_blocks, corrected=False, mask=None):
    return cavi_step_block(state, obs, pri, params, structure, lr,
                           num_blocks, corrected, mask=mask)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_state(key: Array, n: int, T: int, d: int, structure: str,
               init_scale: float, cov_init_scale: float) -> CaviState:
    """Variational-parameter initialization matching the reference's scheme
    per structure (``naive_mf.py:71-87``, ``structured_mf.py:74-113``)."""
    kmean, kcov = jax.random.split(key)
    X_mean = jax.random.normal(kmean, (n, T, d)) * init_scale
    eye = jnp.eye(d)
    if structure == "diag":
        X_cov = jnp.broadcast_to(eye * 0.5, (n, T, d, d))
    elif structure == "full":
        noise = jax.random.normal(kcov, (n, T, d, d)) * 0.01
        cov = eye * cov_init_scale + 0.5 * (noise + jnp.swapaxes(noise, -1, -2))
        X_cov = cov + eye * 0.1
    else:  # block
        noise = jax.random.normal(kcov, (n, T, d, d)) * 0.01
        noise = 0.5 * (noise + jnp.swapaxes(noise, -1, -2))
        mask = jnp.zeros((d, d), dtype=bool)
        mask = mask.at[:2, 2:].set(True).at[2:, :2].set(True)
        cov = jnp.where(mask, 0.0, eye * cov_init_scale + noise)
        X_cov = cov + eye * 0.05
    return CaviState(X_mean=X_mean, X_cov=jnp.asarray(X_cov))


@functools.partial(jax.jit, static_argnames=("structure", "n_power_iters"))
def warm_init_state(Y: Array, params: AMEParams, *,
                    structure: str = "full", cov_init_scale: float = 0.5,
                    n_power_iters: int = 4,
                    key: Optional[Array] = None,
                    obs_mask: Optional[Array] = None) -> CaviState:
    """Data-driven initialization: a two-way decomposition of the
    time-averaged network for the additive effects plus the top-r
    singular pairs of its residual for U/V.

    The reference initializes from scaled Gaussian noise
    (``naive_mf.py:71-87``); a closed-form warm start lands CAVI inside
    the basin at a fraction of the iterations (measured: ~2-3x fewer
    iterations to the tolerance rule at production sizes) for two cheap
    matmuls and an r-column subspace iteration — no extra passes over the
    O(n^2 T) data beyond one time-average.

    * additive: ``a_i = rowmean_i - grand/2``, ``b_j = colmean_j -
      grand/2`` (the exact least-squares two-way fit of
      ``m_ij = a_i + b_j`` on off-diagonal entries, with the global mean
      split evenly between the two sided effects);
    * multiplicative: randomized subspace iteration (power iterations +
      QR) for the top-r singular triplets of the additive residual;
      ``U = u sqrt(s)``, ``V = v sqrt(s)``;
    * the centroid state is broadcast over T (the AR(1) chain
      differentiates time steps within a few updates);
    * covariances use the same per-structure deterministic scheme as
      :func:`init_state` (no noise — the warm start is reproducible
      without a key; pass ``key`` to randomize the subspace probe).

    ``obs_mask`` (n, n, T) restricts every average to OBSERVED dyads:
    time averages divide by per-entry observed counts and row/col/grand
    means by observed-partner counts, so at 30-50 % missingness the
    additive effects do not shrink toward zero by the missing fraction
    (they would under blind ``/(n-1)`` normalization of a zero-filled
    network).  Masked entries of Y are never read (NaN-coding safe).
    """
    n, _, T, _ = Y.shape
    d = params.Phi.shape[0]
    r = (d - 2) // 2
    offd = dyad_ops.offdiag_mask(n)
    if obs_mask is None:
        M = jnp.mean(Y[..., 0], axis=-1) * offd           # (n, n)
        w = offd                                          # entry weights
    else:
        om = obs_mask * offd[:, :, None]
        y0 = jnp.where(om > 0, Y[..., 0], 0.0)
        cnt_t = om.sum(-1)                                # (n, n)
        M = y0.sum(-1) / jnp.maximum(cnt_t, 1.0)
        w = (cnt_t > 0).astype(M.dtype)

    row_mean = M.sum(1) / jnp.maximum(w.sum(1), 1.0)
    col_mean = M.sum(0) / jnp.maximum(w.sum(0), 1.0)
    grand = M.sum() / jnp.maximum(w.sum(), 1.0)
    a = row_mean - grand / 2.0
    b = col_mean - grand / 2.0

    resid = (M - a[:, None] - b[None, :]) * w
    if key is None:
        key = jax.random.PRNGKey(0)
    G = jax.random.normal(key, (n, r), M.dtype)
    Z = resid @ G
    for _ in range(n_power_iters):
        Z, _ = jnp.linalg.qr(resid @ (resid.T @ Z))
    S = Z.T @ resid                                       # (r, n)
    u_s, sing, vt = jnp.linalg.svd(S, full_matrices=False)
    scale = jnp.sqrt(jnp.maximum(sing, 1e-12))
    U = (Z @ u_s) * scale[None, :]
    V = vt.T * scale[None, :]

    centroid = jnp.concatenate([a[:, None], b[:, None], U, V], axis=-1)
    X_mean = jnp.broadcast_to(centroid[:, None, :], (n, T, d))

    eye = jnp.eye(d)
    if structure == "diag":
        X_cov = jnp.broadcast_to(eye * 0.5, (n, T, d, d))
    elif structure == "full":
        X_cov = jnp.broadcast_to(eye * (cov_init_scale + 0.1),
                                 (n, T, d, d))
    else:  # block
        X_cov = jnp.broadcast_to(eye * (cov_init_scale + 0.05),
                                 (n, T, d, d))
    return CaviState(X_mean=jnp.asarray(X_mean, M.dtype),
                     X_cov=jnp.asarray(X_cov, M.dtype))


# ---------------------------------------------------------------------------
# Full fit (compiled convergence loop)
# ---------------------------------------------------------------------------

class FitResult(NamedTuple):
    X_mean: Array        # (n, T, d)
    X_cov: Array         # (n, T, d, d)
    elbo_history: Array  # (max_iter,) padded with NaN after convergence
    mse_history: Array   # (max_iter,)
    n_iter: Array        # scalar int
    converged: Array     # scalar bool
    diverged: Array      # scalar bool: ELBO went non-finite; fit halted
    # Convergence carry at exit — feed back as carry_elbo/carry_patience
    # of a follow-up fit_cavi call to continue a fit in segments with
    # BITWISE-identical stopping behavior (in-fit checkpointing).
    last_elbo: Array = jnp.nan     # scalar: last evaluated ELBO
    pat_count: Array = 0           # scalar int: consecutive small-change count


def fit_cavi(Y: Array, params: AMEParams, init: CaviState, *,
             structure: str = "full", update_mode: str = "jacobi",
             max_iter: int = 100, learning_rate=1.0, tolerance=1e-4,
             patience: int = 3, num_blocks=None,
             corrected: bool = False, elbo_every: int = 1,
             mixed_precision: bool = False,
             diag_mode: str = "exact",
             carry_elbo=None, carry_patience=0,
             mask: Optional[Array] = None) -> FitResult:
    """Run damped CAVI to convergence inside a single compiled loop.

    PRECONDITION: ``Y`` must follow the framework's reciprocal layout —
    ``Y[i, j, t, 1] == Y[j, i, t, 0]`` with zero diagonal (SURVEY.md §1
    data-flow contract; every generator in :mod:`tame.models` produces
    it).  The single-pass sufficient-statistics reductions
    (:func:`_data_mean_cross_terms`, used by the ``diag_mode='stats'``
    diagnostics and the warm start) derive the second weight tensor from
    the first VIA this identity (``W1 == W0'``); a tensor violating the
    layout yields silently skewed stats-mode ELBO/MSE diagnostics, not
    an error.  Use :func:`tame.ops.dyad.symmetrize_dyads` (or
    ``tame.io.edgelist``) to build a compliant ``Y`` from raw data.

    Convergence rule mirrors the reference trainer (``base.py:170-203``):
    stop once the relative ELBO change stays below ``tolerance`` for
    ``patience`` consecutive iterations.  Per-iteration ELBO and
    reconstruction-MSE histories are recorded into fixed-size buffers
    (NaN-padded past the stopping point).

    ``max_iter`` is passed as a *dynamic* bound; the history buffer is sized
    to the next power of two so changing the iteration budget does not
    trigger recompilation.

    ``corrected=False`` (default) reproduces the reference's biased natural
    parameter (offset omission, SURVEY.md §2C-4) for parity;
    ``corrected=True`` uses the exact coordinate update (better optimum,
    supported by the jacobi and block modes).

    ``elbo_every=k`` evaluates the ELBO/MSE diagnostics only every k-th
    iteration (history slots in between stay NaN) — at production scale the
    diagnostic pass reads O(n^2 T) observation-sized tensors and rivals the
    update itself; convergence is then judged on the evaluated points with
    an effective tolerance window of k iterations.  ``1`` (default) matches
    the reference's per-iteration semantics.

    ``mixed_precision=True`` stores the constant (n, n, T) dyad-weight
    tensors in bfloat16 and runs the eta contractions as single-pass bf16
    matmuls with float32 accumulation (see :func:`_eta_contract`); all d x d
    assembly, solves, priors and diagnostics stay float32.  The fixed point
    shifts by O(bf16 rounding) of the data — validated to track the float32
    optimum's MSE at the noise floor (tests).  Not supported with
    ``update_mode='seq'`` (a parity mode).

    ``mask`` enables missing-data fits: an (n, n, T) dyad observation
    mask (1 = observed, 0 = missing; symmetric with zero diagonal — both
    directions of a dyad live in one ``Y[i, j, t]`` entry and are observed
    together).  Masked entries of ``Y`` are never read: the dyad weights
    are zeroed before the constant row sums, the observation precision is
    assembled from per-node masked partner statistics
    (:func:`_masked_obs_precision`), and the ELBO/MSE diagnostics run over
    observed dyads only.  Supported with update modes ``jacobi``/``block``;
    ``diag_mode='stats'`` uses the masked sufficient-statistics expansion
    (:func:`_masked_residual_stats` — one extra mask contraction instead
    of an O(n^2 T) residual pass) and ``mixed_precision`` stores mask and
    dyad weights in bfloat16, so masked fits keep the full production fast
    path.  No reference counterpart (complete networks only,
    ``naive_mf.py:324-374``); build masks with
    :func:`tame.models.random_dyad_mask` or from data.

    ``carry_elbo``/``carry_patience`` seed the convergence bookkeeping
    (last evaluated ELBO and consecutive-small-change count) from a prior
    segment's ``FitResult.last_elbo``/``.pat_count``, so a fit run in
    ``checkpoint_every``-sized segments (engine in-fit checkpointing)
    stops at EXACTLY the same iteration as the uninterrupted fit.  The
    defaults reproduce a fresh start.

    ``diag_mode`` selects how the per-iteration ELBO/MSE are computed:
    ``"exact"`` evaluates the dyadic residuals directly (one O(n^2 T)
    elementwise pass over the forward means); ``"stats"`` expands them into
    global sufficient statistics (:func:`_residual_stats_from_moments`) —
    two eta-class contractions and O(n T r^2) moments, no
    observation-sized reads — making dense per-iteration diagnostics
    nearly free at production scale.  The two agree to float32 reduction
    error (relative ~1e-6 at n=2000; tests assert 1e-4).
    """
    if diag_mode not in ("exact", "stats"):
        raise ValueError(f"unknown diag_mode: {diag_mode!r}")
    if mask is not None:
        # Missing-data fit: observation terms restricted to observed
        # dyads (``mask`` (n, n, T), 1 = observed, symmetric, zero
        # diagonal — the reference supports complete networks only).
        if update_mode not in ("jacobi", "block"):
            raise ValueError(
                "mask is supported with update_mode 'jacobi' or 'block'")
        # Zero the diagonal defensively; symmetry is the caller's contract
        # (each unordered dyad carries both directions in Y[i, j]).
        mask = jnp.asarray(mask, Y.dtype)
        mask = mask * (1.0 - jnp.eye(Y.shape[0], dtype=Y.dtype)[:, :, None])
    if corrected and update_mode == "seq":
        raise ValueError(
            "corrected=True is not supported with update_mode='seq' "
            "(seq exists for reference-trajectory parity)")
    if mixed_precision and update_mode == "seq":
        raise ValueError(
            "mixed_precision=True is not supported with update_mode='seq' "
            "(seq exists for reference-trajectory parity)")
    buf = 64
    while buf < max_iter:
        buf *= 2
    n_ = Y.shape[0]
    if update_mode == "block" and num_blocks is None:
        # Largest divisor of n that is <= 16: near-GS stability with
        # maximal per-phase parallelism.
        num_blocks = next(k for k in range(min(16, n_), 0, -1)
                          if n_ % k == 0)
    return _fit_cavi_impl(Y, params, init, jnp.asarray(max_iter),
                          jnp.asarray(learning_rate, Y.dtype),
                          jnp.asarray(tolerance, Y.dtype),
                          jnp.asarray(-jnp.inf if carry_elbo is None
                                      else carry_elbo, Y.dtype),
                          jnp.asarray(carry_patience),
                          structure=structure, update_mode=update_mode,
                          buf_size=buf, patience=patience,
                          num_blocks=num_blocks, corrected=corrected,
                          elbo_every=elbo_every,
                          mixed_precision=mixed_precision,
                          diag_mode=diag_mode, mask=mask)


@functools.partial(jax.jit, static_argnames=("structure", "update_mode",
                                             "buf_size", "patience",
                                             "num_blocks", "corrected",
                                             "elbo_every",
                                             "mixed_precision",
                                             "diag_mode"))
def _fit_cavi_impl(Y: Array, params: AMEParams, init: CaviState,
                   max_iter: Array, learning_rate: Array, tolerance: Array,
                   carry_elbo: Array, carry_patience: Array,
                   *, structure: str, update_mode: str, buf_size: int,
                   patience: int, num_blocks, corrected: bool,
                   elbo_every: int, mixed_precision: bool,
                   diag_mode: str,
                   mask: Optional[Array] = None) -> FitResult:
    n, _, T, _ = Y.shape
    d = init.X_mean.shape[-1]
    r = (d - 2) // 2
    lr = learning_rate
    tol = tolerance

    # Missing dyads contribute nothing to the data-side statistics.
    # jnp.where (not multiplication) so NaN-coded missing entries — the
    # common real-data encoding — cannot poison the weights or the
    # masked diagnostics: masked entries of Y are genuinely never read.
    mask_c = mask
    if mask is not None:
        Y = jnp.where(mask[..., None] > 0, Y, 0.0)
        if mixed_precision:
            # 0/1 entries are exact in bf16; the masked partner
            # contractions then ride the same single-pass bf16 path as
            # the dyad-weight contractions (half the mask HBM traffic).
            mask_c = mask.astype(jnp.bfloat16)
    obs = precompute_obs_constants(
        Y, params.R_inv,
        w_dtype=jnp.bfloat16 if mixed_precision else None)
    pri = precompute_priors(params)
    if update_mode == "jacobi":
        step_fn = functools.partial(cavi_step_jacobi, corrected=corrected,
                                    mask=mask_c)
    elif update_mode == "block":
        step_fn = functools.partial(cavi_step_block_wrapper,
                                    num_blocks=num_blocks,
                                    corrected=corrected, mask=mask_c)
    else:
        step_fn = cavi_step_seq

    def cond(carry):
        state, it, prev_elbo, pat, conv, div, eh, mh = carry
        running = jnp.logical_not(jnp.logical_or(conv, div))
        return jnp.logical_and(it < max_iter, running)

    dc = (precompute_diag_constants(Y)
          if diag_mode == "stats" else None)
    if mask is not None:
        mask_stats = (0.5 * jnp.sum(mask),
                      mask.astype(jnp.float32).sum(1))
        n_obs_ordered = jnp.maximum(jnp.sum(mask), 1.0)
    else:
        mask_stats = None

    def diagnostics(state):
        if diag_mode == "stats" and mask is not None:
            # Masked sufficient-statistics path: observed-dyad residual
            # stats from one mask contraction, no O(n^2 T) float reads.
            sq, cross = _masked_residual_stats(
                dc, obs, state.X_mean, r, params.R_inv, mask_c)
        elif diag_mode == "stats":
            # Sufficient-statistics path: no O(n^2 T) reads.
            sq, cross = _residual_stats_from_moments(
                dc, obs, state.X_mean, r, params.R_inv)
        elif mask is not None:
            # Masked residuals: observed dyads only (mask is symmetric,
            # so the cross term pairs observed entries with observed).
            fwd = dyad_ops.dyadic_fwd_temporal(state.X_mean, r)
            e0 = (Y[..., 0] - fwd) * mask
            sq = jnp.sum(e0 * e0)
            cross = jnp.einsum("ijt,jit->", e0, e0,
                               preferred_element_type=jnp.float32,
                               precision=HIGHEST)
        else:
            # Fwd-half residual statistics: same values as the
            # stacked-mean path (reciprocity invariant) at half the
            # HBM traffic.
            fwd = dyad_ops.dyadic_fwd_temporal(state.X_mean, r)
            sq, cross = dyad_ops.residual_stats_from_fwd(Y, fwd)
        p_, q_ = params.R_inv[0, 0], params.R_inv[0, 1]
        quad_sum = p_ * sq + q_ * cross
        elbo = _elbo_from_quad(quad_sum, params, pri, state, structure,
                               mask_stats=mask_stats)
        if mask is not None:
            mse = 2.0 * sq / n_obs_ordered
        else:
            mse = 2.0 * sq / (n * (n - 1) * T)
        return elbo, mse

    def body(carry):
        state, it, prev_elbo, pat, conv, div, eh, mh = carry
        state = step_fn(state, obs, pri, params, structure, lr)
        is_eval = jnp.logical_or((it + 1) % elbo_every == 0,
                                 it + 1 == max_iter)
        if elbo_every == 1:
            elbo, mse = diagnostics(state)
        else:
            elbo, mse = jax.lax.cond(
                is_eval, diagnostics,
                lambda _s: (jnp.asarray(jnp.nan, Y.dtype),
                            jnp.asarray(jnp.nan, Y.dtype)),
                state)
        eh = jnp.where(is_eval, eh.at[it].set(elbo), eh)
        mh = jnp.where(is_eval, mh.at[it].set(mse), mh)
        rel = jnp.abs(elbo - prev_elbo) / (jnp.abs(prev_elbo) + 1e-8)
        # A finite prev_elbo (fresh: -inf; segmented fits: the carry) is
        # the "have a previous evaluation" signal, so a continued segment
        # checks convergence from its very first iteration.
        small = jnp.logical_and(
            jnp.logical_and(jnp.isfinite(prev_elbo), is_eval), rel < tol)
        pat = jnp.where(is_eval, jnp.where(small, pat + 1, 0), pat)
        conv = pat >= patience
        # Failure detection: a non-finite ELBO means the update blew up
        # (the reference loops on silently); halt and flag.
        div = jnp.logical_and(is_eval, jnp.logical_not(jnp.isfinite(elbo)))
        prev_elbo = jnp.where(is_eval, elbo, prev_elbo)
        return state, it + 1, prev_elbo, pat, conv, div, eh, mh

    nanbuf = jnp.full((buf_size,), jnp.nan, Y.dtype)
    carry = (init, jnp.asarray(0), carry_elbo.astype(Y.dtype),
             carry_patience, jnp.asarray(False), jnp.asarray(False),
             nanbuf, nanbuf)
    state, it, last, pat, conv, div, eh, mh = jax.lax.while_loop(
        cond, body, carry)
    return FitResult(X_mean=state.X_mean, X_cov=state.X_cov,
                     elbo_history=eh, mse_history=mh, n_iter=it,
                     converged=conv, diverged=div,
                     last_elbo=last, pat_count=pat)
