"""Diagnostics, formatted summaries and multi-method comparison.

Functional parity with the reference's ``src/utils/diagnostics.py``:
reconstruction error for static/temporal shapes, additive/multiplicative
variance contributions, contribution ratio, state MSE, formatted console
summaries, method-ranking comparison, windowed convergence tracking, ELBO
gap and the U'V-product correlation (which the reference defines at
``diagnostics.py:528-562`` but forgets to export — exported here).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from tame.ops import dyad as dyad_ops


def compute_reconstruction_error(Y_true: Array, Y_pred: Array,
                                 exclude_diagonal: bool = True) -> float:
    """Per-*entry* MSE over (optionally off-diagonal) elements
    (reference ``diagnostics.py:32-79``).

    Note the reference's normalization inconsistency: this divides by
    ``n (n-1) T 2`` (per entry) whereas the fit-history MSE divides by
    ``n (n-1) T`` (per dyad) — reproduced as-is.
    """
    Y_true = jnp.asarray(Y_true)
    Y_pred = jnp.asarray(Y_pred)
    sq = (Y_true - Y_pred) ** 2
    if exclude_diagonal:
        n = Y_true.shape[0]
        if Y_true.ndim == 3:
            mask = dyad_ops.offdiag_mask(n)[:, :, None]
            n_elements = n * (n - 1) * 2
        else:
            T = Y_true.shape[2]
            mask = dyad_ops.offdiag_mask(n)[:, :, None, None]
            n_elements = n * (n - 1) * T * 2
        sq = sq * mask
    else:
        n_elements = sq.size
    return float(jnp.sum(sq) / n_elements)


def compute_additive_contribution(A: Array,
                                  exclude_diagonal: bool = True) -> float:
    """Variance of a_i + b_j over pairs (reference ``diagnostics.py:82-122``)."""
    return float(dyad_ops.additive_contribution(jnp.asarray(A),
                                                exclude_diagonal))


def compute_multiplicative_contribution(M: Array,
                                        exclude_diagonal: bool = True
                                        ) -> float:
    """Variance of U_i . V_j over pairs (reference ``diagnostics.py:125-167``)."""
    return float(dyad_ops.multiplicative_contribution(jnp.asarray(M),
                                                      exclude_diagonal))


def compute_temporal_contributions(X: Array, latent_dim: int,
                                   exclude_diagonal: bool = True
                                   ) -> Tuple[Array, Array]:
    """Per-time (additive, multiplicative) contributions, vmapped over T
    (reference ``diagnostics.py:170-217``)."""
    X = jnp.asarray(X)
    A_t = jnp.swapaxes(X[:, :, :2], 0, 1)   # (T, n, 2)
    M_t = jnp.swapaxes(X[:, :, 2:], 0, 1)   # (T, n, 2r)
    add = jax.vmap(
        lambda A: dyad_ops.additive_contribution(A, exclude_diagonal))(A_t)
    mult = jax.vmap(
        lambda M: dyad_ops.multiplicative_contribution(M, exclude_diagonal))(M_t)
    return add, mult


def compute_contribution_ratio(A: Array, M: Array) -> float:
    """sqrt(Var_additive / Var_multiplicative)
    (reference ``diagnostics.py:220-251``)."""
    va = compute_additive_contribution(A)
    vm = compute_multiplicative_contribution(M)
    if vm < 1e-10:
        return float("inf")
    return float(np.sqrt(va / vm))


def compute_state_prediction_error(X_true: Array, X_pred: Array) -> float:
    """State-space MSE (reference ``diagnostics.py:254-273``)."""
    return float(jnp.mean((jnp.asarray(X_true) - jnp.asarray(X_pred)) ** 2))


def print_diagnostic_summary(method_name: str,
                             history: Dict[str, List[float]],
                             X_true: Optional[Array] = None,
                             X_est: Optional[Array] = None,
                             latent_dim: Optional[int] = None,
                             final_only: bool = False) -> None:
    """Formatted console summary (reference ``diagnostics.py:276-372``)."""
    print("\n" + "=" * 70)
    print(f"Diagnostic Summary: {method_name}")
    print("=" * 70)

    n_iter = len(history["elbo"])
    print(f"Number of iterations: {n_iter}")

    if not final_only and n_iter > 0:
        print(f"Initial ELBO: {history['elbo'][0]:10.2f}")
        print(f"Final ELBO:   {history['elbo'][-1]:10.2f}")
        if n_iter > 1:
            print(f"ELBO change:  "
                  f"{history['elbo'][-1] - history['elbo'][0]:10.2f}")

    if history.get("reconstruction_error"):
        final_mse = history["reconstruction_error"][-1]
        print(f"\nFinal reconstruction MSE: {final_mse:.6f}")
        if not final_only and n_iter > 1:
            init_mse = history["reconstruction_error"][0]
            improvement = (1 - final_mse / init_mse) * 100 if init_mse > 0 else 0
            print(f"MSE improvement: {improvement:.1f}%")

    if X_true is not None and X_est is not None:
        print(f"\nState prediction MSE: "
              f"{compute_state_prediction_error(X_true, X_est):.6f}")

    if X_est is not None and latent_dim is not None:
        X_est = jnp.asarray(X_est)
        if X_est.ndim == 3:
            A_final, M_final = X_est[:, -1, :2], X_est[:, -1, 2:]
        else:
            A_final, M_final = X_est[:, :2], X_est[:, 2:]
        add = compute_additive_contribution(A_final)
        mult = compute_multiplicative_contribution(M_final)
        ratio = compute_contribution_ratio(A_final, M_final)
        print("\nEffect contributions (final):")
        print(f"  Additive:       {add:.4f}")
        print(f"  Multiplicative: {mult:.4f}")
        print(f"  A/M ratio:      {ratio:.2f}")

    if not final_only:
        extra = [k for k in history
                 if k not in ("elbo", "reconstruction_error")]
        if extra:
            print("\nAdditional metrics:")
            for metric in extra:
                if history[metric]:
                    print(f"  {metric}: {history[metric][-1]:.6f}")

    print("=" * 70)


def compare_methods(results: Dict[str, Dict[str, Any]],
                    metric: str = "reconstruction_error",
                    X_true: Optional[Array] = None) -> None:
    """Ranked multi-method comparison table
    (reference ``diagnostics.py:375-443``)."""
    print("\n" + "=" * 70)
    print("Method Comparison")
    print("=" * 70)

    scores = {}
    for name, result in results.items():
        hist = result["history"]
        if metric in hist and hist[metric]:
            scores[name] = hist[metric][-1]
    ranked = sorted(scores.items(), key=lambda kv: kv[1])

    print(f"\nFinal {metric}:")
    for rank, (name, score) in enumerate(ranked, 1):
        print(f"  {rank}. {name:20s}: {score:.6f}")

    if X_true is not None:
        print("\nState prediction MSE:")
        state_errors = {
            name: compute_state_prediction_error(X_true, result["X_est"])
            for name, result in results.items() if "X_est" in result}
        for rank, (name, err) in enumerate(
                sorted(state_errors.items(), key=lambda kv: kv[1]), 1):
            print(f"  {rank}. {name:20s}: {err:.6f}")

    if len(ranked) > 1:
        base_name, base_score = ranked[-1]
        print(f"\nImprovement over {base_name}:")
        for name, score in ranked[:-1]:
            print(f"  {name:20s}: {(1 - score / base_score) * 100:+.1f}%")

    print("=" * 70)


def track_convergence(history: Dict[str, List[float]],
                      window_size: int = 10) -> Dict[str, bool]:
    """Windowed convergence check: converged iff all relative changes over
    the last window are < 1e-4 (reference ``diagnostics.py:446-492``)."""
    status = {}
    for metric, values in history.items():
        if len(values) < window_size + 1:
            status[metric] = False
            continue
        recent = values[-window_size:]
        rel_changes = [abs(recent[i] - recent[i - 1]) / abs(recent[i - 1])
                       for i in range(1, len(recent))
                       if abs(recent[i - 1]) > 1e-8]
        status[metric] = bool(rel_changes) and max(rel_changes) < 1e-4
    return status


def compute_elbo_gap(elbo_history: List[float],
                     true_log_likelihood: Optional[float] = None
                     ) -> Optional[float]:
    """Gap between final ELBO and a known log p(Y)
    (reference ``diagnostics.py:495-526``)."""
    if true_log_likelihood is None or not elbo_history:
        return None
    return true_log_likelihood - elbo_history[-1]


# ---------------------------------------------------------------------------
# MCMC chain diagnostics (new surface: the reference has no
# sampler, so no counterpart exists — VI-side convergence tracking above is
# its closest analog, reference ``diagnostics.py:446-492``)
# ---------------------------------------------------------------------------

def split_rhat(samples: Array) -> Array:
    """Split-chain potential-scale-reduction R-hat (Gelman et al. 2013).

    ``samples``: (chains, draws, ...); each chain is split in half (guards
    against within-chain trends), giving 2C sequences.  Returns per-
    parameter R-hat with shape ``samples.shape[2:]``; values near 1
    indicate mixing, > 1.05 is the conventional failure threshold.
    """
    x = jnp.asarray(samples)
    C, N = x.shape[:2]
    half = N // 2
    if half < 2:
        raise ValueError("split_rhat needs at least 4 draws per chain")
    x = jnp.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    n = half
    chain_mean = x.mean(axis=1)                      # (2C, ...)
    chain_var = x.var(axis=1, ddof=1)
    W = chain_var.mean(axis=0)
    B = n * chain_mean.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * W + B / n
    return jnp.sqrt(var_plus / jnp.maximum(W, 1e-12))


def effective_sample_size(samples: Array) -> Array:
    """Per-parameter multi-chain effective sample size.

    ``samples``: (chains, draws, ...).  Uses FFT autocovariances, the
    Vehtari et al. (2021) combined-chain correlation estimate
    ``rho_t = 1 - (W - mean_t) / var_plus`` and Geyer's initial positive
    sequence truncation (stop at the first negative even-odd pair sum).
    Returns shape ``samples.shape[2:]``; host-side numpy (diagnostics are
    not hot-path work).
    """
    x = np.asarray(samples, dtype=np.float64)
    C, N = x.shape[:2]
    P_shape = x.shape[2:]
    flat = x.reshape(C, N, -1)
    P = flat.shape[-1]

    centered = flat - flat.mean(axis=1, keepdims=True)
    nfft = 1
    while nfft < 2 * N:
        nfft *= 2
    f = np.fft.rfft(centered, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :N].real / N
    acov_mean = acov.mean(axis=0)                    # (N, P)

    chain_var = flat.var(axis=1, ddof=1)             # (C, P)
    W = chain_var.mean(axis=0)
    B = N * flat.mean(axis=1).var(axis=0, ddof=1) if C > 1 \
        else np.zeros(P)
    var_plus = (N - 1) / N * W + B / N
    var_plus = np.maximum(var_plus, 1e-12)

    rho = 1.0 - (W[None] - acov_mean) / var_plus[None]   # (N, P)
    # Geyer initial positive sequence on pair sums rho_{2t} + rho_{2t+1},
    # vectorized over parameters: a cumulative-product mask zeroes every
    # pair from the first negative one onward (identical to the
    # break-at-first-negative loop, O(N*P) array work instead of a
    # Python double loop).
    n_pairs = (N - 1) // 2
    pair = rho[1:2 * n_pairs + 1].reshape(n_pairs, 2, P).sum(axis=1)
    keep = np.cumprod(pair >= 0, axis=0)             # (n_pairs, P)
    tau = 1.0 + 2.0 * (pair * keep).sum(axis=0)
    ess = C * N / np.maximum(tau, 1e-12)
    return jnp.asarray(ess.reshape(P_shape))


def chain_diagnostics(positions: Array,
                      logdensities: Optional[Array] = None
                      ) -> Dict[str, float]:
    """Summary convergence report for a (chains, draws, ...) sample stack:
    max split-R-hat, min/median per-parameter ESS, and (when per-draw log
    densities are given) the R-hat of the log density — the single most
    sensitive scalar.  Feed ``TemporalAMEHMC/NUTS.sample`` outputs."""
    rhat = split_rhat(positions)
    ess = effective_sample_size(positions)
    out = {
        "max_rhat": float(jnp.max(rhat)),
        "min_ess": float(jnp.min(ess)),
        "median_ess": float(jnp.median(ess)),
    }
    if logdensities is not None:
        out["logdensity_rhat"] = float(jnp.max(split_rhat(logdensities)))
    return out


def compute_uv_product_correlation(M_est: Array, M_true: Array,
                                   latent_dim: int) -> float:
    """Correlation of the *identified* quantity U'V between estimate and
    truth (reference ``diagnostics.py:528-562``)."""
    r = latent_dim
    M_est = jnp.asarray(M_est)
    M_true = jnp.asarray(M_true)
    UV_est = jnp.ravel(M_est[:, :r] @ M_est[:, r:].T)
    UV_true = jnp.ravel(M_true[:, :r] @ M_true[:, r:].T)
    xc = UV_true - UV_true.mean()
    yc = UV_est - UV_est.mean()
    den = jnp.sqrt(jnp.sum(xc ** 2) * jnp.sum(yc ** 2))
    return float(jnp.where(den < 1e-10, 0.0,
                           jnp.sum(xc * yc) / jnp.maximum(den, 1e-10)))
