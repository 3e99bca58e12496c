"""Production-scale sampler evidence: NUTS at n=128, T=16, r=2, 64 chains.

Runs CAVI-preconditioned NUTS on the GPU at a scale far beyond the
toy tests (north-star config 4: "64+ sharded chains; validates SMF
moments within MC error"), and records ONE JSON artifact
``MCMC_BENCH.json`` with:

* sampling wall clock and ESS/s (per-coordinate effective sample sizes
  of identified dyad-mean scalars, Vehtari et al. estimator);
* split-R-hat of those scalars and of the per-draw log density (the
  single most sensitive statistic);
* the SMF-vs-NUTS posterior moment gap in dyadic-mean space (the
  identified quantity), both as an effect size against the posterior sd
  and as a z-score against the ESS-scaled Monte-Carlo standard error.

Everything heavy is reduced ON DEVICE; the host fetch is K dyad-scalar
traces + summary tensors.

Usage:  python scripts/mcmc_bench.py [--n 128 --T 16 --r 2 --chains 64]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--T", type=int, default=16)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--samples", type=int, default=1000,
                    help=">= 1000 draws/chain so the Vehtari/Geyer ESS "
                         "estimator can resolve autocorrelation below "
                         "the total-draw ceiling (round-4 verdict: at "
                         "200 draws ESS saturated at C*S and ESS/s was "
                         "an extrapolation)")
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--k-scalars", type=int, default=64,
                    help="number of dyad-mean coordinates tracked for "
                         "R-hat/ESS")
    ap.add_argument("--chains-per-dispatch", type=int, default=8,
                    help="chains per device dispatch (dispatches with "
                         "on-device reduction are equivalent for any "
                         "split — chains are independent)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="MCMC_BENCH.json")
    args = ap.parse_args(argv)

    from tame.config import ModelConfig
    from tame.inference import cavi
    from tame.inference.hmc import precondition_from_cavi
    from tame.inference.logprob import log_joint, precompute
    from tame.inference.nuts import run_nuts
    from tame.models import build_params, sample
    from tame.ops import dyad as dyad_ops
    from tame.utils.diagnostics import effective_sample_size, split_rhat

    n, T, r, C = args.n, args.T, args.r, args.chains
    cfg = ModelConfig(n_nodes=n, n_time=T, latent_dim=r, seed=args.seed)
    params = build_params(cfg)
    key = jax.random.PRNGKey(args.seed)
    Y, _ = sample(params, key, n, T)
    jax.block_until_ready(Y)
    print(f"data ready: n={n} T={T} r={r} d={cfg.d} "
          f"({n * T * cfg.d} latent dims/chain, {C} chains)", flush=True)

    # -- SMF reference fit: corrected=True (the EXACT coordinate update)
    # so the moment comparison is SMF-vs-NUTS on the SAME posterior; the
    # default parity mode reproduces the reference's biased natural
    # parameter, whose fixed point is a different distribution than the
    # one NUTS samples.
    init = cavi.init_state(jax.random.fold_in(key, 1), n, T, cfg.d,
                           "full", 0.1, 0.5)
    fit = cavi.fit_cavi(Y, params, init, structure="full",
                        update_mode="block", max_iter=512,
                        corrected=True,
                        learning_rate=0.8, tolerance=1e-5)
    fit = jax.block_until_ready(fit)
    print(f"SMF fit: {int(fit.n_iter)} iters, converged="
          f"{bool(fit.converged)}", flush=True)

    # -- corrected-smoothed reference fit: the tighter joint-trajectory
    # family, same exact-update posterior target — its moment gap
    # isolates how much of the SMF-vs-NUTS bias is the per-(node,time)
    # factorization (round-4 verdict item 3).
    from tame.inference.smoothed import (
        fit_cavi_smoothed,
        warm_init_smoothed_state,
    )

    sfit = jax.block_until_ready(fit_cavi_smoothed(
        Y, params, warm_init_smoothed_state(Y, params),
        max_iter=512, learning_rate=0.8, tolerance=1e-5,
        corrected=True))
    print(f"smoothed fit: {int(sfit.n_iter)} iters, converged="
          f"{bool(sfit.converged)}", flush=True)

    # -- CAVI preconditioning + chain inits --------------------------------
    center, inv_mass = precondition_from_cavi(Y, params, seed=args.seed)
    k_init, k_chains = jax.random.split(jax.random.fold_in(key, 2))
    inits = center[None] + 0.01 * jax.random.normal(
        k_init, (C,) + center.shape)
    keys = jax.random.split(k_chains, C)

    consts = precompute(params)
    ld = lambda x, Yo: log_joint(params, Yo, x, consts)  # noqa: E731

    # identified scalar tracking: K random off-diagonal (i, j, t) coords
    rng = np.random.default_rng(args.seed)
    ii = rng.integers(0, n, size=4 * args.k_scalars)
    jj = rng.integers(0, n, size=4 * args.k_scalars)
    ok = ii != jj
    ii, jj = ii[ok][:args.k_scalars], jj[ok][:args.k_scalars]
    tt = rng.integers(0, T, size=len(ii))
    ii, jj, tt = (jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(tt))

    run = lambda p, k: run_nuts(  # noqa: E731
        ld, p, k, num_warmup=args.warmup, num_samples=args.samples,
        max_depth=args.max_depth, inv_mass=inv_mass,
        logdensity_args=(Y,))

    @jax.jit
    def run_batch(inits_b, keys_b):
        """One dispatch: a chain batch sampled AND reduced on device —
        only the (B, S, K) identified dyad-mean traces, per-draw log
        densities and accept stats leave the program (the full position
        stack never leaves the device)."""
        out = jax.vmap(run)(inits_b, keys_b)

        def per_sample(X):
            a, b, U, V = dyad_ops.split_state(X, r)
            # mu_ij = a_i + b_j + U_i . V_j at the tracked coordinates
            return (a[ii, tt] + b[jj, tt]
                    + jnp.sum(U[ii, tt] * V[jj, tt], axis=-1))
        scal = jax.vmap(jax.vmap(per_sample))(out.positions)
        return scal, out.logdensities, out.accept_prob

    B = args.chains_per_dispatch

    def sweep(all_keys):
        scal, logp, acc = [], [], []
        for s0 in range(0, C, B):
            sc, lp, ac = run_batch(inits[s0:s0 + B],
                                   all_keys[s0:s0 + B])
            scal.append(np.asarray(sc))
            logp.append(np.asarray(lp))
            acc.append(np.asarray(ac))
        return (np.concatenate(scal), np.concatenate(logp),
                np.concatenate(acc))

    print(f"compiling + warmup ({C} chains in dispatches of {B}) ...",
          flush=True)
    t0 = time.perf_counter()
    sweep(keys)
    wall = time.perf_counter() - t0
    print(f"total wall (compile + warmup + sample): {wall:.1f}s",
          flush=True)

    # timed second sweep with fresh keys: steady-state throughput
    keys2 = jax.random.split(jax.random.fold_in(key, 3), C)
    t0 = time.perf_counter()
    scal2_h, logp2_h, acc2_h = sweep(keys2)
    wall2 = time.perf_counter() - t0

    # -- diagnostics (host) ------------------------------------------------
    ess = np.asarray(effective_sample_size(jnp.asarray(scal2_h)))
    rhat = np.asarray(split_rhat(jnp.asarray(scal2_h)))
    rhat_logp = float(np.asarray(split_rhat(jnp.asarray(logp2_h))))
    # the warmup fraction of wall2 still amortizes; report both rates
    ess_per_s_total = ess / wall2

    # -- SMF vs NUTS moment gap in identified (dyad-mean) space ------------
    mu_vi = np.asarray(
        dyad_ops.dyadic_fwd_temporal(fit.X_mean, r)[ii, jj, tt])
    mu_sm = np.asarray(
        dyad_ops.dyadic_fwd_temporal(sfit.state.X_mean, r)[ii, jj, tt])
    mu_nuts = scal2_h.reshape(-1, scal2_h.shape[-1]).mean(0)
    sd_nuts = scal2_h.reshape(-1, scal2_h.shape[-1]).std(0)
    mcse = sd_nuts / np.sqrt(np.maximum(ess, 1.0))
    gap = mu_vi - mu_nuts
    effect = np.abs(gap) / np.maximum(sd_nuts, 1e-8)
    z = np.abs(gap) / np.maximum(mcse, 1e-12)
    gap_sm = mu_sm - mu_nuts
    effect_sm = np.abs(gap_sm) / np.maximum(sd_nuts, 1e-8)
    z_sm = np.abs(gap_sm) / np.maximum(mcse, 1e-12)

    result = {
        "config": {"n": n, "T": T, "r": r, "d": cfg.d,
                   "chains": C, "warmup": args.warmup,
                   "samples": args.samples, "max_depth": args.max_depth,
                   "k_scalars": int(len(ii)), "seed": args.seed,
                   "backend": jax.default_backend()},
        "wall_s_cold": round(wall, 1),
        "wall_s_warm": round(wall2, 1),
        "chains_per_dispatch": B,
        "accept_mean": float(acc2_h.mean()),
        "total_draws": int(C * args.samples),
        "split_rhat_max": float(rhat.max()),
        "split_rhat_median": float(np.median(rhat)),
        "logdensity_rhat": rhat_logp,
        "ess_min": float(ess.min()),
        "ess_median": float(np.median(ess)),
        "ess_per_s_min": float(ess_per_s_total.min()),
        "ess_per_s_median": float(np.median(ess_per_s_total)),
        "smf_gap_rms": float(np.sqrt((gap ** 2).mean())),
        "smf_gap_max_abs": float(np.abs(gap).max()),
        "smf_effect_size_median": float(np.median(effect)),
        "smf_effect_size_max": float(effect.max()),
        "smf_z_median": float(np.median(z)),
        "smoothed_gap_rms": float(np.sqrt((gap_sm ** 2).mean())),
        "smoothed_effect_size_median": float(np.median(effect_sm)),
        "smoothed_effect_size_max": float(effect_sm.max()),
        "smoothed_z_median": float(np.median(z_sm)),
        "posterior_sd_median": float(np.median(sd_nuts)),
    }
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result, indent=1))
    ok = result["split_rhat_max"] < 1.05 and rhat_logp < 1.1
    print("MIXING OK" if ok else "MIXING MARGINAL — inspect R-hats",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
