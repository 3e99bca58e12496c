"""Benchmark: Good-SMF CAVI throughput on the BASELINE demo config, plus
the north-star wall-clock-to-converged at n=2000 (both halves of the
BASELINE.json metric).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", "n2000_*" (cold, warm and smoothed legs)}; "device" names the
platform, device kind and device count.

Baseline: the reference implementation measured at 4.81 ELBO-iterations/s
for Good SMF (lr=0.7, 150 iters, n=15/T=10/r=2 demo config) on CPU
(BASELINE.md, measured 2026-08-17).

Protocol
--------
Each unit of work is one complete 150-iteration Good-SMF fit (the
reference's experiment setting: lr=0.7, ``tolerance=0`` so every iteration
runs).  ``N_FITS`` independent fits (distinct random inits) run
*sequentially* inside ONE compiled program via ``lax.scan`` — no batching,
each fit is the same serial dependency chain the reference times — and the
per-iteration rate is ``N_FITS * 150 / wall``.  Running many fits per
dispatch amortizes the fixed host cost of one dispatch, which at one-fit
granularity would otherwise dominate.  Timing excludes compilation (one
warm-up call), varies the inits per repeat, and ends each timed call with
a host fetch of one scalar per fit.

Needs a CUDA GPU: on any other backend it exits non-zero and prints no
result.  Any leg that fails fails the run.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from tame.config import ModelConfig
from tame.inference import cavi
from tame.inference.smoothed import (
    fit_cavi_smoothed,
    init_smoothed_state,
    warm_init_smoothed_state,
)
from tame.models import build_params, sample
from tame.utils.cache import enable_compile_cache

BASELINE_ITERS_PER_S = 4.81  # reference Good SMF, BASELINE.md
N_ITERS = 150
N_FITS = 512
REPEATS = 5


def n2000_metrics():
    """North-star config (n=2000, T=50, r=4): wall clock of ONE complete
    Good-SMF fit run to the ACTUAL tolerance/patience stopping rule
    (tolerance 1e-4, production path: bf16 dyad weights +
    sufficient-statistics diagnostics, 8-block updates).  One warm-up
    fit compiles; the timed fit uses a distinct init and ends with a host
    fetch."""
    cfg = ModelConfig(n_nodes=2000, n_time=50, latent_dim=4, seed=0)
    params = build_params(cfg)
    key = jax.random.PRNGKey(0)
    Y, _ = sample(params, key, cfg.n_nodes, cfg.n_time)
    jax.block_until_ready(Y)

    def fit(init):
        jax.block_until_ready(init)
        t0 = time.perf_counter()
        out = cavi.fit_cavi(Y, params, init, structure="full",
                            update_mode="block", num_blocks=8,
                            max_iter=512, learning_rate=0.8,
                            tolerance=1e-4, mixed_precision=True,
                            diag_mode="stats")
        np.asarray(out.X_mean)  # host-fetch barrier
        return out, time.perf_counter() - t0

    def cold(i):
        return cavi.init_state(jax.random.fold_in(key, 900 + i),
                               cfg.n_nodes, cfg.n_time, cfg.d,
                               "full", 0.1, 0.5)

    fit(cold(0))  # compile
    out, wall = fit(cold(1))
    n_iter = int(out.n_iter)
    res = {
        "n2000_wall_to_converged_s": round(wall, 3),
        "n2000_iters": n_iter,
        "n2000_converged": bool(out.converged),
        "n2000_ms_per_iter": round(wall / n_iter * 1000, 2),
    }
    # Warm start (closed-form data decomposition): same compiled fit,
    # fewer iterations to the same stopping rule.
    warm = cavi.warm_init_state(Y, params, structure="full")
    out_w, wall_w = fit(warm)
    res["n2000_warm_wall_to_converged_s"] = round(wall_w, 3)
    res["n2000_warm_iters"] = int(out_w.n_iter)
    res["n2000_warm_converged"] = bool(out_w.converged)

    # Smoothed (joint-trajectory) family at the same scale: warm init +
    # production path (bf16 dyad weights, sufficient-statistics
    # diagnostics).  This is the EM E-step engine, so its
    # wall-to-converged bounds hyperparameter learning at n=2000.
    sinit = warm_init_smoothed_state(Y, params)
    jax.block_until_ready(sinit)

    def sfit(init, max_iter):
        t0 = time.perf_counter()
        out = fit_cavi_smoothed(Y, params, init, max_iter=max_iter,
                                learning_rate=0.8, tolerance=1e-4,
                                mixed_precision=True, diag_mode="stats")
        np.asarray(out.state.X_mean)  # host-fetch barrier
        return out, time.perf_counter() - t0

    # Compile warm-up: random init, same pow2 history buffer, so the
    # timed warm-started fit reuses the executable.
    rinit = init_smoothed_state(jax.random.PRNGKey(77), cfg.n_nodes,
                                cfg.n_time, cfg.d, 0.1)
    sfit(rinit, 512)
    out_s, wall_s = sfit(sinit, 512)
    n_s = int(out_s.n_iter)
    res["n2000_smoothed_wall_to_converged_s"] = round(wall_s, 3)
    res["n2000_smoothed_iters"] = n_s
    res["n2000_smoothed_converged"] = bool(out_s.converged)
    res["n2000_smoothed_ms_per_iter"] = round(wall_s / n_s * 1000, 2)
    return res


def main():
    dev = jax.devices()
    if dev[0].platform != "gpu":
        raise SystemExit(f"bench.py: needs a CUDA GPU; JAX found platform "
                         f"{dev[0].platform!r}")
    enable_compile_cache()
    cfg = ModelConfig(n_nodes=15, n_time=10, latent_dim=2,
                      ar_coefficient=0.8, rho_dyadic=0.5, seed=42)
    params = build_params(cfg)
    key = jax.random.PRNGKey(cfg.seed)
    Y, _ = sample(params, key, cfg.n_nodes, cfg.n_time)

    @jax.jit
    def run_fits(keys):
        """N_FITS complete fits, strictly sequential (lax.scan carry)."""
        def one_fit(_, k):
            # diag_mode="exact" is the faster diagnostics path at this
            # tiny config (the observation tensor is 2250 elements; the
            # sufficient-statistics expansion only wins at scale).
            st = cavi.init_state(k, cfg.n_nodes, cfg.n_time, cfg.d,
                                 "full", 0.1, 0.5)
            out = cavi.fit_cavi(Y, params, st, structure="full",
                                update_mode="jacobi", max_iter=N_ITERS,
                                learning_rate=0.7, tolerance=0.0,
                                diag_mode="exact")
            return 0, (out.X_mean, out.n_iter)
        _, (means, iters) = jax.lax.scan(one_fit, 0,
                                         jax.random.split(keys, N_FITS))
        # Reduce to one scalar per fit ON DEVICE: the timed host fetch is
        # a barrier, not part of the measured work.  The sum depends on
        # every fit's full state, so execution is still forced.
        return jnp.sum(means, axis=(1, 2, 3)), iters

    def run(seed_offset):
        # Distinct inits per repeat: the work measured is always fresh
        # fits.
        means, iters = run_fits(jax.random.fold_in(key, seed_offset))
        np.asarray(means)
        assert int(np.asarray(iters).min()) == N_ITERS
        return means

    run(0)  # warm-up: compile
    best = float("inf")
    for rep in range(REPEATS):
        t0 = time.perf_counter()
        run(rep + 1)
        best = min(best, time.perf_counter() - t0)

    iters_per_s = N_FITS * N_ITERS / best

    extra = n2000_metrics()
    print(json.dumps({
        "metric": "good_smf_elbo_iterations_per_s",
        "value": round(iters_per_s, 2),
        "unit": "iter/s",
        "vs_baseline": round(iters_per_s / BASELINE_ITERS_PER_S, 2),
        "device": {"platform": dev[0].platform,
                   "kind": dev[0].device_kind, "count": len(dev)},
        **extra,
    }))


if __name__ == "__main__":
    main()
