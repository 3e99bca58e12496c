"""At-scale SMC evidence artifact: adaptive-tempered SMC at n=64 on one
GPU, with the log-evidence-vs-exact-ELBO comparison that only SMC
enables (round-4 verdict item 4).

Records ``SMC_BENCH.json``:

* the realized adaptive temperature schedule (stage count, first/last
  increments), resampling count, particle-ESS and move-acceptance
  trajectories (summaries);
* the log-evidence estimate over independent replicates (mean +- std —
  the Monte-Carlo error bar);
* the EXACT variational lower bound of the converged corrected-smoothed
  fit (``tame.inference.evidence.exact_elbo`` — a true bound, unlike
  the engines' reference-parity ELBO), and the implied KL gap
  ``log p(Y) - ELBO >= 0``.

Everything heavy is reduced on device; the host fetch per replicate is
the scalar evidence + small histories.

Usage: python scripts/smc_bench.py [--n 64 --T 8 --r 2 --particles 256]
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
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--T", type=int, default=8)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--particles", type=int, default=256)
    ap.add_argument("--buffer", type=int, default=600,
                    help="adaptive-schedule stage buffer")
    # defaults = the settings that produced the recorded SMC_BENCH.json
    # (moves=3/leapfrog=10 under-mixed at n=64: evidence -238 nats BELOW
    # the bound; 6x20 lands +96 above, as it must)
    ap.add_argument("--moves", type=int, default=6)
    ap.add_argument("--leapfrog", type=int, default=20)
    ap.add_argument("--step-scale", type=float, default=0.5)
    ap.add_argument("--replicates", type=int, default=4)
    ap.add_argument("--stages-per-call", type=int, default=30,
                    help="stages per device dispatch (segmented; keeps "
                         "each dispatch under the worker's ~1-min kill "
                         "window)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="SMC_BENCH.json")
    args = ap.parse_args(argv)

    from tame.config import ModelConfig
    from tame.inference.evidence import exact_elbo
    from tame.inference.hmc import precondition_from_cavi
    from tame.inference.smc import run_smc
    from tame.inference.smoothed import (
        fit_cavi_smoothed,
        warm_init_smoothed_state,
    )
    from tame.models import build_params, sample

    n, T, r = args.n, args.T, args.r
    cfg = ModelConfig(n_nodes=n, n_time=T, latent_dim=r, seed=args.seed)
    params = build_params(cfg)
    key = jax.random.PRNGKey(args.seed)
    Y, _ = sample(params, key, n, T)
    jax.block_until_ready(Y)
    dims = n * T * params.d
    print(f"data ready: n={n} T={T} r={r} ({dims} latent dims, "
          f"{args.particles} particles)", flush=True)

    fit = jax.block_until_ready(fit_cavi_smoothed(
        Y, params, warm_init_smoothed_state(Y, params), max_iter=512,
        learning_rate=0.8, tolerance=1e-6, corrected=True))
    elbo = float(exact_elbo(Y, params, fit.state))
    print(f"smoothed fit: {int(fit.n_iter)} iters, exact ELBO {elbo:.1f}",
          flush=True)

    _, variances = precondition_from_cavi(Y, params, seed=args.seed)
    pscale = jnp.sqrt(variances)

    kw = dict(num_particles=args.particles, num_stages=args.buffer,
              num_moves=args.moves, step_scale=args.step_scale,
              num_leapfrog=args.leapfrog, proposal_scale=pscale)

    def run_segmented(seed):
        """Segmented device dispatches, state carried on device."""
        res, seg = None, 0
        while True:
            res = jax.block_until_ready(run_smc(
                params, Y, jax.random.PRNGKey(seed + 1000 * seg),
                resume_from=res, max_new_stages=args.stages_per_call,
                **kw))
            seg += 1
            ns = int(res.n_stages)
            if ns >= args.buffer or \
                    float(np.asarray(res.beta_history)[ns - 1]) >= 1.0:
                return res

    evs, stage_counts, resamples, acc_means, ess_mins = [], [], [], [], []
    wall = []
    beta_first = beta_last = None
    for s in range(args.replicates):
        t0 = time.perf_counter()
        res = run_segmented(100 + s)
        ev = float(res.log_evidence)        # scalar host fetch
        w = time.perf_counter() - t0
        ns = int(res.n_stages)
        betas = np.asarray(res.beta_history)[:ns]
        ess = np.asarray(res.ess_history)[:ns]
        acc = np.asarray(res.accept_history)[:ns]
        evs.append(ev)
        stage_counts.append(ns)
        resamples.append(int(res.n_resamples))
        acc_means.append(float(acc.mean()))
        ess_mins.append(float(ess.min()))
        wall.append(w)
        if s == 0:
            beta_first = float(betas[0])
            beta_last = float(1.0 - betas[-2]) if ns > 1 else 1.0
        print(f"replicate {s}: {ns} stages, {int(res.n_resamples)} "
              f"resamples, accept {acc.mean():.2f}, "
              f"log-evidence {ev:.1f}  ({w:.1f}s)", flush=True)

    evs = np.asarray(evs)
    result = {
        "config": {"n": n, "T": T, "r": r, "d": params.d,
                   "latent_dims": dims,
                   "particles": args.particles,
                   "stage_buffer": args.buffer,
                   "moves": args.moves, "leapfrog": args.leapfrog,
                   "step_scale": args.step_scale,
                   "replicates": args.replicates,
                   "stages_per_call": args.stages_per_call,
                   "seed": args.seed,
                   "backend": jax.default_backend(),
                   "schedule": "adaptive", "move_kernel": "hmc"},
        "log_evidence_mean": float(evs.mean()),
        "log_evidence_std": float(evs.std()),
        "exact_elbo": elbo,
        "kl_gap_nats": float(evs.mean() - elbo),
        "evidence_above_bound": bool(
            evs.mean() + 2 * evs.std() / max(len(evs) - 1, 1) ** 0.5
            > elbo),
        "stages_mean": float(np.mean(stage_counts)),
        "resamples_mean": float(np.mean(resamples)),
        "accept_mean": float(np.mean(acc_means)),
        "ess_min": float(np.min(ess_mins)),
        "first_beta": beta_first,
        "last_dbeta": beta_last,
        "wall_s_per_replicate": [round(w, 1) for w in wall],
    }
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result, indent=1))
    ok = result["kl_gap_nats"] > -3.0
    print("EVIDENCE >= BOUND OK" if ok
          else "EVIDENCE BELOW BOUND — estimator undermixed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
