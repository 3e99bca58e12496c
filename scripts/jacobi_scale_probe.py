"""Is Jacobi stable at n=2000?  Compares MSE trajectories vs block-GS.

Decides whether a single-pass dual contraction (Jacobi-only) is worth
building: Jacobi halves the per-iteration HBM traffic but loses
within-sweep freshness, so it only wins if it converges at a workable
damping without needing ~4x the iterations.
"""
import time

import jax
import numpy as np

from tame.config import ModelConfig
from tame.inference import cavi
from tame.models import build_params, sample

n, T, r = 2000, 50, 4
cfg = ModelConfig(n_nodes=n, n_time=T, latent_dim=r, seed=0)
params = build_params(cfg)
key = jax.random.PRNGKey(0)
print("generating...", flush=True)
Y, _ = sample(params, key, n, T)
jax.block_until_ready(Y)

init = cavi.init_state(jax.random.fold_in(key, 1), n, T, cfg.d,
                       "full", 0.1, 0.5)
jax.block_until_ready(init)


def run(mode, lr, iters=60, **kw):
    t0 = time.perf_counter()
    out = cavi.fit_cavi(Y, params, init, structure="full",
                        update_mode=mode, max_iter=iters,
                        learning_rate=lr, tolerance=0.0,
                        mixed_precision=True, diag_mode="stats", **kw)
    mh = np.asarray(out.mse_history)[:iters]
    dt = time.perf_counter() - t0
    tag = f"{mode} lr={lr}"
    print(f"{tag:22s} mse[0,5,10,20,40,59] = "
          + " ".join(f"{mh[i]:.4f}" for i in (0, 5, 10, 20, 40, 59))
          + f"  ({dt:.1f}s incl compile)", flush=True)


run("block", 0.8, num_blocks=8)
run("jacobi", 0.8)
run("jacobi", 0.5)
run("jacobi", 0.3)
