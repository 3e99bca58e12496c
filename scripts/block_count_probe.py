"""Probe num_blocks tradeoff at the north-star config on the GPU: per-iter
time (slope) and iterations-to-converged for 4/8/16 block phases."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from tame.config import ModelConfig
from tame.inference import cavi
from tame.models import build_params, sample

cfg = ModelConfig(n_nodes=2000, n_time=50, latent_dim=4, seed=0)
params = build_params(cfg)
key = jax.random.PRNGKey(0)
Y, _ = sample(params, key, cfg.n_nodes, cfg.n_time)
jax.block_until_ready(Y)
print("data ready", flush=True)


def run(nb, i, iters, tol):
    init = cavi.init_state(jax.random.fold_in(key, 300 + i), cfg.n_nodes,
                           cfg.n_time, cfg.d, "full", 0.1, 0.5)
    jax.block_until_ready(init)
    t0 = time.perf_counter()
    out = cavi.fit_cavi(Y, params, init, structure="full",
                        update_mode="block", num_blocks=nb,
                        max_iter=iters, learning_rate=0.8, tolerance=tol,
                        mixed_precision=True, diag_mode="stats")
    np.asarray(out.X_mean)
    return out, time.perf_counter() - t0


for nb in (4, 8, 16):
    run(nb, 0, 8, 0.0)  # compile
    _, t_small = run(nb, 1, 8, 0.0)
    _, t_big = run(nb, 2, 40, 0.0)
    ms = (t_big - t_small) / 32 * 1e3
    out, wall = run(nb, 3, 512, 1e-4)
    print(f"num_blocks={nb:2d}: {ms:6.2f} ms/iter | converged="
          f"{bool(out.converged)} at iter {int(out.n_iter)} "
          f"in {wall:.2f}s | final mse "
          f"{float(np.asarray(out.mse_history)[int(out.n_iter)-1]):.4f}",
          flush=True)
