"""Hyperparameter learning at north-star scale on the GPU:
fit_em at n=2000, T=50, r=4 from a wrong starting guess."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from tame.config import ModelConfig
from tame.inference import fit_em
from tame.models import build_params, sample

cfg = ModelConfig(n_nodes=2000, n_time=50, latent_dim=4, seed=0,
                  ar_coefficient=0.8, rho_dyadic=0.5)
Y, _ = sample(build_params(cfg), jax.random.PRNGKey(0), 2000, 50)
jax.block_until_ready(Y)
print("data ready", flush=True)

cfg0 = ModelConfig(n_nodes=2000, n_time=50, latent_dim=4, seed=0,
                   ar_coefficient=0.3, rho_dyadic=0.0,
                   dyadic_variance=1.0)
t0 = time.perf_counter()
res = fit_em(Y, build_params(cfg0), n_em=10, inner_max_iter=60,
             mixed_precision=True, diag_mode="stats", verbose=True)
wall = time.perf_counter() - t0
h = res.history
print(f"fit_em n=2000: {len(h['elbo'])} EM iterations in {wall:.1f}s "
      f"(incl. compile)", flush=True)
print(f"phi={h['phi'][-1]:.3f} (true 0.8)  "
      f"sigma2={h['sigma2'][-1]:.4f} (true 0.1)  "
      f"rho={h['rho'][-1]:.3f} (true 0.5)", flush=True)

# ---- binary leg (round-5): non-Gaussian EM at scale -----------------------
# The binary smoothed E-step has no mixed-precision/stats fast path (its
# weights are iteration-dependent), so the leg runs at n=1000 — still 5x
# the test scale, on the GPU.
cfgb = ModelConfig(n_nodes=1000, n_time=20, latent_dim=2, seed=1,
                   ar_coefficient=0.8)
Yb, _ = sample(build_params(cfgb), jax.random.PRNGKey(1), 1000, 20,
               family="bernoulli")
jax.block_until_ready(Yb)
print("binary data ready", flush=True)
cfgb0 = ModelConfig(n_nodes=1000, n_time=20, latent_dim=2, seed=1,
                    ar_coefficient=0.3)
t0 = time.perf_counter()
resb = fit_em(Yb, build_params(cfgb0), family="bernoulli", n_em=8,
              inner_max_iter=60, learning_rate=0.7, verbose=True)
wallb = time.perf_counter() - t0
hb = resb.history
print(f"fit_em binary n=1000: {len(hb['elbo'])} EM iterations in "
      f"{wallb:.1f}s (incl. compile)", flush=True)
print(f"phi={hb['phi'][-1]:.3f} (true 0.8)", flush=True)
