"""Guarded Poisson CVI at scale on the GPU: n=1000, T=20, r=2.

Like the binary engine, the CVI weights are recomputed every iteration
(no constant-weight precompute), so per-iteration cost is genuine
O(n^2 T) contraction work — plus one extra moment pass per REJECTED
iteration from the guarded loop (none expected at this config).  The
probe records ms/iteration (slope method: two budgets, differenced, so
compile and fixed costs cancel) and recovery quality against the
generating log-rates.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from tame.config import ModelConfig
from tame.inference import cavi, fit_cavi_poisson
from tame.models import build_params, sample
from tame.ops import dyad as dyad_ops

n, T, r = 1000, 20, 2
cfg = ModelConfig(n_nodes=n, n_time=T, latent_dim=r, seed=0)
p = build_params(cfg)
Y, X = sample(p, jax.random.PRNGKey(0), n, T, family="poisson")
jax.block_until_ready(Y)
print("data ready", flush=True)


def fit(i, iters):
    init = cavi.init_state(jax.random.fold_in(jax.random.PRNGKey(0),
                                              10 + i), n, T, p.d,
                           "full", 0.1, 0.5)
    jax.block_until_ready(init)
    t0 = time.perf_counter()
    out = fit_cavi_poisson(Y, p, init, max_iter=iters,
                           learning_rate=0.7, tolerance=0.0)
    np.asarray(out.X_mean)  # host-fetch barrier
    return out, time.perf_counter() - t0


fit(0, 8)  # compile
_, t_small = fit(1, 8)
out, t_big = fit(2, 40)
ms = (t_big - t_small) / 32 * 1e3
print(f"poisson CVI n={n}: {ms:.1f} ms/iter (slope)", flush=True)
print(f"diverged={bool(out.diverged)} final step scale="
      f"{float(out.step_scale):.3f}", flush=True)

m_true = np.asarray(dyad_ops.dyadic_fwd_temporal(jnp.asarray(X), r))
m_est = np.asarray(dyad_ops.dyadic_fwd_temporal(out.X_mean, r))
off = ~np.eye(n, dtype=bool)
corr = np.corrcoef(m_true[off].ravel(), m_est[off].ravel())[0, 1]
dev = float(np.asarray(out.deviance_history)[39])
print(f"log-rate corr with truth: {corr:.3f}  mean deviance: {dev:.3f}",
      flush=True)
