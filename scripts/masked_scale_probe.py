"""Masked (missing-data) fit at north-star scale on the GPU:
n=2000, T=50, r=4, 30% of dyads hidden.

Measures the per-iteration slope of three configurations:

  dense      — no mask, production path (stats diagnostics + bf16
               weights): the reference point;
  masked-old — mask with exact diagnostics + f32 mask contractions
               (the only masked path before round 4: ~2.7x dense);
  masked-new — mask on the production path (masked sufficient-
               statistics diagnostics + bf16 mask/weights,
               cavi._masked_residual_stats): target <= ~1.3x dense.

Also reports observed-vs-held-out reconstruction MSE of the new path.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from tame.config import ModelConfig
from tame.inference import cavi
from tame.models import build_params, random_dyad_mask, sample

cfg = ModelConfig(n_nodes=2000, n_time=50, latent_dim=4, seed=0)
params = build_params(cfg)
key = jax.random.PRNGKey(0)
Y, _ = sample(params, key, cfg.n_nodes, cfg.n_time)
mask = random_dyad_mask(jax.random.fold_in(key, 1), cfg.n_nodes,
                        cfg.n_time, 0.3)
jax.block_until_ready((Y, mask))
print("data ready", flush=True)


def fit(i, iters, **kw):
    init = cavi.init_state(jax.random.fold_in(key, 100 + i), cfg.n_nodes,
                           cfg.n_time, cfg.d, "full", 0.1, 0.5)
    jax.block_until_ready(init)
    t0 = time.perf_counter()
    out = cavi.fit_cavi(Y, params, init, structure="full",
                        update_mode="block", num_blocks=8,
                        max_iter=iters, learning_rate=0.8,
                        tolerance=0.0, **kw)
    np.asarray(out.X_mean)  # host fetch barrier (CLAUDE.md)
    return out, time.perf_counter() - t0


def slope(tag, i0, **kw):
    """ms/iter from the slope between 8- and 40-iter fits (removes the
    fixed dispatch cost); distinct inits defeat transport caching."""
    fit(i0, 8, **kw)  # compile
    _, t_small = fit(i0 + 1, 8, **kw)
    out, t_big = fit(i0 + 2, 40, **kw)
    ms = (t_big - t_small) / (40 - 8) * 1e3
    print(f"{tag}: {ms:.2f} ms/iter", flush=True)
    return out, ms


_, ms_dense = slope("dense (stats+mp)", 0,
                    mixed_precision=True, diag_mode="stats")
_, ms_old = slope("masked-old (exact, f32)", 10, mask=mask)
out, ms_new = slope("masked-new (stats+mp, bf16 mask)", 50, mask=mask,
                    mixed_precision=True, diag_mode="stats")
print(f"masked-new / dense ratio: {ms_new / ms_dense:.2f}x "
      f"(exact-f32 was {ms_old / ms_dense:.2f}x)", flush=True)
# Production cadence: evaluating the (cheap but not free) diagnostics
# every 4th iteration amortizes the two masked diagnostic passes; the
# update itself is 2 W-passes + 1 mask-pass vs the dense 2 W-passes.
_, ms_dense4 = slope("dense (stats+mp, elbo_every=4)", 30,
                     mixed_precision=True, diag_mode="stats",
                     elbo_every=4)
_, ms_new4 = slope("masked-new (stats+mp, elbo_every=4)", 40, mask=mask,
                   mixed_precision=True, diag_mode="stats",
                   elbo_every=4)
print(f"elbo_every=4 masked/dense: {ms_new4 / ms_dense4:.2f}x; "
      f"masked-every-4 vs dense-every-1: "
      f"{ms_new4 / ms_dense:.2f}x", flush=True)

from tame.ops import dyad as dyad_ops

mu = jax.jit(lambda m: dyad_ops.dyadic_fwd_temporal(
    m, cfg.latent_dim))(out.X_mean)
e2 = (Y[..., 0] - mu) ** 2
off = 1.0 - jnp.eye(cfg.n_nodes)[:, :, None]
held = off * (1.0 - mask)
mse_obs = float(jnp.sum(e2 * mask) / jnp.sum(mask))
mse_held = float(jnp.sum(e2 * held) / jnp.sum(held))
print(f"observed MSE {mse_obs:.4f}  held-out MSE {mse_held:.4f} "
      f"(R noise floor 0.1)", flush=True)
