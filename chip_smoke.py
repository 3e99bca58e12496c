"""Drive tame's main path once on an NVIDIA GPU and check what comes out.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded path only

Phases (one process; any failure exits non-zero, no phase carries on
after its own failure):

1. device   — JAX must report a CUDA GPU (no CPU fallback); prints the
              card's name and power limit and the compile-cache directory.
2. kernels  — at n=2000, T=50, d=10: the unrolled batched SPD solve,
              inverse and log-determinant on n*T = 100 000 systems
              against the LU solve under float32 "highest" matmul
              precision, and the forward-backward smoother on one block
              phase (250 nodes) and on all 2000 nodes against a float64
              dense solve of sampled nodes' systems on the host.
3. demo     — the reference workflow (n=15, T=10, r=2, lr=0.7, 150
              iterations): Naive and Good SMF reach the reference's
              MSE ~0.473, Bad diverges (MSE > 2).
4. scale    — the north-star deployment n=2000, T=50, r=4 (Y alone is
              1.6 GB in float32): Good SMF cold and warm, and the
              smoothed engine warm, each to its real stopping rule
              (tolerance 1e-4, patience 3), converged at the noise floor.

``--multi`` runs only ``__graft_entry__.dryrun_multichip(4)``: the CAVI
fit sharded over a (nodes=2, time=2) mesh against the single-device fit,
and HMC chains sharded on the batch axis against unsharded chains.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# The reference's own demo-config MSE (BASELINE.md: 0.472691 Naive, 0.472831
# Good SMF); Naive and Good must land within 5 % of it.
DEMO_MSE = 0.4728
# The engines' reconstruction MSE counts both directions of a dyad, so its
# noise floor is twice the dyadic noise variance (0.1) of every model here.
NOISE_FLOOR = 0.2
NOISE_BAND = 0.05              # |MSE / floor - 1| at convergence


def card_label() -> str:
    """The cards' names and power limits as ``nvidia-smi`` reports them,
    read in a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def phase_device(count: int) -> tuple[str, dict]:
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a CUDA GPU; JAX found "
                         f"platform {platform!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found "
                         f"{len(devices)}")
    from tame.utils.cache import enable_compile_cache

    label = card_label()
    print(f"[device] {label}")
    print(f"[device] jax {jax.__version__}: {len(devices)} x "
          f"{devices[0].device_kind}")
    print(f"[device] compile cache: {enable_compile_cache()}")
    info = {"platform": platform, "kind": devices[0].device_kind,
            "count": len(devices)}
    return label, info


def _check(name: str, got, ref, tol: float, why: str) -> None:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: non-finite values")
    err = float(np.max(np.abs(got - ref)))
    rel = err / float(np.max(np.abs(ref)))
    print(f"[kernels] {name}: max abs err {err:.3e}, max rel err "
          f"{rel:.3e} (tol {tol:.0e}: {why})")
    if not rel <= tol:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {tol}")


def phase_kernels(n: int = 2000, T: int = 50, d: int = 10,
                  block: int = 250) -> None:
    from tame.ops.cholesky import (
        batched_logdet_spd,
        batched_spd_solve,
        batched_spd_solve_inv,
    )
    from tame.ops.tridiag import block_tridiag_smoother, dense_precision

    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    B = n * T
    # SPD systems with eigenvalues in about [0.05, 4]: condition <= ~1e2.
    A = jax.random.normal(k1, (n, T, d, d))
    with jax.default_matmul_precision("highest"):
        P = A @ jnp.swapaxes(A, -1, -2) / d + 0.05 * jnp.eye(d)
    eta = jax.random.normal(k2, (n, T, d))
    mu, cov = jax.jit(batched_spd_solve_inv)(P, eta)
    mu_only = jax.jit(batched_spd_solve)(P, eta)
    logdet = jax.jit(batched_logdet_spd)(P)
    with jax.default_matmul_precision("highest"):
        mu_ref = jnp.linalg.solve(P, eta[..., None])[..., 0]
        cov_ref = jnp.linalg.inv(P)
        logdet_ref = jnp.linalg.slogdet(P)[1]
    why = (f"float32 Cholesky vs LU reference on {B} systems of condition "
           "<= ~1e2: error ~ cond * d * eps ~ 1e-4")
    _check(f"spd solve   ({B} x {d}x{d})", mu, mu_ref, 1e-3, why)
    _check(f"spd inverse ({B} x {d}x{d})", cov, cov_ref, 1e-3, why)
    _check(f"spd solve-only ({B} x {d}x{d})", mu_only, mu_ref, 1e-3, why)
    _check(f"spd logdet  ({B} x {d}x{d})", logdet, logdet_ref, 1e-4,
           "float32 sum of d logs of pivots")

    # Block-tridiagonal trajectory systems: D_t SPD, |O| small enough
    # that every Schur complement S_t stays well conditioned.
    G = jax.random.normal(k3, (n, T, d, d))
    with jax.default_matmul_precision("highest"):
        D = G @ jnp.swapaxes(G, -1, -2) / d + 3.0 * jnp.eye(d)
    O = 0.3 * jax.random.normal(k4, (d, d)) / np.sqrt(d)
    b = jax.random.normal(k5, (n, T, d))
    smooth = jax.jit(jax.vmap(
        lambda Di, bi: block_tridiag_smoother(Di, O, bi)))
    why = (f"float32 (matmuls pinned to highest) vs float64 dense solve; "
           f"reduction order differs over T={T} steps of well-conditioned "
           "(cond <~ 10) Schur complements")
    for m in (block, n):
        got = jax.device_get(smooth(D[:m], b[:m]))
        nodes = np.linspace(0, m - 1, 8).astype(int)
        ref = {"mean": [], "cov": [], "cross_cov": [], "logdet": []}
        for i in nodes:
            P = np.asarray(dense_precision(D[i], O), np.float64)
            C = np.linalg.inv(P)
            blk = C.reshape(T, d, T, d)
            ref["mean"].append(C @ np.asarray(b[i], np.float64).ravel())
            ref["cov"].append(blk[np.arange(T), :, np.arange(T), :])
            ref["cross_cov"].append(
                blk[np.arange(T - 1), :, np.arange(1, T), :])
            ref["logdet"].append(np.linalg.slogdet(P)[1])
        tag = f"(n={m}, T={T}, d={d}; {len(nodes)} nodes checked)"
        _check(f"smoother mean {tag}", got.mean[nodes].reshape(
            len(nodes), -1), ref["mean"], 1e-4, why)
        _check(f"smoother cov {tag}", got.cov[nodes], ref["cov"], 1e-4, why)
        _check(f"smoother cross_cov {tag}", got.cross_cov[nodes],
               ref["cross_cov"], 1e-4, why)
        _check(f"smoother logdet {tag}", got.logdet[nodes], ref["logdet"],
               1e-5, "float32 sum of T*d logs of pivots")


def phase_demo() -> None:
    from tame import (
        TemporalAMEModel,
        TemporalAMENaiveMFVI,
        TemporalAMEStructuredMFVI,
    )

    model = TemporalAMEModel(n_nodes=15, n_time=10, latent_dim=2, seed=42)
    model.generate_data()
    mse = {}
    for name, vi in [
            ("naive", TemporalAMENaiveMFVI(model, learning_rate=0.7)),
            ("good", TemporalAMEStructuredMFVI(model, factorization="good",
                                               learning_rate=0.7)),
            ("bad", TemporalAMEStructuredMFVI(model, factorization="bad",
                                              learning_rate=0.7))]:
        h = vi.fit(max_iter=150, verbose=False)
        mse[name] = float(h["reconstruction_error"][-1])
        print(f"[demo] {name}: {len(h['elbo'])} iterations, final ELBO "
              f"{h['elbo'][-1]:.4f}, MSE {mse[name]:.4f}")
    for name in ("naive", "good"):
        if not abs(mse[name] / DEMO_MSE - 1.0) < 0.05:
            raise AssertionError(f"demo: {name} MSE {mse[name]:.4f} is "
                                 f"not within 5 % of {DEMO_MSE}")
    if not mse["bad"] > 2.0:
        raise AssertionError(f"demo: bad MSE {mse['bad']:.4f} should "
                             "exceed 2 (the reference's divergence)")


def _peak_bytes() -> int:
    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def _fit(label: str, name: str, vi, max_iter: int,
         compiled_in: tuple[float, int] | None = None) -> tuple[float, int]:
    """Fit to the stopping rule, print the run's numbers, check that it
    converged at the noise floor; returns (wall time, iterations).

    ``compiled_in`` is the (wall, iterations) of the same engine's first,
    compiling fit: its compile time is its wall less its iterations at
    this fit's rate."""
    t0 = time.perf_counter()
    h = vi.fit(max_iter=max_iter, tolerance=1e-4, verbose=False)
    jax.block_until_ready(vi.get_variational_means())
    wall = time.perf_counter() - t0
    iters = len(h["elbo"])
    mse = float(h["reconstruction_error"][-1])
    peak = _peak_bytes()
    comp = ""
    if compiled_in is not None:
        compile_s = compiled_in[0] - compiled_in[1] * wall / iters
        comp = f", compile ~{compile_s:.2f} s"
    print(f"[scale] {name}: converged={vi._converged} after {iters} "
          f"iterations, wall to converged {wall:.3f} s "
          f"({1e3 * wall / iters:.2f} ms/iter){comp}, MSE {mse:.5f}, "
          f"peak device memory {peak / 2**30:.2f} GiB ({label})")
    if not vi._converged:
        raise AssertionError(f"{name}: did not meet the stopping rule in "
                             f"{max_iter} iterations")
    if not abs(mse / NOISE_FLOOR - 1.0) < NOISE_BAND:
        raise AssertionError(f"{name}: MSE {mse:.5f} is not at the noise "
                             f"floor {NOISE_FLOOR}")
    return wall, iters


def phase_scale(label: str, n: int = 2000, T: int = 50, r: int = 4,
                max_iter: int = 2048) -> None:
    from tame import TemporalAMECaviVI, TemporalAMEModel
    from tame.inference import TemporalAMESmoothedVI

    t0 = time.perf_counter()
    model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=r, seed=0)
    model.generate_data()
    jax.block_until_ready(model.Y)
    print(f"[scale] n={n}, T={T}, r={r}: Y {model.Y.shape} float32 "
          f"({model.Y.nbytes / 1e9:.2f} GB) generated in "
          f"{time.perf_counter() - t0:.2f} s")

    def good(**kw):
        # Good SMF (structure "full") through the base engine class, which
        # takes the block count.
        return TemporalAMECaviVI(
            model, structure="full", learning_rate=0.8,
            mixed_precision=True, diag_mode="stats", num_blocks=8, **kw)

    def smoothed(**kw):
        return TemporalAMESmoothedVI(
            model, learning_rate=0.8, update_mode="block", num_blocks=8,
            mixed_precision=True, diag_mode="stats", **kw)

    # Each engine's first fit compiles and runs; the timed fits after it
    # reuse the executable.  The smoothed warm fit is deterministic, so its
    # second run does the same work as the first without the compile.
    first = _fit(label, "good-smf cold, compiling", good(seed=1), max_iter)
    _fit(label, "good-smf cold", good(seed=2), max_iter, compiled_in=first)
    _fit(label, "good-smf warm", good(init_mode="warm"), max_iter)
    first = _fit(label, "smoothed warm, compiling",
                 smoothed(init_mode="warm"), max_iter)
    _fit(label, "smoothed warm", smoothed(init_mode="warm"), max_iter,
         compiled_in=first)


def phase_multi(n_devices: int) -> None:
    import __graft_entry__

    __graft_entry__.dryrun_multichip(n_devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded-vs-single path")
    args = ap.parse_args(argv)
    count = 4 if args.multi else 1
    label, info = phase_device(count)
    if args.multi:
        phase_multi(count)
    else:
        phase_kernels()
        phase_demo()
        phase_scale(label)
    print(f"[done] all phases passed ({label})")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
