"""Time each hand-written kernel against what XLA makes of the plain
version, on one GPU, at the north-star widths (n=2000, T=50, d=10).

    python scripts/kernel_bench.py [--out results.json] [--trace DIR]

Sections (each prints its numbers; variants are timed in turns within
one process, so they share the card, its clocks and its power limit):

1. spd       — batched SPD solve + inverse and log-determinant on
               n*T = 100 000 systems of 10 x 10: the unrolled Cholesky of
               ``tame.ops.cholesky`` (batch on the trailing axis, and on
               the leading axis) against ``jnp.linalg.cholesky`` +
               ``cho_solve`` (cuSOLVER / cuBLAS batched); with
               ``--trace``, the kernels XLA made of one unrolled solve.
2. smoother  — ``vmap(block_tridiag_smoother)`` (sequential scan)
               against the associative-scan ``ptridiag`` smoother, on one
               block phase (250 nodes) and on all 2000 nodes.
3. fits      — per-iteration time by slope (two fixed iteration counts,
               same executable) of the n=2000 Good-SMF fit with each SPD
               path and of the n=2000 smoothed fit with each smoother;
               and the demo-config (n=15, T=10, r=2) XLA loop, with its
               kernel launches per iteration read from a profiler trace
               when ``--trace`` is given.

Needs a CUDA GPU; exits non-zero on any other backend.
"""

from __future__ import annotations

import argparse
import glob
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tame.config import ModelConfig  # noqa: E402
from tame.inference import cavi  # noqa: E402
from tame.inference import smoothed as smoothed_mod  # noqa: E402
from tame.models import build_params, sample  # noqa: E402
from tame.ops import cholesky  # noqa: E402
from tame.ops.ptridiag import parallel_block_tridiag_smoother  # noqa: E402
from tame.ops.tridiag import block_tridiag_smoother  # noqa: E402
from tame.utils.cache import enable_compile_cache  # noqa: E402

N, T, D = 2000, 50, 10
RESULTS: dict = {}


def timed_in_turns(fns: dict, args: tuple, reps: int = 10,
                   rounds: int = 2) -> dict:
    """Median wall time (s) of each jitted fn, timed in turns A..Z, Z..A."""
    for f in fns.values():
        jax.block_until_ready(f(*args))            # compile + warm
    times = {k: [] for k in fns}
    order = list(fns)
    for rnd in range(2 * rounds):
        for k in (order if rnd % 2 == 0 else order[::-1]):
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fns[k](*args))
                times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


def report(section: str, res: dict, unit: float = 1e6,
           name: str = "us") -> None:
    RESULTS[section] = {k: v * unit for k, v in res.items()}
    for k, v in res.items():
        print(f"[{section}] {k}: {v * unit:.1f} {name}", flush=True)


def _leading(P, eta):
    """The unrolled algorithm with the batch on the leading axis (entries
    are strided slices of the (B, d, d) array)."""
    d = P.shape[-1]
    L, inv_diag, _ = cholesky.unrolled_cholesky(
        [[P[..., i, j] for j in range(d)] for i in range(d)], d)
    mu = cholesky.unrolled_solve(L, inv_diag,
                                 [eta[..., i] for i in range(d)], d)
    inv = cholesky.unrolled_inverse(L, inv_diag, d)
    return (jnp.stack(mu, -1),
            jnp.stack([jnp.stack(row, -1) for row in inv], -2))


def _cusolver(P, eta):
    chol = jnp.linalg.cholesky(P)
    eye = jnp.broadcast_to(jnp.eye(P.shape[-1], dtype=P.dtype), P.shape)
    cov = jax.scipy.linalg.cho_solve((chol, True), eye)
    mu = jax.scipy.linalg.cho_solve((chol, True), eta[..., None])[..., 0]
    return mu, cov


def _cusolver_logdet(P):
    chol = jnp.linalg.cholesky(P)
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)),
                         axis=-1)


def section_spd(trace_dir: str | None) -> None:
    key = jax.random.PRNGKey(0)
    A = jax.random.normal(key, (N, T, D, D))
    P = A @ jnp.swapaxes(A, -1, -2) / D + 0.05 * jnp.eye(D)
    eta = jax.random.normal(jax.random.fold_in(key, 1), (N, T, D))
    report("spd solve+inverse", timed_in_turns({
        "unrolled, batch trailing": jax.jit(cholesky.batched_spd_solve_inv),
        "unrolled, batch leading": jax.jit(_leading),
        "cusolver cholesky + cho_solve": jax.jit(_cusolver),
    }, (P, eta)))
    report("spd logdet", timed_in_turns({
        "unrolled, batch trailing": jax.jit(cholesky.batched_logdet_spd),
        "cusolver cholesky": jax.jit(_cusolver_logdet),
    }, (P,)))
    if trace_dir:
        # How many kernels XLA made of one unrolled solve + inverse.
        fn = jax.jit(cholesky.batched_spd_solve_inv)
        jax.block_until_ready(fn(P, eta))
        with jax.profiler.trace(f"{trace_dir}/spd"):
            jax.block_until_ready(fn(P, eta))
        RESULTS["spd trace"] = count_device_events(f"{trace_dir}/spd", 1)


def section_smoother() -> None:
    key = jax.random.PRNGKey(1)
    G = jax.random.normal(key, (N, T, D, D))
    Dm = G @ jnp.swapaxes(G, -1, -2) / D + 3.0 * jnp.eye(D)
    O = 0.3 * jax.random.normal(jax.random.fold_in(key, 1), (D, D)) / D**.5
    b = jax.random.normal(jax.random.fold_in(key, 2), (N, T, D))
    Phi = 0.8 * jnp.eye(D)
    Q = 0.1 * jnp.eye(D)
    for m in (250, N):
        args = (Dm[:m], b[:m])
        fns = {
            "vmap(block_tridiag_smoother)": jax.jit(jax.vmap(
                lambda Di, bi: block_tridiag_smoother(Di, O, bi))),
            # same system size and depth; its own parameterisation
            "vmap(parallel_block_tridiag_smoother)": jax.jit(jax.vmap(
                lambda Ji, bi: parallel_block_tridiag_smoother(
                    Ji, bi, Phi, Q, Q))),
        }
        report(f"smoother n={m}", timed_in_turns(fns, args))


def slope(run, lo: int, hi: int, reps: int = 3) -> float:
    """Seconds per iteration between two fixed iteration counts."""
    run(lo)
    run(hi)

    def t(k):
        vals = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(k)
            vals.append(time.perf_counter() - t0)
        return statistics.median(vals)
    return (t(hi) - t(lo)) / (hi - lo)


def section_fits(trace_dir: str | None) -> None:
    cfg = ModelConfig(n_nodes=N, n_time=T, latent_dim=4, seed=0)
    params = build_params(cfg)
    key = jax.random.PRNGKey(0)
    Y, _ = sample(params, key, N, T)
    init = cavi.init_state(jax.random.fold_in(key, 901), N, T, cfg.d,
                           "full", 0.1, 0.5)

    def good(k):
        out = cavi.fit_cavi(Y, params, init, structure="full",
                            update_mode="block", num_blocks=8, max_iter=k,
                            learning_rate=0.8, tolerance=0.0,
                            mixed_precision=True, diag_mode="stats")
        jax.block_until_ready(out)

    res = {}
    originals = (cavi.batched_spd_solve_inv, cavi.batched_logdet_spd)
    for name, solve, logdet in [
            ("unrolled", *originals),
            ("cusolver", lambda P, e: _cusolver(P, e), _cusolver_logdet),
            ("unrolled (again)", *originals)]:
        cavi.batched_spd_solve_inv, cavi.batched_logdet_spd = solve, logdet
        jax.clear_caches()
        res[f"good-smf n={N} ms/iter, spd {name}"] = slope(good, 10, 50)
    cavi.batched_spd_solve_inv, cavi.batched_logdet_spd = originals
    jax.clear_caches()

    sinit = smoothed_mod.warm_init_smoothed_state(Y, params)
    for name, kw in [("sequential scan", dict(smoother="sequential")),
                     ("ptridiag", dict(smoother="parallel")),
                     ("sequential scan (again)",
                      dict(smoother="sequential"))]:
        def sm(k, kw=kw):
            out = smoothed_mod.fit_cavi_smoothed(
                Y, params, sinit, max_iter=k, learning_rate=0.8,
                tolerance=0.0, update_mode="block", num_blocks=8,
                mixed_precision=True, diag_mode="stats", **kw)
            jax.block_until_ready(out)
        res[f"smoothed n={N} ms/iter, {name}"] = slope(sm, 8, 40)
    report("fits", res, unit=1e3, name="ms/iter")

    dcfg = ModelConfig(n_nodes=15, n_time=10, latent_dim=2,
                       ar_coefficient=0.8, rho_dyadic=0.5, seed=42)
    dparams = build_params(dcfg)
    dY, _ = sample(dparams, jax.random.PRNGKey(42), 15, 10)
    dinit = cavi.init_state(jax.random.PRNGKey(3), 15, 10, dcfg.d, "full",
                            0.1, 0.5)

    def demo(k):
        out = cavi.fit_cavi(dY, dparams, dinit, structure="full",
                            update_mode="jacobi", max_iter=k,
                            learning_rate=0.7, tolerance=0.0,
                            diag_mode="exact")
        jax.block_until_ready(out)
    report("demo loop", {"good-smf n=15 us/iter (XLA while loop)":
                         slope(demo, 520, 1020, reps=5)})
    if trace_dir:
        demo(1020)
        with jax.profiler.trace(f"{trace_dir}/demo"):
            demo(1020)
        RESULTS["demo trace"] = count_device_events(f"{trace_dir}/demo",
                                                    1020)


def count_device_events(trace_dir: str, iters: int) -> dict:
    """Kernel events per iteration on the GPU planes of the newest trace."""
    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb",
                            recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            if not events:
                continue
            busy = sum(e.duration_ns for e in events)
            span = max(e.end_ns for e in events) - min(e.start_ns
                                                       for e in events)
            names = {}
            for e in events:
                names[e.name] = names.get(e.name, 0) + 1
            top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
            key = f"{plane.name} / {line.name}"
            out[key] = {"events": len(events),
                        "events_per_iter": len(events) / iters,
                        "busy_us_per_iter": busy / iters / 1e3,
                        "span_us_per_iter": span / iters / 1e3,
                        "top": top}
            print(f"[trace] {key}: {len(events)} events, "
                  f"{len(events) / iters:.1f}/iter, busy "
                  f"{busy / iters / 1e3:.2f} us/iter, span "
                  f"{span / iters / 1e3:.2f} us/iter; top {top}",
                  flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the numbers as JSON here")
    ap.add_argument("--trace", help="profiler trace directory for the "
                                    "kernel counts of the SPD solve and "
                                    "the demo loop")
    ap.add_argument("--sections", default="spd,smoother,fits")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"kernel_bench: needs a CUDA GPU, found "
                         f"{dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}; jax {jax.__version__}; {dev.device_kind}; "
          f"cache {enable_compile_cache()}", flush=True)
    RESULTS["device"] = {"nvidia_smi": card, "kind": dev.device_kind}
    sections = {"spd": lambda: section_spd(args.trace),
                "smoother": section_smoother,
                "fits": lambda: section_fits(args.trace)}
    failed = []
    for name in args.sections.split(","):
        try:
            sections[name]()
        except Exception as e:  # report and go on to the next section
            import traceback

            traceback.print_exc()
            failed.append(f"{name}: {type(e).__name__}: {e}")
    RESULTS["failed"] = failed
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(RESULTS, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
