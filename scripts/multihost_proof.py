"""Multi-host proof: a REAL multi-process `jax.distributed` fit.

The reference has no communication backend of any kind (SURVEY.md §5);
tame's multi-host story is `jax.distributed.initialize` + GSPMD over a
global mesh, with cross-host collectives over the network.  The virtual-mesh
tests (`tests/test_parallel.py`) prove the GSPMD program; this script
proves the *multi-process runtime path*: it spawns N independent
processes, each owning a disjoint set of CPU devices of one global mesh
(cross-process collectives run over Gloo — the CPU stand-in for the
inter-host network), runs
the full Good-SMF `fit_cavi` over the global `(nodes, time)` sharding, and
asserts the result equals a single-process golden fit.

Usage:
    python scripts/multihost_proof.py            # parent: golden + spawn
    python scripts/multihost_proof.py --worker i # internal

Writes MULTIHOST.json {processes, devices, n, T, iters, max_abs_dx,
elbo_rel_err, converged_check, ok} at the repo root.
"""
import json
import os
import subprocess
import sys
import tempfile

PORT = int(os.environ.get("TAME_MH_PORT", "47321"))
NPROC = 2
LOCAL_DEVICES = 4
N, T = 64, 16
R = 1  # latent_dim: r=1 (d=4) exercises the multiplicative blocks
MAX_ITER = 60


def _problem():
    import jax
    from tame.config import ModelConfig
    from tame.inference import cavi
    from tame.models import build_params, sample

    cfg = ModelConfig(n_nodes=N, n_time=T, latent_dim=R, seed=11)
    params = build_params(cfg)
    key = jax.random.PRNGKey(11)
    Y, _ = sample(params, key, N, T)
    init = cavi.init_state(key, N, T, cfg.d, "full", 0.1, 0.5)
    kw = dict(structure="full", update_mode="block", num_blocks=8,
              learning_rate=1.0, max_iter=MAX_ITER, tolerance=0.0)
    return params, Y, init, kw


def _configure_jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    # Share the repo's persistent compile cache (host-keyed: foreign
    # XLA:CPU AOT blobs can segfault, tame/utils/cache.py): repeat runs
    # and the pytest wrapper skip the fit_cavi recompiles.
    from tame.utils.cache import enable_persistent_cache

    enable_persistent_cache(jax)
    return jax


def golden(path: str) -> None:
    """Single-process, single-device fit — the trusted trajectory."""
    _configure_jax()
    import numpy as np

    from tame.inference import cavi

    params, Y, init, kw = _problem()
    out = cavi.fit_cavi(Y, params, init, **kw)
    np.savez(path, X_mean=np.asarray(out.X_mean),
             elbo=np.asarray(out.elbo_history)[:MAX_ITER])


def worker(pid: int, golden_path: str, out_path: str) -> None:
    jax = _configure_jax()
    from tame.parallel.distributed import initialize_distributed

    multi = initialize_distributed(
        coordinator_address=f"localhost:{PORT}",
        num_processes=NPROC, process_id=pid)
    assert multi and jax.process_count() == NPROC
    assert jax.device_count() == NPROC * LOCAL_DEVICES

    import jax.numpy as jnp
    import numpy as np

    from tame.inference import cavi
    from tame.parallel import make_mesh
    from tame.parallel.mesh import cov_sharding, obs_sharding, state_sharding

    # Global (nodes, time) mesh spanning BOTH processes: the nodes axis
    # crosses the process boundary, so the psum'd global statistics inside
    # every CAVI iteration traverse the inter-process link.
    mesh = make_mesh(nodes=4, time=2, devices=jax.devices())
    params, Y, init, kw = _problem()

    def put(arr, sharding):
        """Global array from identical per-process host data."""
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: np.asarray(arr)[idx])

    Y_s = put(Y, obs_sharding(mesh))
    init_s = cavi.CaviState(
        X_mean=put(init.X_mean, state_sharding(mesh)),
        X_cov=put(init.X_cov, cov_sharding(mesh)))

    out = cavi.fit_cavi(Y_s, params, init_s, **kw)
    jax.block_until_ready(out.X_mean)
    assert len(out.X_mean.sharding.device_set) == NPROC * LOCAL_DEVICES

    # Compare this process's addressable shards against the golden fit.
    gold = np.load(golden_path)
    gX, gE = gold["X_mean"], gold["elbo"]
    max_dx = 0.0
    for shard in out.X_mean.addressable_shards:
        max_dx = max(max_dx, float(np.max(np.abs(
            np.asarray(shard.data) - gX[shard.index]))))
    elbo = np.asarray(out.elbo_history)[:MAX_ITER]  # replicated
    rel_e = float(np.max(np.abs(elbo - gE) / np.abs(gE)))
    assert np.all(np.isfinite(elbo))
    assert max_dx < 5e-4, f"[p{pid}] multihost fit != golden: {max_dx}"
    assert rel_e < 1e-5, f"[p{pid}] ELBO trajectory off: {rel_e}"

    # The stopping rule must also work distributed (convergence decision is
    # a replicated scalar — every process must agree and halt together).
    conv = cavi.fit_cavi(Y_s, params, init_s, structure="full",
                         update_mode="block", num_blocks=8,
                         learning_rate=1.0, max_iter=128, tolerance=5e-4)
    jax.block_until_ready(conv.X_mean)
    assert bool(conv.converged)

    print(f"[p{pid}] OK max|dX|={max_dx:.2e} elbo_rel={rel_e:.2e} "
          f"converged@{int(conv.n_iter)}", flush=True)
    if pid == 0:
        with open(out_path, "w") as f:
            json.dump({"processes": NPROC,
                       "devices": NPROC * LOCAL_DEVICES,
                       "collective_backend": "gloo (inter-host network stand-in)",
                       "n": N, "T": T, "latent_dim": R,
                       "iters": MAX_ITER,
                       "max_abs_dx": max_dx,
                       "elbo_rel_err": rel_e,
                       "converged_iter": int(conv.n_iter),
                       "ok": True}, f, indent=1)


def main() -> int:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as td:
        gpath = os.path.join(td, "golden.npz")
        env = dict(os.environ)
        env["PYTHONPATH"] = repo
        env.pop("XLA_FLAGS", None)
        # Golden in a subprocess so the parent never initializes jax.
        subprocess.run([sys.executable, __file__, "--golden", gpath],
                       env=env, check=True, timeout=600)
        wenv = dict(env)
        wenv["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
        out_path = os.path.join(repo, "MULTIHOST.json")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--worker", str(i), gpath, out_path],
            env=wenv) for i in range(NPROC)]
        codes = [p.wait(timeout=600) for p in procs]
        print("worker exit codes:", codes, flush=True)
        return max(codes)


if __name__ == "__main__":
    if "--golden" in sys.argv:
        golden(sys.argv[2])
    elif "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), sys.argv[i + 2], sys.argv[i + 3])
    else:
        sys.exit(main())
