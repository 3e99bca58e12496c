"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The reference has no distributed execution to mirror (SURVEY.md §3.4); these
validate the new framework's mesh layouts: sharded fits must produce the
same numbers as single-device fits.
"""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tame.inference import cavi
from tame.models import TemporalAMEModel
from tame.parallel import make_mesh, obs_sharding, shard_fit_inputs, state_sharding

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _fit(Y, params, init, **kw):
    kw.setdefault("update_mode", "jacobi")
    return cavi.fit_cavi(Y, params, init, structure="full",
                         learning_rate=0.7, max_iter=20, **kw)


@pytest.fixture
def sharded_problem():
    model = TemporalAMEModel(n_nodes=16, n_time=8, latent_dim=2, seed=5)
    Y, _ = model.generate_data(return_latents=True)
    init = cavi.init_state(jax.random.PRNGKey(0), model.n, model.T, model.d,
                           "full", 0.1, 0.5)
    return model, Y, init


@requires_8
class TestShardedFit:
    @pytest.mark.parametrize("mesh_shape,update_mode", [
        ((8, 1), "jacobi"), ((4, 2), "jacobi"), ((2, 2), "jacobi"),
        ((1, 2), "jacobi"), ((4, 2), "block"), ((8, 1), "block")])
    def test_sharded_matches_single_device(self, sharded_problem,
                                           mesh_shape, update_mode):
        model, Y, init = sharded_problem
        kw = {"update_mode": update_mode}
        if update_mode == "block":
            kw["num_blocks"] = 4
        ref = _fit(Y, model.params, init, **kw)

        nodes_ax, time_ax = mesh_shape
        mesh = make_mesh(nodes=nodes_ax, time=time_ax,
                         devices=jax.devices()[:nodes_ax * time_ax])
        Y_s, init_s = shard_fit_inputs(mesh, Y, init)
        out = _fit(Y_s, model.params, init_s, **kw)

        assert np.allclose(np.asarray(ref.X_mean), np.asarray(out.X_mean),
                           atol=1e-4)
        ref_elbo = np.asarray(ref.elbo_history)[:int(ref.n_iter)]
        out_elbo = np.asarray(out.elbo_history)[:int(out.n_iter)]
        assert np.allclose(ref_elbo, out_elbo, rtol=1e-4)

    def test_output_sharding_preserved(self, sharded_problem):
        model, Y, init = sharded_problem
        mesh = make_mesh(nodes=4, time=2, devices=jax.devices()[:8])
        Y_s, init_s = shard_fit_inputs(mesh, Y, init)
        out = _fit(Y_s, model.params, init_s)
        # X_mean should come back sharded over the mesh, not replicated
        assert len(out.X_mean.sharding.device_set) == 8

    @pytest.mark.slow
    @pytest.mark.parametrize("family", ["bernoulli", "poisson"])
    def test_nongaussian_sharded_matches_single_device(self, family):
        """The weighted (JJ/CVI) engines are plain einsum contractions,
        so GSPMD shards them with no engine changes: the sharded fit
        must reproduce the single-device one."""
        from tame.config import ModelConfig
        from tame.inference import (
            cavi,
            fit_cavi_bernoulli,
            fit_cavi_poisson,
        )
        from tame.models import build_params, sample

        n, T = 32, 8
        p = build_params(ModelConfig(n_nodes=n, n_time=T, latent_dim=1,
                                     seed=0))
        fit = (fit_cavi_bernoulli if family == "bernoulli"
               else fit_cavi_poisson)
        Y, _ = sample(p, jax.random.PRNGKey(0), n, T, family=family)
        init = cavi.init_state(jax.random.PRNGKey(1), n, T, p.d,
                               "full", 0.1, 0.5)
        ref = fit(Y, p, init, max_iter=40, tolerance=0.0)
        mesh = make_mesh(nodes=4, time=2, devices=jax.devices()[:8])
        Y_s, init_s = shard_fit_inputs(mesh, Y, init)
        out = fit(Y_s, p, init_s, max_iter=40, tolerance=0.0)
        assert len(out.X_mean.sharding.device_set) == 8
        assert np.allclose(np.asarray(ref.X_mean),
                           np.asarray(out.X_mean), atol=1e-4)
        eh_r = np.asarray(ref.elbo_history)[:40]
        eh_o = np.asarray(out.elbo_history)[:40]
        assert np.allclose(eh_r, eh_o, rtol=1e-4)

    @pytest.mark.slow
    def test_smoothed_sharded_matches_single_device(self):
        """The smoothed (joint-trajectory) engine shards over the nodes
        axis: per-node block-tridiagonal solves are node-local, so the
        sharded fit must reproduce the single-device fit."""
        from tame.inference import smoothed
        from tame.parallel import shard_smoothed_inputs

        model = TemporalAMEModel(n_nodes=16, n_time=6, latent_dim=1,
                                 seed=11)
        Y, _ = model.generate_data(return_latents=True)
        init = smoothed.init_smoothed_state(jax.random.PRNGKey(0), 16, 6, 4)
        ref = smoothed.fit_cavi_smoothed(Y, model.params, init,
                                         max_iter=15, learning_rate=0.8,
                                         tolerance=0.0)

        mesh = make_mesh(nodes=4, devices=jax.devices()[:4])
        Y_s, init_s = shard_smoothed_inputs(mesh, Y, init)
        out = smoothed.fit_cavi_smoothed(Y_s, model.params, init_s,
                                         max_iter=15, learning_rate=0.8,
                                         tolerance=0.0)
        assert np.allclose(np.asarray(ref.state.X_mean),
                           np.asarray(out.state.X_mean), atol=1e-4)
        eh_r = np.asarray(ref.elbo_history)[:15]
        eh_o = np.asarray(out.elbo_history)[:15]
        assert np.allclose(eh_r, eh_o, rtol=1e-4)
        assert len(out.state.X_mean.sharding.device_set) == 4

        with pytest.raises(ValueError, match="nodes"):
            shard_smoothed_inputs(
                make_mesh(nodes=2, time=2, devices=jax.devices()[:4]),
                Y, init)

    @pytest.mark.slow
    def test_batch_axis_vmap_fits(self):
        """Replicate fits sharded over the batch axis (the sensitivity-sweep
        pattern, SURVEY.md §3.5)."""
        model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=1, seed=2)
        params = model.params
        keys = jax.random.split(jax.random.PRNGKey(1), 8)

        from tame.models import sample

        def one_fit(key):
            Y, _ = sample(params, key, 8, 4)
            init = cavi.init_state(key, 8, 4, 4, "full", 0.1, 0.5)
            out = cavi.fit_cavi(Y, params, init, structure="full",
                                learning_rate=0.7, max_iter=10)
            return out.mse_history[9]

        mses = jax.vmap(one_fit)(keys)
        assert mses.shape == (8,)
        assert np.all(np.isfinite(np.asarray(mses)))
        # distinct keys -> distinct data -> distinct results (fixes the
        # reference's broken-replicate-seed bug, SURVEY.md §2C-1)
        assert len(set(np.asarray(mses).round(6).tolist())) > 1


@requires_8
@pytest.mark.slow
def test_graft_entry_dryrun():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_graft_entry_single():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.isfinite(float(out[2]))


class TestDeterminism:
    def test_fit_bitwise_deterministic(self):
        """Two identical fits must be bitwise identical — the multi-host
        determinism story (SURVEY.md §5: no sanitizers on-device;
        determinism tests instead)."""
        model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=1, seed=9)
        Y, _ = model.generate_data(return_latents=True)
        init = cavi.init_state(jax.random.PRNGKey(0), 8, 4, 4, "full",
                               0.1, 0.5)
        a = cavi.fit_cavi(Y, model.params, init, structure="full",
                          update_mode="block", max_iter=15,
                          learning_rate=0.8)
        b = cavi.fit_cavi(Y, model.params, init, structure="full",
                          update_mode="block", max_iter=15,
                          learning_rate=0.8)
        assert np.array_equal(np.asarray(a.X_mean), np.asarray(b.X_mean))
        assert np.array_equal(np.asarray(a.elbo_history),
                              np.asarray(b.elbo_history), equal_nan=True)


class TestFailureDetection:
    def test_nan_divergence_halts_fit(self):
        """A blow-up must stop the loop and set the diverged flag rather
        than looping on NaNs (which the reference does silently)."""
        model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=1, seed=9)
        Y, _ = model.generate_data(return_latents=True)
        # poison the data to force a non-finite ELBO immediately
        Y_bad = jnp.asarray(Y).at[0, 1, 0, 0].set(jnp.nan)
        init = cavi.init_state(jax.random.PRNGKey(0), 8, 4, 4, "full",
                               0.1, 0.5)
        out = cavi.fit_cavi(Y_bad, model.params, init, structure="full",
                            max_iter=50, learning_rate=0.5)
        assert bool(out.diverged)
        assert int(out.n_iter) < 50


@requires_8
class TestShardedChains:
    """North-star config 4: MCMC chains / SMC particles sharded over the
    ``batch`` mesh axis. Sharded runs must reproduce the unsharded numbers
    exactly (chains are independent; sharding only changes placement)."""

    @pytest.fixture(scope="class")
    def tiny_model(self):
        model = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=1, seed=7)
        model.generate_data(return_latents=True)
        return model

    @pytest.mark.slow
    def test_hmc_64_sharded_chains(self, tiny_model):
        from tame.inference import TemporalAMEHMC
        from tame.parallel import make_mesh

        mesh = make_mesh(batch=8)
        hmc = TemporalAMEHMC(tiny_model, num_chains=64, num_leapfrog=5,
                             seed=3, precondition=False)
        out = hmc.sample(num_warmup=15, num_samples=15, mesh=mesh)
        assert out.positions.shape[:2] == (64, 15)
        # chains actually live across all 8 devices
        assert len(out.positions.sharding.device_set) == 8

        ref = hmc.sample(num_warmup=15, num_samples=15)
        assert np.allclose(np.asarray(ref.positions),
                           np.asarray(out.positions), atol=1e-5)

    @pytest.mark.slow
    def test_nuts_sharded_chains(self, tiny_model):
        from tame.inference import TemporalAMENUTS
        from tame.parallel import make_mesh

        mesh = make_mesh(batch=8)
        nuts = TemporalAMENUTS(tiny_model, num_chains=8, max_depth=4,
                               seed=3, precondition=False)
        out = nuts.sample(num_warmup=10, num_samples=10, mesh=mesh)
        assert out.positions.shape[:2] == (8, 10)
        ref = nuts.sample(num_warmup=10, num_samples=10)
        # the binary U-turn decision amplifies reduction-order float
        # differences chaotically, so sharded/unsharded trajectories are
        # not bitwise comparable (unlike fixed-length HMC); check the
        # sampler is statistically unchanged instead
        assert np.all(np.isfinite(np.asarray(out.positions)))
        m_ref = np.asarray(ref.positions).mean(axis=(0, 1))
        m_out = np.asarray(out.positions).mean(axis=(0, 1))
        assert np.allclose(m_ref, m_out, atol=0.5)

    @pytest.mark.slow
    def test_smc_sharded_particles(self, tiny_model):
        from tame.inference import TemporalAMESMC
        from tame.parallel import make_mesh

        mesh = make_mesh(batch=8)
        smc = TemporalAMESMC(tiny_model, num_particles=64, num_stages=5,
                             num_moves=1, seed=3, precondition=False)
        out = smc.sample(mesh=mesh)
        assert out.particles.shape[0] == 64
        assert len(out.particles.sharding.device_set) == 8
        ref = smc.sample()
        # resampling gathers across shards; numerics identical up to
        # reduction order in the logsumexp collectives
        assert np.allclose(np.asarray(ref.particles),
                           np.asarray(out.particles), atol=1e-4)
        assert np.allclose(float(ref.log_evidence),
                           float(out.log_evidence), atol=1e-4)


class TestDistributedHelpers:
    def test_initialize_single_process_noop(self):
        from tame.parallel import initialize_distributed

        assert initialize_distributed() is False

    def test_global_mesh(self):
        from tame.parallel import global_mesh

        mesh = global_mesh()
        assert mesh.devices.size == len(jax.devices())

    @requires_8
    @pytest.mark.slow
    def test_measure_scaling_efficiency(self):
        from tame.parallel import measure_scaling_efficiency

        model = TemporalAMEModel(n_nodes=16, n_time=4, latent_dim=1,
                                 seed=2)
        Y, _ = model.generate_data(return_latents=True)
        init = cavi.init_state(jax.random.PRNGKey(0), 16, 4, 4, "full",
                               0.1, 0.5)

        def fit_fn(Y_s, init_s, mesh):
            out = cavi.fit_cavi(Y_s, model.params, init_s,
                                structure="full", max_iter=5,
                                learning_rate=0.5)
            jax.block_until_ready(out)

        results = measure_scaling_efficiency(fit_fn, Y, init, [1, 2])
        assert set(results) == {1, 2}
        assert results[1]["efficiency"] == 1.0
        assert results[2]["wall_s"] > 0

    @requires_8
    @pytest.mark.slow
    def test_measure_weak_scaling(self):
        from tame.models import sample
        from tame.parallel import measure_weak_scaling

        model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=1, seed=2)
        params = model.params

        def problem_fn(count):
            n = 8 * count
            Y, _ = sample(params, jax.random.PRNGKey(count), n, 4)
            init = cavi.init_state(jax.random.PRNGKey(0), n, 4, 4,
                                   "full", 0.1, 0.5)
            return Y, init

        def fit_fn(Y_s, init_s, mesh):
            out = cavi.fit_cavi(Y_s, params, init_s, structure="full",
                                max_iter=5, learning_rate=0.5)
            jax.block_until_ready(out)

        results = measure_weak_scaling(problem_fn, fit_fn, [1, 2])
        assert results[1]["efficiency"] == 1.0
        assert results[2]["wall_s"] > 0


@requires_8
class TestCommAnalysis:
    """Compiled-HLO communication profile of the sharded fit — the
    evidence behind the multi-host efficiency argument."""

    def test_profile_invariants(self):
        from tame.parallel.comm_analysis import analyze_sharded_fit

        prof = analyze_sharded_fit(64, 8, 2, nodes=4, time_axis=2,
                                   num_blocks=8)
        assert prof["collective_bytes"] > 0
        assert prof["flops"] > 0
        halo = prof["collectives"].get(
            "collective-permute", {"bytes": 0})["bytes"]
        gathers = prof["collectives"].get(
            "all-gather", {"bytes": 0})["bytes"]
        # The time-axis halo (cross-host traffic in the multi-host
        # layout) is far below the node-axis mean gathers (intra-host).
        assert halo > 0 and gathers > 0
        assert halo * 10 < gathers
        # Invariant of the sufficient-statistics design: cross-shard
        # traffic carries latent MEANS, never observation-sized tensors.
        obs_bytes = 64 * 64 * 8 * 2 * 4
        assert prof["collective_bytes"] < obs_bytes

    def test_nodes_only_mesh_has_no_halo(self):
        from tame.parallel.comm_analysis import analyze_sharded_fit

        prof = analyze_sharded_fit(32, 4, 1, nodes=8, time_axis=1,
                                   num_blocks=8)
        assert "collective-permute" not in prof["collectives"]


@pytest.mark.slow
class TestMultiprocessDistributed:
    """REAL multi-process `jax.distributed` path (SURVEY.md §5 distributed
    comm backend): two OS processes, each owning 4 CPU devices of one
    8-device global mesh, cross-process collectives over Gloo (the CPU
    stand-in for the inter-host network).  The proof script asserts the
    globally-sharded fit equals a single-process golden and that the
    distributed stopping rule agrees across processes; see
    MULTIHOST.json."""

    @pytest.mark.slow
    def test_two_process_fit_matches_single_process(self, tmp_path):
        import json
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo
        env["TAME_MH_PORT"] = "47331"  # avoid clashing with manual runs
        r = subprocess.run(
            [sys.executable, f"{repo}/scripts/multihost_proof.py"],
            cwd=repo, env=env, capture_output=True, text=True, timeout=840)
        assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
        with open(f"{repo}/MULTIHOST.json") as f:
            data = json.load(f)
        assert data["ok"] and data["processes"] == 2
        assert data["max_abs_dx"] < 5e-4
        assert data["elbo_rel_err"] < 1e-5
