"""Tests for the probabilistic layer: log-prob, HMC, SMC.

Validation strategy (north-star config 4): the vectorized log densities are
checked against direct numpy computation; HMC/SMC posterior means are
cross-validated against the CAVI variational means within loose Monte-Carlo
error on a tiny model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tame.inference import (
    TemporalAMEHMC,
    TemporalAMESMC,
    log_joint,
    log_likelihood,
    log_prior,
    make_logdensity_fn,
    run_hmc,
    run_smc,
)
from tame.inference.smc import effective_sample_size, systematic_resample
from tame.models import TemporalAMEModel

LOG2PI = np.log(2 * np.pi)


@pytest.fixture(scope="module")
def tiny():
    model = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=1,
                             ar_coefficient=0.8, seed=7)
    Y, X = model.generate_data(return_latents=True)
    return model, np.asarray(Y), np.asarray(X)


class TestLogProb:
    def test_log_prior_matches_numpy(self, tiny):
        model, Y, X = tiny
        params = model.params
        S0 = np.asarray(params.Sigma0)
        Q = np.asarray(params.Q)
        Phi = np.asarray(params.Phi)
        n, T, d = X.shape

        expected = 0.0
        S0_inv = np.linalg.inv(S0)
        Q_inv = np.linalg.inv(Q)
        for i in range(n):
            x0 = X[i, 0]
            expected += -0.5 * (x0 @ S0_inv @ x0
                                + np.linalg.slogdet(S0)[1] + d * LOG2PI)
            for t in range(1, T):
                r = X[i, t] - Phi @ X[i, t - 1]
                expected += -0.5 * (r @ Q_inv @ r
                                   + np.linalg.slogdet(Q)[1] + d * LOG2PI)
        got = float(log_prior(params, jnp.asarray(X)))
        assert got == pytest.approx(expected, rel=1e-4)

    def test_log_likelihood_matches_numpy(self, tiny):
        model, Y, X = tiny
        params = model.params
        R = np.asarray(params.R)
        R_inv = np.linalg.inv(R)
        n, T, d = X.shape
        r_dim = model.r

        expected = 0.0
        for t in range(T):
            a = X[:, t, 0]
            b = X[:, t, 1]
            U = X[:, t, 2:2 + r_dim]
            V = X[:, t, 2 + r_dim:]
            for i in range(n):
                for j in range(i + 1, n):
                    mu = np.array([a[i] + b[j] + U[i] @ V[j],
                                   a[j] + b[i] + U[j] @ V[i]])
                    resid = Y[i, j, t] - mu
                    expected += -0.5 * (resid @ R_inv @ resid
                                        + np.linalg.slogdet(R)[1]
                                        + 2 * LOG2PI)
        got = float(log_likelihood(params, jnp.asarray(Y), jnp.asarray(X)))
        assert got == pytest.approx(expected, rel=1e-4)

    def test_log_joint_is_sum(self, tiny):
        model, Y, X = tiny
        params = model.params
        lj = float(log_joint(params, jnp.asarray(Y), jnp.asarray(X)))
        lp = float(log_prior(params, jnp.asarray(X)))
        ll = float(log_likelihood(params, jnp.asarray(Y), jnp.asarray(X)))
        assert lj == pytest.approx(lp + ll, rel=1e-5)

    def test_grad_finite(self, tiny):
        model, Y, X = tiny
        fn = make_logdensity_fn(model.params, jnp.asarray(Y))
        g = jax.grad(fn)(jnp.asarray(X))
        assert g.shape == X.shape
        assert np.all(np.isfinite(np.asarray(g)))

    def test_true_latents_beat_noise(self, tiny):
        """log p(Y|X_true) must dominate log p(Y|noise)."""
        model, Y, X = tiny
        fn = make_logdensity_fn(model.params, jnp.asarray(Y))
        noise = jax.random.normal(jax.random.PRNGKey(0), X.shape)
        assert float(fn(jnp.asarray(X))) > float(fn(noise))


class TestHMC:
    @pytest.mark.slow
    def test_chain_runs_and_mixes(self, tiny):
        model, Y, X = tiny
        hmc = TemporalAMEHMC(model, num_chains=2, num_leapfrog=8, seed=1)
        out = hmc.sample(num_warmup=50, num_samples=50)
        assert out.positions.shape == (2, 50) + X.shape
        assert np.all(np.isfinite(np.asarray(out.positions)))
        accept = np.asarray(out.accept_prob).mean()
        assert 0.4 < accept <= 1.0  # dual averaging targeted 0.8

    @pytest.mark.slow
    def test_posterior_mean_matches_cavi(self, tiny):
        """North-star config 4: HMC posterior means validate the SMF means
        within loose MC error — compared in dyadic-mean space, which is the
        identified quantity."""
        from tame.inference import TemporalAMEStructuredMFVI
        from tame.ops import dyad as dyad_ops

        model, Y, X = tiny
        vi = TemporalAMEStructuredMFVI(model, factorization="good",
                                       learning_rate=0.7)
        vi.fit(max_iter=100, verbose=False)

        hmc = TemporalAMEHMC(model, num_chains=2, num_leapfrog=16, seed=3)
        out = hmc.sample(num_warmup=150, num_samples=150)
        # The latent X is identified only up to rotations/sign flips, so the
        # comparison lives in dyadic-mean space: average mu(X_s) over
        # samples (per chain, then across chains).
        samples = jnp.asarray(out.positions).reshape(
            (-1,) + out.positions.shape[2:])
        mu_hmc = np.asarray(jnp.mean(jax.vmap(
            lambda Xs: dyad_ops.dyadic_mean_temporal(Xs, model.r)
        )(samples), axis=0))
        mu_vi = np.asarray(dyad_ops.dyadic_mean_temporal(vi.X_mean, model.r))
        mask = ~np.eye(model.n, dtype=bool)
        corr = np.corrcoef(mu_vi[mask].ravel(), mu_hmc[mask].ravel())[0, 1]
        assert corr > 0.9
        rmse = np.sqrt(((mu_vi[mask] - mu_hmc[mask]) ** 2).mean())
        scale = np.abs(mu_vi[mask]).mean() + 1e-8
        assert rmse / scale < 0.6

    def test_run_hmc_standard_normal(self):
        """Sanity: HMC samples a 2-D standard normal correctly."""
        fn = lambda x: -0.5 * jnp.sum(x ** 2)
        out = run_hmc(fn, jnp.zeros(2), jax.random.PRNGKey(0),
                      num_warmup=200, num_samples=500, num_leapfrog=8,
                      initial_step_size=0.5)
        samples = np.asarray(out.positions)
        assert abs(samples.mean()) < 0.25
        assert abs(samples.std() - 1.0) < 0.25


class TestSMC:
    def test_systematic_resample_uniform_weights(self):
        idx = np.asarray(systematic_resample(
            jax.random.PRNGKey(0), jnp.zeros(16)))
        # uniform weights -> every particle survives exactly once
        assert sorted(idx.tolist()) == list(range(16))

    def test_ess(self):
        assert float(effective_sample_size(jnp.zeros(10))) == pytest.approx(10.0)
        concentrated = jnp.array([0.0] + [-100.0] * 9)
        assert float(effective_sample_size(concentrated)) == pytest.approx(
            1.0, abs=1e-3)

    def test_smc_runs(self, tiny):
        model, Y, X = tiny
        smc = TemporalAMESMC(model, num_particles=64, num_stages=64,
                             num_moves=2, seed=0)
        result = smc.sample()
        assert result.particles.shape == (64,) + X.shape
        assert np.all(np.isfinite(np.asarray(result.particles)))
        assert np.isfinite(float(result.log_evidence))
        ns = int(result.n_stages)
        assert 0 < ns <= 64
        ess = np.asarray(result.ess_history)[:ns]
        assert np.all(ess >= 1.0) and np.all(ess <= 64.0)
        # the adaptive schedule reached the posterior (beta = 1)
        betas = np.asarray(result.beta_history)[:ns]
        assert betas[-1] == pytest.approx(1.0)
        assert np.all(np.diff(betas) > 0)

    def test_smc_segmented_resume(self, tiny):
        """resume_from/max_new_stages: a sweep split across calls must
        carry the temperature, weights and evidence on device and end
        at beta = 1 with a consistent estimate (used to keep device
        dispatches short; tame/inference/smc.py docstring)."""
        from tame.inference.smc import run_smc

        model, Y, X = tiny
        kw = dict(num_particles=64, num_stages=64, num_moves=2)
        full = run_smc(model.params, jnp.asarray(Y),
                       jax.random.PRNGKey(5), **kw)
        res, seg = None, 0
        while res is None or (
                float(np.asarray(res.beta_history)[
                    int(res.n_stages) - 1]) < 1.0
                and int(res.n_stages) < 64):
            res = run_smc(model.params, jnp.asarray(Y),
                          jax.random.PRNGKey(50 + seg),
                          resume_from=res, max_new_stages=2, **kw)
            seg += 1
        assert seg > 1
        ns = int(res.n_stages)
        assert float(np.asarray(res.beta_history)[ns - 1]) \
            == pytest.approx(1.0)
        # same estimator in distribution; at this toy config the
        # estimator's own inter-key std is ~100 nats (measured), so the
        # consistency bound is correspondingly loose
        assert abs(float(res.log_evidence) - float(full.log_evidence)) \
            < 500.0
        # carry marshalling is exact: a zero-stage resume is a bitwise
        # no-op on every field
        noop = run_smc(model.params, jnp.asarray(Y),
                       jax.random.PRNGKey(99), resume_from=res,
                       max_new_stages=0, **kw)
        assert np.array_equal(np.asarray(noop.particles),
                              np.asarray(res.particles))
        assert float(noop.log_evidence) == float(res.log_evidence)
        assert int(noop.n_stages) == ns
        assert np.array_equal(np.asarray(noop.beta_history),
                              np.asarray(res.beta_history),
                              equal_nan=True)

    def test_smc_posterior_tracks_truth(self, tiny):
        """The SMC posterior-mean dyadic structure should correlate with the
        observed data far better than the prior mean (zero)."""
        from tame.ops import dyad as dyad_ops

        model, Y, X = tiny
        smc = TemporalAMESMC(model, num_particles=128, num_stages=12,
                             num_moves=3, seed=1)
        result = smc.sample()
        pm = smc.posterior_mean(result)
        mu = np.asarray(dyad_ops.dyadic_mean_temporal(pm, model.r))
        mask = ~np.eye(model.n, dtype=bool)
        corr = np.corrcoef(mu[mask].ravel(), Y[mask].ravel())[0, 1]
        assert corr > 0.5


class TestEvidence:
    """The SMC log-evidence vs the exact variational lower bound
    (tame/inference/evidence.py): for ANY variational posterior,
    log p(Y) >= exact_elbo(q), so the SMC estimate must land at or
    above the bound (within Monte-Carlo error) — the comparison only
    SMC enables, and the validation that the adaptive-tempering +
    Hamiltonian-move estimator is actually estimating the evidence
    (the earlier fixed-schedule RWM version sat thousands of nats
    BELOW the bound, an impossible value)."""

    @pytest.mark.slow
    def test_log_evidence_respects_exact_elbo(self):
        from tame.config import ModelConfig
        from tame.inference.evidence import exact_elbo
        from tame.inference.hmc import precondition_from_cavi
        from tame.inference.smc import run_smc
        from tame.inference.smoothed import (
            fit_cavi_smoothed,
            warm_init_smoothed_state,
        )
        from tame.models import build_params, sample

        n, T, r = 16, 4, 1
        cfg = ModelConfig(n_nodes=n, n_time=T, latent_dim=r, seed=0)
        p = build_params(cfg)
        Y, _ = sample(p, jax.random.PRNGKey(0), n, T)
        fit = fit_cavi_smoothed(Y, p, warm_init_smoothed_state(Y, p),
                                max_iter=300, learning_rate=0.8,
                                tolerance=1e-6, corrected=True)
        elbo = float(exact_elbo(Y, p, fit.state))
        _, variances = precondition_from_cavi(Y, p, seed=0)
        res = run_smc(p, Y, jax.random.PRNGKey(100),
                      num_particles=256, num_stages=400,
                      proposal_scale=jnp.sqrt(variances))
        ev = float(res.log_evidence)
        # measured at these settings: ev - elbo = +13.1 +- 0.5 over
        # seeds; 3 nats of slack guards the MC spread
        assert ev > elbo - 3.0, (ev, elbo)
        # and the bound is genuinely informative (finite KL gap)
        assert ev - elbo < 100.0, (ev, elbo)
        assert int(res.n_stages) < 400  # schedule terminated itself

    @pytest.mark.slow
    def test_evidence_selects_rank(self):
        """Bayesian model selection: the SMC evidence must prefer the
        GENERATING latent rank over an inflated one (the automatic
        Occam penalty — measured ~16 nats per spurious dimension,
        cookbook §9)."""
        from tame.config import ModelConfig
        from tame.inference.hmc import precondition_from_cavi
        from tame.inference.smc import run_smc
        from tame.models import build_params, sample

        Y, _ = sample(build_params(ModelConfig(
            n_nodes=16, n_time=4, latent_dim=1, seed=0)),
            jax.random.PRNGKey(0), 16, 4)
        evs = {}
        for r in (1, 2):
            p = build_params(ModelConfig(n_nodes=16, n_time=4,
                                         latent_dim=r, seed=0))
            _, variances = precondition_from_cavi(Y, p, seed=0)
            res = run_smc(p, Y, jax.random.PRNGKey(10),
                          num_particles=256, num_stages=400,
                          proposal_scale=jnp.sqrt(variances))
            evs[r] = float(res.log_evidence)
        # measured gap ~16 nats with ~5-nat replicate spread; require a
        # margin beyond zero so estimator noise cannot flip the test
        assert evs[1] > evs[2] + 3.0, evs

    def test_exact_elbo_below_parity_elbo_sanity(self):
        """The exact bound differs from the engine-reported parity ELBO
        (plug-in + heuristic correction) — pinning that they are
        distinct quantities and both finite."""
        from tame.config import ModelConfig
        from tame.inference.evidence import exact_elbo
        from tame.inference.smoothed import (
            fit_cavi_smoothed,
            warm_init_smoothed_state,
        )
        from tame.models import build_params, sample

        cfg = ModelConfig(n_nodes=10, n_time=3, latent_dim=1, seed=1)
        p = build_params(cfg)
        Y, _ = sample(p, jax.random.PRNGKey(1), 10, 3)
        fit = fit_cavi_smoothed(Y, p, warm_init_smoothed_state(Y, p),
                                max_iter=150, learning_rate=0.8,
                                tolerance=1e-6, corrected=True)
        exact = float(exact_elbo(Y, p, fit.state))
        parity = float(np.asarray(fit.elbo_history)[int(fit.n_iter) - 1])
        assert np.isfinite(exact) and np.isfinite(parity)
        assert exact != parity


class TestNUTS:
    def test_standard_normal_moments(self):
        from tame.inference import run_nuts

        fn = lambda x: -0.5 * jnp.sum(x ** 2)
        out = run_nuts(fn, jnp.zeros(3), jax.random.PRNGKey(0),
                       num_warmup=300, num_samples=600,
                       initial_step_size=0.5, max_depth=6)
        s = np.asarray(out.positions)
        assert np.abs(s.mean(axis=0)).max() < 0.25
        assert np.abs(s.std(axis=0) - 1.0).max() < 0.25

    def test_correlated_normal(self):
        """NUTS must handle strong correlation (where fixed-length HMC with
        a bad trajectory length would fail)."""
        from tame.inference import run_nuts

        rho = 0.95
        P = jnp.linalg.inv(jnp.array([[1.0, rho], [rho, 1.0]]))
        fn = lambda x: -0.5 * x @ P @ x
        out = run_nuts(fn, jnp.zeros(2), jax.random.PRNGKey(1),
                       num_warmup=300, num_samples=800,
                       initial_step_size=0.3, max_depth=8)
        s = np.asarray(out.positions)
        emp_rho = np.corrcoef(s[:, 0], s[:, 1])[0, 1]
        assert abs(emp_rho - rho) < 0.12
        assert np.abs(s.std(axis=0) - 1.0).max() < 0.3

    def test_adaptive_depth(self):
        """Trajectory lengths should adapt: with a tiny step size NUTS
        integrates deeper than with a large one."""
        from tame.inference.nuts import nuts_kernel

        fn = lambda x: -0.5 * jnp.sum(x ** 2)
        key = jax.random.PRNGKey(2)
        _, _, stats_small = nuts_kernel(fn, jnp.ones(2), key,
                                        jnp.asarray(0.01),
                                        jnp.ones(2), max_depth=10)
        _, _, stats_big = nuts_kernel(fn, jnp.ones(2), key,
                                      jnp.asarray(1.0),
                                      jnp.ones(2), max_depth=10)
        assert int(stats_small["n_leapfrog"]) > int(stats_big["n_leapfrog"])

    def test_on_temporal_ame(self, tiny):
        from tame.inference import TemporalAMENUTS

        model, Y, X = tiny
        nuts = TemporalAMENUTS(model, num_chains=2, max_depth=6, seed=0)
        out = nuts.sample(num_warmup=60, num_samples=60)
        assert out.positions.shape == (2, 60) + X.shape
        assert np.all(np.isfinite(np.asarray(out.positions)))
        assert float(np.asarray(out.accept_prob).mean()) > 0.4

    @pytest.mark.slow
    def test_nuts_mixes_and_matches_hmc_on_ame(self, tiny):
        """NUTS validated ON THE AME POSTERIOR (not just toy normals):
        chains must mix (split-R-hat < 1.05 on the tiny posterior) and the
        posterior means AND marginal variances must agree with HMC in
        dyadic-mean space — the identified quantity — with ESS-SCALED
        tolerances (each sampler's standard error, combined)."""
        from tame.inference import TemporalAMEHMC, TemporalAMENUTS
        from tame.ops import dyad as dyad_ops
        from tame.utils import effective_sample_size

        from tame.utils import split_rhat

        model, Y, X = tiny
        nuts = TemporalAMENUTS(model, num_chains=4, max_depth=6, seed=0)
        out_n = nuts.sample(num_warmup=150, num_samples=150)
        diag = nuts.diagnostics()
        # Raw latent coordinates are identified only up to rotations/sign
        # flips, and chains legitimately random-walk along those symmetry
        # directions — R-hat < 1.05 is asserted on IDENTIFIED quantities
        # (log density here; per-dyad means below), with a loose sanity
        # bound on the raw coordinates.
        assert diag["logdensity_rhat"] < 1.05, diag
        assert diag["max_rhat"] < 1.3, diag
        assert diag["min_ess"] > 10, diag

        hmc = TemporalAMEHMC(model, num_chains=4, num_leapfrog=16, seed=3)
        out_h = hmc.sample(num_warmup=150, num_samples=150)

        def dyad_stats(positions):
            # per-sample dyadic means: (chains, draws, n, n, T)
            mu = jax.vmap(jax.vmap(
                lambda Xs: dyad_ops.dyadic_mean_temporal(Xs, model.r)
            ))(jnp.asarray(positions))[..., 0]
            mean = np.asarray(mu.mean(axis=(0, 1)))
            var = np.asarray(mu.reshape((-1,) + mu.shape[2:]).var(axis=0))
            ess = np.asarray(effective_sample_size(mu))
            return mean, var, ess

        mask = ~np.eye(model.n, dtype=bool)
        m_n, v_n, e_n = dyad_stats(out_n.positions)
        m_h, v_h, e_h = dyad_stats(out_h.positions)

        # identified-quantity mixing: per-dyad-mean split-R-hat < 1.05
        mu_chains = jax.vmap(jax.vmap(
            lambda Xs: dyad_ops.dyadic_mean_temporal(Xs, model.r)
        ))(jnp.asarray(out_n.positions))[..., 0]
        rhat_mu = np.asarray(split_rhat(mu_chains))  # (n, n, T)
        assert float(rhat_mu[mask].max()) < 1.05

        # means: |diff| <= 4 combined MC standard errors, per dyad entry
        se = np.sqrt(v_n / np.maximum(e_n, 1.0)
                     + v_h / np.maximum(e_h, 1.0))
        z = np.abs(m_n - m_h)[mask] / np.maximum(se[mask], 1e-6)
        assert np.quantile(z, 0.95) < 4.0, float(np.quantile(z, 0.95))

        # marginal variances: same posterior => same scale (MC-noisy with
        # a few hundred effective draws, so a factor-2 band per entry and
        # a tight bound on the median ratio)
        ratio = (v_n[mask] + 1e-8) / (v_h[mask] + 1e-8)
        assert 0.67 < float(np.median(ratio)) < 1.5
        assert np.mean((ratio > 0.33) & (ratio < 3.0)) > 0.9


class TestChainDiagnostics:
    """Split-R-hat / multi-chain ESS (tame.utils.diagnostics) — the MCMC
    convergence surface the reference cannot have (it has no sampler)."""

    def test_split_rhat_iid_near_one(self):
        from tame.utils import split_rhat

        x = jax.random.normal(jax.random.PRNGKey(0), (4, 500, 3))
        r = np.asarray(split_rhat(x))
        assert r.shape == (3,)
        assert np.all(r < 1.02)

    def test_split_rhat_detects_nonmixing(self):
        from tame.utils import split_rhat

        x = jax.random.normal(jax.random.PRNGKey(1), (4, 200, 2))
        x = x.at[0].add(5.0)  # one chain stuck in a different mode
        assert float(np.max(np.asarray(split_rhat(x)))) > 1.5

    def test_split_rhat_detects_within_chain_trend(self):
        from tame.utils import split_rhat

        # drifting chains look fine to unsplit R-hat; the split catches it
        t = jnp.linspace(0.0, 5.0, 300)
        x = (jax.random.normal(jax.random.PRNGKey(2), (4, 300))
             + t[None, :])[..., None]
        assert float(np.asarray(split_rhat(x))[0]) > 1.2

    def test_ess_iid_vs_autocorrelated(self):
        from tame.utils import effective_sample_size

        iid = jax.random.normal(jax.random.PRNGKey(3), (4, 500, 2))
        ess = np.asarray(effective_sample_size(iid))
        assert ess.shape == (2,)
        assert np.all(ess > 0.5 * 2000)

        # AR(1), phi=0.95: true efficiency (1-phi)/(1+phi) ~ 2.6 %
        eps = np.asarray(jax.random.normal(jax.random.PRNGKey(4),
                                           (4, 500)))
        ar = np.zeros_like(eps)
        for s in range(1, 500):
            ar[:, s] = 0.95 * ar[:, s - 1] + eps[:, s]
        ess_ar = float(np.asarray(
            effective_sample_size(ar[:, :, None]))[0])
        assert ess_ar < 0.15 * 2000

    def test_sampler_reports_diagnostics(self, tiny):
        model, Y, X = tiny
        hmc = TemporalAMEHMC(model, num_chains=2, num_leapfrog=8, seed=1)
        out = hmc.sample(num_warmup=40, num_samples=40)
        diag = hmc.diagnostics()
        assert set(diag) >= {"max_rhat", "min_ess", "median_ess",
                             "logdensity_rhat"}
        assert diag["max_rhat"] > 0.9
        assert 0 < diag["min_ess"] <= 2 * 40


class TestMaskedLogProb:
    """Missing-data posterior surface shared with the masked CAVI engines:
    obs_mask on log_likelihood / samplers (no reference counterpart)."""

    def test_full_mask_matches_unmasked(self, tiny):
        model, Y, X = tiny
        from tame.inference.logprob import log_likelihood

        n, T = Y.shape[0], Y.shape[2]
        full = (1.0 - jnp.eye(n))[:, :, None] * jnp.ones((n, n, T))
        a = float(log_likelihood(model.params, Y, jnp.asarray(X)))
        b = float(log_likelihood(model.params, Y, jnp.asarray(X),
                                 obs_mask=full))
        assert np.isclose(a, b, rtol=1e-6)

    def test_masked_entries_never_read(self, tiny):
        model, Y, X = tiny
        from tame.inference.logprob import log_likelihood
        from tame.models import random_dyad_mask

        n, T = Y.shape[0], Y.shape[2]
        mask = random_dyad_mask(jax.random.PRNGKey(3), n, T, 0.4)
        Yg = jnp.where(mask[..., None] == 0, 1e6, Y)
        a = float(log_likelihood(model.params, Y, jnp.asarray(X),
                                 obs_mask=mask))
        b = float(log_likelihood(model.params, Yg, jnp.asarray(X),
                                 obs_mask=mask))
        assert a == b

    def test_masked_hmc_runs(self, tiny):
        model, Y, X = tiny
        from tame.models import random_dyad_mask

        n, T = Y.shape[0], Y.shape[2]
        mask = random_dyad_mask(jax.random.PRNGKey(4), n, T, 0.3)
        hmc = TemporalAMEHMC(model, num_chains=2, num_leapfrog=5, seed=1,
                             mask=mask)
        out = hmc.sample(num_warmup=15, num_samples=15)
        assert bool(jnp.all(jnp.isfinite(out.positions)))
        assert bool(jnp.all(jnp.isfinite(out.logdensities)))


def test_masked_hmc_nan_coded_actually_samples(tiny):
    """NaN-coded missing entries must not silently freeze the chain (a
    NaN log-likelihood rejects every proposal while positions stay
    finite); the masked target gates reads with where."""
    from tame.inference.logprob import log_likelihood
    from tame.models import random_dyad_mask

    model, Y, X = tiny
    n, T = Y.shape[0], Y.shape[2]
    mask = random_dyad_mask(jax.random.PRNGKey(4), n, T, 0.3)
    Ynan = jnp.where(mask[..., None] == 0, jnp.nan, jnp.asarray(Y))
    ll = log_likelihood(model.params, Ynan, jnp.asarray(X), obs_mask=mask)
    assert bool(jnp.isfinite(ll))
    model.Y = np.asarray(Ynan)
    hmc = TemporalAMEHMC(model, num_chains=2, num_leapfrog=5, seed=1,
                         mask=mask, precondition=False)
    out = hmc.sample(num_warmup=20, num_samples=20)
    assert bool(jnp.all(jnp.isfinite(out.logdensities)))
    assert float(out.accept_prob.mean()) > 0.2  # the chain actually moves


@pytest.mark.slow
class TestNUTSAtScale:
    """Sampler evidence beyond toy sizes (north-star config 4): n=64
    chains sharded over the CPU mesh, split-R-hat convergence on
    identified dyad-mean scalars, and SMF-vs-NUTS moment agreement with
    ESS-scaled tolerances.  ``scripts/mcmc_bench.py`` measures the same
    on one GPU (n=128/T=16/r=2/64 chains)."""

    def test_nuts_n64_rhat_and_moment_agreement(self):
        from tame.inference import TemporalAMENUTS, TemporalAMEStructuredMFVI
        from tame.ops import dyad as dyad_ops
        from tame.parallel import make_mesh
        from tame.utils.diagnostics import (
            effective_sample_size,
            split_rhat,
        )

        n, T, r = 64, 8, 1
        model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=r,
                                 seed=0)
        model.generate_data()

        vi = TemporalAMEStructuredMFVI(model, factorization="good",
                                       learning_rate=0.8,
                                       update_mode="block",
                                       corrected=True)
        vi.fit(max_iter=200, tolerance=1e-6, verbose=False)

        mesh = make_mesh(batch=8)
        nuts = TemporalAMENUTS(model, num_chains=8, max_depth=6, seed=1)
        out = nuts.sample(num_warmup=120, num_samples=120, mesh=mesh)
        assert len(out.positions.sharding.device_set) == 8

        # identified dyad-mean scalars at K random off-diag coordinates
        rng = np.random.default_rng(0)
        ii = rng.integers(0, n, 96)
        jj = rng.integers(0, n, 96)
        keep = ii != jj
        ii, jj = ii[keep][:48], jj[keep][:48]
        tt = rng.integers(0, T, len(ii))

        def per_sample(X):
            a, b, U, V = dyad_ops.split_state(X, r)
            return (a[ii, tt] + b[jj, tt]
                    + jnp.sum(U[ii, tt] * V[jj, tt], -1))

        scal = jax.jit(jax.vmap(jax.vmap(per_sample)))(out.positions)
        scal = np.asarray(scal)                      # (8, 120, K)

        rhat = np.asarray(split_rhat(jnp.asarray(scal)))
        assert rhat.max() < 1.2, rhat.max()
        assert np.median(rhat) < 1.05

        ess = np.asarray(effective_sample_size(jnp.asarray(scal)))
        assert ess.min() > 10.0

        # SMF-vs-NUTS moment gap, normalized by the posterior sd and by
        # the ESS-scaled Monte-Carlo standard error
        a, b, U, V = dyad_ops.split_state(vi.X_mean, r)
        mu_vi = np.asarray(a[ii, tt] + b[jj, tt]
                           + jnp.sum(U[ii, tt] * V[jj, tt], -1))
        flat = scal.reshape(-1, scal.shape[-1])
        mu_nuts = flat.mean(0)
        sd_nuts = flat.std(0)
        effect = np.abs(mu_vi - mu_nuts) / np.maximum(sd_nuts, 1e-8)
        # mean-field bias is real but small in the identified space
        assert np.median(effect) < 0.5, np.median(effect)
        assert effect.max() < 3.0, effect.max()


class TestLikelihoodFamilies:
    """The declarative likelihood seam (tame.models.likelihoods): the
    sampler backends accept a declared dyadic family; the reference (and
    the CAVI engines) hardcode the Gaussian (naive_mf.py:114-132)."""

    def test_gaussian_family_matches_builtin(self):
        """family='gaussian' must equal the hand-fused default path."""
        from tame.inference.logprob import make_logdensity_fn
        from tame.models import build_params, sample
        from tame.config import ModelConfig

        cfg = ModelConfig(n_nodes=8, n_time=3, latent_dim=1, seed=1)
        p = build_params(cfg)
        Y, X = sample(p, jax.random.PRNGKey(1), 8, 3)
        f0 = make_logdensity_fn(p, Y)
        f1 = make_logdensity_fn(p, Y, family="gaussian")
        assert float(f0(X)) == pytest.approx(float(f1(X)), rel=1e-6)

    def test_poisson_sampling_layout(self):
        from tame.config import ModelConfig
        from tame.models import build_params, sample

        cfg = ModelConfig(n_nodes=10, n_time=3, latent_dim=1, seed=0)
        p = build_params(cfg)
        Y, X = sample(p, jax.random.PRNGKey(0), 10, 3, family="poisson")
        Y = np.asarray(Y)
        assert np.all(Y >= 0) and np.all(Y == np.floor(Y))
        assert np.array_equal(Y[..., 1], np.swapaxes(Y[..., 0], 0, 1))
        assert np.all(Y[np.arange(10), np.arange(10)] == 0)

    def test_unknown_family_raises(self):
        from tame.models import get_family

        with pytest.raises(ValueError, match="unknown likelihood"):
            get_family("negative-binomial")

    @pytest.mark.slow
    def test_nuts_recovers_poisson_dyads(self):
        """NUTS on a declared Poisson-dyad family recovers the
        generating log-rate surface (identified dyadic space)."""
        from tame.config import ModelConfig
        from tame.inference.logprob import make_logdensity_fn
        from tame.inference.nuts import run_nuts
        from tame.models import build_params, sample
        from tame.ops import dyad as dyad_ops

        cfg = ModelConfig(n_nodes=12, n_time=4, latent_dim=1, seed=0)
        p = build_params(cfg)
        Y, X = sample(p, jax.random.PRNGKey(0), 12, 4, family="poisson")
        fn = make_logdensity_fn(p, Y, family="poisson")
        assert float(fn(jnp.asarray(X))) > float(fn(jnp.zeros_like(X)))
        out = jax.vmap(lambda pos, k: run_nuts(
            fn, pos, k, num_warmup=150, num_samples=150, max_depth=6))(
            0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                    (2,) + X.shape),
            jax.random.split(jax.random.PRNGKey(2), 2))
        samples = jnp.asarray(out.positions).reshape((-1,) + X.shape)
        mu_hat = np.asarray(jnp.mean(jax.vmap(
            lambda Xs: dyad_ops.dyadic_fwd_temporal(Xs, 1))(samples), 0))
        mu_true = np.asarray(dyad_ops.dyadic_fwd_temporal(
            jnp.asarray(X), 1))
        m = ~np.eye(12, dtype=bool)
        corr = np.corrcoef(mu_true[m].ravel(), mu_hat[m].ravel())[0, 1]
        assert corr > 0.8, corr

    @pytest.mark.slow
    def test_bernoulli_smc_and_class_surface(self):
        """The engine classes accept family=...; SMC on binary ties runs
        and its posterior tracks the tie structure."""
        from tame.inference import TemporalAMESMC
        from tame.models import sample_observations
        from tame.ops import dyad as dyad_ops

        model = TemporalAMEModel(n_nodes=10, n_time=3, latent_dim=1,
                                 seed=2)
        model.generate_data(return_latents=True)
        Yb = sample_observations(model.params, jax.random.PRNGKey(3),
                                 jnp.asarray(model.X),
                                 family="bernoulli")
        model.Y = np.asarray(Yb)
        smc = TemporalAMESMC(model, num_particles=64, num_stages=8,
                             num_moves=2, seed=0, family="bernoulli")
        assert smc.precondition is False  # Gaussian preconditioner off
        result = smc.sample()
        assert np.all(np.isfinite(np.asarray(result.particles)))
        mean_X = smc.posterior_mean(result)
        mu = np.asarray(dyad_ops.dyadic_fwd_temporal(mean_X, 1))
        y0 = np.asarray(Yb[..., 0])
        m = ~np.eye(10, dtype=bool)
        # posterior log-odds separate ties from non-ties
        assert mu[m].ravel()[y0[m].ravel() > 0].mean() > \
            mu[m].ravel()[y0[m].ravel() == 0].mean()


def test_smc_partial_buffer_warns(tiny, capsys):
    """A stage buffer too small for the adaptive schedule must warn
    loudly (partial evidence / tempered posterior), not fail silently."""
    model, Y, X = tiny
    smc = TemporalAMESMC(model, num_particles=32, num_stages=2,
                         num_moves=1, seed=0)
    result = smc.sample()
    out = capsys.readouterr().out
    ns = int(result.n_stages)
    beta = float(np.asarray(result.beta_history)[ns - 1])
    if beta < 1.0:
        assert "PARTIAL" in out
    else:  # schedule finished within 2 stages: nothing to warn about
        assert "PARTIAL" not in out
