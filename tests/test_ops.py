"""Core-op tests: dyadic ops, the unrolled batched SPD solve and the
block-tridiagonal smoothers.

The SPD path and the smoothers are checked against float64 numpy linalg
on the same systems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tame.ops import dyad as dyad_ops
from tame.ops.cholesky import (
    batched_logdet_spd,
    batched_spd_solve,
    batched_spd_solve_inv,
)


def _random_spd(key, B, d):
    A = jax.random.normal(key, (B, d, d))
    return jnp.matmul(A, jnp.swapaxes(A, -1, -2)) + 2.0 * jnp.eye(d)


class TestCholeskySolve:
    @pytest.mark.parametrize("d", [2, 4, 6, 10])
    def test_unrolled_matches_float64(self, d):
        key = jax.random.PRNGKey(d)
        k1, k2 = jax.random.split(key)
        B = 37  # no size the algorithm could specialise on
        P = _random_spd(k1, B, d)
        eta = jax.random.normal(k2, (B, d))

        mu, cov = batched_spd_solve_inv(P, eta)
        P_np = np.asarray(P, dtype=np.float64)
        eta_np = np.asarray(eta, dtype=np.float64)
        mu_np = np.linalg.solve(P_np, eta_np[..., None])[..., 0]
        cov_np = np.linalg.inv(P_np)
        assert np.allclose(np.asarray(mu), mu_np, atol=1e-4)
        assert np.allclose(np.asarray(cov), cov_np, atol=1e-4)

    @pytest.mark.parametrize("shape", [(1,), (13,), (3, 5)])
    def test_solve_only_and_logdet_match_float64(self, shape):
        key = jax.random.PRNGKey(len(shape) + shape[0])
        k1, k2 = jax.random.split(key)
        d = 6
        B = int(np.prod(shape))
        P = _random_spd(k1, B, d).reshape(*shape, d, d)
        eta = jax.random.normal(k2, (*shape, d))
        mu = batched_spd_solve(P, eta)
        logdet = batched_logdet_spd(P)
        assert mu.shape == (*shape, d) and logdet.shape == shape
        P_np = np.asarray(P, dtype=np.float64)
        mu_np = np.linalg.solve(
            P_np, np.asarray(eta, np.float64)[..., None])[..., 0]
        assert np.allclose(np.asarray(mu), mu_np, atol=1e-4)
        assert np.allclose(np.asarray(logdet),
                           np.linalg.slogdet(P_np)[1], rtol=1e-5)

    def test_xla_path_correct(self):
        key = jax.random.PRNGKey(3)
        k1, k2 = jax.random.split(key)
        P = _random_spd(k1, 8, 6)
        eta = jax.random.normal(k2, (8, 6))
        mu, cov = jax.jit(batched_spd_solve_inv)(P, eta)
        assert np.allclose(np.asarray(jnp.matmul(P, cov)),
                           np.eye(6), atol=1e-3)
        assert np.allclose(
            np.asarray(jnp.matmul(P, mu[..., None])[..., 0]),
            np.asarray(eta), atol=1e-3)

    def test_dispatch_supports_leading_batch_dims(self):
        key = jax.random.PRNGKey(5)
        k1, k2 = jax.random.split(key)
        P = _random_spd(k1, 12, 4).reshape(3, 4, 4, 4)
        eta = jax.random.normal(k2, (3, 4, 4))
        mu, cov = batched_spd_solve_inv(P, eta)
        assert mu.shape == (3, 4, 4)
        assert cov.shape == (3, 4, 4, 4)
        mu2 = batched_spd_solve(P, eta)
        assert np.allclose(np.asarray(mu), np.asarray(mu2), atol=1e-5)


class TestDyadOps:
    def test_symmetrize_dyads_invariants(self, rng_key):
        D = jax.random.normal(rng_key, (6, 6, 3, 2))
        Y = np.asarray(dyad_ops.symmetrize_dyads(D))
        assert np.allclose(np.diagonal(Y, axis1=0, axis2=1), 0.0)
        assert np.allclose(Y[..., 1], Y.transpose(1, 0, 2, 3)[..., 0])
        # upper triangle preserved verbatim
        D_np = np.asarray(D)
        for i in range(6):
            for j in range(i + 1, 6):
                assert np.allclose(Y[i, j], D_np[i, j])

    def test_temporal_mean_matches_static_per_time(self, rng_key):
        X = jax.random.normal(rng_key, (5, 4, 6))
        mu_t = np.asarray(dyad_ops.dyadic_mean_temporal(X, 2))
        for t in range(4):
            mu_s = np.asarray(dyad_ops.dyadic_mean_static(
                X[:, t, :2], X[:, t, 2:], 2))
            assert np.allclose(mu_t[:, :, t], mu_s, atol=1e-5)

    def test_split_state_roundtrip(self, rng_key):
        X = jax.random.normal(rng_key, (5, 4, 6))
        a, b, U, V = dyad_ops.split_state(X, 2)
        rebuilt = jnp.concatenate(
            [a[..., None], b[..., None], U, V], axis=-1)
        assert np.allclose(np.asarray(rebuilt), np.asarray(X))


class TestBlockTridiagSmoother:
    """The smoother must agree with a dense solve of the same system."""

    def _random_system(self, key, T, d):
        k1, k2, k3 = jax.random.split(key, 3)
        A = jax.random.normal(k1, (T, d, d))
        D = jnp.matmul(A, jnp.swapaxes(A, -1, -2)) + 5.0 * jnp.eye(d)
        O = 0.3 * jax.random.normal(k2, (d, d))
        b = jax.random.normal(k3, (T, d))
        return D, O, b

    def test_matches_dense(self):
        from tame.ops.tridiag import block_tridiag_smoother, dense_precision

        T, d = 6, 4
        D, O, b = self._random_system(jax.random.PRNGKey(0), T, d)
        out = block_tridiag_smoother(D, O, b)

        P = np.asarray(dense_precision(D, O), dtype=np.float64)
        mean_dense = np.linalg.solve(P, np.asarray(b, np.float64).ravel())
        cov_dense = np.linalg.inv(P)

        assert np.allclose(np.asarray(out.mean).ravel(), mean_dense,
                           atol=1e-3)
        for t in range(T):
            blk = cov_dense[t * d:(t + 1) * d, t * d:(t + 1) * d]
            assert np.allclose(np.asarray(out.cov[t]), blk, atol=1e-3), t
        for t in range(T - 1):
            blk = cov_dense[t * d:(t + 1) * d, (t + 1) * d:(t + 2) * d]
            assert np.allclose(np.asarray(out.cross_cov[t]), blk,
                               atol=1e-3), t
        sign, logdet_dense = np.linalg.slogdet(P)
        assert sign > 0
        assert float(out.logdet) == pytest.approx(logdet_dense, rel=1e-4)

    @pytest.mark.parametrize("T,d", [(2, 2), (5, 6), (4, 10)])
    def test_matches_dense_sizes(self, T, d):
        """Means, marginal and lag-1 covariances and the log-determinant
        against a float64 dense solve, up to the engine's widest block."""
        from tame.ops.tridiag import block_tridiag_smoother, dense_precision

        D, O, b = self._random_system(jax.random.PRNGKey(10 * T + d), T, d)
        out = block_tridiag_smoother(D, O, b)
        P = np.asarray(dense_precision(D, O), dtype=np.float64)
        cov_dense = np.linalg.inv(P)
        mean_dense = cov_dense @ np.asarray(b, np.float64).ravel()
        assert np.allclose(np.asarray(out.mean).ravel(), mean_dense,
                           atol=1e-4)
        for t in range(T):
            sl = slice(t * d, (t + 1) * d)
            assert np.allclose(np.asarray(out.cov[t]), cov_dense[sl, sl],
                               atol=1e-4), t
            if t < T - 1:
                nx = slice((t + 1) * d, (t + 2) * d)
                assert np.allclose(np.asarray(out.cross_cov[t]),
                                   cov_dense[sl, nx], atol=1e-4), t
        assert float(out.logdet) == pytest.approx(np.linalg.slogdet(P)[1],
                                                  rel=1e-5)

    def test_single_time_step(self):
        from tame.ops.tridiag import block_tridiag_smoother

        D, O, b = self._random_system(jax.random.PRNGKey(1), 1, 3)
        out = block_tridiag_smoother(D, O, b)
        assert np.allclose(np.asarray(out.mean[0]),
                           np.linalg.solve(np.asarray(D[0]),
                                           np.asarray(b[0])), atol=1e-4)
        assert out.cross_cov.shape == (0, 3, 3)

    def test_vmapped_over_nodes(self):
        from tame.ops.tridiag import block_tridiag_smoother

        keys = jax.random.split(jax.random.PRNGKey(2), 5)
        systems = [self._random_system(k, 4, 3) for k in keys]
        D = jnp.stack([s[0] for s in systems])
        O = systems[0][1]
        b = jnp.stack([s[2] for s in systems])
        out = jax.vmap(lambda Di, bi: block_tridiag_smoother(Di, O, bi))(D, b)
        assert out.mean.shape == (5, 4, 3)
        assert np.all(np.isfinite(np.asarray(out.mean)))


class TestParallelSmoother:
    """Time-parallel exact smoother (tame.ops.ptridiag): the
    conditional-Gaussian associative-scan formulation must match the
    sequential block-tridiagonal solver to float32 tolerance — including
    at long T and in the weak-information/high-phi regime where the
    earlier transfer-matrix attempt failed (tridiag.py module notes)."""

    def _compare(self, T, d=6, phi=0.8, pscale=0.5, seed=0):
        from tame.ops.ptridiag import parallel_block_tridiag_smoother
        from tame.ops.tridiag import block_tridiag_smoother

        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        A = jax.random.normal(k1, (T, d, d)) * pscale
        Pobs = (jnp.einsum("tij,tkj->tik", A, A)
                + max(2 * pscale, 1e-3) * jnp.eye(d))
        eta = jax.random.normal(k2, (T, d))
        Phi = phi * jnp.eye(d)
        Q = (1 - phi ** 2) * 0.1 * (jnp.eye(d) + 0.2 * jnp.ones((d, d)))
        Sigma0 = jnp.eye(d) * 0.7 + 0.1
        Q_inv = jnp.linalg.inv(Q)
        S0_inv = jnp.linalg.inv(Sigma0)
        PQP = Phi.T @ Q_inv @ Phi
        t = jnp.arange(T)
        D = (Pobs + (t == 0)[:, None, None] * S0_inv
             + (t > 0)[:, None, None] * Q_inv
             + (t < T - 1)[:, None, None] * PQP)
        ref = block_tridiag_smoother(D, -Phi.T @ Q_inv, eta)
        got = parallel_block_tridiag_smoother(Pobs, eta, Phi, Q, Sigma0)
        assert np.allclose(np.asarray(ref.mean), np.asarray(got.mean),
                           atol=5e-4)
        assert np.allclose(np.asarray(ref.cov), np.asarray(got.cov),
                           atol=5e-4)
        if T > 1:
            assert np.allclose(np.asarray(ref.cross_cov),
                               np.asarray(got.cross_cov), atol=5e-4)
        assert abs(float(ref.logdet) - float(got.logdet)) \
            / abs(float(ref.logdet)) < 1e-4

    @pytest.mark.parametrize("T,d", [(2, 4), (5, 10)])
    def test_matches_sequential_small(self, T, d):
        self._compare(T, d=d)

    @pytest.mark.slow
    @pytest.mark.parametrize("T", [1, 2, 3, 8, 64])
    def test_matches_sequential(self, T):
        self._compare(T)

    @pytest.mark.slow
    def test_matches_sequential_T512(self):
        self._compare(512)

    @pytest.mark.slow
    def test_weak_information_high_phi(self):
        """The regime that killed the transfer-matrix formulation."""
        self._compare(512, phi=0.97, pscale=0.05, seed=1)


def test_parallel_smoother_option_matches_sequential_fit():
    """``smoother="parallel"`` runs the associative-scan solver inside the
    smoothed fit and reaches the sequential solver's iterates."""
    from tame.inference.smoothed import (
        fit_cavi_smoothed,
        init_smoothed_state,
    )
    from tame.models import TemporalAMEModel

    model = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=1, seed=0)
    Y, _ = model.generate_data(return_latents=True)
    st = init_smoothed_state(jax.random.PRNGKey(0), 6, 3, 4)
    outs = [fit_cavi_smoothed(jnp.asarray(Y), model.params, st, max_iter=3,
                              tolerance=0.0, smoother=sm)
            for sm in ("sequential", "parallel")]
    assert [int(o.n_iter) for o in outs] == [3, 3]
    assert np.allclose(np.asarray(outs[0].state.X_mean),
                       np.asarray(outs[1].state.X_mean), atol=1e-4)
    with pytest.raises(ValueError, match="unknown smoother"):
        fit_cavi_smoothed(jnp.asarray(Y), model.params, st, max_iter=1,
                          smoother="fused")


@pytest.mark.slow
def test_parallel_smoother_very_long_T():
    """T = 2048 — the 'very long T' regime the module's docstring claims
    as its value (round-4 verdict: validation previously stopped at
    T = 512).  Exactness must hold through 11 scan levels, including
    the weak-information/high-phi corner."""
    t = TestParallelSmoother()
    t._compare(2048)
    t._compare(2048, phi=0.95, pscale=0.1, seed=2)
