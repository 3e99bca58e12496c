"""Experiment-harness tests: dirs, persistence, timing, reports, and small
end-to-end experiment runs (the reference covers this via its standalone
integration script, ``tests/test_integration.py``)."""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest

from tame.experiments.utils import (
    generate_experiment_report,
    load_results,
    print_experiment_header,
    run_method_with_timing,
    save_results,
    setup_experiment_dir,
)
from tame.inference import TemporalAMENaiveMFVI
from tame.models import TemporalAMEModel


class TestHarnessUtils:
    def test_setup_experiment_dir(self, tmp_path):
        exp_dir = setup_experiment_dir("unit", base_dir=str(tmp_path))
        assert exp_dir.exists()
        assert (exp_dir / "figures").is_dir()
        assert (exp_dir / "data").is_dir()
        assert exp_dir.name.startswith("unit_")

    def test_save_and_load_results(self, tmp_path, temporal_data):
        exp_dir = setup_experiment_dir("unit", base_dir=str(tmp_path))
        results = {"method": {"history": {"elbo": [-1.0, -0.5]},
                              "X_est": temporal_data["X"],
                              "runtime": 1.0}}
        save_results(results, exp_dir)
        loaded = load_results(exp_dir)
        assert loaded["method"]["history"]["elbo"] == [-1.0, -0.5]
        # arrays are numpy after round-trip (host-loadable)
        assert isinstance(loaded["method"]["X_est"], np.ndarray)
        # JSON summary exists and strips arrays
        with open(exp_dir / "data" / "results.json") as f:
            js = json.load(f)
        assert js["method"]["X_est"] is None
        assert js["method"]["runtime"] == 1.0

    def test_run_method_with_timing(self, temporal_data):
        result = run_method_with_timing(
            TemporalAMENaiveMFVI, temporal_data["model"], "Naive MF",
            max_iter=3, verbose=False, learning_rate=0.5)
        assert set(result) >= {"vi", "history", "X_est", "runtime",
                               "iterations", "method_name"}
        assert result["iterations"] == 3
        assert result["runtime"] > 0
        assert result["X_est"].shape == temporal_data["X"].shape

    def test_generate_report(self, tmp_path, temporal_data):
        exp_dir = setup_experiment_dir("unit", base_dir=str(tmp_path))
        result = run_method_with_timing(
            TemporalAMENaiveMFVI, temporal_data["model"], "Naive MF",
            max_iter=3, verbose=False, learning_rate=0.5)
        generate_experiment_report({"Naive MF": result}, exp_dir,
                                   X_true=temporal_data["X"],
                                   experiment_name="Unit")
        report = (exp_dir / "report.md").read_text()
        assert "# Unit Report" in report
        assert "Naive MF" in report
        assert "Parameter Recovery" in report

    def test_print_header(self, capsys):
        print_experiment_header("Exp", {"a": 1})
        out = capsys.readouterr().out
        assert "EXPERIMENT: Exp" in out
        assert "a" in out


@pytest.mark.slow
@pytest.mark.integration
class TestExperimentsEndToEnd:
    def test_three_way_comparison_small(self, tmp_path, monkeypatch,
                                        capsys):
        monkeypatch.chdir(tmp_path)
        from tame.experiments.three_way_comparison import (
            run_three_way_comparison)

        results, exp_dir = run_three_way_comparison(
            n_nodes=6, n_time=3, latent_dim=1, max_iter=5,
            learning_rate=0.5, save_outputs=True, verbose=False)
        # smoothed engine is included by default (promoted, VERDICT r2)
        assert set(results) == {"Naive MF", "Good SMF", "Bad SMF",
                                "Smoothed VI"}
        for r in results.values():
            assert len(r["history"]["elbo"]) == 5
            assert r["X_aligned"].shape == (6, 3, 4)
        assert (exp_dir / "report.md").exists()
        assert (exp_dir / "data" / "results.pkl").exists()
        assert list((exp_dir / "figures").glob("*.png"))

        results3, _ = run_three_way_comparison(
            n_nodes=6, n_time=3, latent_dim=1, max_iter=3,
            learning_rate=0.5, save_outputs=False, verbose=False,
            include_smoothed=False)
        assert set(results3) == {"Naive MF", "Good SMF", "Bad SMF"}

    def test_sensitivity_analysis_small(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        from tame.experiments.sensitivity_analysis import (
            run_sensitivity_analysis)

        results, exp_dir = run_sensitivity_analysis(
            parameter="n_nodes", values=[6, 8],
            base_params={"n_nodes": 6, "n_time": 3, "latent_dim": 1,
                         "ar_coefficient": 0.8, "rho_dyadic": 0.5},
            max_iter=5, learning_rate=0.5, n_replicates=2,
            save_outputs=True)
        assert set(results["data"]) == {6, 8}
        for v in (6, 8):
            naive = results["data"][v]["Naive MF"]
            assert len(naive["mses"]) == 2
            # keyed replicates must differ (reference bug: identical)
            assert naive["mses"][0] != naive["mses"][1]
        assert (exp_dir / "report.md").exists()

    def test_sensitivity_rejects_unknown_parameter(self):
        from tame.experiments.sensitivity_analysis import (
            run_sensitivity_analysis)
        with pytest.raises(ValueError):
            run_sensitivity_analysis(parameter="bogus", values=[1])

    def test_multiplicative_strength_small(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        from tame.experiments.multiplicative_strength_comparison import (
            run_experiment)

        results, model, X_true = run_experiment(
            "Strong Multiplicative", additive_scale=1.0,
            multiplicative_scale=2.0, n_nodes=6, n_time=3, max_iter=5,
            learning_rate=0.5, verbose=False)
        assert set(results) == {"Naive MF", "Good SMF", "Bad SMF"}
        # scaled truth was written back to the model
        assert model.X is X_true or np.allclose(
            np.asarray(model.X), np.asarray(X_true))
        for r in results.values():
            assert r["uv_correlation"].shape == (3,)
            assert np.all(np.abs(r["uv_correlation"]) <= 1.0 + 1e-6)

    def test_demo_runs(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        import sys
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        import demo

        results = demo.main(lr=0.5, max_iter=4, outdir=str(tmp_path / "o"),
                            n_nodes=6, n_time=3)
        out = capsys.readouterr().out
        assert "Step 9: Verdict" in out
        assert len(list((tmp_path / "o").glob("*.png"))) == 4
        assert set(results) == {"Naive MF", "Good SMF", "Bad SMF"}


class TestCLI:
    def test_fit_subcommand(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        from tame.cli import main

        rc = main(["fit", "--n-nodes", "6", "--n-time", "3",
                   "--latent-dim", "1", "--method", "good", "--lr", "0.5",
                   "--max-iter", "3",
                   "--checkpoint", str(tmp_path / "ck")])
        assert rc == 0
        out = capsys.readouterr().out
        assert "Diagnostic Summary" in out
        assert (tmp_path / "ck" / "manifest.json").exists()

    def test_fit_checkpoint_every_and_resume(self, tmp_path, monkeypatch,
                                             capsys):
        monkeypatch.chdir(tmp_path)
        from tame.cli import main

        rc = main(["fit", "--n-nodes", "6", "--n-time", "3",
                   "--latent-dim", "1", "--method", "good", "--lr", "0.5",
                   "--max-iter", "6", "--tolerance", "0",
                   "--checkpoint", str(tmp_path / "ck"),
                   "--checkpoint-every", "2"])
        assert rc == 0
        assert "checkpointed" in capsys.readouterr().out
        assert (tmp_path / "ck" / "manifest.json").exists()

        rc = main(["fit", "--n-nodes", "6", "--n-time", "3",
                   "--latent-dim", "1", "--method", "good", "--lr", "0.5",
                   "--max-iter", "10", "--tolerance", "0",
                   "--checkpoint", str(tmp_path / "ck"), "--resume"])
        assert rc == 0

    @pytest.mark.slow
    def test_sample_subcommand(self, capsys):
        from tame.cli import main

        rc = main(["sample", "--sampler", "hmc", "--n-nodes", "5",
                   "--n-time", "2", "--latent-dim", "1",
                   "--num-chains", "2", "--num-warmup", "10",
                   "--num-samples", "10"])
        assert rc == 0
        assert "HMC" in capsys.readouterr().out

    @pytest.mark.slow
    def test_sample_family_subcommand(self, capsys):
        from tame.cli import main

        rc = main(["sample", "--sampler", "smc", "--family", "poisson",
                   "--n-nodes", "6", "--n-time", "2", "--latent-dim",
                   "1", "--num-particles", "16", "--num-stages", "3"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "family='poisson'" in out and "SMC" in out

    def test_fit_binary_subcommand(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        from tame.cli import main

        rc = main(["fit", "--n-nodes", "8", "--n-time", "3",
                   "--latent-dim", "1", "--method", "binary",
                   "--lr", "0.8", "--max-iter", "10",
                   "--missing-frac", "0.2",
                   "--checkpoint", str(tmp_path / "ck")])
        assert rc == 0
        out = capsys.readouterr().out
        assert "family='bernoulli'" in out
        assert "Held-out-dyad accuracy" in out
        assert (tmp_path / "ck" / "manifest.json").exists()

    def test_fit_poisson_subcommand(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        from tame.cli import main

        rc = main(["fit", "--n-nodes", "8", "--n-time", "3",
                   "--latent-dim", "1", "--method", "poisson",
                   "--max-iter", "10", "--missing-frac", "0.2"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "family='poisson'" in out
        assert "Held-out-dyad mean deviance" in out

    def test_unknown_command_fails(self):
        from tame.cli import main

        with pytest.raises(SystemExit):
            main(["bogus"])


@pytest.mark.slow
def test_binary_comparison_experiment(tmp_path, monkeypatch, capsys):
    """The binary experiment row (tame/experiments/binary_comparison.py):
    all three methods produce held-out scores, the correct observation
    model wins or ties the Gaussian control on AUC, artifacts land in
    the results dir."""
    monkeypatch.chdir(tmp_path)
    from tame.experiments.binary_comparison import run_binary_comparison

    results, exp_dir = run_binary_comparison(n_nodes=20, n_time=5,
                                             max_iter=80, seed=0)
    assert set(results) == {"Binary JJ-VI", "Smoothed binary",
                            "Gaussian Good SMF"}
    for res in results.values():
        assert 0.0 <= res["holdout_accuracy"] <= 1.0
        assert np.isfinite(res["holdout_auc"])
        assert res["scores"].shape == (20, 20, 5)
    assert results["Binary JJ-VI"]["holdout_auc"] >= \
        results["Gaussian Good SMF"]["holdout_auc"] - 0.02
    assert (exp_dir / "figures" / "adjacency_probabilities.png").exists()
    assert (exp_dir / "report.md").exists()


@pytest.mark.slow
def test_sensitivity_missing_frac_sweep(tmp_path, monkeypatch):
    """The missing-data sweep axis: MSE degrades gracefully as dyads are
    hidden (each replicate gets its own random mask)."""
    from tame.experiments.sensitivity_analysis import (
        run_sensitivity_analysis)

    results, _ = run_sensitivity_analysis(
        parameter="missing_frac", values=[0.0, 0.4],
        base_params={"n_nodes": 10, "n_time": 4, "latent_dim": 1,
                     "ar_coefficient": 0.8, "rho_dyadic": 0.5},
        max_iter=30, learning_rate=0.7, n_replicates=2,
        save_outputs=False)
    d = results["data"]
    assert set(d) == {0.0, 0.4}
    for v in d.values():
        for m in v.values():
            assert np.isfinite(m["mse_mean"])


def test_learn_family_subcommand(capsys):
    from tame.cli import main

    rc = main(["learn", "--family", "poisson", "--n-nodes", "20",
               "--n-time", "4", "--latent-dim", "1", "--n-em", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "family=poisson" in out and "Learned after" in out
