"""Command-line interface: config-driven runners for every workflow.

The reference has no CLI at all — experiments are "configured" by editing
``__main__`` blocks (reference ``three_way_conparison.py:321-333``,
SURVEY.md §5).  Here every workflow is a subcommand with flags mirroring
the model/inference keyword surface:

    python -m tame demo --lr 0.7 --max-iter 150
    python -m tame fit --n-nodes 100 --n-time 20 --method good --lr 0.8
    python -m tame three-way --n-nodes 15 --max-iter 200 --lr 0.7
    python -m tame sensitivity --parameter n_nodes --values 10 20 30
    python -m tame mult-strength --n-nodes 20
    python -m tame sample --sampler nuts --num-chains 4
    python -m tame bench
"""

from __future__ import annotations

import argparse
import sys


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n-nodes", type=int, default=15)
    p.add_argument("--n-time", type=int, default=10)
    p.add_argument("--latent-dim", type=int, default=2)
    p.add_argument("--ar-coefficient", type=float, default=0.8)
    p.add_argument("--rho-additive", type=float, default=0.5)
    p.add_argument("--rho-multiplicative", type=float, default=0.3)
    p.add_argument("--rho-dyadic", type=float, default=0.5)
    p.add_argument("--process-noise-scale", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)


def _build_model(args):
    from tame.models import TemporalAMEModel

    return TemporalAMEModel(
        n_nodes=args.n_nodes, n_time=args.n_time,
        latent_dim=args.latent_dim, ar_coefficient=args.ar_coefficient,
        rho_additive=args.rho_additive,
        rho_multiplicative=args.rho_multiplicative,
        rho_dyadic=args.rho_dyadic,
        process_noise_scale=args.process_noise_scale, seed=args.seed)


def _cmd_demo(args) -> int:
    import demo

    demo.main(lr=args.lr, max_iter=args.max_iter, outdir=args.outdir,
              n_nodes=args.n_nodes, n_time=args.n_time, seed=args.seed)
    return 0


def _cmd_fit(args) -> int:
    from tame.inference import (
        TemporalAMENaiveMFVI,
        TemporalAMEStructuredMFVI,
    )
    from tame.utils import print_diagnostic_summary

    model = _build_model(args)
    _, X_true = model.generate_data(return_latents=True)
    if args.method in ("binary", "poisson"):
        # Regenerate observations from the matching dyadic family
        # through the same latent states (cf. the `sample` subcommand).
        import jax
        import numpy as np

        from tame.models import sample_observations

        family = "bernoulli" if args.method == "binary" else "poisson"
        model.Y = np.asarray(sample_observations(
            model.params, jax.random.PRNGKey(args.seed + 7),
            model.X, family=family))
        print(f"Observations regenerated with family='{family}'.")
    mask = None
    missing = getattr(args, "missing_frac", 0.0)
    if missing:
        import jax

        from tame.models import random_dyad_mask

        if args.update_mode == "seq" and args.method not in (
                "smoothed", "binary", "poisson"):
            print("--missing-frac requires --update-mode block or jacobi.")
            return 1
        mask = random_dyad_mask(jax.random.PRNGKey(args.seed + 1),
                                args.n_nodes, args.n_time, missing)
        print(f"Hiding {missing:.0%} of dyads at random; fitting on "
              "the rest.")
    if args.method in ("binary", "poisson"):
        from tame.inference import (
            TemporalAMEBernoulliVI,
            TemporalAMEPoissonVI,
        )

        cls = (TemporalAMEBernoulliVI if args.method == "binary"
               else TemporalAMEPoissonVI)
        vi = cls(model, learning_rate=args.lr, seed=args.seed,
                 init_mode=args.init, mask=mask)
    elif args.method == "naive":
        vi = TemporalAMENaiveMFVI(model, learning_rate=args.lr,
                                  seed=args.seed,
                                  update_mode=args.update_mode,
                                  init_mode=args.init, mask=mask)
    elif args.method == "smoothed":
        from tame.inference import TemporalAMESmoothedVI

        if args.update_mode == "seq":
            print("--update-mode seq is a CAVI reference-parity mode; "
                  "the smoothed engine supports block or jacobi.")
            return 1
        vi = TemporalAMESmoothedVI(model, learning_rate=args.lr,
                                   seed=args.seed, init_mode=args.init,
                                   update_mode=args.update_mode,
                                   mask=mask)
    else:
        vi = TemporalAMEStructuredMFVI(
            model, factorization=args.method, learning_rate=args.lr,
            seed=args.seed, update_mode=args.update_mode,
            init_mode=args.init, mask=mask)
    # Validate checkpoint support BEFORE the (potentially long) fit so an
    # unsupported engine fails fast instead of discarding the work.
    if args.checkpoint and not hasattr(vi, "save_checkpoint"):
        print("Checkpointing is not supported for this engine.")
        return 1
    fit_kw = {}
    if args.checkpoint_every:
        fit_kw.update(checkpoint_every=args.checkpoint_every,
                      ckpt_dir=args.checkpoint)
    if args.resume:
        fit_kw.update(ckpt_dir=args.checkpoint, resume=True)
    history = vi.fit(max_iter=args.max_iter, tolerance=args.tolerance,
                     verbose=True, check_every=args.check_every, **fit_kw)
    print_diagnostic_summary(args.method, history, X_true=X_true,
                             X_est=vi.X_mean, latent_dim=args.latent_dim)
    if mask is not None:
        import jax.numpy as jnp
        import numpy as np

        from tame.ops import dyad as dyad_ops

        fwd = np.asarray(dyad_ops.dyadic_fwd_temporal(
            vi.X_mean, args.latent_dim))
        y0 = np.asarray(jnp.asarray(model.Y)[..., 0])
        m = np.asarray(mask)
        off = 1.0 - np.eye(args.n_nodes)[:, :, None]
        held = off * (1.0 - m)
        if args.method == "binary":
            acc = (fwd > 0) == (y0 > 0.5)
            print(f"Observed-dyad accuracy: "
                  f"{(acc * m).sum() / m.sum():.4f}")
            print(f"Held-out-dyad accuracy: "
                  f"{(acc * held).sum() / max(held.sum(), 1):.4f}")
        elif args.method == "poisson":
            rate = np.exp(np.clip(fwd, -20, 20))
            with np.errstate(divide="ignore", invalid="ignore"):
                ylogy = np.where(y0 > 0, y0 * np.log(np.maximum(y0,
                                                                1e-12)),
                                 0.0)
            dev = 2.0 * (ylogy - y0 * fwd - y0 + rate)
            print(f"Observed-dyad mean deviance: "
                  f"{(dev * m).sum() / m.sum():.4f}")
            print(f"Held-out-dyad mean deviance: "
                  f"{(dev * held).sum() / max(held.sum(), 1):.4f}")
        else:
            e2 = (y0 - fwd) ** 2
            print(f"Observed-dyad recon MSE: "
                  f"{(e2 * m).sum() / m.sum():.6f}")
            print(f"Held-out-dyad recon MSE: "
                  f"{(e2 * held).sum() / max(held.sum(), 1):.6f}")
    if args.checkpoint:
        vi.save_checkpoint(args.checkpoint)
        print(f"Checkpoint written to {args.checkpoint}")
    return 0


def _cmd_three_way(args) -> int:
    from tame.experiments.three_way_comparison import (
        run_three_way_comparison)

    run_three_way_comparison(
        n_nodes=args.n_nodes, n_time=args.n_time,
        latent_dim=args.latent_dim, rho_dyadic=args.rho_dyadic,
        ar_coefficient=args.ar_coefficient, max_iter=args.max_iter,
        learning_rate=args.lr, seed=args.seed,
        save_outputs=not args.no_save)
    return 0


def _cmd_sensitivity(args) -> int:
    from tame.experiments.sensitivity_analysis import (
        run_sensitivity_analysis)

    run_sensitivity_analysis(
        parameter=args.parameter, values=args.values,
        max_iter=args.max_iter, learning_rate=args.lr,
        n_replicates=args.n_replicates, seed=args.seed,
        save_outputs=not args.no_save)
    return 0


def _cmd_mult_strength(args) -> int:
    from tame.experiments.multiplicative_strength_comparison import main

    main(save_outputs=not args.no_save, n_nodes=args.n_nodes,
         n_time=args.n_time, max_iter=args.max_iter, seed=args.seed)
    return 0


def _cmd_binary_compare(args) -> int:
    from tame.experiments.binary_comparison import run_binary_comparison

    run_binary_comparison(
        n_nodes=args.n_nodes, n_time=args.n_time,
        latent_dim=args.latent_dim,
        ar_coefficient=args.ar_coefficient,
        missing_frac=args.missing_frac, max_iter=args.max_iter,
        seed=args.seed, save_outputs=not args.no_save)
    return 0


def _cmd_sample(args) -> int:
    import numpy as np

    from tame.inference import (
        TemporalAMEHMC,
        TemporalAMENUTS,
        TemporalAMESMC,
    )

    model = _build_model(args)
    model.generate_data()
    family = getattr(args, "family", "gaussian")
    if family != "gaussian":
        # Regenerate observations from the declared dyadic family
        # through the same latent states (tame.models.likelihoods).
        import jax

        from tame.models import sample_observations

        model.Y = np.asarray(sample_observations(
            model.params, jax.random.PRNGKey(args.seed + 7),
            model.X, family=family))
        print(f"Observations regenerated with family='{family}'.")
    if args.sampler == "smc":
        smc = TemporalAMESMC(model, num_particles=args.num_particles,
                             num_stages=args.num_stages, seed=args.seed,
                             family=family)
        result = smc.sample()
        ns = int(result.n_stages)
        print(f"SMC: {args.num_particles} particles, "
              f"{ns} adaptive stages, "
              f"log-evidence = {float(result.log_evidence):.2f}, "
              f"final ESS = "
              f"{float(np.asarray(result.ess_history)[ns - 1]):.1f}")
    else:
        cls = TemporalAMENUTS if args.sampler == "nuts" else TemporalAMEHMC
        sampler = cls(model, num_chains=args.num_chains, seed=args.seed,
                      family=family)
        out = sampler.sample(num_warmup=args.num_warmup,
                             num_samples=args.num_samples)
        print(f"{args.sampler.upper()}: {args.num_chains} chains x "
              f"{args.num_samples} samples, mean accept = "
              f"{float(np.asarray(out.accept_prob).mean()):.3f}, "
              f"step sizes = "
              f"{np.round(np.asarray(out.step_size), 4).tolist()}")
    return 0


def _cmd_learn(args) -> int:
    """Hyperparameter learning demo: generate with the true config, start
    variational EM from a (wrong) guess, print the recovery."""
    import jax

    from tame.config import ModelConfig
    from tame.inference import fit_em
    from tame.models import build_params, sample

    family = getattr(args, "family", "gaussian")
    cfg = ModelConfig(n_nodes=args.n_nodes, n_time=args.n_time,
                      latent_dim=args.latent_dim,
                      ar_coefficient=args.ar_coefficient,
                      rho_dyadic=args.rho_dyadic, seed=args.seed)
    Y, _ = sample(build_params(cfg), jax.random.PRNGKey(args.seed),
                  cfg.n_nodes, cfg.n_time,
                  family=None if family == "gaussian" else family)
    cfg0 = ModelConfig(n_nodes=args.n_nodes, n_time=args.n_time,
                       latent_dim=args.latent_dim,
                       ar_coefficient=args.start_phi,
                       rho_dyadic=args.start_rho,
                       dyadic_variance=args.start_variance,
                       seed=args.seed)
    mask = None
    if args.missing_frac:
        from tame.models import random_dyad_mask

        mask = random_dyad_mask(jax.random.PRNGKey(args.seed + 1),
                                args.n_nodes, args.n_time,
                                args.missing_frac)
    if family == "gaussian":
        print(f"True:  phi={cfg.ar_coefficient}  sigma2=0.1  "
              f"rho={cfg.rho_dyadic}")
        print(f"Start: phi={args.start_phi}  "
              f"sigma2={args.start_variance}  rho={args.start_rho}")
    else:
        print(f"family={family}: learning phi/Q/Sigma0 (the R M-step "
              "is Gaussian-specific and skipped)")
        print(f"True:  phi={cfg.ar_coefficient}   "
              f"Start: phi={args.start_phi}")
    res = fit_em(Y, build_params(cfg0), n_em=args.n_em, mask=mask,
                 family=family, verbose=True)
    h = res.history
    if family == "gaussian":
        print(f"Learned after {len(h['elbo'])} EM iterations: "
              f"phi={h['phi'][-1]:.3f}  sigma2={h['sigma2'][-1]:.4f}  "
              f"rho={h['rho'][-1]:.3f}")
    else:
        print(f"Learned after {len(h['elbo'])} EM iterations: "
              f"phi={h['phi'][-1]:.3f}")
    return 0


def _cmd_bench(args) -> int:
    import bench

    bench.main()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tame", description="temporal-AME inference")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("demo", help="canonical 9-step workflow")
    _add_model_flags(p)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--outdir", default="demo_output")
    p.set_defaults(fn=_cmd_demo)

    p = sub.add_parser("fit", help="fit one VI engine")
    _add_model_flags(p)
    p.add_argument("--method",
                   choices=["naive", "good", "bad", "smoothed",
                            "binary", "poisson"],
                   default="good",
                   help="'binary'/'poisson' fit the non-Gaussian "
                        "engines (JJ-bound / CVI) on observations "
                        "regenerated from the matching dyadic family")
    p.add_argument("--lr", type=float, default=0.7)
    p.add_argument("--max-iter", type=int, default=150)
    p.add_argument("--tolerance", type=float, default=1e-4)
    p.add_argument("--check-every", type=int, default=10)
    p.add_argument("--update-mode",
                   choices=["block", "jacobi", "seq"], default="block")
    p.add_argument("--init", choices=["random", "warm"], default="random",
                   help="'warm' seeds CAVI from a closed-form data "
                        "decomposition (fewer iterations / better optima)")
    p.add_argument("--checkpoint", default=None,
                   help="directory to write a checkpoint to")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="checkpoint + print progress every K iterations "
                        "during the fit (requires --checkpoint)")
    p.add_argument("--resume", action="store_true",
                   help="restore --checkpoint before fitting; --max-iter "
                        "is the total budget")
    p.add_argument("--missing-frac", type=float, default=0.0,
                   help="hide this fraction of dyads at random and fit "
                        "on the rest (missing-data demo; reports held-"
                        "out reconstruction error)")
    p.set_defaults(fn=_cmd_fit)

    p = sub.add_parser("three-way", help="Naive vs Good vs Bad comparison")
    _add_model_flags(p)
    p.add_argument("--lr", type=float, default=0.7)
    p.add_argument("--max-iter", type=int, default=200)
    p.add_argument("--no-save", action="store_true")
    p.set_defaults(fn=_cmd_three_way)

    p = sub.add_parser("sensitivity", help="parameter sweep")
    p.add_argument("--parameter", default="n_nodes",
                   choices=["n_nodes", "n_time", "ar_coefficient",
                            "rho_dyadic", "missing_frac"])
    p.add_argument("--values", type=float, nargs="+",
                   default=[10, 15, 20, 25, 30])
    p.add_argument("--lr", type=float, default=0.7)
    p.add_argument("--max-iter", type=int, default=150)
    p.add_argument("--n-replicates", type=int, default=3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-save", action="store_true")
    p.set_defaults(fn=_cmd_sensitivity)

    p = sub.add_parser("mult-strength",
                       help="weak vs strong multiplicative regimes")
    _add_model_flags(p)
    p.add_argument("--max-iter", type=int, default=150)
    p.add_argument("--no-save", action="store_true")
    p.set_defaults(fn=_cmd_mult_strength)

    p = sub.add_parser(
        "binary-compare",
        help="binary networks: JJ-VI vs smoothed vs Gaussian control")
    _add_model_flags(p)
    p.add_argument("--missing-frac", type=float, default=0.2)
    p.add_argument("--max-iter", type=int, default=200)
    p.add_argument("--no-save", action="store_true")
    p.set_defaults(fn=_cmd_binary_compare)

    p = sub.add_parser("sample", help="posterior sampling (HMC/NUTS/SMC)")
    _add_model_flags(p)
    p.add_argument("--sampler", choices=["hmc", "nuts", "smc"],
                   default="nuts")
    p.add_argument("--family",
                   choices=["gaussian", "poisson", "bernoulli"],
                   default="gaussian",
                   help="dyadic observation family (non-Gaussian "
                        "families regenerate Y from the latents and "
                        "sample the matching posterior)")
    p.add_argument("--num-chains", type=int, default=4)
    p.add_argument("--num-warmup", type=int, default=200)
    p.add_argument("--num-samples", type=int, default=200)
    p.add_argument("--num-particles", type=int, default=256)
    p.add_argument("--num-stages", type=int, default=200,
                   help="stage BUFFER for the adaptive tempering "
                        "schedule (the run stops when beta reaches 1)")
    p.set_defaults(fn=_cmd_sample)

    p = sub.add_parser(
        "learn",
        help="hyperparameter learning (variational EM) recovery demo")
    _add_model_flags(p)
    p.add_argument("--family",
                   choices=["gaussian", "bernoulli", "poisson"],
                   default="gaussian",
                   help="observation family (non-Gaussian: the smoothed"
                        " JJ/CVI E-step learns phi/Q/Sigma0)")
    p.add_argument("--n-em", type=int, default=20)
    p.add_argument("--start-phi", type=float, default=0.3,
                   help="wrong starting AR coefficient")
    p.add_argument("--start-rho", type=float, default=0.0,
                   help="wrong starting dyadic correlation")
    p.add_argument("--start-variance", type=float, default=1.0,
                   help="wrong starting dyadic variance (true: 0.1)")
    p.add_argument("--missing-frac", type=float, default=0.0)
    p.set_defaults(fn=_cmd_learn)

    p = sub.add_parser("bench", help="one-line JSON benchmark")
    p.set_defaults(fn=_cmd_bench)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # sensitivity values: ints for count-like parameters
    if getattr(args, "parameter", None) in ("n_nodes", "n_time"):
        args.values = [int(v) for v in args.values]
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
