"""Setup checker: file-existence + import smoke check
(reference ``quick_test.py:22-104``)."""

import sys
from pathlib import Path


def _pin_cpu():
    """The smoke check should not depend on an accelerator."""
    try:
        import jax
        jax.config.update("jax_platforms", "cpu")
    except Exception:  # noqa: BLE001
        pass

REQUIRED = [
    "tame/__init__.py",
    "tame/config.py",
    "tame/models/temporal_ame.py",
    "tame/models/static_ame.py",
    "tame/inference/cavi.py",
    "tame/inference/engine.py",
    "tame/inference/smoothed.py",
    "tame/inference/hmc.py",
    "tame/inference/nuts.py",
    "tame/inference/smc.py",
    "tame/inference/binary_cavi.py",
    "tame/inference/poisson_cavi.py",
    "tame/inference/family_smoothed.py",
    "tame/inference/evidence.py",
    "tame/io/datasets.py",
    "data/karate.csv",
    "tame/io/cstore.cpp",
    "tame/parallel/comm_analysis.py",
    "tame/ops/dyad.py",
    "tame/parallel/mesh.py",
    "tame/utils/alignment.py",
    "tame/utils/metrics.py",
    "tame/utils/diagnostics.py",
    "tame/visualization/__init__.py",
    "tame/experiments/utils.py",
    "demo.py",
    "bench.py",
    "__graft_entry__.py",
]


def main() -> int:
    _pin_cpu()
    root = Path(__file__).parent
    ok = True

    print("Checking files...")
    for rel in REQUIRED:
        exists = (root / rel).exists()
        print(f"  [{'OK' if exists else 'MISSING'}] {rel}")
        ok &= exists

    print("\nChecking imports...")
    try:
        import tame
        from tame.models import StaticAMEModel, TemporalAMEModel  # noqa
        from tame.inference import (  # noqa
            TemporalAMENaiveMFVI, TemporalAMEStructuredMFVI)
        from tame.inference import fit_em  # noqa
        from tame.inference import (  # noqa
            TemporalAMEBernoulliVI, TemporalAMEPoissonVI,
            fit_smoothed_family)
        from tame.inference.evidence import exact_elbo  # noqa
        from tame.io import edgelist_to_tensors, load_karate_club  # noqa
        from tame.models import random_dyad_mask  # noqa
        from tame import utils, visualization  # noqa
        from tame.experiments import utils as exp_utils  # noqa
        print(f"  [OK] tame {tame.__version__} imports cleanly")
    except Exception as e:  # noqa: BLE001
        print(f"  [FAIL] import error: {e}")
        ok = False

    print("\nSmoke test (tiny model)...")
    try:
        from tame.models import TemporalAMEModel
        from tame.inference import TemporalAMENaiveMFVI

        model = TemporalAMEModel(n_nodes=5, n_time=3, latent_dim=1, seed=0)
        model.generate_data()
        vi = TemporalAMENaiveMFVI(model, learning_rate=0.5)
        h = vi.fit(max_iter=3, verbose=False)
        assert len(h["elbo"]) == 3
        print("  [OK] 3-iteration fit ran")
    except Exception as e:  # noqa: BLE001
        print(f"  [FAIL] smoke test: {e}")
        ok = False

    print("\n" + ("All checks passed." if ok else "CHECKS FAILED."))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
