"""Typed configuration objects for the temporal AME framework.

Parameter names intentionally mirror the reference implementation's keyword
surface (``/root/reference/src/models/temporal_ame.py:93-104``,
``src/inference/naive_mf.py:60-66``, ``src/inference/structured_mf.py:58-66``,
``src/inference/base.py:127-133``) so that a user of the reference can move
configs over unchanged.  Unlike the reference — whose constructor seeding is
broken (seed lands in a ``sigma`` positional slot, see reference
``static_ame.py:89`` vs ``base.py:64-71``) — randomness here flows through
explicit ``jax.random`` keys derived from ``seed``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Configuration of the temporal AME generative model.

    The model family (reference ``temporal_ame.py:25-145``):

        Y_ij^t = [y_ij^t, y_ji^t]' ~ N(mu_ij^t, R)
        mu_ij^t = [a_i^t + b_j^t + U_i^t . V_j^t,  a_j^t + b_i^t + U_j^t . V_i^t]'
        X_i^t  = [a_i^t, b_i^t, U_i^t, V_i^t]  in R^d,  d = 2 + 2 r
        X_i^0  ~ N(0, blockdiag(Sigma, Psi))
        X_i^t  = Phi X_i^{t-1} + eps,   eps ~ N(0, Q)

    with Phi = ar_coefficient * I_d and
    Q = (1 - ar_coefficient^2) * blockdiag(Sigma, Psi) * process_noise_scale
    (the reference's deliberate variance-shrinkage semantics,
    ``temporal_ame.py:134-145``).
    """

    n_nodes: int
    n_time: int = 1
    latent_dim: int = 2
    ar_coefficient: float = 0.8
    rho_additive: float = 0.5
    rho_multiplicative: float = 0.3
    rho_dyadic: float = 0.5
    process_noise_scale: float = 0.1
    dyadic_variance: float = 0.1  # reference hard-codes 0.1 (static_ame.py:96-101)
    seed: int = 42

    @property
    def d(self) -> int:
        """State dimension d = 2 + 2 r (reference ``temporal_ame.py:119-120``)."""
        return 2 + 2 * self.latent_dim

    @property
    def r(self) -> int:
        return self.latent_dim


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Configuration of a CAVI fit.

    ``learning_rate`` is a damping factor on the coordinate update
    (reference ``naive_mf.py:277-281``): new = lr * closed_form + (1-lr) * old.

    ``update_mode``:
      * ``"jacobi"``  — all (node, time) factors updated simultaneously from
        the previous iterate.  Fully batched.  Same
        fixed points as the reference's sweep, different trajectory.
      * ``"block"``   — block Gauss–Seidel: nodes in a few sequential
        groups, each group batched; near-GS stability at high damping with
        full device parallelism inside a group.  Preferred at large n.
      * ``"seq"``     — Gauss–Seidel sweep over nodes (and times within a
        node), matching the reference trajectory semantics
        (``naive_mf.py:203-205``, ``naive_mf.py:235``).  Compiled via
        ``lax.fori_loop``/``lax.scan``; useful for small-n parity studies.

    ``mixed_precision`` stores the constant dyad-weight tensors in
    bfloat16 and runs the eta contractions as single-pass bf16 tensor-core
    matmuls with float32 accumulation; ``diag_mode="stats"`` computes
    per-iteration ELBO/MSE from global sufficient statistics instead of an
    O(n^2 T) residual pass.  Both are production-scale speedups validated
    against the exact paths (``tame.inference.cavi.fit_cavi``).
    """

    structure: str = "full"  # "diag" | "full" | "block" (naive / good / bad)
    learning_rate: float = 1.0
    init_scale: float = 0.1
    cov_init_scale: float = 0.5
    max_iter: int = 100
    tolerance: float = 1e-4
    patience: int = 3  # consecutive small-rel-change iters (base.py:183-191)
    update_mode: str = "block"
    mixed_precision: bool = False
    diag_mode: str = "exact"  # "exact" | "stats"
    seed: int = 42

    def __post_init__(self):
        if self.structure not in ("diag", "full", "block"):
            raise ValueError(
                f"Unknown structure '{self.structure}' "
                "(expected 'diag', 'full' or 'block')"
            )
        if self.update_mode not in ("jacobi", "block", "seq"):
            raise ValueError(f"Unknown update_mode '{self.update_mode}'")
        if self.diag_mode not in ("exact", "stats"):
            raise ValueError(f"Unknown diag_mode '{self.diag_mode}'")


# Mapping between the reference's factorization nomenclature and ours.
FACTORIZATION_TO_STRUCTURE = {"good": "full", "bad": "block"}
STRUCTURE_TO_FACTORIZATION = {v: k for k, v in FACTORIZATION_TO_STRUCTURE.items()}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-chip execution.

    Axes:
      * ``nodes``  — shards the node axis n (the n x n dyad contraction);
      * ``time``   — shards the AR(1) time axis T (1-step halo coupling);
      * ``batch``  — data/replicate/chain parallelism (vmapped fits, HMC
        chains, SMC particles).
    Any axis of size 1 is dropped from the mesh.
    """

    nodes: int = 1
    time: int = 1
    batch: int = 1
