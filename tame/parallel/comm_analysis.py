"""Communication/compute analysis of the compiled sharded fit.

The multi-device scaling claim (BASELINE.md: >= 80 % efficiency at N >= 2
hosts) is *argued* from the compiled program itself: GSPMD inserts
explicit collective ops (``all-reduce``, ``all-gather``,
``collective-permute``, ...) into the HLO, and their shapes are the exact
per-iteration communication volume.  This module extracts them and
compares against the FLOP count from the compiler's cost analysis.

The reference has no distributed execution of any kind (SURVEY.md §2);
this analysis layer is new surface.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import jax
import jax.numpy as jnp

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")

# `f32[128,16]{1,0} all-gather(...)`; async ops appear as `-start`.
_OP_RE = re.compile(
    r"=\s*(?:\()?\s*([a-z0-9]+)\[([\d,]*)\][^ ]*\s+"
    r"(" + "|".join(_COLLECTIVES) + r")(?:-start)?\(")


def collective_stats(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind op count and byte volume in an HLO module.

    Counts each op once (``-start``/``-done`` pairs collapse onto the
    start); bytes are the op's result shape.  Ops inside the while-loop
    body execute once per fit iteration.
    """
    stats: Dict[str, Dict[str, float]] = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m or "-done" in line.split("=")[0]:
            continue
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        size = _DTYPE_BYTES.get(dtype)
        if size is None:
            continue
        count = 1
        for d in dims.split(","):
            if d:
                count *= int(d)
        entry = stats.setdefault(kind, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += count * size
    return stats


def analyze_sharded_fit(n: int, T: int, r: int, *, nodes: int = 1,
                        time_axis: int = 1, structure: str = "full",
                        update_mode: str = "block",
                        num_blocks: Optional[int] = None,
                        diag_mode: str = "exact") -> Dict:
    """Compile (without executing) one full CAVI fit sharded over a
    ``nodes x time`` mesh and return its communication and compute
    profile.

    Uses abstract ``ShapeDtypeStruct`` inputs with the canonical
    shardings, so north-star shapes (n=2000, T=50, r=4) analyze in
    seconds without materializing observation tensors.

    Returns keys: ``collectives`` (per-kind count/bytes — loop-body ops
    execute once per iteration), ``collective_bytes`` (total), ``flops``
    and ``bytes_accessed`` (whole-fit cost analysis as reported by XLA;
    divide by ``max_iter`` externally if a per-iteration figure is
    needed — the while loop body is counted once in both).
    """
    from tame.config import ModelConfig
    from tame.inference import cavi
    from tame.models import build_params
    from tame.parallel.mesh import (
        cov_sharding,
        make_mesh,
        obs_sharding,
        replicated,
        state_sharding,
    )

    d = 2 + 2 * r
    if num_blocks is None:
        num_blocks = next(k for k in range(min(16, n), 0, -1)
                          if n % k == 0)
    mesh = make_mesh(nodes=nodes, time=time_axis,
                     devices=jax.devices()[:nodes * time_axis])
    cfg = ModelConfig(n_nodes=n, n_time=T, latent_dim=r, seed=0)
    params = build_params(cfg)

    f32 = jnp.float32
    Y = jax.ShapeDtypeStruct((n, n, T, 2), f32,
                             sharding=obs_sharding(mesh))
    init = cavi.CaviState(
        X_mean=jax.ShapeDtypeStruct((n, T, d), f32,
                                    sharding=state_sharding(mesh)),
        X_cov=jax.ShapeDtypeStruct((n, T, d, d), f32,
                                   sharding=cov_sharding(mesh)),
    )
    rep = replicated(mesh)
    scalar = jax.ShapeDtypeStruct((), f32, sharding=rep)
    int_scalar = jax.ShapeDtypeStruct((), jnp.int32, sharding=rep)

    lowered = cavi._fit_cavi_impl.lower(
        Y, params, init, int_scalar, scalar, scalar, scalar, int_scalar,
        structure=structure, update_mode=update_mode, buf_size=64,
        patience=3, num_blocks=num_blocks, corrected=False,
        elbo_every=1, mixed_precision=False, diag_mode=diag_mode,
)
    compiled = lowered.compile()
    stats = collective_stats(compiled.as_text())

    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return {
        "n": n, "T": T, "r": r, "nodes": nodes, "time": time_axis,
        "num_blocks": num_blocks, "structure": structure,
        "update_mode": update_mode,
        "collectives": stats,
        "collective_bytes": sum(v["bytes"] for v in stats.values()),
        "flops": float(cost.get("flops", 0.0)),
        "bytes_accessed": float(cost.get("bytes accessed", 0.0)),
    }
