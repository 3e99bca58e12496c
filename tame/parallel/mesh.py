"""Device-mesh construction and sharding layouts for multi-chip execution.

The reference is single-process/single-thread Python with no distributed
capability of any kind (SURVEY.md §2); every capability here is new
design:

* ``nodes`` mesh axis — shards the node axis n.  The n x n dyad contraction
  becomes row-local matmuls against an all-gathered (n, T, r) means tensor
  (small), and the per-time global sufficient statistics become ``psum``s.
* ``time`` mesh axis — shards the AR(1) time axis T.  The t-1/t/t+1
  tridiagonal coupling becomes a 1-step halo exchange, which GSPMD lowers to
  collective permutes on the shifted-pad operations.
* ``batch`` mesh axis — data parallelism over replicate fits / HMC chains /
  SMC particles.

All sharding is expressed through ``jax.sharding.NamedSharding`` +
``jit``/GSPMD; XLA hands the collectives to NCCL.  The mesh follows the
algorithm: the GPUs of a host reach each other all to all over NVLink.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(nodes: int = 1, time: int = 1, batch: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a mesh with axes ``(batch, nodes, time)``; size-1 axes are kept
    (GSPMD treats them as replicated) so PartitionSpecs stay uniform."""
    if devices is None:
        devices = jax.devices()
    needed = nodes * time * batch
    if needed > len(devices):
        raise ValueError(
            f"mesh {batch}x{nodes}x{time} needs {needed} devices, "
            f"have {len(devices)}")
    dev_array = np.asarray(devices[:needed]).reshape(batch, nodes, time)
    return Mesh(dev_array, axis_names=("batch", "nodes", "time"))


def auto_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Factor the available devices into a (nodes, time) mesh: time gets at
    most 2 (the halo exchange only pays off for long T), nodes the rest."""
    if n_devices is None:
        n_devices = len(jax.devices())
    time = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    nodes = n_devices // time
    return make_mesh(nodes=nodes, time=time)


def state_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for latent-state tensors (n, T, d): nodes x time."""
    return NamedSharding(mesh, P("nodes", "time", None))


def cov_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for covariance tensors (n, T, d, d)."""
    return NamedSharding(mesh, P("nodes", "time", None, None))


def obs_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for the observation tensor (n, n, T, 2): rows sharded over
    ``nodes`` (each shard owns its nodes' outgoing dyads), time over
    ``time``; the j (column) axis stays replicated so the per-row
    contraction against gathered means is local."""
    return NamedSharding(mesh, P("nodes", None, "time", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def chain_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Sharding for per-chain/per-particle stacked tensors with a leading
    chains axis: chains over ``batch``, everything else replicated.  Used to
    shard vmapped HMC/NUTS chains and SMC particles across the mesh (the
    north-star "64 sharded chains" configuration) — each device integrates
    only its chains; no collectives are needed because chains are
    independent."""
    return NamedSharding(mesh, P("batch", *([None] * (ndim - 1))))


def shard_smoothed_inputs(mesh: Mesh, Y, state):
    """Place smoothed-engine fit inputs on the mesh.

    The smoothed family's coordinate update is a per-node block-
    tridiagonal solve over the WHOLE trajectory
    (``tame.inference.smoothed``), so it shards over ``nodes`` only: the
    observation rows and every per-node state tensor split on the node
    axis; the time axis stays unsharded (the forward-backward recursion
    is sequential in t — use the ``nodes`` axis for scale; SURVEY.md §5
    records the measured negative result for T-sharding the exact
    smoother, ``tame/ops/tridiag.py:30-45``)."""
    from tame.inference.smoothed import SmoothedState

    if mesh.shape.get("time", 1) != 1:
        raise ValueError(
            "the smoothed engine shards over 'nodes' only; build the mesh "
            "with time=1")
    node_only = NamedSharding(mesh, P("nodes"))
    Y_sharded = jax.device_put(Y, NamedSharding(
        mesh, P("nodes", None, None, None)))
    state_sharded = SmoothedState(
        X_mean=jax.device_put(state.X_mean, NamedSharding(
            mesh, P("nodes", None, None))),
        X_cov=jax.device_put(state.X_cov, NamedSharding(
            mesh, P("nodes", None, None, None))),
        X_cross=jax.device_put(state.X_cross, NamedSharding(
            mesh, P("nodes", None, None, None))),
        logdets=jax.device_put(state.logdets, node_only),
    )
    return Y_sharded, state_sharded


def shard_fit_inputs(mesh: Mesh, Y, state):
    """Place fit inputs on the mesh with the canonical layout; jit picks the
    shardings up from the arguments and GSPMD propagates them through the
    whole compiled while-loop."""
    from tame.inference.cavi import CaviState

    Y_sharded = jax.device_put(Y, obs_sharding(mesh))
    state_sharded = CaviState(
        X_mean=jax.device_put(state.X_mean, state_sharding(mesh)),
        X_cov=jax.device_put(state.X_cov, cov_sharding(mesh)),
    )
    return Y_sharded, state_sharded
