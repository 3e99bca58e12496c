"""Multi-host distributed execution: initialization and scaling harness.

The reference is single-process with no communication backend at all
(SURVEY.md §5).  Here: ``jax.distributed.initialize`` + GSPMD, with
XLA handing the collectives to NCCL (NVLink within a host, the network
across hosts).  Every process runs the same program; arrays are globally
sharded over the full multi-process mesh built here.

On a single host these helpers degrade gracefully (no-op initialize,
meshes over local devices), so the same launcher script works from one
GPU to many hosts.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import jax

from tame.parallel.mesh import make_mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Initialize the multi-process runtime.

    ``coordinator_address`` (``host:port``), or else the
    ``COORDINATOR_ADDRESS`` environment variable, names the coordinator;
    ``num_processes`` and ``process_id`` go with it.  With neither, the
    run stays single-process.  Returns True when running multi-process,
    False when single-process (already initialized counts as its current
    state).
    """
    import os

    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    try:
        if address is not None:
            jax.distributed.initialize(
                coordinator_address=address,
                num_processes=num_processes, process_id=process_id)
    except RuntimeError:
        # Already initialized.
        pass
    return jax.process_count() > 1


def global_mesh(nodes: Optional[int] = None, time_axis: int = 1,
                batch: int = 1):
    """Mesh over ALL devices across hosts: defaults to every device on the
    ``nodes`` axis."""
    total = jax.device_count()
    if nodes is None:
        nodes = total // (time_axis * batch)
    return make_mesh(nodes=nodes, time=time_axis, batch=batch,
                     devices=jax.devices())


def measure_scaling_efficiency(fit_fn, Y, init, device_counts,
                               repeats: int = 2) -> Dict[int, Dict]:
    """STRONG-scaling harness: run ``fit_fn(Y, init, mesh)`` on the SAME
    problem over meshes of increasing size and report wall time, speedup
    and parallel efficiency relative to the smallest mesh.

    ``fit_fn`` must return after ``block_until_ready``; with the smallest
    count N0, efficiency at N devices is ``(t_{N0} * N0) / (t_N * N)`` —
    1.0 means perfect linear speedup (the north-star's >= 80% multi-host
    criterion).  For WEAK scaling (problem grows with the mesh) use
    :func:`measure_weak_scaling`.

    Caveat: on a virtual CPU mesh (``xla_force_host_platform_device_count``)
    all "devices" share the host's physical cores, so wall-clock efficiency
    there measures sharding *overhead*, not real speedup —
    :mod:`tame.parallel.comm_analysis` gives the communication volume
    from the compiled program instead.
    """
    from tame.parallel.mesh import shard_fit_inputs

    results: Dict[int, Dict] = {}
    base = None
    for count in device_counts:
        mesh = make_mesh(nodes=count, devices=jax.devices()[:count])
        Y_s, init_s = shard_fit_inputs(mesh, Y, init)
        fit_fn(Y_s, init_s, mesh)  # compile
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fit_fn(Y_s, init_s, mesh)
            best = min(best, time.perf_counter() - t0)
        if base is None:
            base = best * count  # device-seconds of the smallest mesh
        efficiency = base / (best * count)
        results[count] = {"wall_s": best,
                          "speedup": efficiency * count,
                          "efficiency": efficiency}
    return results


def measure_weak_scaling(problem_fn, fit_fn, device_counts,
                         repeats: int = 2) -> Dict[int, Dict]:
    """WEAK-scaling harness: the problem grows with the mesh.

    ``problem_fn(count) -> (Y, init)`` builds a problem sized for
    ``count`` devices (e.g. n proportional to count); ``fit_fn(Y, init,
    mesh)`` must block until done.  Perfect weak scaling keeps wall time
    flat, so efficiency at N devices is ``t_{N0} / t_N``.
    """
    from tame.parallel.mesh import shard_fit_inputs

    results: Dict[int, Dict] = {}
    base_time = None
    for count in device_counts:
        mesh = make_mesh(nodes=count, devices=jax.devices()[:count])
        Y, init = problem_fn(count)
        Y_s, init_s = shard_fit_inputs(mesh, Y, init)
        fit_fn(Y_s, init_s, mesh)  # compile
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fit_fn(Y_s, init_s, mesh)
            best = min(best, time.perf_counter() - t0)
        if base_time is None:
            base_time = best
        results[count] = {"wall_s": best,
                          "efficiency": base_time / best}
    return results
