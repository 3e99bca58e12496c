"""Probe: can this jax build run REAL multi-process (multi-"host")
collectives on the CPU backend?  Spawns itself twice with
``jax.distributed.initialize``; each process owns 4 virtual CPU devices of
a global 8-device world and computes a psum over a global mesh."""
import os
import subprocess
import sys

PORT = 47311


def worker(pid: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    print(f"[p{pid}] local={jax.local_device_count()} "
          f"global={jax.device_count()}", flush=True)
    assert jax.device_count() == 8
    mesh = Mesh(jax.devices(), ("x",))
    sharding = NamedSharding(mesh, P("x"))

    # Global array: each process supplies its local shards.
    def cb(index):
        return jnp.arange(16.0)[index]

    arr = jax.make_array_from_callback((16,), sharding, cb)
    total = jax.jit(lambda a: jnp.sum(a) * 1.0,
                    out_shardings=NamedSharding(mesh, P()))(arr)
    val = float(total.addressable_shards[0].data) if total.addressable_shards else None
    print(f"[p{pid}] sum={val}", flush=True)
    assert val == 120.0, val
    print(f"[p{pid}] OK", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]))
    else:
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["PYTHONPATH"] = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
        procs = [subprocess.Popen([sys.executable, __file__, str(i)],
                                  env=env) for i in range(2)]
        codes = [p.wait(timeout=180) for p in procs]
        print("exit codes:", codes)
        sys.exit(max(codes))
