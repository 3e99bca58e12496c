"""Entry points that measure on the GPU refuse other backends, and the
persistent compile cache sits where the run can find it again."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--multi"],
                                  ["bench.py"]])
def test_measurement_entry_points_refuse_cpu(argv, tmp_path):
    """No CPU fallback: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, os.path.join(REPO, argv[0]),
                        *argv[1:]], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a CUDA GPU" in r.stderr


class TestCompileCache:
    def test_honours_env_dir(self, monkeypatch, tmp_path):
        import jax

        from tame.utils import cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert cache.compile_cache_dir() == str(tmp_path)
        assert cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; no config update over it
        assert jax.config.jax_compilation_cache_dir == before

    def test_fixed_in_checkout_path_otherwise(self, monkeypatch):
        from tame.utils import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        first = cache.compile_cache_dir()
        assert first == os.path.join(REPO, ".jax_cache", "xla")
        assert cache.compile_cache_dir() == first

    def test_cpu_backend_stays_opt_in(self, monkeypatch):
        from tame.utils import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.delenv("TAME_JAX_CACHE", raising=False)
        assert cache.enable_compile_cache() == ""


@pytest.mark.gpu
def test_kernel_phase_on_gpu(gpu):
    """chip_smoke.py's kernel checks at a reduced width, as compiled for
    the card."""
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.phase_kernels(n=400, T=20, block=100)
