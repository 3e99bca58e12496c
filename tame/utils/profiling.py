"""Profiling and observability utilities.

The reference's only instrumentation is wall-clock ``time.time()`` pairs
around ``fit()`` (reference ``experiments/utils.py:200-203``) and console
prints.  This module provides the production story:

* :func:`trace` — ``jax.profiler`` trace context (view in TensorBoard /
  xprof) for per-kernel device timing;
* :func:`benchmark` — warm-up + min-of-k wall timing with
  ``block_until_ready`` (the honest way to time dispatched device work);
* :class:`MetricsLogger` — append-only JSONL metric stream with host
  timestamps, the structured replacement for print-based progress.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[None]:
    """Capture a jax.profiler trace of the enclosed block.

    View with ``tensorboard --logdir <log_dir>`` (profile plugin) or xprof.
    """
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def benchmark(fn: Callable, *args, warmup: int = 1, repeats: int = 3,
              **kwargs) -> Dict[str, float]:
    """Time ``fn(*args)`` with compile excluded and async dispatch flushed.

    Returns ``{"best_s", "mean_s", "repeats"}``.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    times: List[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {"best_s": min(times), "mean_s": sum(times) / len(times),
            "repeats": repeats}


class MetricsLogger:
    """Append-only JSONL metrics stream.

    Each record: ``{"step": int, "time": unix_seconds, **metrics}``.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def log(self, step: int, **metrics: Any) -> None:
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read(path: str | Path) -> List[Dict[str, Any]]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]


def log_fit_history(logger: MetricsLogger, history: Dict[str, List[float]],
                    start_step: int = 0) -> None:
    """Stream a fit history dict into a metrics logger."""
    n = max((len(v) for v in history.values()), default=0)
    for i in range(n):
        logger.log(start_step + i,
                   **{k: v[i] for k, v in history.items() if i < len(v)})
