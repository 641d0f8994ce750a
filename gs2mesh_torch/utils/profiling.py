"""Profiling and per-stage timing (port of gs2mesh_tpu utils/profiling.py).

The reference's observability is CUDA-event iteration timing logged to
TensorBoard (train.py:44-45,67,95,160) plus tqdm bars. Here:

  * ``profile_trace`` — a ``torch.profiler.profile`` scope (host activity,
    and the card's kernels when one is present) that writes a Chrome trace
    under ``log_dir`` (viewable in Perfetto or chrome://tracing);
  * ``StageTimer`` — wall-clock per-stage accumulator with JSON export;
  * ``time_block`` — one-off timed scope that synchronises the card first;
  * ``MetricLogger`` — append-only JSONL scalars.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler scope; on exit writes ``trace_<time>_<pid>.json``
    (Chrome trace format) under log_dir. Yields log_dir."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
        f".json"))


def _synchronize(value) -> None:
    """Waits for the card(s) behind every CUDA tensor in ``value`` (a tensor
    or a list / tuple / dict of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _synchronize(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _synchronize(v)


@contextlib.contextmanager
def time_block(name: str = "block", sync=None, verbose: bool = True):
    """Timed scope; pass ``sync=tensor`` to wait for its card before the
    clock stops. Yields a dict whose "ms" is set on exit."""
    rec = {}
    t0 = time.perf_counter()
    yield rec
    if sync is not None:
        _synchronize(sync)
    rec["ms"] = (time.perf_counter() - t0) * 1e3
    if verbose:
        print(f"[time] {name}: {rec['ms']:.2f} ms")


class StageTimer:
    """Accumulates wall time + call counts per named stage."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": self.total[k], "count": self.count[k],
                    "mean_s": self.total[k] / max(self.count[k], 1)}
                for k in self.total}

    def report(self) -> str:
        lines = [f"{k:24s} {v['total_s']:9.3f}s  x{v['count']:<6d} "
                 f"({v['mean_s'] * 1e3:8.2f} ms/call)"
                 for k, v in sorted(self.summary().items())]
        return "\n".join(lines)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


class MetricLogger:
    """Append-only JSONL scalar logger (TensorBoard-scalar stand-in; the
    reference logs train loss/PSNR/iter_time, train.py:148-191)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, step: int, **scalars) -> None:
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
