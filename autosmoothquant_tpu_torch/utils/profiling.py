"""Phase timers, a device trace and a device timer (the port of
``autosmoothquant_tpu/utils/profiling.py``).

  - ``phase``: wall-clock phase timers into a process-wide report, as in the
    JAX package;
  - ``device_trace(logdir)``: a ``torch.profiler`` trace (CUDA activity on a
    card, CPU activity always) written into ``logdir`` as a Chrome trace;
  - ``device_time(fn, *args)``: the median time of one call on CUDA events.
    The JAX version fits a slope over chained loops because the TPU's
    dispatch jitters by tens of milliseconds; a CUDA event pair brackets the
    device's work alone, so no slope is needed. On a CPU device, which the
    caller asked for, the host clock times the call.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from collections import defaultdict
from typing import Callable, Dict

import torch

_PHASES: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _PHASES[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def phase_report(reset: bool = False) -> Dict[str, Dict[str, float]]:
    out = {k: {"seconds": round(v, 4), "calls": _COUNTS[k]}
           for k, v in sorted(_PHASES.items())}
    if reset:
        _PHASES.clear()
        _COUNTS.clear()
    return out


def print_phase_report(reset: bool = True) -> None:
    print(json.dumps(phase_report(reset)))


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CUDA activity when a card
    is present) and write ``logdir``/trace.json, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(args):
    return next((a for a in args if isinstance(a, torch.Tensor)), None)


def device_time(fn: Callable, *args, warmup: int = 3, reps: int = 20) -> float:
    """Median seconds of one ``fn(*args)``: CUDA events around each call
    when the first tensor argument is on a card, the host clock otherwise
    (a CPU tensor: the caller asked for the CPU)."""
    x = _first_tensor(args)
    on_card = x is not None and x.is_cuda
    for _ in range(warmup):
        fn(*args)
    vals = []
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(x.device)
        for _ in range(reps):
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            vals.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            vals.append(time.perf_counter() - t0)
    return float(statistics.median(vals))
