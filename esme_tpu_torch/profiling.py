"""Benchmarking and profiling helpers.

Counterpart of ``esme_tpu/profiling.py``:

* :func:`benchmark` — mean seconds per call after warm-up; CUDA events
  on the card, the host clock on the CPU;
* :func:`sync` — wait for the device that holds a result;
* :func:`device_memory_stats` / :func:`peak_memory_gb` — the caching
  allocator's counters (``torch.cuda.memory_stats``,
  ``max_memory_allocated``); empty / None on the CPU;
* :func:`memory_analysis_gb` — the measured peak of one call (eager
  PyTorch has no compile-time memory analysis);
* :func:`trace` — a ``torch.profiler`` trace of a block, written as a
  Chrome trace and a table of device time by kernel.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def sync(out=None) -> None:
    """Wait until the device that holds ``out`` (a tensor or a nest of
    them) has finished all work queued so far; the current CUDA device
    when ``out`` holds no tensor. A no-op on the CPU."""
    t = _first_tensor(out)
    if t is not None and t.device.type == 'cuda':
        torch.cuda.synchronize(t.device)
    elif t is None and torch.cuda.is_available():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, reps: int = 10, warmup: int = 1,
              device: Optional[str] = None) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``reps`` calls, after
    ``warmup`` calls.

    On the card (``device='cuda'``, or the device of the first tensor
    argument) the calls are bracketed by CUDA events, so the time is the
    device's, not the enqueue's; on the CPU the host clock is read
    around them."""
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args)
    if device is None:
        t = _first_tensor(list(args))
        device = t.device.type if t is not None else 'cpu'
    if device == 'cuda':
        sync(out)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    return (time.perf_counter() - t0) / reps


def device_memory_stats(device=None) -> dict:
    """Bytes in use, peak and reserved on a CUDA device; {} on the CPU
    or where there is no card."""
    if not torch.cuda.is_available():
        return {}
    device = torch.device('cuda' if device is None else device)
    if device.type != 'cuda':
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        'bytes_in_use': stats.get('allocated_bytes.all.current'),
        'peak_bytes_in_use': stats.get('allocated_bytes.all.peak'),
        'bytes_reserved': stats.get('reserved_bytes.all.current'),
    }


def peak_memory_gb(device=None) -> Optional[float]:
    """Peak allocated GiB on a CUDA device since the last reset; None
    without one."""
    stats = device_memory_stats(device)
    peak = stats.get('peak_bytes_in_use')
    return peak / 2 ** 30 if peak is not None else None


def memory_analysis_gb(fn: Callable, *args, **kwargs) -> dict:
    """The device memory one call of ``fn(*args, **kwargs)`` takes,
    measured: the peak allocated during the call above what was
    allocated before it, and what stays allocated after it (its
    outputs). Eager PyTorch has no compile-time memory analysis, so
    this runs the call once. {} on the CPU."""
    if not torch.cuda.is_available():
        return {}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    g = float(2 ** 30)
    result = {
        'temp_gb': (torch.cuda.max_memory_allocated() - before) / g,
        'output_gb': (torch.cuda.memory_allocated() - before) / g,
        'total_gb': torch.cuda.max_memory_allocated() / g,
    }
    del out
    return result


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(dir):`` profiles the block with ``torch.profiler``
    (CPU and, where there is a card, CUDA activity) and writes
    ``dir/trace.json`` (a Chrome trace) and ``dir/kernels.txt`` (device
    time by kernel)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        sync()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
    key = 'self_device_time_total' if torch.cuda.is_available() \
        else 'self_cpu_time_total'
    with open(os.path.join(logdir, 'kernels.txt'), 'w') as f:
        f.write(prof.key_averages().table(sort_by=key, row_limit=40))
