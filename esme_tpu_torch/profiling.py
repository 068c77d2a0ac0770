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
* :func:`span` — a named stage of the port (:data:`SPANS`) as a
  ``torch.profiler`` range while a profiler records, else one flag test;
* :func:`trace` — a ``torch.profiler`` trace of a block on every thread,
  written as a Chrome trace and a table of device time by kernel.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd import (_record_function_with_args_enter,
                            _record_function_with_args_exit)

# Every stage span of the port, by module (README.md, "Tracing the port's
# stages", says how they nest).
SPANS = (
    'esme.model.prepare',       # models/esm.py: uploads, packing meta, pads,
                                # RoPE tables, FSDP's outer gather
    'esme.model.trunk',         # models/esm.py: embedding, layer_stack, norm
    'esme.model.layer_params',  # models/modules.py: per-layer slices
    'esme.model.head',          # models/esm.py: LM head, log_softmax, reps
    'esme.model.unpad',         # models/esm.py: outputs back to (B, L)
    'esme.variant.build',       # variant.py: one chunk's items, np.stack
    'esme.variant.forward',     # variant.py: predict_log_prob of a chunk
    'esme.variant.fetch',       # variant.py: row pick and copy to the host
    'esme.variant.margins',     # variant.py: host fp64 scores
    'esme.train.batch',         # train/trainer.py: uploads, packing meta
    'esme.train.forward',       # train/trainer.py: forward_flat
    'esme.train.loss',          # train/trainer.py: targets up, cross_entropy
    'esme.train.backward',      # train/trainer.py: loss.backward()
    'esme.train.optimizer',     # train/trainer.py: accumulate, step, zero
    'esme.train.sync',          # train/trainer.py: the loss to the host
    'esme.data.build',          # data.py: one item on the worker thread
    'esme.data.wait',           # data.py: the consumer waiting for an item
)


class _Range:
    """A ``torch.profiler`` range (the kind ``record_function`` opens),
    with ``item`` as its recorded argument where given."""

    __slots__ = ('_args', '_handle')

    def __init__(self, name: str, item: Optional[int]):
        self._args = (name,) if item is None else (name, int(item))

    def __enter__(self):
        self._handle = _record_function_with_args_enter(*self._args)
        return self

    def __exit__(self, *exc):
        _record_function_with_args_exit(self._handle)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, item: Optional[int] = None):
    """``with span(name):`` marks a stage of the port (one of
    :data:`SPANS`). While a torch profiler records, it is a range on the
    profiler's clock (the device's kernels' clock in the same trace),
    nested in whatever range is open on the thread; ``item`` (the data
    layer's item index) is its argument, which a trace shows where shapes
    are recorded (:func:`trace`). Otherwise it is one shared no-op
    context: one flag test, nothing allocated."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Range(name, item)


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


def _all_threads() -> dict:
    """The profiler's option to record every thread, where the installed
    torch has it ({} where not: then only the threads that start ranges
    under the profiler's own thread state, autograd's among them)."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {'experimental_config':
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(dir):`` profiles the block with ``torch.profiler``
    (CPU and, where there is a card, CUDA activity; every thread where
    torch can, so the data layer's worker shows its spans; shapes
    recorded, so each data span shows its item's index) and writes
    ``dir/trace.json`` (a Chrome trace) and ``dir/kernels.txt`` (device
    time by kernel). The port's stages (:data:`SPANS`) are ranges in it."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True,
                 **_all_threads()) as prof:
        yield logdir
        sync()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
    key = 'self_device_time_total' if torch.cuda.is_available() \
        else 'self_cpu_time_total'
    with open(os.path.join(logdir, 'kernels.txt'), 'w') as f:
        f.write(prof.key_averages().table(sort_by=key, row_limit=40))
