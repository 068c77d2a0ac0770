"""What every driver shares: the launch counters, the feed of batches
through the port's ``Prefetcher``, the release of the program's state and
the reference's weights."""

from __future__ import annotations

import gc
import threading
import time

from reference.model import Params, strict_fp32

from .. import port, weights


class Base:
    fault = None          # a fault planted in the timed path, or 'control':
                          # the control's answer in the program's place
                          # (tests and tools/readings.py only)

    def __init__(self, ctx):
        self.ctx = ctx
        self.feed = None

    def counters(self) -> dict:
        return port.launches()

    def end_window(self) -> None:
        """The window has closed: stop the feed."""
        self.close()

    def close(self) -> None:
        if self.feed is not None:
            self.feed.close()

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        import torch
        for name in ('plm', 'model', 'params'):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference_params(self) -> Params:
        """The weights made again from the seed, as float32 leaves."""
        strict_fp32()
        tree = weights.make_params(self.ctx.arch, self.ctx.seed,
                                   self.ctx.device)
        return Params(tree)


class _Until:
    """A dataset that stops yielding once ``stop`` is set."""

    def __init__(self, dataset, stop: threading.Event):
        self.dataset, self.stop = dataset, stop

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return self.dataset[i]

    def __iter__(self):
        for i in range(len(self.dataset)):
            if self.stop.is_set():
                return
            yield self.dataset[i]


class Feed:
    """Batches through the port's ``Prefetcher``, epoch after epoch
    (``dataset(epoch)`` makes each epoch's dataset); :meth:`next` returns
    the batch and the seconds the caller waited for it."""

    def __init__(self, prefetcher, dataset, depth: int):
        self._prefetcher, self._dataset, self._depth = \
            prefetcher, dataset, depth
        self._stop = threading.Event()
        self._epoch = 0
        self._it = self._open()

    def _open(self):
        ds = _Until(self._dataset(self._epoch), self._stop)
        return iter(self._prefetcher(ds, depth=self._depth))

    def next(self):
        t = time.perf_counter()
        try:
            batch = next(self._it)
        except StopIteration:
            self._epoch += 1
            self._it = self._open()
            batch = next(self._it)
        return batch, time.perf_counter() - t

    def close(self) -> None:
        """Stop the prefetch thread and wait until it has ended."""
        if self._it is None:
            return
        self._stop.set()
        for _ in self._it:
            pass
        self._it = None


def real_lengths(cu_lens) -> list:
    """The lengths of a packed batch's sequences (its padding left out)."""
    import numpy as np
    d = np.diff(np.asarray(cu_lens))
    return [int(n) for n in d[d > 0]]
