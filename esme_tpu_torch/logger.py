"""Structured metric logging: an append-only JSONL logger.

A copy of ``esme_tpu/logger.py`` (the reference logs through Lightning
and Weights & Biases, reference: esme/trainer.py:34,41,97-98): every
``log`` call appends one JSON line ``{"run", "step", "t", **metrics}``
(append-only, crash safe) and optionally echoes to stderr. Logs written
by either package read back in the other.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional


class MetricLogger:
    """Append-only JSONL metric logger with run metadata.

    >>> logger = MetricLogger('run.jsonl', run='esm2-650m-lora')
    >>> logger.log({'loss': 3.2}, step=10)

    ``summary`` keeps the latest value per key (the W&B summary
    equivalent); ``best`` tracks min/max per key on demand.
    """

    def __init__(self, path: Optional[str] = None, run: Optional[str] = None,
                 stdout: bool = False, flush_every: int = 1):
        self.path = path
        self.run = run
        self.stdout = stdout
        self.summary: dict = {}
        self._fh = open(path, 'a') if path else None
        self._flush_every = max(int(flush_every), 1)
        self._since_flush = 0
        self._best: dict = {}

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {}
        if self.run is not None:
            rec['run'] = self.run
        if step is not None:
            rec['step'] = int(step)
        rec['t'] = round(time.time(), 3)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self.summary.update({k: rec[k] for k in metrics})
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + '\n')
            self._since_flush += 1
            if self._since_flush >= self._flush_every:
                self._fh.flush()
                self._since_flush = 0
        if self.stdout:
            body = ' '.join(
                f'{k}={v:.6g}' if isinstance(v, float) else f'{k}={v}'
                for k, v in rec.items() if k not in ('t', 'run'))
            print(body, file=sys.stderr, flush=True)
        return rec

    def best(self, key: str, mode: str = 'min'):
        """Best value logged so far for ``key`` (checkpoint policies)."""
        vals = self._best.get(key)
        return vals[mode] if vals else None

    def track_best(self, metrics: dict):
        for k, v in metrics.items():
            if not isinstance(v, (int, float)):
                continue
            b = self._best.setdefault(k, {'min': v, 'max': v})
            b['min'] = min(b['min'], v)
            b['max'] = max(b['max'], v)

    def close(self):
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_log(path: str) -> list:
    """Load a JSONL metric log back as a list of dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
