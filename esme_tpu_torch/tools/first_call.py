"""Which op of a bf16 CPU forward gives other bits in a process's first
call than in its later calls on the same inputs.

    python -m esme_tpu_torch.tools.first_call [--procs 12]

Each of ``--procs`` fresh interpreters builds a 2-layer bf16 ESM2
(width 128, 2 heads, seed 0) on the CPU and runs three identical padded
forwards (the 40-residue sequence's first batch of 32 masked copies, as
``variant.predict_mask_margin`` builds it) under a dispatch trace that
keeps every op's output that owns its storage (views and ``empty``
buffers are skipped). It prints, per process, the first op whose output
in the first call differs from the second call's, or ``equal``, then the
counts. The CPU only: no kernel is launched.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

SEQ = 'MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRV'


class _Trace(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.outs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {a.untyped_storage().data_ptr() for a in args
               if isinstance(a, torch.Tensor)}
        if isinstance(out, torch.Tensor) and 'empty' not in str(func) \
                and out.untyped_storage().data_ptr() not in ins:
            self.outs.append((str(func), out.detach().clone()))
        return out


def first_difference(first, later):
    """The first ``(op, max|Δ|)`` whose output differs between two traces
    of the same calls, or None."""
    for (op, a), (_, b) in zip(first, later):
        if a.shape != b.shape or not torch.equal(a, b):
            return op, (a.double() - b.double()).abs().max().item()
    return None


def one_process() -> str:
    from ..models.esm import ESM2
    from ..variant import MaskMarginDataset, _batched_items
    model = ESM2(num_layers=2, embed_dim=128, attention_heads=2, rng=0,
                 device='cpu')
    _, tokens, _ = next(_batched_items(MaskMarginDataset(
        SEQ, alphabet=model.alphabet), 32))
    traces = []
    for _ in range(3):
        with _Trace() as t:
            model.predict_log_prob(tokens)
        traces.append(t.outs)
    diff = first_difference(traces[0], traces[1])
    return 'equal' if diff is None else f'{diff[0]} max|Δ| {diff[1]:.3e}'


def main(argv=None):
    p = argparse.ArgumentParser(prog='esme_tpu_torch.tools.first_call')
    p.add_argument('--procs', type=int, default=12)
    p.add_argument('--one', action='store_true', help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print(one_process())
        return
    seen = collections.Counter()
    for i in range(args.procs):
        out = subprocess.run([sys.executable, '-m', __spec__.name, '--one'],
                             capture_output=True, text=True, check=True)
        line = out.stdout.strip()
        print(f'process {i}: {line}', flush=True)
        seen[line.split(' max')[0]] += 1
    print(dict(seen))


if __name__ == '__main__':
    main()
