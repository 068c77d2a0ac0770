"""The port's stage spans (``esme_tpu_torch/profiling.py:span``) on the
CPU, at a tiny ESM2: each entry point's stages under ``torch.profiler``,
nested and in order; the data layer's spans on their two threads with the
item's index; and no range entered while no profiler records."""

import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esme_tpu_torch import (ESM2, MaskedFastaTokenDataset, Prefetcher,
                            profiling, variant)
from esme_tpu_torch.alphabet import tokenize, tokenize_unpad
from esme_tpu_torch.models.config import esm2_config
from esme_tpu_torch.train import MaskedPLM

PORT = Path(profiling.__file__).parent


def _model():
    return ESM2(config=esm2_config(2, 64, 4, dtype='float32'), rng=3,
                device='cpu')


def _seqs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [''.join(rng.choice(list('LAGVSERTIDPKQNFYMHWC'), n))
            for n in lengths]


def _spans(prof) -> list:
    """``(name, start, end)`` of every ``esme.`` range, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith('esme.')]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _top(spans) -> list:
    """The spans no other span encloses, in order."""
    return [s for s in spans
            if not any(o is not s and _within(s, o) for o in spans)]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.mark.parametrize('route', ['packed', 'padded'])
def test_predict_log_prob_stages_nest_in_order(route):
    model = _model()
    seqs = _seqs([30, 12, 45])
    if route == 'packed':
        tok, _, cu, ml = tokenize_unpad(seqs)
        call = lambda: model.predict_log_prob(tok, pad_args=(cu, ml))  # noqa
    else:
        call = lambda: model.predict_log_prob(tokenize(seqs))  # noqa
    out, spans = _profiled(call)
    top = [s[0] for s in _top(spans)]
    want = ['esme.model.prepare', 'esme.model.trunk', 'esme.model.head']
    assert top == want + (['esme.model.unpad'] if route == 'padded' else [])
    starts = [s[1] for s in _top(spans)]
    ends = [s[2] for s in _top(spans)]
    assert all(e <= s for e, s in zip(ends, starts[1:]))
    trunk = next(s for s in spans if s[0] == 'esme.model.trunk')
    params = [s for s in spans if s[0] == 'esme.model.layer_params']
    assert len(params) == 1 and _within(params[0], trunk)
    assert len(spans) == len(top) + 1
    # the spans leave the answer as it was: the same call, unprofiled
    assert torch.equal(out, call())


def test_predict_mask_margin_stages_once_a_chunk():
    model = _model()
    seq = _seqs([70])[0]
    scores, spans = _profiled(
        lambda: variant.predict_mask_margin(model, seq, batch_size=32))
    chunks = math.ceil(len(seq) / 32)
    top = [s[0] for s in _top(spans)]
    stages = ['esme.variant.build', 'esme.variant.forward',
              'esme.variant.fetch', 'esme.variant.margins']
    assert top == stages * chunks
    forwards = [s for s in spans if s[0] == 'esme.variant.forward']
    for name in ('esme.model.prepare', 'esme.model.trunk',
                 'esme.model.head', 'esme.model.unpad'):
        mine = [s for s in spans if s[0] == name]
        assert len(mine) == chunks, name
        assert all(_within(s, f) for s, f in zip(mine, forwards)), name
    assert len(scores) == 20 * len(seq)
    assert scores == variant.predict_mask_margin(model, seq, batch_size=32)


@pytest.fixture(scope='module')
def batch(fasta_path):
    return MaskedFastaTokenDataset(fasta_path, token_per_batch=1024,
                                   shuffle=False, random_state=0)[0]


def test_training_step_stages_in_order(batch):
    plm = MaskedPLM(_model())
    loss, spans = _profiled(lambda: plm.training_step(batch))
    assert np.isfinite(loss)
    top = [s[0] for s in _top(spans)]
    assert top == ['esme.train.batch', 'esme.train.forward',
                   'esme.train.loss', 'esme.train.backward',
                   'esme.train.optimizer', 'esme.train.sync']
    forward = next(s for s in spans if s[0] == 'esme.train.forward')
    inside = [s[0] for s in spans if s is not forward
              and _within(s, forward)]
    # the trainer's per-layer dicts need no slicing: no layer_params span
    assert inside == ['esme.model.prepare', 'esme.model.trunk',
                      'esme.model.head']


def _trace_events(logdir) -> list:
    with open(Path(logdir) / 'trace.json') as f:
        return json.load(f)['traceEvents']


def _item(ev) -> int:
    return int(ev['args']['Concrete Inputs'][0])


@pytest.mark.parametrize('num_workers', [1, 2])
def test_prefetcher_spans_on_both_threads_carry_the_index(tmp_path,
                                                          num_workers):
    n = 5
    data = [np.full(8, i, dtype=np.int32) for i in range(n)]
    pre = Prefetcher(data, depth=2, num_workers=num_workers,
                     device_put=lambda a: torch.as_tensor(a) + 1)
    with profiling.trace(str(tmp_path / 'prof')):
        got = [int(t[0]) for t in pre]
    assert got == [i + 1 for i in range(n)]
    events = [e for e in _trace_events(tmp_path / 'prof')
              if e.get('ph') == 'X']
    builds = [e for e in events if e['name'] == 'esme.data.build']
    waits = [e for e in events if e['name'] == 'esme.data.wait']
    consumer = {e['tid'] for e in waits}
    assert len(consumer) == 1
    assert not consumer & {e['tid'] for e in builds}
    built = sorted(_item(e) for e in builds)
    waited = sorted(_item(e) for e in waits)
    assert built[:n] == list(range(n))
    # the single worker's last span meets the end of the dataset; the
    # consumer's last wait takes that end
    assert waited[:n] == list(range(n))
    assert len(waited) == n + (num_workers == 1)
    # an item's wait ends after its build has ended
    end = {_item(e): e['ts'] + e['dur'] for e in builds}
    for e in waits:
        if _item(e) < n:
            assert e['ts'] + e['dur'] >= end[_item(e)]


def test_no_range_is_entered_without_a_profiler(monkeypatch, batch):
    entered = []
    real = profiling._record_function_with_args_enter

    def counted(*args):
        entered.append(args[0])
        return real(*args)
    monkeypatch.setattr(profiling, '_record_function_with_args_enter',
                        counted)
    model = _model()
    plm = MaskedPLM(_model())
    seqs = _seqs([20, 9])

    def everything():
        model.predict_log_prob(tokenize(seqs))
        variant.predict_mask_margin(model, seqs[0], batch_size=8)
        plm.training_step(batch)
        list(Prefetcher(list(range(3))))
    everything()
    assert entered == []
    assert profiling.span('esme.model.trunk') is \
        profiling.span('esme.data.wait', 3)
    with profile(activities=[ProfilerActivity.CPU]):
        everything()
    # the counter is on the spans' path: under a profiler every span is
    assert set(entered) == set(profiling.SPANS)


def test_every_span_in_the_source_is_listed():
    used = set()
    for path in PORT.rglob('*.py'):
        used |= set(re.findall(r"span\('([a-z_.]+)'", path.read_text()))
    assert used == set(profiling.SPANS)
    assert len(profiling.SPANS) == len(set(profiling.SPANS))
