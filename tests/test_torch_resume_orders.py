"""The cross-order resumes of ``tests/test_torch_resume.py`` (ROADMAP.md
Queue 3, item 28), in a file of their own so that xdist's --dist loadfile
puts them on another worker than the rest of that file: a run cut and
restored into a trainer over the same weights whose trees list the same
leaves in another order (``reordered``, ``sorted``, ``nf4``, as that
file's docstring says), the losses and every leaf by path bit for bit.
The model, batches, gates and the one-thread fixture are that file's."""

import numpy as np
import pytest

import jax

from esme_tpu_torch import ESM2
from esme_tpu_torch.data import LabeledDataset
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.models.heads import init_learned_aggregation
from esme_tpu_torch.train import CheckpointManager, MaskedPLM

from test_torch_cp_train import _batch
from test_torch_resume import (CASES, STEPS, TRAINERS, _add_lora,
                               _assert_same_leaves, _labelled, _model)
from test_torch_resume import _one_thread  # noqa: F401 (autouse fixture)


def _reordered(tree):
    """``tree``'s leaves (copies) with every dict's keys reversed."""
    return {k: _reordered(tree[k]) if isinstance(tree[k], dict)
            else tree[k].clone() for k in reversed(list(tree))}


def _sorted(tree):
    """``tree`` as ``params_from_jax`` gives it from JAX's pytree of the
    same weights: every dict's keys sorted, bit for bit."""
    return tio.params_from_jax(
        jax.tree.map(lambda t: np.array(t.numpy()), tree), None)


def _orders(order, tmp, lora=False):
    """The models of run A and resumed trainer B for ``order``: the same
    weights, trees of the same leaves listed in other orders."""
    if order == 'nf4':
        path = str(tmp / 'model.safetensors')
        _model().save_pretrained(path)
        kw = dict(dtype='float32', device='cpu')
        a = ESM2.from_pretrained(path, quantization='4bit', **kw)
        b = ESM2.from_pretrained(path, **kw).quantize('4bit')
        return (_add_lora(a), _add_lora(b)) if lora else (a, b)
    a = _model(lora)
    b = ESM2(config=a.config, device='cpu', params=(
        _reordered if order == 'reordered' else _sorted)(a.params))
    b.lora_kwargs = a.lora_kwargs
    return a, b


ORDERS = ('reordered', 'sorted', 'nf4')


def _cross_run(make, batches, cut, directory):
    """Run ``make(a)``'s trainer over ``batches``, saving its state before
    step ``cut``; a trainer ``make(b)`` restores it and takes the rest.
    Returns both runs' losses after the cut."""
    ta, tb = make('a'), make('b')
    mgr = CheckpointManager(str(directory), monitor=None)
    losses = []
    for i, batch in enumerate(batches):
        if i == cut:
            mgr.save(ta.step, ta.state)
        losses.append(ta.training_step(batch))
    tb.state = mgr.restore(tb.state)
    assert tb.step == cut
    return [tb.training_step(b) for b in batches[cut:]], losses[cut:]


@pytest.mark.parametrize('order', ORDERS)
@pytest.mark.parametrize('case', list(CASES))
def test_masked_plm_resumes_across_orders(case, order, tmp_path):
    """A run cut after ``cut`` steps and restored into a ``MaskedPLM`` over
    the same weights in another order gives the losses and the params of
    the run without a break, bit for bit: params, moments, ``adam8bit``'s
    codes and scales, the open cycle and the offloaded masters all paired
    by leaf path and view."""
    kw, lora, cut = CASES[case]
    models = dict(zip('ab', _orders(order, tmp_path, lora)))
    batches = [_batch(70 + i, ESM2.alphabet) for i in range(STEPS)]
    got, want = _cross_run(lambda w: MaskedPLM(models[w], **kw), batches,
                           cut, tmp_path / 'ckpt')
    assert got == want
    _assert_same_leaves(models['b'].params, models['a'].params)


def _head(order):
    head = init_learned_aggregation(3, 64, dtype='float32', device='cpu')
    return {'reordered': _reordered, 'sorted': _sorted}.get(
        order, lambda t: t)(head)


@pytest.mark.parametrize('order', ORDERS)
@pytest.mark.parametrize('trainer', list(TRAINERS))
def test_fine_tune_resumes_across_orders(trainer, order, tmp_path):
    """The fine-tune trainers (LoRA on the trunk at ``lr``, the
    aggregation head at ``head_lr``): cut after 2 of 4 steps and restored
    into a trainer over the same weights in another order (the head's
    tree too), the same losses and params, bit for bit."""
    models = dict(zip('ab', _orders(order, tmp_path, lora=True)))
    heads = {'a': _head(None), 'b': _head(order)}
    seqs, labels = _labelled(24, 5)
    ds = LabeledDataset(seqs, labels, token_per_batch=300, shuffle=False)
    batches = [ds[i % len(ds)] for i in range(4)]

    def make(w):
        return TRAINERS[trainer](models[w], heads[w], lr=1e-3,
                                 head_lr=5e-3)
    got, want = _cross_run(make, batches, 2, tmp_path / 'ckpt')
    assert got == want
    _assert_same_leaves({'plm': models['b'].params, 'head': heads['b']},
                        {'plm': models['a'].params, 'head': heads['a']})
