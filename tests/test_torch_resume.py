"""Checkpoint and resume of training: ``MaskedPLM.state`` (and the
fine-tune trainers') through ``CheckpointManager`` into a fresh trainer,
against the run that was never interrupted, also where the fresh
trainer's params tree lists the same leaves in another order; a witness
that JAX's ``MaskedPLM`` cannot resume under ``offload_optimizer=True``
(ROADMAP.md Queue 3, item 25) while the port's does.

The model is ESM2 with 2 layers of width 64 and 4 heads, fp32, its
weights from seed 0; the batches are ``tests/test_torch_cp_train.py``'s
packed 1,024-token masked-LM batches. Each case trains 4 steps without a
break, then again from the same weights with a checkpoint after 2 or 3
steps restored into a fresh trainer on a fresh model, which takes the
rest. The sharded trainer's round trip runs in a gloo world of
``tests/test_torch_sharded_lora.py``.

The orders of the cross-order resumes (ROADMAP.md Queue 3, item 28: the
setters paired leaves by position; ``tests/test_torch_resume_orders.py``,
a file of its own so that xdist's --dist loadfile spreads the two):
``reordered``, every dict of the tree in reverse key order (``k`` before
``q``); ``sorted``, the tree
``models/io.py:params_from_jax`` gives from JAX's pytree of the same
weights (keys sorted); ``nf4``, a saved file loaded with
``quantization='4bit'`` for the run and quantized after loading
(``quantize('4bit')``) for the resumed trainer, which list a quantized
linear's leaves in other orders (and draw other NF4 codes where row
maxima tie: the restore replaces the trunk). The fine-tune trainers run
on packed labelled batches of 300 tokens with the aggregation head.

Gates (each with its reason):
* the resumed run: every loss after the cut and every param at the end
  bit-equal to the run without a break (the same arithmetic on the same
  state: Adam's moments and step, ``adam8bit``'s codes and scales, the
  running mean of an open ``grad_accum`` cycle, the offloaded fp32
  masters, the LoRA dropout's step-folded keys).
* the cross-order resumes: the same, every leaf compared by path (the
  trees list the leaves in other orders);
* the ``k``-before-``q`` witness: after ``tb.state = ta.state`` every
  leaf of B is A's leaf of the same path, bit for bit (a positional copy
  gives B's ``q`` A's ``k``);
* a state without ``views`` (as saved before states were keyed by leaf
  path): bit for bit where its params list the trainer's paths in the
  same order, ``ValueError`` naming the first leaf that differs otherwise;
* the witness: JAX's offloaded trainer, its state copied into a fresh
  one after 3 steps at learning rate 1e-2, differs from the trainer it
  was copied from after one more step by more than the learning rate in
  the token embedding (it restarts from its own masters; the same copy
  without offload differs by 0.0), while the loss of that step is the
  same (the working params were copied); the port's offloaded trainer
  resumed through ``CheckpointManager`` differs by 0.0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esme_tpu.models import config as jconfig
from esme_tpu.models import esm as jesm
from esme_tpu.train import MaskedPLM as JMaskedPLM

from esme_tpu_torch import ESM2
from esme_tpu_torch.data import LabeledDataset
from esme_tpu_torch.models.config import esm2_config
from esme_tpu_torch.models.heads import init_learned_aggregation
from esme_tpu_torch.train import (CheckpointManager, ClassificationTrainer,
                                  MaskedPLM, RegressionTrainer, adam8bit)

from test_torch_cp_train import AA, _batch

LR = 1e-2
STEPS = 4


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test on one torch thread: beside the other test workers, each
    using every core, this file's many small steps ran 13x slower on the
    default count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _add_lora(model):
    model.add_lora(rank=4, alpha=8, dropout_p=0.1, rng=1)
    gen = torch.Generator().manual_seed(2)
    for p in model.params['layers']['attn'].values():
        for ad in p.get('lora', {}).values():
            ad['b'].copy_(torch.randn(ad['b'].shape, generator=gen) * 0.1)
    return model


def _model(lora=False):
    model = ESM2(config=esm2_config(2, 64, 4, dtype='float32'), rng=0,
                 device='cpu')
    return _add_lora(model) if lora else model


CASES = {
    'adam': (dict(learning_rate=LR), False, 2),
    'adamw_accum': (dict(learning_rate=LR, weight_decay=0.05, grad_accum=2),
                    False, 3),
    'adam8bit': (dict(optimizer=adam8bit(LR)), False, 2),
    'offload': (dict(learning_rate=LR, offload_optimizer=True, grad_accum=2),
                False, 3),
    'lora': (dict(learning_rate=LR, lora_only=True), True, 2),
}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield '.'.join(path + (k,)), v


def _resumed(kw, lora, cut, batches, directory):
    """The losses of steps ``cut``.. and the params of a run cut after
    ``cut`` steps, saved, and restored into a fresh trainer."""
    first = MaskedPLM(_model(lora), **kw)
    for b in batches[:cut]:
        first.training_step(b)
    mgr = CheckpointManager(str(directory), monitor=None)
    mgr.save(first.step, first.state)
    assert mgr.all_steps() == [cut]
    model = _model(lora)
    plm = MaskedPLM(model, **kw)
    plm.state = mgr.restore(plm.state)
    assert plm.step == cut
    return [plm.training_step(b) for b in batches[cut:]], model.params


@pytest.mark.parametrize('case', list(CASES))
def test_masked_plm_resumes_bit_for_bit(case, tmp_path):
    """A run cut after ``cut`` steps (for ``grad_accum=2``, inside an
    accumulation cycle), saved with ``CheckpointManager`` and restored into
    a fresh ``MaskedPLM`` gives the losses and the params of the run
    without a break, bit for bit."""
    kw, lora, cut = CASES[case]
    batches = [_batch(70 + i, ESM2.alphabet) for i in range(STEPS)]
    model = _model(lora)
    plm = MaskedPLM(model, **kw)
    losses = [plm.training_step(b) for b in batches]
    got, params = _resumed(kw, lora, cut, batches, tmp_path / 'ckpt')
    assert got == losses[cut:]
    for name, ref in _leaves(model.params):
        assert torch.equal(dict(_leaves(params))[name], ref), name
    start = dict(_leaves(_model(lora).params))
    assert any(not torch.equal(start[name], ref)
               for name, ref in _leaves(model.params))


def _jax_copy_differs(offload):
    """JAX's ``MaskedPLM`` (ESM2, 2 layers of width 64, fp32, einsum
    attention) 3 steps at ``LR``, its state copied into a fresh trainer,
    one more step on each: the largest difference of their token
    embeddings, and both losses of that step."""
    cfg = jconfig.esm2_config(num_layers=2, embed_dim=64, attention_heads=4,
                              dtype='float32')
    batches = [_batch(80 + i, ESM2.alphabet) for i in range(4)]

    def trainer():
        return JMaskedPLM(jesm.ESM2(config=cfg, rng=0), learning_rate=LR,
                          attn_impl='reference', offload_optimizer=offload)
    a = trainer()
    for b in batches[:3]:
        a.training_step(b)
    fresh = trainer()
    fresh.state = jax.tree.map(jnp.copy, a.state)
    la, lb = a.training_step(batches[3]), fresh.training_step(batches[3])
    diff = np.abs(np.asarray(a.state.params['embed_tokens'])
                  - np.asarray(fresh.state.params['embed_tokens'])).max()
    return float(diff), la, lb


def test_jax_offloaded_resume_differs_the_port_does_not(tmp_path):
    """JAX's offloaded state holds no fp32 masters, so a copy of it
    resumes from the fresh trainer's own masters: its next update differs
    by more than the learning rate, where a copy without offload differs
    by nothing; the port's offloaded ``MaskedPLM.state`` holds them, and
    the same protocol through ``CheckpointManager`` differs by 0.0."""
    off, la, lb = _jax_copy_differs(True)
    on, _, _ = _jax_copy_differs(False)
    assert off > LR and la == lb
    assert on == 0.0
    kw = dict(learning_rate=LR, offload_optimizer=True)
    batches = [_batch(80 + i, ESM2.alphabet) for i in range(4)]
    model = _model()
    plm = MaskedPLM(model, **kw)
    losses = [plm.training_step(b) for b in batches]
    got, params = _resumed(kw, False, 3, batches, tmp_path / 'ckpt')
    assert got == losses[3:]
    assert float((params['embed_tokens']
                  - model.params['embed_tokens']).abs().max()) == 0.0


def test_state_refuses_another_model(tmp_path):
    """A saved state restores only into a trainer whose params have its
    leaves' shapes and dtypes; a state inside a ``grad_accum`` cycle only
    with its running mean."""
    plm = MaskedPLM(_model(), learning_rate=LR, grad_accum=2)
    plm.training_step(_batch(90, ESM2.alphabet))
    state = plm.state
    assert state.step == 1 and state.accum is not None
    other = MaskedPLM(ESM2(config=esm2_config(2, 32, 4, dtype='float32'),
                           rng=0, device='cpu'), learning_rate=LR)
    with pytest.raises(ValueError, match='saved leaf'):
        other.state = state
    fresh = MaskedPLM(_model(), learning_rate=LR, grad_accum=2)
    with pytest.raises(ValueError, match='accumulated'):
        fresh.state = state._replace(accum=None)


# -------------------------------------------------------------------------
# states keyed by leaf path
# -------------------------------------------------------------------------

def _paths(tree):
    return [name for name, _ in _leaves(tree)]


def _assert_same_leaves(got, want):
    """Every leaf of ``got`` bit-equal to ``want``'s of the same path, the
    two trees listing them in other orders."""
    assert _paths(got) != _paths(want)
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for name, ref in want.items():
        assert got[name].dtype == ref.dtype and torch.equal(
            got[name], ref), name


def _labelled(n, seed):
    rng = np.random.default_rng(seed)
    seqs = [''.join(rng.choice(AA, int(rng.integers(20, 60))))
            for _ in range(n)]
    return seqs, rng.integers(0, 2, n).astype(np.float32)


TRAINERS = {'regression': RegressionTrainer,
            'classification': ClassificationTrainer}


def _k_before_q(model):
    """A model of ``model``'s config (fresh weights, seed 5) whose
    ``params['layers']['attn']`` lists ``k`` before ``q``."""
    fresh = ESM2(config=model.config, rng=5, device='cpu').params
    attn = fresh['layers']['attn']
    swap = {'q': 'k', 'k': 'q'}
    fresh['layers']['attn'] = {swap.get(n, n): attn[swap.get(n, n)]
                               for n in attn}
    return ESM2(config=model.config, params=fresh, device='cpu')


@pytest.mark.parametrize('trainer', ['masked_plm', 'regression'])
def test_state_pairs_q_and_k_by_path(trainer):
    """The witness of ROADMAP.md Queue 3, item 28: trainer B over a model
    whose attention lists ``k`` before ``q`` (its forward reads by key)
    takes trainer A's state; every leaf of B is then A's of the same
    path, bit for bit, where the positional copy gave B's ``q`` A's
    ``k``."""
    a = _model()
    b = _k_before_q(a)
    keys = list(b.params['layers']['attn'])
    assert keys.index('k') < keys.index('q')
    seqs, labels = _labelled(12, 6)
    batch = LabeledDataset(seqs, labels, token_per_batch=300,
                           shuffle=False)[0]
    if trainer == 'masked_plm':
        ta, tb = MaskedPLM(a, learning_rate=LR), MaskedPLM(b,
                                                           learning_rate=LR)
        ta.training_step(_batch(91, ESM2.alphabet))
        trees = b.params, a.params
    else:
        ha = init_learned_aggregation(3, 64, dtype='float32', device='cpu')
        hb = init_learned_aggregation(4, 64, dtype='float32', device='cpu')
        ta, tb = RegressionTrainer(a, ha), RegressionTrainer(b, hb)
        ta.training_step(batch)
        trees = {'plm': b.params, 'head': hb}, {'plm': a.params, 'head': ha}
    q, k = (a.params['layers']['attn'][n]['kernel'] for n in 'qk')
    assert q.shape == k.shape and not torch.equal(q, k)
    tb.state = ta.state
    _assert_same_leaves(*trees)
    batch = _batch(92, ESM2.alphabet) if trainer == 'masked_plm' else batch
    assert tb.training_step(batch) == ta.training_step(batch)


@pytest.mark.parametrize('trainer', ['masked_plm', 'regression'])
def test_state_without_views(trainer, tmp_path):
    """A state as the trainers saved it before states were keyed by leaf
    path (no ``views``): it restores bit for bit into a trainer whose
    params list the same paths in the same order (mid-cycle under
    ``grad_accum=2`` for ``MaskedPLM``), and raises ``ValueError`` naming
    the first leaf that differs into one that lists them otherwise."""
    seqs, labels = _labelled(24, 7)
    ds = LabeledDataset(seqs, labels, token_per_batch=300, shuffle=False)
    if trainer == 'masked_plm':
        batches = [_batch(60 + i, ESM2.alphabet) for i in range(4)]

        def make(model):
            return MaskedPLM(model, learning_rate=LR, weight_decay=0.05,
                             grad_accum=2)
    else:
        batches = [ds[i % len(ds)] for i in range(4)]

        def make(model):
            return RegressionTrainer(model, init_learned_aggregation(
                3, 64, dtype='float32', device='cpu'))
    run = make(_model())
    losses = [run.training_step(b) for b in batches]
    cut = make(_model())
    for b in batches[:3]:
        cut.training_step(b)
    old = cut.state._replace(views=None)
    mgr = CheckpointManager(str(tmp_path / 'old'), monitor=None)
    mgr.save(cut.step, old)
    fresh = make(_model())
    fresh.state = mgr.restore(fresh.state)
    assert fresh.training_step(batches[3]) == losses[3]
    for name, ref in _leaves(run.model.params):
        assert torch.equal(dict(_leaves(fresh.model.params))[name], ref), name
    other = make(_k_before_q(_model()))
    with pytest.raises(ValueError, match=r'lists leaf (plm\.)?layers\.attn'
                       r'\.q\.kernel where this trainer lists (plm\.)?'
                       r'layers\.attn\.k\.kernel'):
        other.state = old


def test_frozen_leaf_of_another_dtype_restores_exactly(tmp_path):
    """bf16 QLoRA: quantize-at-load keeps NF4's outlier rows in fp32 (as
    JAX's numpy twin), ``quantize()`` in the model's dtype. A state over
    the first restores into a trainer over the second: the rows' values
    convert exactly (they are the file's bf16 weights), and every other
    leaf is bit-equal. A frozen leaf whose values would round, and a
    trained leaf of another dtype, raise ``ValueError`` naming them."""
    path = str(tmp_path / 'model.safetensors')
    ESM2(config=esm2_config(2, 64, 4, dtype='bfloat16'), rng=0,
         device='cpu').save_pretrained(path)
    a = _add_lora(ESM2.from_pretrained(path, quantization='4bit',
                                       device='cpu'))
    b = _add_lora(ESM2.from_pretrained(path, device='cpu').quantize('4bit'))
    rows = 'layers.attn.q.outlier_rows'
    la, lb = dict(_leaves(a.params)), dict(_leaves(b.params))
    assert la[rows].dtype == torch.float32 and lb[rows].dtype == torch.bfloat16
    state = MaskedPLM(a, lora_only=True).state
    tb = MaskedPLM(b, lora_only=True)
    tb.state = state
    lb = dict(_leaves(b.params))
    for name, ref in la.items():
        assert torch.equal(lb[name].to(ref.dtype), ref), name
        assert lb[name].dtype == ref.dtype or name.endswith('outlier_rows')
    la[rows].add_(2.0 ** -20)
    with pytest.raises(ValueError, match=f'saved leaf {rows} of'):
        tb.state = state
    la[rows].sub_(2.0 ** -20)
    c = _add_lora(ESM2.from_pretrained(path, device='cpu',
                                       dtype='float32').quantize('4bit'))
    tc = MaskedPLM(c, lora_only=True)
    with pytest.raises(ValueError,
                       match=r'saved leaf layers\.attn\.\w+\.lora\.'):
        tc.state = state


def test_state_names_the_leaf_it_refuses():
    """A saved state missing a leaf of the trainer, or holding one it does
    not have, raises ``ValueError`` naming that leaf."""
    plm = MaskedPLM(_model(), learning_rate=LR)
    state = plm.state
    params = {k: v for k, v in state.params.items() if k != 'lm_head'}
    with pytest.raises(ValueError, match=r'leaf lm_head\.\S+ is in this '
                       'trainer but not in the saved state'):
        MaskedPLM(_model(), learning_rate=LR).state = state._replace(
            params=params)
    extra = {**state.params, 'extra': torch.zeros(3)}
    with pytest.raises(ValueError, match='leaf extra is in the saved state '
                       'but not in this trainer'):
        MaskedPLM(_model(), learning_rate=LR).state = state._replace(
            params=extra)
