"""The fine-tuning slice of the port against the JAX package: segment
pooling, the heads, the labelled data, the regression and classification
trainers over a LoRA trunk, and ``MaskedPLM`` training adapters only (on
the card and with the optimizer offloaded to the host).

Models are tiny (ESM2, 2 layers, width 64, 4 heads, fp32) from JAX's init
with adapters (rank 4, alpha 8 on query, value and output) whose ``b`` is
non-zero, carried over with ``params_from_jax`` together with JAX's head.
The JAX side runs its einsum attention (``attn_impl='auto'`` on the CPU),
the port the kernels' plain versions.

Gates (each with its reason):
* pooling and heads, fp32: 1e-5 of the output's scale (fp32 sums in
  another order: JAX scatter-adds token by token, the port multiplies by
  the segment indicator; measured at most 2.9e-7); bf16 pooling: one bf16
  ulp of the scale, 2^-8·max|ref| (the same fp32 values rounded once, a
  sum order apart; measured 0). Empty segments pool to exactly 0 on both sides.
* labelled batches and class balancing: exact.
* the trainers over 3 steps (the trainers' default learning rates, as
  ``benchmarks/tasks.py`` runs them): losses 1e-5 relative
  (``test_torch_train.py``'s MaskedPLM gate) to the batch's scale, the
  larger of the loss and its real labels' mean square: torch's Adam and
  optax's round an update differently by an ulp, so the params after an
  update differ by an ulp here and there, and a batch whose loss the head
  has nearly fit (0.029, two sequences) shows that as 2.6e-5 of its loss,
  7.5e-7 absolute (measured; at most 3.7e-6 of the scale here). Each trainable leaf within 0.1·lr per update
  of its group (trunk ``lr``, head ``head_lr``: Adam moves a leaf ~lr
  whatever its gradient, so a gradient near 0 that differs in its last
  bits moves the update by a fraction of lr; measured 1e-4·lr); frozen
  trunk leaves bit-equal to their start. One leaf has no scale of its own: the aggregation head's key
  bias adds one constant to every score of a segment, which the softmax
  removes, so its gradient is 0 in exact arithmetic and rounding noise on
  both sides, which Adam turns into steps of up to lr: it is held within
  2·head_lr per update (ROADMAP.md Queue 3, rule 15; measured 0.24).
  Validation metrics: MSE and BCE 1e-4 relative (measured 4.9e-6), the
  rank metrics (Spearman, AUROC, AUPRC) 1e-6 absolute (equal unless two
  predictions swap order; measured 0).
* ``MaskedPLM(lora_only=True)``, on the card's path and offloaded: losses
  1e-5 relative, adapters within 0.1·lr per update, everything else
  bit-equal to its start.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esme_tpu import data as jdata
from esme_tpu import logger as jlogger
from esme_tpu.models import esm as jesm
from esme_tpu.models import heads as jheads
from esme_tpu.models.config import esm2_config as jesm2_config
from esme_tpu.ops import pooling as jpool
from esme_tpu.train import ClassificationTrainer as JClassificationTrainer
from esme_tpu.train import MaskedPLM as JMaskedPLM
from esme_tpu.train import RegressionTrainer as JRegressionTrainer
from esme_tpu.train import checkpoint as jcheckpoint

from esme_tpu_torch import ESM2, data as tdata
from esme_tpu_torch import logger as tlogger
from esme_tpu_torch.models import heads as theads
from esme_tpu_torch.models import esm as tesm
from esme_tpu_torch.models.config import esm2_config
from esme_tpu_torch.models.io import params_from_jax
from esme_tpu_torch.ops import pooling as tpool
from esme_tpu_torch.train import (CheckpointManager, ClassificationTrainer,
                                  MaskedPLM, RegressionTrainer)

from test_torch_families import _batch, _leaves, _seqs
from test_torch_lora import _lift_b

AA = list('LAGVSERTIDPKQNFYMHWC')
# segments 0, 2, 3 (1 is empty) and a tail whose ids (4, 5) are dropped
SEG = np.repeat(np.array([0, 2, 3, 4, 5], np.int32), [30, 50, 70, 25, 25])
S = 4


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.array(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return params_from_jax({'x': np.asarray(a)}, None)['x']


def _close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    tol = 1e-5 if dtype == 'float32' else 2.0 ** -8
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), \
        (np.abs(got - ref).max(), np.abs(ref).max())


def _x(dtype, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((SEG.shape[0], D)),
                       getattr(jnp, dtype))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_pooling_matches_jax(dtype):
    x = _x(dtype)
    seg = jnp.asarray(SEG)
    got = tpool.partition_mean_pool(_t(x), torch.from_numpy(SEG), S)
    ref = jpool.partition_mean_pool(x, seg, S)
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref, dtype)
    rng = np.random.default_rng(1)
    jdt = getattr(jnp, dtype)
    cls_q = jnp.asarray(rng.standard_normal((3, 64)), jdt)
    k = {'kernel': jnp.asarray(rng.standard_normal((64, 64)) * 0.125, jdt),
         'bias': jnp.asarray(rng.standard_normal(64) * 0.1, jdt)}
    ref = jpool.attention_pool(cls_q, x, k, seg, S, 4)
    got = tpool.attention_pool(_t(cls_q), _t(x), jax.tree.map(_t, k),
                               torch.from_numpy(SEG), S, 4)
    assert got.shape == (S, 3, 64) and got.dtype == getattr(torch, dtype)
    _close(got, ref, dtype)
    for out in (got, tpool.partition_mean_pool(_t(x), torch.from_numpy(SEG),
                                               S)):
        assert not out[1].any()            # the empty segment
    # a segment of one token pools to that token's value
    one = tpool.attention_pool(_t(cls_q), _t(x)[:1], jax.tree.map(_t, k),
                               torch.zeros(1, dtype=torch.int32), 1, 4)
    assert torch.allclose(one[0, 0].float(), _t(x)[0].float(), atol=1e-6)


def _head_pair(kind, dtype='float32', num_cls=1):
    if kind == 'aggregation':
        jh = jheads.init_learned_aggregation(0, 64, num_cls=num_cls,
                                             attention_heads=4,
                                             dtype=getattr(jnp, dtype))
    elif kind == 'cls':
        jh = jheads.init_cls_head(0, 64, num_cls=num_cls, hidden_dim=128,
                                  dtype=getattr(jnp, dtype))
    else:
        jh = jheads.init_feed_forward(0, 64, 96, out_dim=32,
                                      dtype=getattr(jnp, dtype))
    rng = np.random.default_rng(7)
    # move every leaf off its init so biases and the cls queries count
    jh = jax.tree.map(lambda a: a + jnp.asarray(
        rng.standard_normal(a.shape) * 0.05, a.dtype), jh)
    return jh, jax.tree.map(_t, jh)


@pytest.mark.parametrize('num_cls', [1, 3])
def test_heads_match_jax(num_cls):
    x, seg = _x('float32'), jnp.asarray(SEG)
    tx, tseg = _t(x), torch.from_numpy(SEG)
    jh, th = _head_pair('aggregation', num_cls=num_cls)
    _close(theads.apply_learned_aggregation(th, tx, tseg, S, 4),
           jheads.apply_learned_aggregation(jh, x, seg, S, 4), 'float32')
    _close(theads.apply_learned_attention_pool(th, tx, tseg, S, 4),
           jheads.apply_learned_attention_pool(jh, x, seg, S, 4), 'float32')
    jh, th = _head_pair('cls', num_cls=num_cls)
    got = theads.apply_cls_head(th, tx, tseg, S)
    assert got.shape == ((S,) if num_cls == 1 else (S, num_cls))
    _close(got, jheads.apply_cls_head(jh, x, seg, S), 'float32')
    jh, th = _head_pair('ff')
    _close(theads.apply_feed_forward(th, tx),
           jheads.apply_feed_forward(jh, x), 'float32')


def test_head_inits_match_jax_trees():
    """The same trees of shapes and dtypes as JAX's inits, ones for the
    cls queries, zero biases, kernels truncated at 2 standard deviations;
    the seed decides the draw."""
    for name, kw in (('init_learned_aggregation', dict(num_cls=2)),
                     ('init_cls_head', dict(hidden_dim=48)),
                     ('init_feed_forward', dict(hidden_dim=40))):
        jh = getattr(jheads, name)(0, 32, **kw)
        th = getattr(theads, name)(0, 32, **kw, device='cpu')
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix('torch.'))
                for k, v in _leaves(th)} == \
            {k: (v.shape, v.dtype.name) for k, v in _leaves(jh)}
        for k, v in _leaves(th):
            if k == 'cls':
                assert torch.equal(v, torch.ones_like(v))
            elif k.endswith('bias'):
                assert not v.any()
            else:
                assert v.float().abs().max() <= 2.0 * v.shape[0] ** -0.5
        again = getattr(theads, name)(0, 32, **kw, device='cpu')
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(_leaves(th), _leaves(again)))
    assert not torch.equal(
        theads.init_cls_head(1, 32, device='cpu')['fc1']['kernel'],
        theads.init_cls_head(0, 32, device='cpu')['fc1']['kernel'])


def _labelled(n, seed):
    rng = np.random.default_rng(seed)
    seqs = [''.join(rng.choice(AA, int(k))) for k in rng.integers(5, 70, n)]
    return seqs, [float(y) for y in rng.standard_normal(n)]


@pytest.mark.parametrize('kw', [
    dict(token_per_batch=200, shuffle=False),
    dict(token_per_batch=300, shuffle=True, random_state=3,
         truncate_len=40),
    dict(token_per_batch=256, shuffle=False, pad_to_budget=False)],
    ids=['plain', 'shuffle-truncate', 'unpadded'])
def test_labeled_dataset_matches_jax(kw):
    seqs, labels = _labelled(23, 0)
    jds = jdata.LabeledDataset(seqs, labels, **kw)
    tds = tdata.LabeledDataset(seqs, labels, **kw)
    assert len(tds) == len(jds) > 2 and tds.max_segments == jds.max_segments
    for jb, tb in zip(jds, tds):
        for f in ('tokens', 'cu_lens', 'indices', 'labels'):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f),
                                          err_msg=f)
            assert getattr(tb, f).dtype == getattr(jb, f).dtype, f
        assert tb.max_len == jb.max_len
        if kw.get('pad_to_budget', True):
            assert tb.tokens.shape == (kw['token_per_batch'],)


def test_balance_binary_matches_jax():
    seqs = [f's{i}' for i in range(17)]
    labels = [float(i % 5 == 0) for i in range(17)]
    for balance in (None, 'upsample', 'downsample'):
        got = tdata.balance_binary(seqs, labels, balance,
                                   rng=np.random.default_rng(1))
        ref = jdata.balance_binary(seqs, labels, balance,
                                   rng=np.random.default_rng(1))
        assert got == ref, balance
    assert sum(tdata.balance_binary(seqs, labels)[1]) == 4 * 3
    with pytest.raises(ValueError, match='balance'):
        tdata.balance_binary(seqs, labels, 'both')


SIGNATURES = {
    'RegressionTrainer': (JRegressionTrainer.__init__,
                          RegressionTrainer.__init__),
    'ClassificationTrainer': (JClassificationTrainer.__init__,
                              ClassificationTrainer.__init__),
    'LabeledDataset': (jdata.LabeledDataset.__init__,
                       tdata.LabeledDataset.__init__),
    'balance_binary': (jdata.balance_binary, tdata.balance_binary),
    'MetricLogger': (jlogger.MetricLogger.__init__,
                     tlogger.MetricLogger.__init__),
    'CheckpointManager': (jcheckpoint.CheckpointManager.__init__,
                          CheckpointManager.__init__),
    'add_lora': (jesm._ESMBase.add_lora, tesm._ESMBase.add_lora),
    'save_lora': (jesm._ESMBase.save_lora, tesm._ESMBase.save_lora),
    'load_lora': (jesm._ESMBase.load_lora, tesm._ESMBase.load_lora),
    'trainable_filter': (jesm._ESMBase.trainable_filter,
                         tesm._ESMBase.trainable_filter),
    'init_learned_aggregation': (jheads.init_learned_aggregation,
                                 theads.init_learned_aggregation),
    'init_cls_head': (jheads.init_cls_head, theads.init_cls_head),
}


@pytest.mark.parametrize('entry', sorted(SIGNATURES))
def test_fine_tune_signatures_start_with_jax_parameters(entry):
    """As ``test_torch_api.py`` holds the models' entries: JAX's
    parameters in JAX's order, then at most the port's ``device``."""
    jnames, tnames = (list(inspect.signature(f).parameters)
                      for f in SIGNATURES[entry])
    assert tnames[:len(jnames)] == jnames, (jnames, tnames)
    assert set(tnames[len(jnames):]) <= {'device'}, tnames


@functools.lru_cache(maxsize=None)
def _jax_lora_params():
    cfg = jesm2_config(2, 64, 4, dtype='float32')
    jm = jesm.ESM2(config=cfg, rng=0)
    jm.add_lora(rank=4, alpha=8)
    return _lift_b(jm.params, 11), jm.lora_kwargs


def _pair():
    jp, kw = _jax_lora_params()
    jm = jesm.ESM2(config=jesm2_config(2, 64, 4, dtype='float32'),
                   params=jax.tree.map(jnp.copy, jp))
    jm.lora_kwargs = dict(kw)
    tcfg = esm2_config(2, 64, 4, dtype='float32')
    tm = ESM2(config=tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg), device='cpu')
    tm.lora_kwargs = dict(kw)
    return jm, tm


def _params_close(tparams, jparams, mask, lr, updates, what):
    """Trainable leaves within 0.1·lr per update; frozen bit-equal to the
    JAX tree's start (``_jax_lora_params``)."""
    start = dict(_leaves(jax.tree.map(np.asarray, _jax_lora_params()[0])))
    got = dict(_leaves(tparams))
    n_train = 0
    for name, ref in _leaves(jax.tree.map(np.asarray, jparams)):
        g = got[name].numpy()
        if not dict(_leaves(mask))[name]:
            assert np.array_equal(g.view(np.uint32),
                                  start[name].view(np.uint32)), (what, name)
            continue
        n_train += 1
        err = np.abs(g - ref).max()
        assert err <= 0.1 * lr * updates, (what, name, err)
    return n_train


CASES = [(RegressionTrainer, JRegressionTrainer, 'aggregation'),
         (RegressionTrainer, JRegressionTrainer, 'cls'),
         (ClassificationTrainer, JClassificationTrainer, 'aggregation'),
         (ClassificationTrainer, JClassificationTrainer, 'cls')]


@pytest.mark.parametrize('tcls,jcls,head', CASES,
                         ids=['regression-aggregation', 'regression-cls',
                              'classification-aggregation',
                              'classification-cls'])
def test_fine_tune_trainer_matches_jax(tcls, jcls, head):
    seqs, labels = _labelled(14, 2)
    if jcls is JClassificationTrainer:
        labels = [float(y > 0) for y in labels]
    kw = dict(token_per_batch=256, shuffle=False)
    jds, tds = (jdata.LabeledDataset(seqs, labels, **kw),
                tdata.LabeledDataset(seqs, labels, **kw))
    assert len(tds) >= 3
    jm, tm = _pair()
    jh, th = _head_pair(head)
    lr, head_lr = 1e-4, 1e-3
    jt = jcls(jm, jh, head=head, head_lr=head_lr, lr=lr)
    tt = tcls(tm, th, head=head, head_lr=head_lr, lr=lr)
    for i in range(3):
        lj = jt.training_step(jds[i])
        lt = tt.training_step(tds[i])
        real = tds[i].labels[:int((np.diff(tds[i].cu_lens) > 0).sum())]
        scale = max(abs(lj), float(np.mean(real ** 2)))
        assert abs(lt - lj) <= 1e-5 * scale, (i, lt, lj)
    assert tt.step == 3 and tt.state.step == 3
    mask = tm.trainable_filter()
    n = _params_close(tm.params, jt.state.params['plm'], mask, lr, 3, head)
    assert n == 3 * 2                         # q, v, out: a and b
    got = dict(_leaves(th))
    for name, ref in _leaves(jax.tree.map(np.asarray, jt.state.params[
            'head'])):
        err = np.abs(got[name].numpy() - ref).max()
        bound = 2 * head_lr if name == 'k.bias' else 0.1 * head_lr
        assert err <= bound * 3, (name, err)
    jv, tv = jt.validation_metrics(jds), tt.validation_metrics(tds)
    assert jv.keys() == tv.keys()
    for k in jv:
        if k in ('val_mse', 'val_bce'):
            np.testing.assert_allclose(tv[k], jv[k], rtol=1e-4)
        else:
            assert abs(tv[k] - jv[k]) <= 1e-6, (k, tv[k], jv[k])
    # predict: the real sequences only, no dropout, fp32 on the host
    pred = tt.predict(tds[0])
    assert pred.shape == (int((np.diff(tds[0].cu_lens) > 0).sum()),)
    np.testing.assert_allclose(pred, np.asarray(jt.predict(jds[0])),
                               rtol=1e-4, atol=1e-6)


def test_fine_tune_fit_logs_each_epoch(tmp_path):
    seqs, labels = _labelled(10, 4)
    ds = tdata.LabeledDataset(seqs, labels, token_per_batch=300,
                              shuffle=False)
    _, tm = _pair()
    _, th = _head_pair('aggregation')
    tt = RegressionTrainer(tm, th, lr=1e-3, head_lr=5e-3)
    with tlogger.MetricLogger(str(tmp_path / 'm.jsonl'), run='t') as lg:
        hist = tt.fit(lambda epoch: ds, epochs=2, val_dataset=ds, logger=lg)
    recs = tlogger.read_log(str(tmp_path / 'm.jsonl'))
    assert [r['epoch'] for r in recs] == [0.0, 1.0] == \
        [h['epoch'] for h in hist]
    assert recs[-1]['step'] == 2 * len(ds)
    assert {'train_loss', 'val_mse', 'val_spearman'} <= set(recs[0])
    assert lg.best('val_mse') == min(r['val_mse'] for r in recs)


@pytest.mark.parametrize('offload', [False, True], ids=['card', 'offload'])
def test_masked_plm_lora_only_matches_jax(offload):
    jm, tm = _pair()
    batches = [_batch(300, 512, seed=s, alphabet=ESM2.alphabet)
               for s in (5, 6)]
    lr = 1e-3
    jt = JMaskedPLM(jm, learning_rate=lr, offload_optimizer=offload)
    tt = MaskedPLM(tm, learning_rate=lr, lora_only=True,
                   offload_optimizer=offload)
    assert (tt._host is not None) == offload
    for i in range(3):
        lj = jt.training_step(batches[i % 2])
        lt = tt.training_step(batches[i % 2])
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
    n = _params_close(tm.params, jt.state.params, tm.trainable_filter(), lr,
                      3, 'MaskedPLM')
    assert n == 3 * 2
    if offload:
        # the host holds fp32 masters of the adapters only
        masters = [m for _, m, _ in tt._host._up]
        assert len(masters) == n and all(
            m.dtype == torch.float32 for m in masters)
