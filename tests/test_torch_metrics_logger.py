"""The fine-tuning slice's small helpers against the JAX package: the
metrics, the JSONL logger, the segment helpers, the trainable/frozen
split of a params tree (JAX's ``split_by_mask``; the port's mask expanded
to its leaves and the trainers' gradient targets), and the port's
checkpoint manager.

Gates: every comparison here is exact. The metrics are the same numpy
code on the same float64 inputs (ties included), the logs the same JSON,
the segment helpers integer metadata, the split the same leaves in the
same order. The checkpoint manager has its own semantics (JAX's writes
orbax files, which the port does not read): top-k by the monitored
metric, the best and the latest step, and a restored trainer whose
params, optimizer state and step are bit-equal to those saved and whose
next step is bit-equal to the uninterrupted trainer's.
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esme_tpu import logger as jlogger
from esme_tpu import metrics as jmetrics
from esme_tpu.models import esm as jesm
from esme_tpu.models.config import esm2_config as jesm2_config
from esme_tpu.ops import segment as jseg
from esme_tpu.train import partition as jpart

from esme_tpu_torch import ESM2, LabeledDataset
from esme_tpu_torch import logger as tlogger
from esme_tpu_torch import metrics as tmetrics
from esme_tpu_torch.models.config import esm2_config
from esme_tpu_torch.models.heads import init_learned_aggregation
from esme_tpu_torch.models.io import params_from_jax
from esme_tpu_torch.ops import segment as tseg
from esme_tpu_torch.train import CheckpointManager, RegressionTrainer
from esme_tpu_torch.train import partition as tpart
from esme_tpu_torch.train.trainer import train_views

AA = list('LAGVSERTIDPKQNFYMHWC')


def _scores(n, seed, ties):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(n)
    if ties:
        s = np.round(s, 1)              # many ties
    return s


@pytest.mark.parametrize('ties', [False, True], ids=['distinct', 'ties'])
def test_metrics_match_jax(ties):
    for n, seed in ((50, 0), (333, 1), (7, 2)):
        pred, target = _scores(n, seed, ties), _scores(n, seed + 10, ties)
        labels = (_scores(n, seed + 20, ties) > 0.3).astype(np.float32)
        assert tmetrics._rank(pred).tolist() == \
            jmetrics._rank(pred).tolist()
        for name, args in (('spearman', (pred, target)),
                           ('auroc', (labels, pred)),
                           ('auprc', (labels, pred)),
                           ('accuracy', (labels, pred))):
            got = getattr(tmetrics, name)(*args)
            ref = getattr(jmetrics, name)(*args)
            assert got == ref, (name, n, got, ref)
    # one class only: NaN on both sides
    ones = np.ones(5)
    assert np.isnan(tmetrics.auroc(ones, np.arange(5.0)))
    assert np.isnan(tmetrics.auprc(np.zeros(5), np.arange(5.0)))
    assert tmetrics.spearman(ones, np.arange(5.0)) == \
        jmetrics.spearman(ones, np.arange(5.0)) == 0.0


def test_metric_logger_round_trip(tmp_path, capsys):
    recs = [({'loss': 3.25, 'epoch': 0}, 1), ({'loss': np.float32(2.5),
             'note': 'warm', 'val_spearman': 0.5}, 2), ({'loss': 1.0}, None)]
    logs = {}
    for name, mod in (('port', tlogger), ('jax', jlogger)):
        path = str(tmp_path / f'{name}.jsonl')
        with mod.MetricLogger(path, run='r', stdout=True) as lg:
            for metrics, step in recs:
                lg.log(metrics, step=step)
                lg.track_best(metrics)
            logs[name] = (lg.summary, lg.best('loss'), lg.best('loss', 'max'))
        read = mod.read_log(path)
        assert [r.pop('t') > 0 for r in read] == [True] * 3
        logs[name] += (read,)
    assert logs['port'] == logs['jax']
    assert logs['port'][-1][1] == {'run': 'r', 'step': 2, 'loss': 2.5,
                                   'note': 'warm', 'val_spearman': 0.5}
    err = capsys.readouterr().err.splitlines()
    assert err[:3] == err[3:] and err[0] == 'step=1 loss=3.25 epoch=0'


def test_read_log_of_the_task_artefacts():
    """Each ``task_*/metrics.jsonl`` of the repo reads as JAX reads it."""
    paths = sorted(glob.glob('task_*/metrics.jsonl'))
    assert len(paths) == 4
    for path in paths:
        got = tlogger.read_log(path)
        assert got == jlogger.read_log(path) and len(got) >= 10, path


def test_segment_helpers_match_jax():
    rng = np.random.default_rng(0)
    valid = rng.random((4, 9)) < 0.7
    for b, l, v in ((4, 9, valid), (1, 5, np.ones((1, 5), bool)),
                    (3, 4, np.zeros((3, 4), bool))):
        got = tseg.padded_to_flat_meta(b, l, torch.from_numpy(v))
        ref = jseg.padded_to_flat_meta(b, l, jnp.asarray(v))
        for g, r in zip(got, ref):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    cu = np.array([0, 5, 5, 12, 40], np.int32)
    np.testing.assert_array_equal(
        tseg.segment_lengths(torch.from_numpy(cu)).numpy(),
        np.asarray(jseg.segment_lengths(jnp.asarray(cu))))


def _tiny_params():
    cfg = jesm2_config(2, 32, 2, dtype='float32')
    jm = jesm.ESM2(config=cfg, rng=0)
    jm.add_lora(rank=4, alpha=8, adapter_names=['x', 'y'])
    tcfg = esm2_config(2, 32, 2, dtype='float32')
    return jm, params_from_jax(jax.tree.map(np.asarray, jm.params), tcfg)


@pytest.mark.parametrize('lora_only', [None, False, ['y']])
def test_split_by_mask_matches_jax(lora_only):
    """The port's split of the params by a trainable mask is JAX's: the
    expanded mask flags the leaves JAX's ``split_by_mask`` trains (in
    JAX's leaf order, the same values on each side), and the trainers'
    views (``train_views``) take a gradient on exactly those leaves and
    share the storage of every leaf."""
    jm, tp = _tiny_params()
    jmask = jm.trainable_filter(lora_only=lora_only)
    tmask = ESM2(config=esm2_config(2, 32, 2, dtype='float32'), params=tp,
                 device='cpu').trainable_filter(lora_only=lora_only)
    jtrain, jfrozen, _, jflags = jpart.split_by_mask(jm.params, jmask)
    expanded = tpart.expand_mask(tmask, tp)
    flags = jax.tree.leaves(expanded)
    assert flags == list(jflags) and 0 < sum(flags) <= len(flags)
    leaves = jax.tree.leaves(tp)
    assert len(leaves) == len(jax.tree.leaves(jm.params))
    train = [x for x, f in zip(leaves, flags) if f]
    frozen = [x for x, f in zip(leaves, flags) if not f]
    for got, ref in zip(train + frozen, list(jtrain) + list(jfrozen)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    views = train_views(tp, tmask)
    for key, v in views.items():
        for view in (v if key == 'layers' else [v]):
            want = jax.tree.leaves(expanded[key])
            got = jax.tree.leaves(jax.tree.map(lambda t: t.requires_grad,
                                               view))
            assert got == want, key
    for i, layer in enumerate(views['layers']):
        for t, src in zip(jax.tree.leaves(layer),
                          jax.tree.leaves(tp['layers'])):
            assert t.data_ptr() == src[i].data_ptr()
    # one bool covers a subtree; a mask of another structure is refused
    flags = jax.tree.leaves(tpart.expand_mask(
        {**{k: False for k in tp}, 'lm_head': True}, tp))
    assert sum(flags) == len(jax.tree.leaves(tp['lm_head']))
    with pytest.raises(ValueError, match='does not match'):
        tpart.expand_mask({'layers': True}, tp)


def _trainer(seed=0):
    model = ESM2(config=esm2_config(2, 32, 2, dtype='float32'), rng=seed,
                 device='cpu')
    model.add_lora(rank=4, alpha=8, rng=seed)
    head = init_learned_aggregation(seed, 32, dtype='float32', device='cpu')
    return RegressionTrainer(model, head, head_lr=5e-3, lr=1e-3,
                             head_attention_heads=2)


def _dataset():
    rng = np.random.default_rng(5)
    seqs = [''.join(rng.choice(AA, int(n))) for n in rng.integers(5, 40, 12)]
    return LabeledDataset(seqs, [len(s) / 40 for s in seqs],
                          token_per_batch=160, shuffle=False)


def test_checkpoint_manager_top_k_best_and_resume(tmp_path):
    ds = _dataset()
    tr = _trainer()
    mgr = CheckpointManager(str(tmp_path / 'ck'), max_to_keep=3,
                            monitor='val_spearman', mode='max')
    assert mgr.latest_step() is None and mgr.restore() is None
    scores = [0.1, 0.7, 0.3, 0.7, 0.9]
    for epoch, score in enumerate(scores):
        tr.training_step(ds[epoch % len(ds)])
        mgr.save(epoch, tr.state, {'val_spearman': score, 'epoch': epoch})
        if epoch == 1:
            saved = {k: v.clone() for k, v in tr.model.lora_state_dict()
                     .items()}
            saved_step = tr.step
    # the three best stay
    assert mgr.all_steps() == [1, 3, 4]
    assert mgr.best_step() == 4 and mgr.latest_step() == 4
    assert json.loads((tmp_path / 'ck' / '1' / 'metrics.json').read_text()) \
        == {'val_spearman': 0.7, 'epoch': 1.0}
    # a fresh trainer resumes from step 1, bit for bit
    fresh = _trainer(seed=9)
    fresh.state = mgr.restore(fresh.state, step=1)
    assert fresh.step == saved_step
    for k, v in fresh.model.lora_state_dict().items():
        assert torch.equal(v, saved[k]), k
    # ... and the latest: its next step equals the trainer's own
    fresh.state = mgr.restore(fresh.state)
    for a, b in zip(jax.tree.leaves(fresh.state.params),
                    jax.tree.leaves(tr.state.params)):
        assert torch.equal(a, b)
    b0 = ds[0]
    assert fresh.training_step(b0) == tr.training_step(b0)
    for a, b in zip(jax.tree.leaves(fresh.state.params),
                    jax.tree.leaves(tr.state.params)):
        assert torch.equal(a, b)
    # a tie keeps (and ranks first) the newer; 'min' keeps the lowest
    ties = CheckpointManager(str(tmp_path / 'ties'), max_to_keep=2,
                             monitor='val_loss', mode='min')
    for step, loss in enumerate([0.5, 0.2, 0.9, 0.2]):
        ties.save(step, {'w': torch.zeros(1)}, {'val_loss': loss})
    assert ties.all_steps() == [1, 3] and ties.best_step() == 3
    # without a monitor the newest stay
    plain = CheckpointManager(str(tmp_path / 'plain'), max_to_keep=2,
                              monitor=None)
    for step in range(4):
        plain.save(step, {'w': torch.full((2,), float(step))})
    assert plain.all_steps() == [2, 3] and plain.best_step() is None
    assert torch.equal(plain.restore()['w'], torch.full((2,), 3.0))
