"""The port's position extension (``esme_tpu_torch/extend.py``) against
``esme_tpu/extend.py`` and ``tests/test_extend.py``'s checks, on its tiny
fp32 ESM1b (2 layers, width 64, 4 heads, 64 learned positions, seed 0)
carried over with ``params_from_jax``.

The new rows come from a torch Generator, so they are not JAX's bits:
JAX's extended table is carried across to compare the forwards on a
sequence longer than the old table (gate 1e-5 on the logits, fp32 sums
in another order). On the port alone the checks are exact: short
sequences' logits bit-equal before and after the extension, the old
rows copied bit for bit, and a positions-only step changing
``embed_positions`` and no other leaf.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from esme_tpu import ESM1b as JESM1b
from esme_tpu import extend as jext
from esme_tpu.models.config import esm1b_config as jesm1b_config

from esme_tpu_torch import ESM1b, ESM2, MaskedFastaTokenDataset, \
    tokenize_unpad
from esme_tpu_torch import extend as text
from esme_tpu_torch.models.config import esm1b_config, esm2_config
from esme_tpu_torch.models.io import params_from_jax
from esme_tpu_torch.train import MaskedPLM

LOGIT_ATOL = 1e-5


def _cfg(config):
    return replace(config(dtype='float32'), num_layers=2, embed_dim=64,
                   attention_heads=4, learned_positions=64)


def tiny_1b():
    jm = JESM1b(config=_cfg(jesm1b_config), rng=0)
    cfg = _cfg(esm1b_config)
    tm = ESM1b(config=cfg, params=params_from_jax(
        jax.tree.map(np.array, jm.params), cfg), device='cpu')
    return jm, tm


def test_extend_preserves_short_seq_outputs_and_matches_jax():
    jm, tm = tiny_1b()
    tok, _, cu, ml = tokenize_unpad(['MAGVLKE', 'LKE'], alphabet=tm.alphabet)
    before = tm.forward(tok, pad_args=(cu, ml))
    old = tm.params['embed_positions'].clone()
    assert text.extend_positions(tm, 128, rng=3) is tm
    table = tm.params['embed_positions']
    assert table.shape == (130, 64) and table.dtype == torch.float32
    assert tm.config.learned_positions == 128
    assert torch.equal(table[:66], old)
    assert 0.01 < table[66:].std().item() < 0.03      # std 0.02
    assert torch.equal(tm.forward(tok, pad_args=(cu, ml)), before)

    # the same rng: the same rows; another: other rows
    _, again = tiny_1b()
    assert torch.equal(text.extend_positions(again, 128, rng=3)
                       .params['embed_positions'], table)
    _, other = tiny_1b()
    assert not torch.equal(text.extend_positions(other, 128, rng=4)
                           .params['embed_positions'], table)

    # past the old table, with JAX's new rows carried across
    jext.extend_positions(jm, 128)
    tm.params['embed_positions'] = torch.from_numpy(
        np.array(jm.params['embed_positions']))
    long = 'MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSGAEKAVQVKVKALP' \
        'DAQFEVVHSLAKWKRQTLGQHDFSAGEGLYTHMKALRPDEDRLSPLHSVYVDQWDWE'
    assert 64 < len(long) + 2 <= 130
    tok, _, cu, ml = tokenize_unpad([long, 'MAGVLKE'], alphabet=tm.alphabet)
    got = tm.forward(tok, pad_args=(cu, ml)).numpy()
    ref = np.asarray(jm.forward(tok, pad_args=(cu, ml)))
    assert np.abs(got - ref).max() <= LOGIT_ATOL


def test_extend_rejects_shrink_and_rotary_models():
    _, tm = tiny_1b()
    with pytest.raises(ValueError):
        text.extend_positions(tm, 32)
    with pytest.raises(ValueError):
        text.extend_positions(tm, 64)
    rotary = ESM2(config=esm2_config(1, 32, 2, dtype='float32'),
                  device='cpu')
    with pytest.raises(ValueError, match='learned-position'):
        text.extend_positions(rotary, 128)


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v


def test_positions_only_training(fasta_path):
    jm, tm = tiny_1b()
    text.extend_positions(tm, 512)
    jext.extend_positions(jm, 512)
    mask = text.positions_only_mask(tm.params)
    assert mask == jext.positions_only_mask(jm.params)
    assert mask['embed_positions'] is True
    assert mask['embed_tokens'] is False

    batch = MaskedFastaTokenDataset(fasta_path, token_per_batch=1024,
                                    shuffle=False, random_state=0)[0]
    before = {k: v.clone() for k, v in _flat(tm.params)}
    trainer = MaskedPLM(tm, learning_rate=1e-2, trainable_mask=mask)
    for _ in range(2):
        assert np.isfinite(trainer.training_step(batch))
    after = dict(_flat(tm.params))
    assert after.keys() == before.keys()
    for name, v in after.items():
        if name == 'embed_positions':
            assert (v - before[name]).abs().max() > 0
        else:
            assert torch.equal(v, before[name]), name
