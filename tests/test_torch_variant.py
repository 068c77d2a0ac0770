"""The port's variant scoring (``esme_tpu_torch/variant.py``) against the
JAX package's (``esme_tpu/variant.py``), on ``tests/test_variant.py``'s
tiny fp32 ESM2 (2 layers, width 64, 4 heads, seed 0) carried over with
``params_from_jax``.

The port returns ``dict`` ``variant -> score`` where JAX returns a pandas
frame: the keys must be the frame's index, in its order, and the masked
datasets' items bit-equal. Gates: scores within ``SCORE_ATOL`` = 1e-5
(fp32 log-probs of the two packages differ by ~1e-6, their sums taken in
another order; measured max 2.4e-6), the pseudo-perplexity within 1e-5
relative.
"""

import jax
import numpy as np
import pytest

from esme_tpu import ESM2 as JESM2
from esme_tpu import variant as jvar
from esme_tpu.alphabet import Alphabet as JAlphabet
from esme_tpu.models.config import esm2_config as jesm2_config

from esme_tpu_torch import ESM2
from esme_tpu_torch import variant as tvar
from esme_tpu_torch.alphabet import Alphabet
from esme_tpu_torch.models.config import esm2_config
from esme_tpu_torch.models.io import params_from_jax

SEQ = 'MPEAAPPVAPAPAAP'
SCORE_ATOL = 1e-5


@pytest.fixture(scope='module')
def models():
    jm = JESM2(config=jesm2_config(2, 64, 4, dtype='float32'), rng=0)
    cfg = esm2_config(2, 64, 4, dtype='float32')
    tm = ESM2(config=cfg, params=params_from_jax(
        jax.tree.map(np.array, jm.params), cfg), device='cpu')
    return jm, tm


@pytest.fixture(scope='module')
def jax_frame(models):
    return jvar.predict_mask_margin(models[0], SEQ, batch_size=8)


def _same(got: dict, frame):
    assert isinstance(got, dict)
    assert list(got) == list(frame.index)
    err = np.abs(np.array(list(got.values())) - frame['score'].to_numpy())
    assert err.max() <= SCORE_ATOL, err.max()


def test_mask_margin_items_equal():
    for kw in ({}, {'max_len': 32}):
        seq = SEQ if not kw else 'M' * 50 + 'W' + 'K' * 50
        got = tvar.MaskMarginDataset(seq, alphabet=Alphabet, **kw)
        ref = jvar.MaskMarginDataset(seq, alphabet=JAlphabet, **kw)
        assert len(got) == len(ref)
        for i in range(len(ref)):
            a, b = got[i], ref[i]
            assert a.keys() == b.keys()
            np.testing.assert_array_equal(a.pop('token'), b.pop('token'))
            assert a == b


def test_mask_margin_dict_is_the_frame(models, jax_frame):
    got = tvar.predict_mask_margin(models[1], SEQ, batch_size=8)
    _same(got, jax_frame)
    assert len(got) == len(SEQ) * 20 and got['M1M'] == 0.0
    assert all(np.isfinite(list(got.values())))


def test_mask_margin_batch_tail(models, jax_frame):
    # 15 positions: batches of 4 pad the tail chunk with repeated rows
    tm = models[1]
    tail = tvar.predict_mask_margin(tm, SEQ, batch_size=4)
    whole = tvar.predict_mask_margin(tm, SEQ, batch_size=len(SEQ))
    assert list(tail) == list(whole)
    np.testing.assert_allclose(list(tail.values()), list(whole.values()),
                               rtol=0, atol=SCORE_ATOL)
    _same(tail, jax_frame)      # JAX's batches of 8: a tail of 7


def test_mask_margin_window(models):
    jm, tm = models
    seq = 'M' * 20 + 'W' + 'K' * 19
    got = tvar.predict_mask_margin(tm, seq, batch_size=16, max_len=24)
    _same(got, jvar.predict_mask_margin(jm, seq, batch_size=16, max_len=24))
    ds = tvar.MaskMarginDataset(seq, max_len=24, alphabet=Alphabet)
    assert tvar.predict_mask_margin(tm, ds, batch_size=16) == got


def test_pseudoperplexity(models):
    jm, tm = models
    got = tvar.predict_pseudoperplexity(tm, SEQ, batch_size=8)
    ref = jvar.predict_pseudoperplexity(jm, SEQ, batch_size=8)
    assert isinstance(got, float) and 1.0 < got < 40.0
    assert abs(got - ref) <= 1e-5 * ref


def test_pseudoperplexity_margin(models):
    jm, tm = models
    # 320 items in 4 batches (the batch size changes no score)
    got = tvar.predict_pseudoperplexity_margin(tm, SEQ[:4], batch_size=80)
    _same(got, jvar.predict_pseudoperplexity_margin(jm, SEQ[:4],
                                                    batch_size=80))
    assert len(got) == 4 * 20 and list(got) == sorted(got)
    ds_t = tvar.PseudoPerplexitiesMarginDataset(SEQ[:4], alphabet=Alphabet)
    ds_j = jvar.PseudoPerplexitiesMarginDataset(SEQ[:4], alphabet=JAlphabet)
    assert ds_t.variants == ds_j.variants
    for i in (0, 17, len(ds_j) - 1):
        a, b = ds_t[i], ds_j[i]
        np.testing.assert_array_equal(a.pop('token'), b.pop('token'))
        assert a == b
