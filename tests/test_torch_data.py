"""The port's host data path and losses vs the JAX package: BERT masking
and static packing (``alphabet.py``), the FASTA reader (``fasta.py``),
token-budget batching and the packed masked-LM dataset (``data.py``),
and the masked losses (``loss.py``).

Gates: the numpy code must give bit-equal arrays from the same
Generator state (the same draws in the same order). The losses are
fp32 on both sides: 1e-6 relative (the same sums in another order),
and their gradients 1e-6 absolute.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esme_tpu import alphabet as jalpha
from esme_tpu import data as jdata
from esme_tpu import fasta as jfasta
from esme_tpu import loss as jloss

from esme_tpu_torch import alphabet as talpha
from esme_tpu_torch import data as tdata
from esme_tpu_torch import fasta as tfasta
from esme_tpu_torch import loss as tloss

AA = list('LAGVSERTIDPKQNFYMHWC')


def _seqs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [''.join(rng.choice(AA, n)) for n in lengths]


@pytest.mark.parametrize('freq', [0.15, 0.01])
@pytest.mark.parametrize('alphabet', ['Alphabet', 'Alphabet3'])
def test_mask_tokens_bit_equal(freq, alphabet):
    seqs = _seqs([40, 7, 130, 3, 64])
    tok2d = talpha.tokenize(seqs)
    tok1d = talpha.tokenize_unpad(seqs)[0]
    for tok in (tok1d, tok2d):
        for seed in range(3):
            got = talpha.mask_tokens(tok, freq, 0.1,
                                     alphabet=getattr(talpha, alphabet),
                                     rng=np.random.default_rng(seed))
            ref = jalpha.mask_tokens(tok, freq, 0.1,
                                     alphabet=getattr(jalpha, alphabet),
                                     rng=np.random.default_rng(seed))
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert got[1].sum(-1).min() >= 1       # a mask in every row


def test_pack_tokens_equal():
    seqs = _seqs([40, 7, 130])
    for args in ((None, None), (512, None), (512, 8)):
        for a, b in zip(talpha.pack_tokens(seqs, *args),
                        jalpha.pack_tokens(seqs, *args)):
            np.testing.assert_array_equal(a, b)
    for args, what in (((100, None), 'token_budget'),
                       ((512, 2), 'max_segments')):
        with pytest.raises(ValueError, match=what):
            talpha.pack_tokens(seqs, *args)


def test_fasta_reader_equal(fasta_path, tmp_path):
    fai = str(tmp_path / 'port.fai')
    tfasta.write_fai(fasta_path, fai)
    with open(fai) as a, open(fasta_path + '.fai') as b:
        assert a.read() == b.read()
    assert tfasta.read_fai(fai) == jfasta.read_fai(fai)
    for kw in ({}, {'max_len': 300}):
        t = tfasta.Fasta(fasta_path, **kw)
        j = jfasta.Fasta(fasta_path, **kw)
        assert len(t) == len(j) and t.lengths() == j.lengths()
        assert [t[i] for i in range(len(t))] == [j[i] for i in range(len(j))]
        assert t['PROT0004'] == j['PROT0004']
    t = tfasta.Fasta(fasta_path, k_sample=5, rng=np.random.default_rng(2))
    j = jfasta.Fasta(fasta_path, k_sample=5, rng=np.random.default_rng(2))
    assert t.fai == j.fai
    with pytest.raises(FileNotFoundError, match='Missing index'):
        tfasta.Fasta(fasta_path, fai=str(tmp_path / 'none.fai'))


@pytest.mark.parametrize('shuffle,seed', [(False, 0), (True, 3)])
def test_token_size_batch_sampler_equal(shuffle, seed):
    sizes = np.random.default_rng(seed).integers(5, 900, 60).tolist()
    kw = dict(shuffle=shuffle, random_state=seed)
    for drop_last in (False, True):
        got = tdata.TokenSizeBatchSampler(sizes, 2048, drop_last, **kw)
        ref = jdata.TokenSizeBatchSampler(sizes, 2048, drop_last, **kw)
        assert list(got) == list(ref) and len(got) == len(ref)


@pytest.mark.parametrize('shuffle,budget', [(False, 1024), (True, 2048)])
def test_masked_fasta_token_dataset_bit_equal(fasta_path, shuffle, budget):
    """The same batches, masks and all, read in the same order (the JAX
    dataset on its Python path, as ``use_native=False`` reads)."""
    kw = dict(token_per_batch=budget, shuffle=shuffle, random_state=7)
    got = tdata.MaskedFastaTokenDataset(fasta_path, **kw)
    ref = jdata.MaskedFastaTokenDataset(fasta_path, **kw)
    ref._native = None
    assert len(got) == len(ref) and got.max_segments == ref.max_segments
    for a, b in zip(got, ref):
        for name in ('tokens', 'cu_lens', 'indices', 'masked_tokens',
                     'mask'):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y)
        assert a.max_len == b.max_len and a.num_tokens == b.num_tokens
        assert a.tokens.shape == (budget,)


def test_fasta_token_dataset_checks(fasta_path):
    assert tdata.FastaTokenDataset(fasta_path, use_native=True).reader == \
        'native'
    with pytest.raises(ValueError, match='pad_to_budget'):
        tdata.FastaTokenDataset(fasta_path, use_native=True,
                                pad_to_budget=False)
    with pytest.raises(ValueError, match='token_per_batch=512'):
        tdata.FastaTokenDataset(fasta_path, token_per_batch=512)
    ds = tdata.FastaTokenDataset(fasta_path, token_per_batch=1024,
                                 use_native=False, shuffle=False)
    ref = jdata.FastaTokenDataset(fasta_path, token_per_batch=1024,
                                  use_native=False, shuffle=False)
    for a, b in zip(ds, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.masked_tokens is None and a.pad_args[1] == b.max_len


def _loss_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((300, 33)).astype(np.float32) * 3
    targets = rng.integers(0, 33, 300).astype(np.int32)
    mask = rng.random(300) < 0.2
    jl = jnp.asarray(logits, jnp.bfloat16 if dtype == 'bfloat16'
                     else jnp.float32)
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))) \
        .to(getattr(torch, dtype))
    return (jl, jnp.asarray(targets), jnp.asarray(mask)), \
        (tl, torch.from_numpy(targets), torch.from_numpy(mask))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_losses_match_jax(dtype):
    (jl, jt, jm), (tl, tt, tm) = _loss_inputs(dtype)
    pairs = [
        (tloss.cross_entropy(tl, tt, tm), jloss.cross_entropy(jl, jt, jm)),
        (tloss.nll_loss(torch.log_softmax(tl.float(), -1), tt, tm),
         jloss.nll_loss(jax.nn.log_softmax(jl.astype(jnp.float32)), jt, jm)),
        (tloss.cross_entropy(tl, tt, torch.zeros_like(tm)),
         jloss.cross_entropy(jl, jt, jnp.zeros_like(jm))),    # no mask: 0
        (tloss.mse_loss(tl[:, 0], tl[:, 1]), jloss.mse_loss(jl[:, 0],
                                                           jl[:, 1])),
        (tloss.mse_loss(tl[:, 0], tl[:, 1], tm),
         jloss.mse_loss(jl[:, 0], jl[:, 1], jm)),
        (tloss.bce_with_logits(tl[:, 0], tm), jloss.bce_with_logits(
            jl[:, 0], jm)),
        (tloss.bce_with_logits(tl[:, 0], tm, tl[:, 2].abs()),
         jloss.bce_with_logits(jl[:, 0], jm, jnp.abs(jl[:, 2]))),
    ]
    for got, ref in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6,
                                   atol=1e-7)


def test_cross_entropy_grad_matches_jax():
    (jl, jt, jm), (tl, tt, tm) = _loss_inputs('float32', seed=1)
    ref = jax.grad(jloss.cross_entropy)(jl, jt, jm)
    tl.requires_grad_()
    tloss.cross_entropy(tl, tt, tm).backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
