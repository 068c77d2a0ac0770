"""The port's data plane against the JAX package's: the native FASTA
reader (``esme_tpu_torch/native``, built with ``g++`` into the git-ignored
build tree), the padded FASTA datasets and both data modules, the packed
datasets on either reader, and ``Prefetcher``.

Every gate is exact: the same sequences, tokens, offsets, masks and
order, bit for bit, from the same seeds (numpy on both sides, the same
draws in the same order). The JAX side reads in Python
(``_native = None`` on its packed datasets).
"""

import numpy as np
import pytest

from esme_tpu import data as jdata
from esme_tpu import native as jnative
from esme_tpu.alphabet import Alphabet as JAlphabet
from esme_tpu.alphabet import tokenize_unpad as jtokenize_unpad
from esme_tpu.fasta import Fasta as JFasta
from esme_tpu.fasta import read_fai

from esme_tpu_torch import _build, native
from esme_tpu_torch import data as tdata
from esme_tpu_torch.alphabet import Alphabet

FIELDS = ('tokens', 'cu_lens', 'indices', 'masked_tokens', 'mask')


def _same_batch(a, b, fields=FIELDS):
    for name in fields:
        x, y = getattr(a, name), getattr(b, name)
        if y is None:
            assert x is None, name
            continue
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.max_len == b.max_len


def _python(ds):
    ds._native = None
    return ds


def test_native_reader_is_jax_python_path(fasta_path):
    rows = read_fai(fasta_path + '.fai')
    nf = native.NativeFasta(fasta_path, rows, Alphabet)
    fa = JFasta(fasta_path)
    assert [nf.read_seq(i) for i in range(len(fa))] == \
        [fa[i] for i in range(len(fa))]
    np.testing.assert_array_equal(native.make_lut(Alphabet),
                                  jnative.make_lut(JAlphabet))
    for idxs in ([2, 0, 7], [13], list(range(5))):
        tokens, cu, ml = nf.tokenize_pack(idxs, 2048)
        want, _, want_cu, want_ml = jtokenize_unpad(
            [fa[i] for i in idxs], alphabet=JAlphabet)
        assert ml == want_ml and tokens.dtype == np.int32
        np.testing.assert_array_equal(cu, want_cu)
        np.testing.assert_array_equal(tokens[:len(want)], want)
        assert (tokens[len(want):] == Alphabet.padding_idx).all()
    with pytest.raises(ValueError, match='token_budget'):
        nf.tokenize_pack(list(range(16)), 64)
    nf.close()


def test_native_library_lives_in_the_build_tree():
    path = native.build()
    assert path == native.lib_path() and path.exists()
    assert _build.BUILD_ROOT in path.parents
    assert not list(native.SRC.parent.glob('*.so'))


@pytest.mark.parametrize('shuffle', [False, True])
def test_fasta_token_dataset_native_is_jax_python(fasta_path, shuffle):
    kw = dict(token_per_batch=1024, shuffle=shuffle, random_state=3,
              alphabet=Alphabet)
    got = tdata.FastaTokenDataset(fasta_path, use_native=True, **kw)
    assert got.reader == 'native'
    ref = jdata.FastaTokenDataset(fasta_path, use_native=False,
                                  **{**kw, 'alphabet': JAlphabet})
    assert len(got) == len(ref) and got.max_segments == ref.max_segments
    for a, b in zip(got, ref):
        _same_batch(a, b, ('tokens', 'cu_lens', 'indices'))
    py = tdata.FastaTokenDataset(fasta_path, use_native=False, **kw)
    assert py.reader == 'python'
    for a, b in zip(got, py):
        _same_batch(a, b, ('tokens', 'cu_lens', 'indices'))


def test_token_data_module_both_readers_across_epochs(fasta_path):
    kw = dict(token_per_batch=2048, max_len=900)
    mods = [tdata.MaskedFastaTokenDataModule(fasta_path, fasta_path,
                                             use_native=use, **kw)
            for use in (True, False)]
    ref = jdata.MaskedFastaTokenDataModule(fasta_path, fasta_path, **kw)
    for epoch in (0, 1):
        for m in (*mods, ref):
            m.set_epoch(epoch)
        for loader in ('train_dataloader', 'val_dataloader'):
            nat, py = (getattr(m, loader)() for m in mods)
            want = _python(getattr(ref, loader)())
            assert (nat.reader, py.reader) == ('native', 'python')
            assert len(nat) == len(py) == len(want)
            for a, b, c in zip(nat, py, want):
                _same_batch(a, c)
                _same_batch(b, c)


def test_padded_datasets_and_module(fasta_path):
    got = tdata.FastaDataset(fasta_path, max_len=500)
    ref = jdata.FastaDataset(fasta_path, max_len=500)
    assert len(got) == len(ref)
    for kw in ({}, {'shuffle': True, 'random_state': 5}):
        for a, b in zip(got.batches(3, **kw), ref.batches(3, **kw)):
            np.testing.assert_array_equal(a, b)
    got = tdata.MaskedFastaDataset(fasta_path, rng=np.random.default_rng(2))
    ref = jdata.MaskedFastaDataset(fasta_path, rng=np.random.default_rng(2))
    for a, b in zip(got.batches(4, shuffle=True, random_state=1),
                    ref.batches(4, shuffle=True, random_state=1)):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    tm = tdata.MaskedFastaDataModule(fasta_path, fasta_path, fasta_path,
                                     batch_size=5, max_len=700)
    jm = jdata.MaskedFastaDataModule(fasta_path, fasta_path, fasta_path,
                                     batch_size=5, max_len=700)
    for epoch in (0, 3):
        tm.set_epoch(epoch)
        jm.set_epoch(epoch)
        for loader in ('train_dataloader', 'val_dataloader',
                       'test_dataloader'):
            pairs = list(zip(getattr(tm, loader)(), getattr(jm, loader)()))
            assert len(pairs) == 3        # 13 sequences of <= 700
            for a, b in pairs:
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('workers', [1, 4])
def test_prefetcher_order(fasta_path, workers):
    ds = tdata.MaskedFastaTokenDataset(fasta_path, token_per_batch=1024,
                                       shuffle=True, random_state=9,
                                       use_native=True)
    want = [ds[i] for i in range(len(ds))]

    def put(b):
        b.tokens = b.tokens.copy()
        return b
    again = tdata.MaskedFastaTokenDataset(fasta_path, token_per_batch=1024,
                                          shuffle=True, random_state=9)
    pf = tdata.Prefetcher(again, depth=2, device_put=put, num_workers=workers)
    got = list(pf)
    assert len(pf) == len(got) == len(want)
    # the masks come from one Generator in the order items are built: one
    # worker builds in order; four build the same tokens in any order
    fields = FIELDS if workers == 1 else FIELDS[:3]
    for a, b in zip(got, want):
        _same_batch(a, b, fields)
    ref = jdata.Prefetcher(_python(jdata.FastaTokenDataset(
        fasta_path, token_per_batch=1024, shuffle=True, random_state=9)),
        num_workers=workers)
    for a, b in zip(got, ref):
        _same_batch(a, b, FIELDS[:3])
    with pytest.raises(TypeError, match='indexable'):
        tdata.Prefetcher(iter(want), num_workers=2)


def test_prefetcher_raises_the_workers_error():
    class Broken:
        def __iter__(self):
            yield 1
            raise OSError('disk gone')

        def __len__(self):
            return 2
    with pytest.raises(OSError, match='disk gone'):
        list(tdata.Prefetcher(Broken()))


def test_use_native_without_gxx(fasta_path, monkeypatch, tmp_path):
    """Without ``g++`` the reader cannot be built: ``use_native=True``
    raises the build's error, ``None`` reads in Python."""
    monkeypatch.setattr(_build, 'BUILD_ROOT', tmp_path / 'build')
    monkeypatch.setattr(native.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        tdata.FastaTokenDataset(fasta_path, use_native=True)
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        tdata.MaskedFastaTokenDataModule(
            fasta_path, use_native=True).train_dataloader()
    assert tdata.FastaTokenDataset(fasta_path).reader == 'python'
    assert not (tmp_path / 'build').exists()
