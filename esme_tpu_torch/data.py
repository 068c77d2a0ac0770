"""Token-budget batching, the FASTA datasets and data modules, and the
host prefetcher.

Counterpart of ``esme_tpu/data.py`` (reference: esme/data.py:12-453):
:class:`TokenSizeBatchSampler`, :class:`PackedBatch`, the padded
:class:`FastaDataset` and :class:`MaskedFastaDataset` with
:class:`MaskedFastaDataModule`, the packed :class:`FastaTokenDataset`
(Python reader, or the C++ mmap reader of :mod:`esme_tpu_torch.native`)
and :class:`MaskedFastaTokenDataset` with
:class:`MaskedFastaTokenDataModule`, the fine-tuning data
:class:`LabeledDataset` and :func:`balance_binary`, and
:class:`Prefetcher`, with the same batches for the same ``random_state``.
Batches are numpy arrays; the trainer moves them to the model's device
(or a :class:`Prefetcher`'s ``device_put`` does). Packed batches are
padded to a static ``(token_per_batch, max_segments)`` shape as in the
JAX package, whose jitted step compiled once per shape; here the static
shape keeps every step's allocations alike.
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from .alphabet import (Alphabet3, mask_tokens, pad_tokens, tokenize,
                       tokenize_unpad)
from .fasta import Fasta
from .native import NativeFasta
from .profiling import span


class TokenSizeBatchSampler:
    """Greedy token-budget batching (``esme_tpu/data.py:28-79``).

    Groups dataset indices so that the summed tokenized length
    (sequence length + 2 for cls/eos) stays under ``token_per_batch``.
    Shuffling is a numpy permutation seeded by ``random_state``.
    """

    def __init__(self, token_sizes, token_per_batch, drop_last=False,
                 shuffle=True, random_state=None):
        self.token_sizes = list(token_sizes)
        self.token_per_batch = token_per_batch
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.random_state = random_state
        self._batches = list(self.batches())

    def batches(self):
        indices = list(range(len(self.token_sizes)))

        if self.shuffle:
            rng = np.random.default_rng(self.random_state)
            indices = [int(i) for i in rng.permutation(len(indices))]

        batch: List[int] = []
        total = 0

        for idx in indices:
            token_len = self.token_sizes[idx] + 2  # +2 for cls/eos

            if total + token_len > self.token_per_batch:
                if batch:
                    yield batch
                total = token_len
                batch = [idx]
            else:
                total += token_len
                batch.append(idx)

        if len(batch) > 0 and not self.drop_last:
            yield batch

    def __iter__(self):
        return iter(self._batches)

    def __getitem__(self, idx):
        return self._batches[idx]

    def __len__(self):
        return len(self._batches)


@dataclass
class PackedBatch:
    """A packed varlen batch with static shapes (``esme_tpu/data.py:82-109``).

    ``tokens`` is ``(token_budget,)`` int32 (tail = padding_idx past
    ``cu_lens[-1]``); ``cu_lens`` is ``(max_segments + 1,)`` int32 with
    the last real value repeated into the tail. ``max_len`` is the
    longest (cls/eos-inclusive) segment. ``indices`` locates each real
    flat token inside the row-major padded ``(num_seqs, max_len)``
    layout.
    """
    tokens: np.ndarray
    cu_lens: np.ndarray
    max_len: int
    indices: Optional[np.ndarray] = None
    # masked-LM extras (None for inference batches)
    masked_tokens: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    # regression/classification labels
    labels: Optional[np.ndarray] = None

    @property
    def pad_args(self):
        return self.cu_lens, self.max_len

    @property
    def num_tokens(self) -> int:
        return int(self.cu_lens[-1])


def _pad_packed(tokens, cu_lens, token_budget, max_segments, pad_idx):
    total = tokens.shape[0]
    nseg = cu_lens.shape[0] - 1
    if token_budget is not None:
        tokens = np.pad(tokens, (0, token_budget - total),
                        constant_values=pad_idx)
    if max_segments is not None:
        cu_lens = np.pad(cu_lens, (0, max_segments - nseg), mode='edge')
    return tokens, cu_lens


class BaseFastaDataset:
    """Shared FASTA plumbing (``esme_tpu/data.py:123-134``, reference:
    esme/data.py:63-78)."""

    def __init__(self, fasta, fai=None, k_sample=None, max_len=None,
                 alphabet=Alphabet3, rng=None):
        self.max_len = max_len
        self.alphabet = alphabet
        self.fasta = Fasta(fasta, fai=fai, max_len=max_len,
                           k_sample=k_sample, rng=rng)

    def read_seq(self, idx):
        return self.fasta[idx]


def _shuffled(n, shuffle, random_state):
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(random_state).permutation(order)
    return order


class FastaDataset(BaseFastaDataset):
    """Padded ``(B, L)`` batches of tokenized sequences
    (``esme_tpu/data.py:137-154``, reference: esme/data.py:81-112)."""

    def __len__(self):
        return len(self.fasta)

    def __getitem__(self, idx):
        return tokenize(self.read_seq(idx), alphabet=self.alphabet)

    def batches(self, batch_size, shuffle=False, random_state=None):
        order = _shuffled(len(self), shuffle, random_state)
        for lo in range(0, len(order), batch_size):
            chunk = order[lo:lo + batch_size]
            yield pad_tokens([self[int(i)] for i in chunk],
                             alphabet=self.alphabet)


class FastaTokenDataset(BaseFastaDataset):
    """Packed varlen batches under a token budget
    (``esme_tpu/data.py:157-224``, reference: esme/data.py:115-162).

    One item = one :class:`PackedBatch` whose flat length is padded to
    ``token_per_batch`` and segment count to the dataset-wide maximum.

    ``use_native``: ``True`` reads and packs with the C++ mmap reader
    (:class:`esme_tpu_torch.native.NativeFasta`), built at first use, and
    raises the build's own error if it cannot be built; ``None`` takes it
    when it builds and reads in Python otherwise (the JAX meaning);
    ``False`` reads in Python. The native reader needs
    ``pad_to_budget``. ``reader`` says which one this dataset took
    (``'native'`` or ``'python'``). The two readers give the same
    batches, ``indices`` included (JAX's native batch has none).
    """

    def __init__(self, fasta, fai=None, token_per_batch=50_000, k_sample=None,
                 max_len=None, drop_last=False, shuffle=True,
                 random_state=None, alphabet=Alphabet3, pad_to_budget=True,
                 use_native=None):
        super().__init__(fasta, fai=fai, k_sample=k_sample, max_len=max_len,
                         alphabet=alphabet)
        self.token_per_batch = token_per_batch
        self.pad_to_budget = pad_to_budget

        self._native = None
        if use_native is True and not pad_to_budget:
            raise ValueError('use_native=True needs pad_to_budget=True')
        if use_native is not False and pad_to_budget:
            try:
                self._native = NativeFasta(self.fasta.fasta, self.fasta.fai,
                                           alphabet)
            except (RuntimeError, OSError):
                if use_native is True:
                    raise
        self.reader = 'python' if self._native is None else 'native'

        lengths = self.fasta.lengths()
        longest = max(lengths, default=0) + 2
        if pad_to_budget and longest > token_per_batch:
            raise ValueError(
                f'longest sequence needs {longest} tokens (incl cls/eos) '
                f'but token_per_batch={token_per_batch}; filter with '
                f'max_len<={token_per_batch - 2} or raise the budget')
        self.sampler = list(TokenSizeBatchSampler(
            lengths, token_per_batch, drop_last=drop_last,
            shuffle=shuffle, random_state=random_state))
        self.max_segments = max(len(b) for b in self.sampler) \
            if self.sampler else 0

    def __len__(self):
        return len(self.sampler)

    def __getitem__(self, idx) -> PackedBatch:
        indices = self.sampler[idx]
        if self._native is not None:
            tokens, cu_lens, max_len = self._native.tokenize_pack(
                indices, self.token_per_batch)
            lens = np.diff(cu_lens)
            starts = np.repeat(cu_lens[:-1].astype(np.int64), lens)
            rows = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
            tok_indices = rows * max_len + np.arange(cu_lens[-1]) - starts
            cu_lens = np.pad(cu_lens, (0, self.max_segments - len(indices)),
                             mode='edge')
            return PackedBatch(tokens=tokens, cu_lens=cu_lens,
                               max_len=max_len, indices=tok_indices)
        tokens, tok_indices, cu_lens, max_len = tokenize_unpad(
            [self.read_seq(i) for i in indices], alphabet=self.alphabet)
        if self.pad_to_budget:
            tokens, cu_lens = _pad_packed(
                tokens, cu_lens, self.token_per_batch, self.max_segments,
                self.alphabet.padding_idx)
        return PackedBatch(tokens=tokens, cu_lens=cu_lens, max_len=max_len,
                           indices=tok_indices)

    def __iter__(self) -> Iterator[PackedBatch]:
        for i in range(len(self)):
            yield self[i]


class MaskedFastaDataset(FastaDataset):
    """Padded batches with BERT masking (``esme_tpu/data.py:227-261``,
    reference: esme/data.py:165-205). Masks are drawn from ``rng`` (a
    numpy Generator) in the order items are read."""

    def __init__(self, fasta, fai=None, max_len=None, k_sample=None,
                 mask_freq=.15, alter_freq=.1, alphabet=Alphabet3, rng=None):
        super().__init__(fasta, fai=fai, k_sample=k_sample, max_len=max_len,
                         alphabet=alphabet)
        self.mask_freq = mask_freq
        self.alter_freq = alter_freq
        self.rng = rng or np.random.default_rng()

    def __getitem__(self, idx):
        token = super().__getitem__(idx)
        mtokens, mask = mask_tokens(token, self.mask_freq, self.alter_freq,
                                    alphabet=self.alphabet, rng=self.rng)
        return token, mtokens, mask

    def batches(self, batch_size, shuffle=False, random_state=None):
        """Padded ``(B, L)`` ``(tokens, masked_tokens, mask)`` batches, the
        reference's padded collate (reference: esme/data.py:190-205)."""
        order = _shuffled(len(self), shuffle, random_state)
        pad = self.alphabet.padding_idx
        for lo in range(0, len(order), batch_size):
            items = [self[int(i)] for i in order[lo:lo + batch_size]]
            L = max(t.shape[1] for t, _, _ in items)

            def pad_to(a, fill):
                return np.pad(a, ((0, 0), (0, L - a.shape[1])),
                              constant_values=fill)
            yield tuple(np.concatenate([pad_to(item[j], fill)
                                        for item in items])
                        for j, fill in enumerate((pad, pad, False)))


class MaskedFastaDataModule:
    """Padded-batch train/val/test masked-LM loaders, the reference's
    non-packed DataModule (``esme_tpu/data.py:264-303``, reference:
    esme/data.py:247-300). Each loader masks with a Generator seeded by
    the epoch and shuffles the train split by it (``set_epoch``)."""

    def __init__(self, train_fasta, val_fasta=None, test_fasta=None,
                 train_fai=None, val_fai=None, test_fai=None,
                 batch_size: int = 8, mask_freq=.15, alter_freq=.1,
                 max_len=None, alphabet=Alphabet3):
        self.train_fasta, self.train_fai = train_fasta, train_fai
        self.val_fasta, self.val_fai = val_fasta, val_fai
        self.test_fasta, self.test_fai = test_fasta, test_fai
        self.batch_size = batch_size
        self.mask_freq = mask_freq
        self.alter_freq = alter_freq
        self.max_len = max_len
        self.alphabet = alphabet
        self.current_epoch = 0

    def _loader(self, fasta, fai, shuffle):
        ds = MaskedFastaDataset(
            fasta, fai=fai, max_len=self.max_len,
            mask_freq=self.mask_freq, alter_freq=self.alter_freq,
            alphabet=self.alphabet,
            rng=np.random.default_rng(self.current_epoch))
        return ds.batches(self.batch_size, shuffle=shuffle,
                          random_state=self.current_epoch)

    def train_dataloader(self):
        return self._loader(self.train_fasta, self.train_fai, shuffle=True)

    def val_dataloader(self):
        return self._loader(self.val_fasta, self.val_fai, shuffle=False)

    def test_dataloader(self):
        return self._loader(self.test_fasta, self.test_fai, shuffle=False)

    def set_epoch(self, epoch):
        self.current_epoch = epoch


class MaskedFastaTokenDataset(FastaTokenDataset):
    """Packed varlen batches with BERT masking for masked-LM training
    (``esme_tpu/data.py:306-334``, reference: esme/data.py:208-244).
    Yields :class:`PackedBatch` with ``masked_tokens`` (model input) and
    ``mask`` (loss positions). Masks are drawn from one Generator seeded
    by ``random_state``, in the order batches are read. ``use_native``
    as :class:`FastaTokenDataset`'s (JAX passes its default, None)."""

    def __init__(self, fasta, fai=None, token_per_batch=50_000, k_sample=None,
                 max_len=None, mask_freq=.15, alter_freq=.1, drop_last=False,
                 shuffle=True, random_state=None, alphabet=Alphabet3,
                 pad_to_budget=True, use_native=None):
        super().__init__(fasta, fai=fai, token_per_batch=token_per_batch,
                         k_sample=k_sample, max_len=max_len,
                         drop_last=drop_last, shuffle=shuffle,
                         random_state=random_state, alphabet=alphabet,
                         pad_to_budget=pad_to_budget, use_native=use_native)
        self.mask_freq = mask_freq
        self.alter_freq = alter_freq
        self.rng = np.random.default_rng(random_state)

    def __getitem__(self, idx) -> PackedBatch:
        batch = super().__getitem__(idx)
        total = batch.num_tokens
        real = batch.tokens[:total]
        mtokens, mask = mask_tokens(real, self.mask_freq, self.alter_freq,
                                    alphabet=self.alphabet, rng=self.rng)
        pad = batch.tokens.shape[0] - total
        batch.masked_tokens = np.pad(mtokens, (0, pad),
                                     constant_values=self.alphabet.padding_idx)
        batch.mask = np.pad(mask, (0, pad), constant_values=False)
        return batch


class MaskedFastaTokenDataModule:
    """Per-epoch reshuffled train/val/test packed masked-LM loaders
    (``esme_tpu/data.py:337-376``, reference: esme/data.py:303-364 minus
    the Lightning base class). ``set_epoch`` reseeds the shuffle and the
    masks, as the reference's ``SetEpochCallback`` does (reference:
    esme/data.py:367-374). ``use_native`` goes to each dataset."""

    def __init__(self, train_fasta, val_fasta=None, test_fasta=None,
                 train_fai=None, val_fai=None, test_fai=None,
                 token_per_batch=100_000, mask_freq=.15, alter_freq=.1,
                 max_len=None, alphabet=Alphabet3, use_native=None):
        self.train_fasta, self.train_fai = train_fasta, train_fai
        self.val_fasta, self.val_fai = val_fasta, val_fai
        self.test_fasta, self.test_fai = test_fasta, test_fai
        self.token_per_batch = token_per_batch
        self.mask_freq = mask_freq
        self.alter_freq = alter_freq
        self.max_len = max_len
        self.alphabet = alphabet
        self.use_native = use_native
        self.current_epoch = 0

    def _dataset(self, fasta, fai, shuffle):
        return MaskedFastaTokenDataset(
            fasta, fai=fai, token_per_batch=self.token_per_batch,
            max_len=self.max_len, mask_freq=self.mask_freq,
            alter_freq=self.alter_freq, shuffle=shuffle,
            random_state=self.current_epoch, alphabet=self.alphabet,
            use_native=self.use_native)

    def train_dataloader(self):
        return self._dataset(self.train_fasta, self.train_fai, shuffle=True)

    def val_dataloader(self):
        return self._dataset(self.val_fasta, self.val_fai, shuffle=False)

    def test_dataloader(self):
        return self._dataset(self.test_fasta, self.test_fai, shuffle=False)

    def set_epoch(self, epoch):
        self.current_epoch = epoch


class LabeledDataset:
    """Packed batches of ``(sequence, label)`` pairs for fine-tuning
    (``esme_tpu/data.py:379-424``, reference: esme/data.py:377-415), with
    ``truncate_len``. With ``pad_to_budget`` the tokens are padded to
    ``token_per_batch`` and the segments to the dataset's most per batch:
    ``cu_lens`` repeats its last value (empty segments) and the labels
    take zeros there."""

    def __init__(self, seqs, labels, token_per_batch, shuffle=True,
                 random_state=None, truncate_len=None, alphabet=Alphabet3,
                 pad_to_budget=True):
        self.seqs = list(seqs)
        self.labels = list(labels)
        self.truncate_len = truncate_len
        self.alphabet = alphabet
        self.token_per_batch = token_per_batch
        self.pad_to_budget = pad_to_budget

        self.sampler = list(TokenSizeBatchSampler(
            [min(len(s), truncate_len or len(s)) for s in self.seqs],
            token_per_batch, shuffle=shuffle, random_state=random_state))
        self.max_segments = max(len(b) for b in self.sampler) \
            if self.sampler else 0

    def truncate(self, seq):
        if self.truncate_len is not None and len(seq) > self.truncate_len:
            return seq[:self.truncate_len]
        return seq

    def __len__(self):
        return len(self.sampler)

    def __getitem__(self, idx) -> PackedBatch:
        indices = self.sampler[idx]
        tokens, tok_indices, cu_lens, max_len = tokenize_unpad(
            [self.truncate(self.seqs[i]) for i in indices],
            alphabet=self.alphabet)
        labels = np.asarray([self.labels[i] for i in indices],
                            dtype=np.float32)
        if self.pad_to_budget:
            tokens, cu_lens = _pad_packed(
                tokens, cu_lens, self.token_per_batch, self.max_segments,
                self.alphabet.padding_idx)
            labels = np.pad(labels, (0, self.max_segments - len(indices)))
        return PackedBatch(tokens=tokens, cu_lens=cu_lens, max_len=max_len,
                           indices=tok_indices, labels=labels)

    def __iter__(self) -> Iterator[PackedBatch]:
        for i in range(len(self)):
            yield self[i]


def balance_binary(seqs, labels, balance: Optional[str] = 'upsample',
                   rng=None):
    """Class-balance a binary ``(sequence, label)`` set by repeating the
    positive class (``'upsample'``) or subsampling the negative class
    (``'downsample'``), as the reference's TF dataset does (reference:
    workflow/tf/finetune.py:21-56; ``esme_tpu/data.py:427-446``)."""
    if balance not in (None, 'upsample', 'downsample'):
        raise ValueError(f'unknown balance: {balance!r}')
    if balance is None:
        return list(seqs), list(labels)
    seqs, labels = list(seqs), list(labels)
    pos = [s for s, y in zip(seqs, labels) if y]
    neg = [s for s, y in zip(seqs, labels) if not y]
    if balance == 'upsample':
        imbalance = max(len(neg) // max(len(pos), 1), 1)
        pos = pos * imbalance
    else:
        rng = rng or np.random.default_rng()
        idx = rng.permutation(len(neg))[:max(len(pos), 1)]
        neg = [neg[i] for i in idx]
    return pos + neg, [1.0] * len(pos) + [0.0] * len(neg)


class Prefetcher:
    """Background building of host batches (``esme_tpu/data.py:449-524``;
    the multi-worker DataLoader's role, reference: esme/data.py:109-112):
    reading, tokenizing and masking run in ``num_workers`` threads while
    the device computes the previous step, and batches come out strictly
    in dataset order.

    With one worker a thread iterates the dataset into a queue of
    ``depth`` items. With ``num_workers > 1`` the dataset must be
    indexable: a pool of threads builds items ``i .. i + depth +
    num_workers`` ahead. The threads share the GIL; the native reader's
    calls and numpy's array work release it.

    ``device_put``: None, or a callable applied to each item in its
    worker thread, e.g. one that copies a :class:`PackedBatch`'s arrays to
    the card from pinned memory with ``non_blocking=True``."""

    def __init__(self, dataset, depth: int = 2, device_put=None,
                 num_workers: int = 1):
        self.dataset = dataset
        self.depth = max(int(depth), 1)
        self.device_put = device_put
        self.num_workers = max(int(num_workers), 1)
        if self.num_workers > 1 and not hasattr(dataset, '__getitem__'):
            raise TypeError('num_workers > 1 requires an indexable dataset')

    def _build(self, item):
        return item if self.device_put is None else self.device_put(item)

    def _iter_pool(self):
        n = len(self.dataset)
        window = self.depth + self.num_workers

        def build(i):
            with span('esme.data.build', i):
                return self._build(self.dataset[i])

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = {i: pool.submit(build, i)
                       for i in range(min(window, n))}
            for i in range(n):
                with span('esme.data.wait', i):
                    item = futures.pop(i).result()
                if i + window < n:
                    futures[i + window] = pool.submit(build, i + window)
                yield item

    def __iter__(self):
        if self.num_workers > 1:
            yield from self._iter_pool()
            return
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = object()
        failed = []

        def worker():
            try:
                items = iter(self.dataset)
                for i in itertools.count():
                    with span('esme.data.build', i):
                        item = next(items, stop)
                        if item is not stop:
                            item = self._build(item)
                    if item is stop:
                        break
                    q.put(item)
            except BaseException as e:      # raised again in the consumer
                failed.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        for i in itertools.count():
            with span('esme.data.wait', i):
                item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if failed:
            raise failed[0]

    def __len__(self):
        return len(self.dataset)
