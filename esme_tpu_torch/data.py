"""Token-budget batching and the packed masked-LM FASTA dataset.

Counterpart of ``esme_tpu/data.py`` (reference: esme/data.py:12-415):
:class:`TokenSizeBatchSampler`, :class:`PackedBatch`, the Python path of
:class:`FastaTokenDataset` and :class:`MaskedFastaTokenDataset`, the
fine-tuning data :class:`LabeledDataset` and :func:`balance_binary`, with
the same batches for the same ``random_state``. Batches are numpy arrays;
the trainer moves them to the model's device. Batches are padded to a
static ``(token_per_batch, max_segments)`` shape as in the JAX package,
whose jitted step compiled once per shape; here the static shape keeps
every step's allocations alike. The C++ mmap reader, the prefetcher
and the data modules come with the data-plane slice (ROADMAP.md Queue 1,
item 18).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from .alphabet import Alphabet3, mask_tokens, tokenize_unpad
from .fasta import Fasta


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


class FastaTokenDataset:
    """Packed varlen batches under a token budget
    (``esme_tpu/data.py:157-224``, reference: esme/data.py:115-162).

    One item = one :class:`PackedBatch` whose flat length is padded to
    ``token_per_batch`` and segment count to the dataset-wide maximum.
    ``use_native`` is taken for the JAX signature: the C++ reader is not
    ported yet, so ``True`` raises and anything else reads in Python.
    """

    def __init__(self, fasta, fai=None, token_per_batch=50_000, k_sample=None,
                 max_len=None, drop_last=False, shuffle=True,
                 random_state=None, alphabet=Alphabet3, pad_to_budget=True,
                 use_native=None):
        if use_native is True:
            raise NotImplementedError(
                'the native FASTA reader comes with the data-plane slice; '
                'use_native=None or False reads in Python')
        self.max_len = max_len
        self.alphabet = alphabet
        self.fasta = Fasta(fasta, fai=fai, max_len=max_len,
                           k_sample=k_sample)
        self.token_per_batch = token_per_batch
        self.pad_to_budget = pad_to_budget

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

    def read_seq(self, idx):
        return self.fasta[idx]

    def __len__(self):
        return len(self.sampler)

    def __getitem__(self, idx) -> PackedBatch:
        indices = self.sampler[idx]
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


class MaskedFastaTokenDataset(FastaTokenDataset):
    """Packed varlen batches with BERT masking for masked-LM training
    (``esme_tpu/data.py:306-334``, reference: esme/data.py:208-244).
    Yields :class:`PackedBatch` with ``masked_tokens`` (model input) and
    ``mask`` (loss positions). Masks are drawn from one Generator seeded
    by ``random_state``, in the order batches are read."""

    def __init__(self, fasta, fai=None, token_per_batch=50_000, k_sample=None,
                 max_len=None, mask_freq=.15, alter_freq=.1, drop_last=False,
                 shuffle=True, random_state=None, alphabet=Alphabet3,
                 pad_to_budget=True):
        super().__init__(fasta, fai=fai, token_per_batch=token_per_batch,
                         k_sample=k_sample, max_len=max_len,
                         drop_last=drop_last, shuffle=shuffle,
                         random_state=random_state, alphabet=alphabet,
                         pad_to_budget=pad_to_budget)
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
