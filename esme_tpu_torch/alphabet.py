"""Amino-acid alphabets, tokenization, and packed (unpadded) batching.

Numpy copy of ``esme_tpu/alphabet.py`` with the same semantics (the
port imports nothing of the JAX package). Host-side tokenization is
pure numpy; the model consumes flat int32 token vectors plus cumulative
lengths (``cu_lens``), the packed "varlen" layout
(reference: esme/alphabet.py:148-183).

Tokens are int32 (vocab sizes are tiny: 33/64). BERT masking
(:func:`mask_tokens`) and static-shape packing (:func:`pack_tokens`)
draw from a ``numpy`` Generator exactly as the JAX package does, so the
same Generator state gives the same arrays.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple, Union

import numpy as np


class Alphabet:
    """Alphabet for ESM-1v, ESM-1b, and ESM2 models.

    33-token vocabulary with ``<cls>=0, <pad>=1, <eos>=2, <unk>=3,
    <mask>=32`` (reference: esme/alphabet.py:9-31).
    """

    alphabet = [
        '<cls>', '<pad>', '<eos>', '<unk>',
        'L', 'A', 'G', 'V', 'S', 'E', 'R', 'T', 'I', 'D', 'P', 'K',
        'Q', 'N', 'F', 'Y', 'M', 'H', 'W', 'C', 'X', 'B', 'U', 'Z', 'O',
        '.', '-', '<null_1>', '<mask>'
    ]
    amino_acids = alphabet[4:24]
    amino_acids_idx = list(range(4, 24))

    idx_to_token = dict(enumerate(alphabet))
    token_to_idx = {token: idx for idx, token in idx_to_token.items()}

    cls_idx = token_to_idx['<cls>']
    eos_idx = token_to_idx['<eos>']
    padding_idx = token_to_idx['<pad>']
    mask_idx = token_to_idx['<mask>']
    unk_idx = token_to_idx['<unk>']


class Alphabet3:
    """Alphabet for ESMC with ``|`` chain-break token
    (reference: esme/alphabet.py:34-56)."""

    alphabet = [
        '<cls>', '<pad>', '<eos>', '<unk>',
        "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K",
        "Q", "N", "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O",
        ".", "-", "|", "<mask>",
    ]
    amino_acids = alphabet[4:24]
    amino_acids_idx = list(range(4, 24))

    idx_to_token = dict(enumerate(alphabet))
    token_to_idx = {token: idx for idx, token in idx_to_token.items()}

    cls_idx = token_to_idx['<cls>']
    eos_idx = token_to_idx['<eos>']
    padding_idx = token_to_idx['<pad>']
    mask_idx = token_to_idx['<mask>']
    unk_idx = token_to_idx['<unk>']


_TOKEN_RE = re.compile(r"<[^>]+>|.")


def split_alphabet(seq: Union[str, List[str]]):
    """Split a sequence string into alphabet tokens, keeping multi-char
    tokens like ``<mask>`` intact (reference: esme/alphabet.py:79-98).

    >>> split_alphabet('MPV<mask>AP')
    ['M', 'P', 'V', '<mask>', 'A', 'P']
    """
    if isinstance(seq, str):
        return _TOKEN_RE.findall(seq)
    return [_TOKEN_RE.findall(s) for s in seq]


def token_to_str(tokens, alphabet=Alphabet3) -> List[str]:
    """Convert a 2D array of token indices back to strings
    (reference: esme/alphabet.py:101-114)."""
    tokens = np.asarray(tokens)
    return [
        ''.join(alphabet.idx_to_token[int(i)] for i in seq)
        for seq in tokens
    ]


def _encode(seq: List[str], alphabet) -> np.ndarray:
    ids = [alphabet.cls_idx]
    ids.extend(alphabet.token_to_idx.get(aa, alphabet.unk_idx) for aa in seq)
    ids.append(alphabet.eos_idx)
    return np.asarray(ids, dtype=np.int32)


def tokenize(sequences: Union[List[str], str], alphabet=Alphabet3) -> np.ndarray:
    """Tokenize into a padded ``(B, max_len)`` int32 array with cls/eos
    added per sequence (reference: esme/alphabet.py:117-145)."""
    if isinstance(sequences, str):
        sequences = [sequences]

    seqs = split_alphabet(sequences)
    max_len = max(len(s) for s in seqs) + 2

    tokens = np.full((len(seqs), max_len), alphabet.padding_idx, dtype=np.int32)
    for i, seq in enumerate(seqs):
        enc = _encode(seq, alphabet)
        tokens[i, :len(enc)] = enc
    return tokens


def tokenize_unpad(
    sequences: Union[List[str], str], alphabet=Alphabet3
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Tokenize into the packed flat layout.

    Returns ``(tokens, indices, cu_lens, max_len)`` exactly matching the
    reference contract (reference: esme/alphabet.py:148-183):

    * ``tokens``: ``(total,)`` int32, all sequences concatenated with
      cls/eos added.
    * ``indices``: ``(total,)`` int64 indices of each flat token in the
      row-major padded ``(B, max_len)`` layout (for scatter-back).
    * ``cu_lens``: ``(B + 1,)`` int32 cumulative lengths.
    * ``max_len``: int, the longest (cls/eos-inclusive) length.
    """
    if isinstance(sequences, str):
        sequences = [sequences]

    seqs = split_alphabet(sequences)
    lens = [len(s) + 2 for s in seqs]
    cu_lens = np.cumsum([0] + lens).astype(np.int32)
    max_len = max(lens)

    tokens = np.concatenate([_encode(s, alphabet) for s in seqs])
    indices = np.concatenate([
        np.arange(i * max_len, i * max_len + l, dtype=np.int64)
        for i, l in enumerate(lens)
    ])
    return tokens, indices, cu_lens, max_len


def pad_tokens(tokens: Sequence[np.ndarray], alphabet=Alphabet3) -> np.ndarray:
    """Pad a list of 1D token arrays (or stack 2D token arrays) to the
    same length with the padding index (reference: esme/alphabet.py:186-212).
    """
    tokens = [np.asarray(t) for t in tokens]
    if tokens[0].ndim == 1:
        max_size = max(t.shape[0] for t in tokens)
        return np.stack([
            np.pad(t, (0, max_size - t.shape[0]),
                   constant_values=alphabet.padding_idx)
            for t in tokens
        ])

    max_size = max(t.shape[1] for t in tokens)
    return np.concatenate([
        np.pad(t, ((0, 0), (0, max_size - t.shape[1])),
               constant_values=alphabet.padding_idx)
        for t in tokens
    ], axis=0)


def mask_tokens(token: np.ndarray, freq: float = 0.15, alter: float = 0.1,
                alphabet=Alphabet3, rng: np.random.Generator | None = None):
    """BERT-style 80/10/10 masking with at least one mask per row
    (``esme_tpu/alphabet.py:175-214``; reference: esme/alphabet.py:215-265).

    Returns ``(masked_tokens, mask)``.
    """
    rng = rng or np.random.default_rng()
    token = np.array(token, copy=True)

    valid = (token != alphabet.cls_idx) \
        & (token != alphabet.eos_idx) \
        & (token != alphabet.padding_idx)
    mask = (rng.random(token.shape) < freq) & valid

    # guarantee >=1 mask per row by sampling a valid position for empty rows
    not_masked = mask.sum(axis=-1) == 0
    if not_masked.any():
        if token.ndim == 1:
            pos = rng.choice(np.nonzero(valid)[0])
            mask[pos] = True
        elif token.ndim == 2:
            for row in np.nonzero(not_masked)[0]:
                pos = rng.choice(np.nonzero(valid[row])[0])
                mask[row, pos] = True
        else:
            raise ValueError('tokens must be 1D or 2D')

    orig = token.copy()
    # 80% of masked positions -> <mask>
    token[mask] = alphabet.mask_idx
    # 10% -> random amino acid
    random_aa = rng.integers(alphabet.amino_acids_idx[0],
                             alphabet.amino_acids_idx[-1] + 1,
                             size=token.shape, dtype=token.dtype)
    token = np.where((rng.random(token.shape) < alter) & mask, random_aa, token)
    # 10% -> keep original token
    token = np.where((rng.random(token.shape) < alter) & mask, orig, token)

    return token, mask


def padding_mask(cu_lens: np.ndarray, max_len: int) -> np.ndarray:
    """Boolean ``(n, max_len)`` validity mask from cumulative lengths
    (reference: esme/alphabet.py:268-286)."""
    cu_lens = np.asarray(cu_lens)
    lengths = cu_lens[1:] - cu_lens[:-1]
    return np.arange(max_len)[None, :] < lengths[:, None]


def pack_tokens(
    sequences: Union[List[str], str],
    token_budget: int | None = None,
    max_segments: int | None = None,
    alphabet=Alphabet3,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Like :func:`tokenize_unpad` but padded to static shapes
    (``esme_tpu/alphabet.py:229-261``).

    The flat token vector is padded with ``padding_idx`` up to
    ``token_budget`` and ``cu_lens`` is padded by repeating its last
    value up to ``max_segments + 1`` entries. Trailing pad tokens lie
    past ``cu_lens[-1]``, so they form fake segments that never attend
    real tokens.
    """
    tokens, indices, cu_lens, max_len = tokenize_unpad(sequences, alphabet)
    total = tokens.shape[0]

    if token_budget is not None:
        if total > token_budget:
            raise ValueError(
                f'total tokens {total} exceed token_budget {token_budget}')
        tokens = np.pad(tokens, (0, token_budget - total),
                        constant_values=alphabet.padding_idx)

    if max_segments is not None:
        nseg = cu_lens.shape[0] - 1
        if nseg > max_segments:
            raise ValueError(
                f'{nseg} segments exceed max_segments {max_segments}')
        cu_lens = np.pad(cu_lens, (0, max_segments - nseg), mode='edge')

    return tokens, indices, cu_lens, max_len
