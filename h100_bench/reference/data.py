"""The inputs as the reference reads them: the FASTA file the benchmark
wrote, tokenized independently, and checks of the batches the program's
data layer built from it.

Token ids are the ESM alphabet's (ESM2's and ESMC's agree on every id used
here): ``<cls>`` 0, ``<pad>`` 1, ``<eos>`` 2, the twenty amino acids
``LAGVSERTIDPKQNFYMHWC`` 4–23, ``<mask>`` 32.
"""

from __future__ import annotations

import numpy as np

CLS, PAD, EOS, MASK = 0, 1, 2, 32
AMINO = 'LAGVSERTIDPKQNFYMHWC'
AA_FIRST, AA_LAST = 4, 23
_LUT = np.full(256, -1, np.int32)
_LUT[np.frombuffer(AMINO.encode(), np.uint8)] = np.arange(4, 24)


def read_fasta(path) -> list:
    """Every record's residues, in file order."""
    seqs, cur, inside = [], [], False
    with open(path) as f:
        for line in f:
            if line.startswith('>'):
                if inside:
                    seqs.append(''.join(cur))
                cur, inside = [], True
            else:
                cur.append(line.strip())
    if inside:
        seqs.append(''.join(cur))
    return seqs


def tokenize(seq: str) -> np.ndarray:
    """``<cls>``, the residues, ``<eos>`` as int32 ids."""
    ids = _LUT[np.frombuffer(seq.encode(), np.uint8)]
    if (ids < 0).any():
        raise ValueError('a residue outside the twenty amino acids')
    return np.concatenate([[CLS], ids, [EOS]]).astype(np.int32)


class Catalog:
    """The FASTA's records by content, to recognise each sequence of a
    batch and to count how often it was served."""

    def __init__(self, seqs):
        self.count = {}
        for s in seqs:
            key = tokenize(s).tobytes()
            self.count[key] = self.count.get(key, 0) + 1

    def unknown(self, segments) -> int:
        """How many of ``segments`` (token arrays) are no record of the
        file, or appear more often than the file holds them."""
        seen, bad = {}, 0
        for s in segments:
            key = np.asarray(s, np.int32).tobytes()
            seen[key] = seen.get(key, 0) + 1
            if seen[key] > self.count.get(key, 0):
                bad += 1
        return bad


def segments(tokens, lengths) -> list:
    """The flat ``tokens`` cut into sequences of ``lengths``."""
    cuts = np.cumsum([0, *lengths])
    return [tokens[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


def mask_faults(tokens, masked, mask, lengths, freq: float) -> int:
    """Breaks of the masking rules in one batch: a mask on ``<cls>`` or
    ``<eos>``; an unmasked position whose input differs from its token; a
    masked position whose input is neither ``<mask>``, nor an amino acid;
    a masked share more than 5 standard deviations from ``freq``."""
    tokens, masked, mask = (np.asarray(a) for a in (tokens, masked, mask))
    ends = np.isin(tokens, (CLS, EOS, PAD))
    bad = int((mask & ends).sum())
    bad += int(((~mask) & (masked != tokens)).sum())
    inp = masked[mask]
    bad += int((~((inp == MASK) | ((inp >= AA_FIRST) & (inp <= AA_LAST))))
               .sum())
    n = int((~ends).sum())
    share = float(mask.sum()) / max(n, 1)
    sd = (freq * (1 - freq) / max(n, 1)) ** 0.5
    if abs(share - freq) > 5 * sd:
        bad += 1
    return bad
