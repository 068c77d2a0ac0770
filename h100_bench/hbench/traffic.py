"""The general generator of the traffic files' inputs.

A traffic file fixes a multiset of sequence lengths, the same for every
seed: ``lengths: {min, max, count, length_seed}`` draws ``count`` lengths
uniformly in ``[min, max]`` from ``length_seed``; ``lengths: {min, max,
each}`` takes every length of the range ``each`` times. A run's ``--seed``
draws the residues (uniform over the twenty amino acids) and the order, so
every seed gives the same sizes in another order.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import seeds

AMINO = b'LAGVSERTIDPKQNFYMHWC'
LINE = 60


def length_pool(spec: dict) -> np.ndarray:
    lo, hi = int(spec['min']), int(spec['max'])
    if 'each' in spec:
        return np.repeat(np.arange(lo, hi + 1), int(spec['each']))
    return np.random.default_rng(int(spec['length_seed'])).integers(
        lo, hi + 1, int(spec['count']))


def residues(rng: np.random.Generator, n: int) -> bytes:
    letters = np.frombuffer(AMINO, np.uint8)
    return letters[rng.integers(0, len(AMINO), n)].tobytes()


def write_fasta(path: Path, spec: dict, seed: int) -> int:
    """The pool's sequences in a seeded order and with seeded residues, 60
    residues a line, with the samtools ``.fai`` index beside it. Returns
    the number of records."""
    order = seeds.rng(seed, 'order').permutation(length_pool(spec))
    res = residues(seeds.rng(seed, 'residues'), int(order.sum()))
    chunks, fai, offset, lo = [], [], 0, 0
    for i, n in enumerate(order):
        n = int(n)
        seq = res[lo:lo + n]
        lo += n
        head = b'>s%d\n' % i
        body = b''.join(seq[j:j + LINE] + b'\n' for j in range(0, n, LINE))
        fai.append(f's{i}\t{n}\t{offset + len(head)}\t{LINE}\t{LINE + 1}\n')
        chunks += [head, body]
        offset += len(head) + len(body)
    path.write_bytes(b''.join(chunks))
    Path(str(path) + '.fai').write_text(''.join(fai))
    return len(order)


def proteins(spec: dict, seed: int):
    """Endless proteins: round ``r`` is the pool in the order of the
    stream ``(seed, r)``."""
    pool = length_pool(spec)
    r = 0
    while True:
        rng = seeds.rng(seed, 'round', r)
        for n in rng.permutation(pool):
            yield residues(rng, int(n)).decode()
        r += 1
