"""Random-access FASTA reader backed by a samtools ``.fai`` index.

Copy of ``esme_tpu/fasta.py`` (pure Python/numpy; the port imports
nothing of the JAX package): ``read_fai``, ``write_fai`` and ``Fasta``
with the same semantics (reference: esme/fasta.py:5-100).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Union

import numpy as np

_FAI_COLS = ("id", "length", "offset", "line_bases", "line_width")


def read_fai(fai_path) -> List[dict]:
    """Parse a ``samtools faidx`` index file into a list of row dicts with
    keys ``id, length, offset, line_bases, line_width``
    (reference: esme/fasta.py:5-22)."""
    rows = []
    with open(fai_path) as f:
        for rec in csv.reader(f, delimiter='\t'):
            if not rec:
                continue
            rows.append({
                'id': rec[0],
                'length': int(rec[1]),
                'offset': int(rec[2]),
                'line_bases': int(rec[3]),
                'line_width': int(rec[4]),
            })
    return rows


def write_fai(fasta_path, fai_path=None) -> str:
    """Create a ``.fai`` index for a FASTA file (equivalent of running
    ``samtools faidx``; convenience the reference delegates to samtools,
    reference: esme/fasta.py:56-60)."""
    fai_path = fai_path or str(fasta_path) + '.fai'
    rows = []
    with open(fasta_path, 'rb') as f:
        name = None
        length = 0
        offset = 0
        line_bases = 0
        line_width = 0
        while True:
            pos = f.tell()
            line = f.readline()
            if line.startswith(b'>') or not line:
                if name is not None:
                    rows.append((name, length, offset, line_bases, line_width))
                if not line:
                    break
                name = line[1:].split()[0].decode()
                length = 0
                offset = f.tell()
                line_bases = 0
                line_width = 0
            else:
                stripped = line.strip()
                if not line_bases:
                    line_bases = len(stripped)
                    line_width = len(line)
                length += len(stripped)
    with open(fai_path, 'w') as f:
        for row in rows:
            f.write('\t'.join(str(x) for x in row) + '\n')
    return fai_path


class Fasta:
    """Random access to FASTA sequences by integer index or protein id
    (reference: esme/fasta.py:25-100).

    Args:
        fasta: path to the FASTA file.
        fai: path to the index; defaults to ``fasta + '.fai'``.
        max_len: keep only sequences with ``length <= max_len``.
        k_sample: subsample this many sequences (without replacement).
        rng: numpy Generator used for subsampling.
    """

    def __init__(self, fasta, fai=None, max_len=None, k_sample=None,
                 rng: np.random.Generator | None = None):
        self.fasta = str(fasta)

        if not Path(fasta).exists():
            raise FileNotFoundError(f"File not found: {fasta}")

        if fai is None:
            fai = self.fasta + '.fai'
        if not Path(fai).exists():
            raise FileNotFoundError(
                f"Missing index {fai}. Index the fasta with "
                f"`samtools faidx {fasta}` or esme_tpu_torch.fasta.write_fai()")

        self.fai = read_fai(fai)

        if max_len is not None:
            self.fai = [r for r in self.fai if r['length'] <= max_len]

        if k_sample is not None:
            rng = rng or np.random.default_rng()
            idx = rng.choice(len(self.fai), size=k_sample, replace=False)
            self.fai = [self.fai[i] for i in idx]

        self.proteins: Dict[str, int] = {
            row['id']: i for i, row in enumerate(self.fai)}

    def lengths(self) -> List[int]:
        return [row['length'] for row in self.fai]

    def __getitem__(self, idx: Union[int, str]) -> str:
        if isinstance(idx, (int, np.integer)):
            return self.read_seq(int(idx))
        if isinstance(idx, str):
            return self.read_seq(self.proteins[idx])
        raise ValueError(f"Invalid index: {idx}")

    def read_seq(self, idx: int) -> str:
        row = self.fai[idx]
        with open(self.fasta) as f:
            f.seek(row['offset'])
            lines = []
            while True:
                line = f.readline()
                if line.startswith('>') or line == '':
                    break
                lines.append(line.strip())
        seq = ''.join(lines)
        if len(seq) != row['length']:
            raise ValueError(f"index/record mismatch for {row['id']}")
        return seq

    def __len__(self):
        return len(self.fai)
