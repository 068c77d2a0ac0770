"""The generator's inputs: the same seed gives the same files and
proteins, every seed the same sizes; the reference reads them back."""

import numpy as np

from hbench import traffic
from reference.data import Catalog, read_fasta, segments, tokenize

SPEC = {'min': 10, 'max': 90, 'count': 50, 'length_seed': 2}


def test_fasta_is_the_seeds_and_has_the_pools_lengths(tmp_path):
    paths = [tmp_path / f'{i}.fa' for i in range(3)]
    for p, seed in zip(paths, (2 ** 31 + 11, 2 ** 31 + 11, 5)):
        traffic.write_fasta(p, SPEC, seed)
    a, b, c = (p.read_bytes() for p in paths)
    assert a == b and a != c
    assert (paths[0].with_suffix('.fa.fai').read_text()
            == paths[1].with_suffix('.fa.fai').read_text())
    pool = sorted(traffic.length_pool(SPEC).tolist())
    for p in paths:
        assert sorted(map(len, read_fasta(p))) == pool


def test_fai_points_at_each_record(tmp_path):
    p = tmp_path / 'x.fa'
    traffic.write_fasta(p, SPEC, 3)
    seqs = read_fasta(p)
    raw = p.read_bytes()
    for line, seq in zip(p.with_suffix('.fa.fai').read_text().splitlines(),
                         seqs):
        _, n, off, bases, width = line.split('\t')
        assert int(n) == len(seq)
        assert raw[int(off):int(off) + min(len(seq), 60)].decode() \
            == seq[:60]


def test_proteins_repeat_for_a_seed_and_cover_every_length():
    spec = {'min': 5, 'max': 12, 'each': 1}
    take = [p for _, p in zip(range(16), traffic.proteins(spec, 9))]
    again = [p for _, p in zip(range(16), traffic.proteins(spec, 9))]
    other = [p for _, p in zip(range(16), traffic.proteins(spec, 10))]
    assert take == again and take != other
    assert sorted(map(len, take[:8])) == list(range(5, 13))
    assert sorted(map(len, other[8:])) == list(range(5, 13))


def test_catalog_flags_sequences_not_in_the_file():
    seqs = ['ACDE', 'LLLL']
    cat = Catalog(seqs)
    toks = np.concatenate([tokenize(s) for s in seqs])
    assert cat.unknown(segments(toks, [6, 6])) == 0
    assert cat.unknown(segments(toks, [6, 6]) + [tokenize('ACDE')]) == 1
    assert cat.unknown([tokenize('ACDF')]) == 1
