"""``benchmarks/quant_accuracy.py``'s outlier reading at ESM2-650M's width
in the port against the JAX package on the same weights
(``tests/torch_quant_witness.py``), and ``chip_smoke.py``'s draw of that
script's weights (JAX's init reproduced without JAX) against JAX's init."""

import os
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from esme_tpu.models import esm as jesm
from esme_tpu.models.config import config_for as jconfig_for
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.models.config import config_for

from torch_quant_witness import ROOT, cosines

sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize('draw', ['jax', 'port'])
def test_outlier_cosine_at_650m_width_matches_jax(draw):
    """``benchmarks/quant_accuracy.py``'s reading at ESM2-650M's width
    (2 layers, bf16, 2 of its sequences) on each package's seed-0 draw
    after its outlier injection: the port's per-token cosine of each
    quantized model against its dense one (minimum and mean) within 10%
    of JAX's distance from 1 on the same weights, and the two packages'
    quantized log-probs within the bf16 model gate's largest error (0.1,
    ``test_torch_families.py``). Both packages round
    to bf16 at other points, so the readings agree to the log-probs' bf16
    noise (measured: 1.6% of the distance at most)."""
    for mode, r in cosines(2, draw, n_seq=2).items():
        for j, t in zip(r['jax'], r['port']):
            assert abs(t - j) <= 0.1 * (1.0 - j), (mode, r)
        assert r['max_abs'] <= 0.1, (mode, r)


@pytest.mark.parametrize('seed', [0, 5])
def test_chip_smoke_jax_draw_matches_jax_init(seed):
    """``chip_smoke.jax_seed_params`` at ESM2-650M's width (2 layers)
    against ``ESM2(config, rng=seed).params`` of the JAX package: the same
    leaves, shapes and dtypes; JAX's counter bits and uniforms are
    reproduced exactly, its fp32 ``erf_inv`` only to a few ulps, so a bf16
    weight is bit-equal or one bf16 ulp away (measured: 1 in ~20,000),
    or, within 1e-6 of its leaf's largest, near 0, where a uniform near
    the interval's middle keeps only an absolute precision (measured: ~1e-9
    apart at weights of ~1e-8)."""
    jcfg = replace(jconfig_for('esm2_650m'), num_layers=2)
    tcfg = replace(config_for('esm2_650m'), num_layers=2)
    ref = tio.params_from_jax(jax.tree.map(
        np.asarray, jesm.ESM2(config=jcfg, rng=seed).params), tcfg)
    got = chip_smoke.jax_seed_params(tcfg, seed, 'cpu')
    assert sorted(n for n, _ in chip_smoke._named_leaves(got)) == \
        sorted(n for n, _ in chip_smoke._named_leaves(ref))
    n = equal = 0
    for name, a, b in chip_smoke._leaf_pairs(got, ref):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        ulps = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
        near = (a.float() - b.float()).abs() <= 1e-6 * b.float().abs().max()
        assert bool(((ulps <= 1) | near).all()), name
        n, equal = n + a.numel(), equal + int((ulps == 0).sum())
    assert equal >= (1 - 1e-4) * n, (equal, n)
