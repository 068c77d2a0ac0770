"""The yardstick's frozen counts against the figures PERF.md gives for
the 50k batches (H1 173.4 GFLOP; H2 435.5 GFLOP and 0.907 GB), on the
batches those figures came from: ``bench.py``'s recipe (100–1000 aa until
the 50,000-token budget is within 1,024 of full; seed 0 for inference,
seed 2 for training), as the kernels see them: the budget's padding in
256-token tail segments, then one segment to the next multiple of 256."""

import numpy as np
import pytest

from hbench import work
from reference.model import Arch

BUDGET = 50_000
T = 50_176
H, D = 20, 64


def kernel_segments(seed):
    rng = np.random.default_rng(seed)
    lens, total = [], 0
    while total < BUDGET - 1024:
        n = int(rng.integers(100, 1000))
        lens.append(n + 2)
        total += n + 2
    tail = BUDGET - total
    segs = list(lens) + [256] * (tail // 256) + ([tail % 256] if tail % 256
                                                  else [])
    return segs + [T - BUDGET], lens


def test_h1_operations_at_the_inference_batch():
    segs, real = kernel_segments(0)
    nbytes, flops = work.flash_fwd_work(segs, H, D, total=T)
    assert round(flops / 1e9, 1) == 173.4
    assert work.bound_s(nbytes, flops) == pytest.approx(0.1753e-3, rel=2e-3)
    assert sum(real) == 49_369


def test_h2_operations_and_bytes_at_the_train_batch():
    segs, real = kernel_segments(2)
    nbytes, flops = work.flash_bwd_work(segs, H, D, total=T)
    assert round(flops / 1e9, 1) == 435.5
    assert round(nbytes / 1e9, 3) == 0.907
    assert work.bound_s(nbytes, flops) == pytest.approx(0.4404e-3, rel=2e-3)


def test_model_operations_match_mfu_arithmetic():
    arch = Arch.from_config({'architecture': 'esm2', 'num_hidden_layers': 33,
                             'hidden_size': 1280, 'num_attention_heads': 20,
                             'intermediate_size': 5120, 'vocab_size': 33,
                             'mask_token_id': 32, 'pad_token_id': 1})
    lens = [300, 700]
    attn = work.attn_fwd_flops(lens, arch.width, arch.layers)
    assert attn == 4 * (300 ** 2 + 700 ** 2) * 1280 * 33
    n = 1000
    assert work.model_flops_train(10, n, attn) == 60 * n + 3.5 * attn
    layer, head = work.gemm_flops_per_token(arch)
    assert layer == 2 * (4 * 1280 ** 2 + 2 * 1280 * 5120)
    # the recompute's forward once more, the backward's two products
    fwd = work.gemm_flops_infer(arch, n)
    assert work.gemm_flops_train(arch, n, True) == pytest.approx(
        3 * fwd + n * 33 * layer + n * 2 * 33 * 1280)
