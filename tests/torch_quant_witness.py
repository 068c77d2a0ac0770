"""The per-token cosine of a quantized ESM2's log-probs against the dense
model's after ``benchmarks/quant_accuracy.py``'s outlier injection, in the
JAX package and in the port on the same weights, on the CPU.

ESM2-650M's width (1280, 20 heads, bf16) cut to ``layers``, on that
script's batch (15 sequences of 514 tokens, one sequence a call). ``draw``
'jax' is JAX's init at ``seed`` (the script's weights at seed 0, for the
cut depth), 'port' the port's (``esme_tpu_torch.models.init``); both
packages run each draw, with JAX's ``inject_outliers`` (8 input rows of
every linear scaled 20x, seed 7) and ``quantize_model_params``, and the
port's ``quantize``. Run as a script it prints a table::

    JAX_PLATFORMS=cpu python tests/torch_quant_witness.py --layers 4 8 16 \
        --draws jax port --seeds 0 1 2
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'benchmarks'))
from quant_accuracy import inject_outliers  # noqa: E402

from esme_tpu.alphabet import Alphabet  # noqa: E402
from esme_tpu.models import esm as jesm  # noqa: E402
from esme_tpu.models.config import config_for as jconfig_for  # noqa: E402
from esme_tpu.quant import quantize_model_params  # noqa: E402
from esme_tpu_torch import ESM2  # noqa: E402
from esme_tpu_torch.models import io as tio  # noqa: E402
from esme_tpu_torch.models.config import config_for  # noqa: E402
from esme_tpu_torch.models.init import init_params  # noqa: E402

MODES = ('8bit', '4bit')
SEQ = 514


def script_batch(T=8192):
    """``benchmarks/quant_accuracy.py``'s tokens and sequence bounds."""
    rng = np.random.default_rng(0)
    lens, total = [], 0
    while total + SEQ <= T - 128:
        lens.append(SEQ)
        total += SEQ
    cu = np.cumsum([0, *lens]).astype(np.int32)
    tokens = np.full(T, Alphabet.padding_idx, np.int32)
    tokens[:cu[-1]] = rng.integers(4, 24, cu[-1])
    for i in range(len(lens)):
        tokens[cu[i]] = Alphabet.cls_idx
        tokens[cu[i + 1] - 1] = Alphabet.eos_idx
    return tokens, cu


def _bf16_np(t):
    return np.asarray(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _bf16_np(tree) if tree.dtype == torch.bfloat16 else tree.numpy()


def cos_min_mean(a, b):
    """The uncentred per-token cosine of two ``(T, V)`` arrays, its
    minimum and mean (``quant_accuracy.py``'s form)."""
    c = (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-9)
    return float(c.min()), float(c.mean())


def cosines(layers, draw='jax', n_seq=15, seed=0):
    """``{mode: {'jax': (min, mean), 'port': (min, mean), 'max_abs': x}}``:
    each package's quantized model against its own dense model on the
    injected weights, and the largest difference between the two
    packages' quantized log-probs."""
    jcfg = replace(jconfig_for('esm2_650m'), num_layers=layers)
    tcfg = replace(config_for('esm2_650m'), num_layers=layers)
    if draw == 'jax':
        jp = jesm.ESM2(config=jcfg, rng=seed).params
    else:
        jp = jax.tree.map(jnp.asarray, _np_tree(init_params(tcfg, seed)))
    jp = inject_outliers(jp, jcfg)
    tp = tio.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    tokens, cu = script_batch()
    one = np.array([0, SEQ], np.int32)
    seg, pos = jesm.packed_meta(jnp.asarray(one), SEQ)

    def jax_lp(params):
        return np.concatenate([np.asarray(jesm.forward_flat(
            params, jcfg, jnp.asarray(tokens[cu[i]:cu[i + 1]]), seg, pos,
            log_prob=True, attn_impl='reference', max_seqlen=SEQ),
            np.float32) for i in range(n_seq)])

    def port_lp(model):
        return np.concatenate([model.predict_log_prob(
            torch.as_tensor(tokens[cu[i]:cu[i + 1]]),
            pad_args=(torch.as_tensor(one), SEQ)).float().numpy()
            for i in range(n_seq)])

    jd = jax_lp(jp)
    td = port_lp(ESM2(config=tcfg, params=tp, device='cpu'))
    out = {}
    for mode in MODES:
        jq = jax_lp(quantize_model_params(jp, jcfg, mode))
        tq = port_lp(ESM2(config=tcfg, params=dict(tp),
                          device='cpu').quantize(mode))
        out[mode] = {'jax': cos_min_mean(jq, jd),
                     'port': cos_min_mean(tq, td),
                     'max_abs': float(np.abs(tq - jq).max())}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--layers', type=int, nargs='+', default=[4, 8, 16])
    ap.add_argument('--draws', nargs='+', default=['jax', 'port'])
    ap.add_argument('--seeds', type=int, nargs='+', default=[0])
    args = ap.parse_args()
    print('layers,draw,seed,mode,jax_min,jax_mean,port_min,port_mean,'
          'max_abs_port_vs_jax', flush=True)
    for layers in args.layers:
        for draw in args.draws:
            for seed in args.seeds:
                for mode, r in cosines(layers, draw, seed=seed).items():
                    print(f'{layers},{draw},{seed},{mode},{r["jax"][0]:.6f},'
                          f'{r["jax"][1]:.6f},{r["port"][0]:.6f},'
                          f'{r["port"][1]:.6f},{r["max_abs"]:.4f}',
                          flush=True)


if __name__ == '__main__':
    main()
