"""The float32 reference against the port in float32 at a tiny size
(the port's plain PyTorch paths on the CPU), the control against both,
and the reference's independence from the program."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import TINY_ESM2, TINY_ESMC
from hbench import port, weights
from reference import compare
from reference.model import Arch, Params, halves, log_probs, train

REF = Path(__file__).resolve().parents[1] / 'reference'
LENGTHS = [12, 30, 7, 30]


def batch(seed):
    rng = np.random.default_rng(seed)
    toks = [np.concatenate([[0], rng.integers(4, 24, n - 2), [2]])
            for n in LENGTHS]
    return np.concatenate(toks).astype(np.int32)


@pytest.mark.parametrize('config', [TINY_ESM2, TINY_ESMC],
                         ids=['esm2', 'esmc'])
def test_log_probs_match_the_port_in_float32(config):
    arch = Arch.from_config(config)
    tree = weights.make_params(arch, 5, 'cpu', dtype=torch.float32)
    model = port.model(arch, tree, 'cpu')
    model.config = model.config.with_dtype('float32')
    tokens = batch(1)
    cu = np.cumsum([0, *LENGTHS]).astype(np.int32)
    got = model.predict_log_prob(tokens, pad_args=(cu, max(LENGTHS)))
    ref = log_probs(Params(tree), arch, torch.as_tensor(tokens), LENGTHS)
    assert compare.max_abs(got.numpy(), ref.numpy()) < 2e-4


@pytest.mark.parametrize('config', [TINY_ESM2, TINY_ESMC],
                         ids=['esm2', 'esmc'])
def test_control_reads_farther_than_the_bf16_port(config):
    arch = Arch.from_config(config)
    tree = weights.make_params(arch, 6, 'cpu')
    model = port.model(arch, tree, 'cpu')
    tokens = batch(2)
    cu = np.cumsum([0, *LENGTHS]).astype(np.int32)
    got = model.predict_log_prob(tokens, pad_args=(cu, max(LENGTHS)))
    p = Params(tree)
    tok = torch.as_tensor(tokens)
    ref = log_probs(p, arch, tok, LENGTHS).numpy()
    low = log_probs(p, arch, tok, LENGTHS, fp8=True).numpy()
    prog = compare.rel_rms(got.numpy(), ref)
    assert compare.rel_rms(low, ref) > 3 * prog


def test_training_matches_the_ports_adam_in_float32():
    from esme_tpu_torch.train import MaskedPLM
    from esme_tpu_torch.data import PackedBatch
    arch = Arch.from_config(TINY_ESM2)
    tree = weights.make_params(arch, 7, 'cpu', dtype=torch.float32)
    model = port.model(arch, tree, 'cpu', checkpointing=True)
    model.config = model.config.with_dtype('float32')
    plm = MaskedPLM(model, learning_rate=1e-3)
    rng = np.random.default_rng(0)
    batches, losses = [], []
    cu = np.cumsum([0, *LENGTHS]).astype(np.int32)
    for s in range(3):
        tokens = batch(10 + s)
        mask = (rng.random(tokens.shape) < 0.3) & (tokens > 3)
        masked = np.where(mask, 32, tokens).astype(np.int32)
        losses.append(plm.training_step(PackedBatch(
            tokens=tokens, cu_lens=cu, max_len=max(LENGTHS),
            masked_tokens=masked, mask=mask)))
        if s == 0:       # the first gradient as Adam holds it, by view
            st = plm.state
            first = {tuple(v): st.opt_state['state'][i]['exp_avg'] / 0.1
                     for i, v in enumerate(st.views['optimizer'])}
        batches.append({'tokens': torch.as_tensor(masked),
                        'targets': torch.as_tensor(tokens),
                        'mask': torch.as_tensor(mask), 'lengths': LENGTHS})
    start = weights.make_params(arch, 7, 'cpu', dtype=torch.float32)
    ref = train(start, arch, batches, 1e-3, (0.9, 0.999), 1e-8,
                storage=torch.float32)
    assert compare.loss_gap(losses, ref['losses']) < 1e-5
    change = {}
    for (path, x), (_, s) in zip(_named(model.params), _named(start)):
        change[path] = float((x - s).norm())
    keep = compare.kept_leaves(ref['grad_norms'])
    assert compare.norm_gap(change, ref['change_norms'], keep) < 1e-3
    diff = compare.diff_gaps(first, ref['first_grads'], ref['grad_norms'],
                             keep)
    assert sorted(diff) == keep and max(diff.values()) < 1e-4


def test_one_half_alone_leans_by_the_other_halfs_share():
    arch = Arch.from_config(TINY_ESM2)
    rng = np.random.default_rng(3)
    tokens = batch(20)
    mask = (rng.random(tokens.shape) < 0.3) & (tokens > 3)
    whole = {'tokens': torch.as_tensor(np.where(mask, 32, tokens)),
             'targets': torch.as_tensor(tokens),
             'mask': torch.as_tensor(mask), 'lengths': LENGTHS}

    def first(b):
        tree = weights.make_params(arch, 8, 'cpu')
        return train(tree, arch, [b], 1e-4, (0.9, 0.999), 1e-8)
    ref = first(whole)
    assert compare.lean(ref['first_grads'], ref['first_grads'],
                        ref['halves_diff']) == 0
    one, other = halves(whole)
    share = float(other['mask'].sum()) / float(mask.sum())
    got = compare.lean(first(one)['first_grads'], ref['first_grads'],
                       ref['halves_diff'])
    assert abs(got - share) < 1e-3


def _named(tree, path=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f'{path}{k}.')
        else:
            yield f'{path}{k}', v


def test_reference_imports_nothing_of_the_program():
    banned = {'esme_tpu_torch', 'esme_tpu', 'jax', 'jaxlib', 'flax',
              'hbench'}
    for path in REF.glob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split('.', 1)[0] not in banned, (path.name, n)
    code = ('import sys; sys.path.insert(0, %r); import reference.model, '
            'reference.data, reference.compare; print(sorted({m.split(".")'
            '[0] for m in sys.modules}))' % str(REF.parent))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & banned, loaded & banned
