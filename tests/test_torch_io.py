"""Weight IO between the packages: safetensors files written by one
load in the other, ``params_from_jax`` carries weights bit for bit,
and the metadata dispatch picks the family. Every gate here is exact
equality: weights are copied, never recomputed.
"""

import jax
import numpy as np
import pytest
import torch

from esme_tpu.models import io as jio
from esme_tpu.models.config import esm2_config as jesm2_config
from esme_tpu.models.config import esmc_config as jesmc_config
from esme_tpu.models.init import init_params as jinit

from esme_tpu_torch import ESM, ESM2, ESMC, tokenize_unpad
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.models.config import esm2_config as tesm2_config


def _jax_model(dtype='bfloat16', L=2, C=64, H=4):
    jcfg = jesm2_config(num_layers=L, embed_dim=C, attention_heads=H,
                        dtype=dtype)
    return jcfg, jinit(jcfg, jax.random.key(0))


def _leaves(tree, prefix=''):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v


def _assert_same(jtree, ttree):
    jl = dict(_leaves(jax.tree.map(np.asarray, jtree)))
    tl = dict(_leaves(ttree))
    assert jl.keys() == tl.keys()
    for key, a in jl.items():
        t = tl[key]
        assert tuple(t.shape) == a.shape, key
        if a.dtype.name == 'bfloat16':
            assert t.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=key)
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=key)


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_params_from_jax_is_exact(dtype):
    jcfg, jp = _jax_model(dtype)
    tcfg = tesm2_config(2, 64, 4, dtype=dtype)
    _assert_same(jp, tio.params_from_jax(jax.tree.map(np.asarray, jp), tcfg))


def test_port_reads_jax_file(tmp_path):
    jcfg, jp = _jax_model()
    path = str(tmp_path / 'esm2_t.safetensors')
    jio.save_pretrained(path, jp, jcfg, 'esm2_t')
    assert tio.read_metadata(path) == jio.read_metadata(path)
    cfg, tp, name = tio.load_pretrained(path, dtype='bfloat16')
    assert name == 'esm2_t' and not cfg.tie_lm_head
    assert (cfg.num_layers, cfg.embed_dim, cfg.attention_heads) == (2, 64, 4)
    _assert_same(jp, tp)


def test_jax_reads_port_file(tmp_path):
    jcfg, jp = _jax_model()
    tcfg = tesm2_config(2, 64, 4)
    tp = tio.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    path = str(tmp_path / 'esm2_t.safetensors')
    tio.save_pretrained(path, tp, tcfg, 'esm2_t')
    cfg, jp2, name = jio.load_pretrained(path, dtype='bfloat16')
    assert name == 'esm2_t' and cfg.num_layers == 2
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree_util.tree_leaves_with_path(jp2)):
        assert ka == kb
        np.testing.assert_array_equal(np.asarray(a).view(np.int16),
                                      np.asarray(b).view(np.int16))


def test_tied_head_detected_both_ways(tmp_path):
    jcfg, jp = _jax_model('float32')
    flat = jio.params_to_flat(jp, jcfg)
    flat['lm_head.final.weight'] = flat['embed_tokens.weight']
    path = str(tmp_path / 'esm2_tied.safetensors')
    from safetensors import numpy as stn
    stn.save_file(flat, path, {'name': 'esm2_tied', 'num_layers': '2',
                               'embed_dim': '64', 'attention_heads': '4'})
    jcfg2, jp2, _ = jio.load_pretrained(path, dtype='float32')
    tcfg2, tp2, _ = tio.load_pretrained(path, dtype='float32')
    assert jcfg2.tie_lm_head and tcfg2.tie_lm_head
    assert 'kernel' not in tp2['lm_head']['final']
    _assert_same(jp2, tp2)
    # the port writes the tied head back as the schema's duplicate tensor
    out = str(tmp_path / 'again.safetensors')
    tio.save_pretrained(out, tp2, tcfg2, 'esm2_tied')
    flat2, _ = tio.read_safetensors(out)
    assert torch.equal(flat2['lm_head.final.weight'],
                       flat2['embed_tokens.weight'])


def test_metadata_dispatch(tmp_path):
    jcfg, jp = _jax_model()
    path = str(tmp_path / 'esm2_t.safetensors')
    jio.save_pretrained(path, jp, jcfg, 'esm2_t')
    m = ESM.from_pretrained(path, device='cpu')
    assert isinstance(m, ESM2) and m.name == 'esm2_t'
    assert m.params['embed_tokens'].dtype == torch.bfloat16
    m32 = ESM2.from_pretrained(path, dtype='float32', device='cpu')
    assert m32.params['embed_tokens'].dtype == torch.float32

    # an ESMC file dispatches to ESMC, which loads and runs it
    ccfg = jesmc_config(num_layers=1, embed_dim=48, attention_heads=4)
    cpath = str(tmp_path / 'esmc_t.safetensors')
    jio.save_pretrained(cpath, jinit(ccfg, jax.random.key(1)), ccfg,
                        'esmc_t')
    mc = ESM.from_pretrained(cpath, device='cpu')
    assert isinstance(mc, ESMC) and mc.name == 'esmc_t'
    assert (mc.config.num_layers, mc.config.embed_dim) == (1, 48)
    tok, _, cu, ml = tokenize_unpad(['MKTAYIAK', 'LLG'],
                                    alphabet=mc.alphabet)
    lp = mc.predict_log_prob(tok, pad_args=(cu, ml))
    assert lp.shape == (tok.shape[0], 64) and torch.isfinite(lp).all()
    with pytest.raises(FileNotFoundError):
        ESM.from_pretrained(str(tmp_path / 'missing.safetensors'),
                            device='cpu')


def test_safetensors_codec_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        'a': torch.from_numpy(rng.standard_normal((3, 5)).astype(
            np.float32)).to(torch.bfloat16),
        'b': torch.arange(7, dtype=torch.int32),
        'c': torch.from_numpy(rng.standard_normal(4)),
        'd': torch.tensor([True, False]),
    }
    path = str(tmp_path / 'x.safetensors')
    tio.write_safetensors(path, tensors, {'k': 'v'})
    back, meta = tio.read_safetensors(path)
    assert meta == {'k': 'v'}
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t)
    # the reference codec reads the same bytes
    from safetensors import safe_open
    with safe_open(path, framework='numpy') as f:
        np.testing.assert_array_equal(f.get_tensor('b'), np.arange(7))
        assert np.asarray(f.get_tensor('a')).view(np.int16).tolist() == \
            tensors['a'].view(torch.int16).tolist()
