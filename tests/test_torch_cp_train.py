"""Context-parallel training on the port against the JAX package: H10's
plain version (the rectangular segment-flash backward) against
``jax.grad`` of JAX's ``flash_rect_attention`` (K-rect's backward in
interpret mode), the gradient of ``make_kv_gather`` against ``jax.vjp``
of JAX's gather under ``shard_map``, ``fsdp_partition_specs`` against
JAX's, and the whole slice: ranks of ``ShardedMaskedPLM(seq_axis='seq')``
over ``(data, fsdp, seq)`` meshes against the single-device JAX gradient
of the global masked mean and against JAX's ``ShardedMaskedPLM`` on a
mesh of the same shape (``tests/conftest.py`` gives JAX 8 CPU devices).

The port's ranks are processes of their own (``tests/torch_cp_ranks.py``,
which imports no JAX), spawned into a gloo group on 127.0.0.1. On the CPU
every kernel runs as its plain version; H10 itself is held against that
plain version on the card (``tests/test_torch_kernels_cuda.py``).

Gates (each with its reason):
* H10's plain version, fp32: ``tests/test_torch_flash_bwd.py``'s fp32
  gradient gate, atol 5e-5 / rtol 1e-3 (the JAX suite's own,
  ``tests/test_flash.py:85-86``): the same fp32 function in another
  summation order. Key rows no query shares an id with: dk = dv = 0
  exactly on both sides.
* the gather's gradient: the rows exact; each rank's gradient, a sum of
  n fp32 cotangents, exact at n = 2 and within n fp32 ulps of the
  largest term at n = 4 (gloo and XLA add in orders of their own).
* the shard dims: exact.
* the sharded gradient, fp32: per leaf max|Δ| <= 1e-4 · max|g| and the
  loss 1e-5 relative against the single-device JAX gradient of the global
  masked mean (``tests/test_torch_train.py``'s gate: the same fp32
  function summed in another order); every rank holds the same
  gradients, bit for bit. Without RoPE (ESM1b) k's bias has no scale of
  its own (``tests/test_torch_families.py``: rounding noise on both
  sides, under 1e-6 of k's kernel's largest gradient).
* bf16: ``tests/test_torch_train.py``'s bf16 gradient gate against the
  JAX einsum path, loss 1e-3 relative, per leaf cosine >= 0.999 and
  max|Δ| <= 2^-4 · max|g|.
* two steps' losses against JAX's ``ShardedMaskedPLM`` at rtol 1e-4, the
  gate of JAX's own tests (``tests/test_distributed.py:53-70``). JAX's
  update is a multiple of the gradient (ROADMAP.md Queue 3, item 17),
  which Adam's first step hides.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from esme_tpu.models import esm as jesm
from esme_tpu.models.init import init_params as jinit
from esme_tpu.ops import flash as jflash
from esme_tpu.parallel import context as jcontext
from esme_tpu.parallel import fsdp as jfsdp
from esme_tpu.train.distributed import ShardedMaskedPLM as JSharded

from esme_tpu_torch import mask_tokens, tokenize_unpad
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.ops import flash as tflash
from esme_tpu_torch.parallel import fsdp as tfsdp
from esme_tpu_torch.train import MaskedPLM, stack_batches

from test_torch_context import _configs, _packed_ids, _qkv
from torch_cp_ranks import CLASSES, _flat, fit_rank, gather_rank, train_rank
from torch_spawn import free_port, spawn

import warnings
with warnings.catch_warnings():
    warnings.simplefilter('ignore', DeprecationWarning)
    from jax.experimental.shard_map import shard_map

F32 = dict(atol=5e-5, rtol=1e-3)
AA = list('LAGVSERTIDPKQNFYMHWC')
T_BATCH = 1024
MAX_SEGMENTS = 24


# -------------------------------------------------------------------------
# H10's plain version against K-rect's backward
# -------------------------------------------------------------------------

def _rect_grads_jax(q, k, v, seg_q, seg_k, w):
    def f(q, k, v):
        o = jflash.flash_rect_attention(q, k, v, seg_q, seg_k, block_q=128,
                                        block_k=128, interpret=True)
        return (o * w).sum()
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _rect_grads_port(q, k, v, seg_q, seg_k, w):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tflash.flash_rect_attention(q, k, v, torch.from_numpy(seg_q),
                                    torch.from_numpy(seg_k))
    (o * torch.from_numpy(w)).sum().backward()
    return q.grad, k.grad, v.grad


def _check_rect_grads(q, k, v, seg_q, seg_k, seed):
    """Both sides' dq, dk, dv under the fp32 gate; the key rows whose ids
    no query carries are 0 on both. Returns the port's gradients."""
    w = np.random.default_rng(seed).standard_normal(q.shape) \
        .astype(np.float32)
    want = _rect_grads_jax(q, k, v, seg_q, seg_k, w)
    got = _rect_grads_port(q, k, v, seg_q, seg_k, w)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32)
    untouched = ~np.isin(seg_k, seg_q)
    for g, r in zip(got[1:], want[1:]):
        assert not g.numpy()[untouched].any()
        assert not np.asarray(r)[untouched].any()
    return got


@pytest.mark.parametrize('n,D', [(n, D) for n in (2, 4)
                                 for D in (16, 32, 64, 128)])
def test_flash_rect_grad_matches_jax(n, D):
    """Every rank of a 1,024-token packed batch (segments crossing the
    ranks' boundaries) over the whole batch: the port's
    ``flash_rect_attention`` gradient (H10's plain version) against
    ``jax.grad`` of JAX's (K-rect in interpret mode); summed over the
    ranks, dk and dv are the square attention's (the H2 plain version on
    the whole batch)."""
    T, H = 1024, 2
    seg = _packed_ids(T, 60, 420, seed=D + 1)
    q, k, v = _qkv(T, T, H, D, seed=n * D)
    dk_sum = np.zeros_like(k)
    dv_sum = np.zeros_like(v)
    dq_all = []
    w_all = []
    for r in range(n):
        lo, hi = r * T // n, (r + 1) * T // n
        dq, dk, dv = _check_rect_grads(q[lo:hi], k, v, seg[lo:hi], seg,
                                       seed=r)
        dq_all.append(dq.numpy())
        dk_sum += dk.numpy()
        dv_sum += dv.numpy()
        w_all.append(np.random.default_rng(r).standard_normal(
            (hi - lo, H, D)).astype(np.float32))
    # the square gradient of the same output weights
    dq, dk, dv = _rect_grads_port(q, k, v, seg, seg, np.concatenate(w_all))
    np.testing.assert_allclose(np.concatenate(dq_all), dq.numpy(), **F32)
    np.testing.assert_allclose(dk_sum, dk.numpy(), **F32)
    np.testing.assert_allclose(dv_sum, dv.numpy(), **F32)


def test_flash_rect_grad_ragged_matches_jax():
    """A ragged split, Tq = 389 (Tq % 128 != 0) over Tk = 1,000 keys (a
    ragged last k block)."""
    T, H, D = 1000, 2, 32
    seg = _packed_ids(T, 50, 350, seed=3)
    q, k, v = _qkv(T, T, H, D, seed=5)
    _check_rect_grads(q[307:696], k, v, seg[307:696], seg, seed=6)


def test_flash_rect_grad_empty_span():
    """A q block whose ids match no key: its dq rows are 0, and so are dk
    and dv of every key row no query shares an id with (every row but
    those of the other blocks' segments), on both sides; H10's spans are
    empty there."""
    T, H, D = 1000, 2, 16
    seg = _packed_ids(T, 50, 350, seed=8)
    q, k, v = _qkv(T, T, H, D, seed=9)
    sq = seg[400:700].copy()
    sq[:tflash.BLOCK_Q] = 10 ** 6
    dq, dk, dv = _check_rect_grads(q[400:700], k, v, sq, seg, seed=10)
    assert not dq[:tflash.BLOCK_Q].any()
    ks, ke, qs, qe = tflash.rect_flash_spans(torch.from_numpy(sq),
                                             torch.from_numpy(seg))
    assert ke[0] <= ks[0] and bool((ke[1:] > ks[1:]).all())
    assert bool((qe[:300 // tflash.BLOCK_KV] <= qs[:300 // tflash.BLOCK_KV])
                .all())
    untouched = ~np.isin(seg, sq)
    assert untouched.sum() >= 300
    assert not dk.numpy()[untouched].any() and not dv.numpy()[untouched].any()


def test_rect_flash_spans_match_jax():
    """H10's dk/dv spans are JAX's transposed spans of the rank's queries
    over the whole batch's keys at the kernels' 64-row tiles; the first
    two are H9's."""
    T = 2048
    seg = _packed_ids(T, 40, 400, seed=2)
    for n in (2, 4):
        for r in range(n):
            sq = seg[r * T // n:(r + 1) * T // n]
            got = tflash.rect_flash_spans(torch.from_numpy(sq),
                                          torch.from_numpy(seg))
            want = jflash.block_spans(jnp.asarray(sq), tflash.BLOCK_QT,
                                      tflash.BLOCK_KV, jnp.asarray(seg))
            for a, b in zip(got[2:], want[2:]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            for a, b in zip(got[:2], tflash.rect_spans(
                    torch.from_numpy(sq), torch.from_numpy(seg))):
                assert torch.equal(a, b)


# -------------------------------------------------------------------------
# the gather's gradient, the shard dims
# -------------------------------------------------------------------------

def _run(target, n, *args, out, timeout=240):
    spawn(target, n, free_port(), *args, out, timeout=timeout)
    return [dict(np.load(out / f'rank{r}.npz')) for r in range(n)]


@pytest.mark.parametrize('n', [2, 4])
def test_kv_gather_grad_matches_jax(n, tmp_path):
    """n gloo ranks gather their rows of k and v (and of the ids) and
    take the gradient of ``<k_full, dk_r> + <v_full, dv_r>``, each rank
    its own cotangent: the gathered rows and each rank's gradient (the
    reduce-scatter of every rank's cotangent) against ``jax.vjp`` of JAX's
    ``make_kv_gather`` under ``shard_map`` over a ``seq`` mesh."""
    T, H, D = 48, 2, 8
    rng = np.random.default_rng(n)
    k, v = (rng.standard_normal((T, H, D)).astype(np.float32)
            for _ in range(2))
    dk, dv = (rng.standard_normal((n, T, H, D)).astype(np.float32)
              for _ in range(2))
    ranks = _run(gather_rank, n, k, v, dk, dv, out=tmp_path)

    mesh = Mesh(np.asarray(jax.devices()[:n]), ('seq',))
    gather = jcontext.make_kv_gather('seq')

    def local(k, v, ids):
        kf, vf, sf = gather(k, v, ids)
        return kf[None], vf[None], sf[None]
    fn = shard_map(local, mesh=mesh, in_specs=(P('seq'),) * 3,
                   out_specs=(P('seq'),) * 3, check_rep=False)
    ids = jnp.arange(T, dtype=jnp.int32)
    (kf, vf, sf), vjp = jax.vjp(lambda k, v: fn(k, v, ids), jnp.asarray(k),
                                jnp.asarray(v))
    jdk, jdv = vjp((jnp.asarray(dk), jnp.asarray(dv),
                    jnp.zeros((n, T), jax.dtypes.float0)))
    # a sum of n fp32 terms: exact at n = 2, within n ulps of the largest
    # term beyond (the libraries add in orders of their own)
    atol = 0.0 if n == 2 else n * np.finfo(np.float32).eps * max(
        np.abs(dk).max(), np.abs(dv).max())
    for r, res in enumerate(ranks):
        lo, hi = r * T // n, (r + 1) * T // n
        np.testing.assert_array_equal(res['k'], np.asarray(kf[r]))
        np.testing.assert_array_equal(res['ids'], np.asarray(sf[r]))
        np.testing.assert_allclose(res['dk'], np.asarray(jdk)[lo:hi],
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(res['dv'], np.asarray(jdv)[lo:hi],
                                   rtol=0, atol=atol)


class _Mesh:
    """The two facts ``fsdp_partition_specs`` reads of a mesh."""
    mesh_dim_names = ('data', 'fsdp')

    def __init__(self, fsdp):
        self.shape = (1, fsdp)

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize('fsdp', [2, 4, 8])
def test_fsdp_partition_specs_match_jax(fsdp):
    """Every leaf's shard dim of ESM2-650M's and ESMC-300M's params (meta
    tensors of their shapes; both packages have the same tree) and of a
    tiny ESM2's, against the dim JAX's ``fsdp_partition_specs`` names
    ``fsdp`` on a ``(1, fsdp)`` mesh."""
    from esme_tpu.models import config as jconfig
    mesh = Mesh(np.asarray(jax.devices()[:fsdp]).reshape(1, fsdp),
                ('data', 'fsdp'))
    for name, kw in (('esm2_config', dict(num_layers=33, embed_dim=1280,
                                          attention_heads=20)),
                     ('esmc_config', dict(num_layers=30, embed_dim=960,
                                          attention_heads=15)),
                     ('esm2_config', dict(num_layers=2, embed_dim=128,
                                          attention_heads=4))):
        jcfg = getattr(jconfig, name)(**kw)
        shapes = jax.eval_shape(lambda: jinit(jcfg, jax.random.key(0)))
        want = jfsdp.fsdp_partition_specs(shapes, mesh)
        params = jax.tree.map(
            lambda a: torch.empty(a.shape, device='meta'), shapes)
        got = tfsdp.fsdp_partition_specs(params, _Mesh(fsdp))
        flat_w = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, P))[0]
        assert len(flat_w) == len(list(_leaf_items(got)))
        for path, spec in flat_w:
            d = got
            for key in path:
                d = d[key.key]
            dims = [i for i, a in enumerate(tuple(spec)) if a == 'fsdp']
            assert d == (dims[0] if dims else None), (path, spec, d)


def _leaf_items(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaf_items(v)
        else:
            yield v


# -------------------------------------------------------------------------
# the slice: ShardedMaskedPLM over (data, fsdp, seq) meshes
# -------------------------------------------------------------------------

def _batch(seed, alphabet):
    """A packed masked-LM batch of ``T_BATCH`` tokens (sequences of 20-250
    residues, a padding tail) with ``cu_lens`` padded to
    ``MAX_SEGMENTS + 1``, as the data plane's static shapes."""
    rng = np.random.default_rng(seed)
    lens, total = [], 0
    while total < T_BATCH - 300:
        n = int(rng.integers(20, 250))
        lens.append(n)
        total += n + 2
    seqs = [''.join(rng.choice(AA, n)) for n in lens]
    tok, _, cu, ml = tokenize_unpad(seqs, alphabet=alphabet)
    masked, mask = mask_tokens(tok, alphabet=alphabet,
                               rng=np.random.default_rng(seed + 1))
    pad = T_BATCH - tok.shape[0]
    fill = alphabet.padding_idx
    return SimpleNamespace(
        tokens=np.pad(tok, (0, pad), constant_values=fill),
        masked_tokens=np.pad(masked, (0, pad), constant_values=fill),
        mask=np.pad(mask, (0, pad), constant_values=False),
        cu_lens=np.pad(cu, (0, MAX_SEGMENTS + 1 - len(cu)), mode='edge'),
        max_len=ml)


def _jax_params(family, dtype):
    """JAX's init from seed 3 with every leaf moved by 0.1·N(0, 1), so
    that each norm, bias and table takes part."""
    jcfg, _ = _configs(family, dtype)
    jp = jinit(jcfg, jax.random.key(3))
    rng = np.random.default_rng(4)
    return jax.tree.map(lambda a: a + jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, a.dtype), jp)


def _jax_grads(jcfg, jp, batches, impl):
    """The single-device gradient of the global masked mean over the
    batches (``MaskedPLM``'s loss over their union)."""
    def loss(p):
        s = c = 0.0
        for b in batches:
            seg, pos = jesm.packed_meta(jnp.asarray(b.cu_lens), T_BATCH)
            logits = jesm.forward_flat(p, jcfg, jnp.asarray(b.masked_tokens),
                                       seg, pos, attn_impl=impl)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            ll = jnp.take_along_axis(logp, jnp.asarray(b.tokens)[:, None],
                                     axis=-1)[:, 0]
            w = jnp.asarray(b.mask, jnp.float32)
            s, c = s + (ll * w).sum(), c + w.sum()
        return -s / jnp.maximum(c, 1.0)
    return jax.value_and_grad(loss)(jp)


def _flat_jax(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_jax(v, path + (k,)))
        else:
            out['.'.join(path + (k,))] = np.asarray(
                jnp.asarray(v).astype(jnp.float32))
    return out


TRAIN_CASES = [
    ('esm2', (2, 1, 1), 'float32', False),
    ('esm2', (1, 2, 1), 'float32', False),
    ('esm2', (1, 1, 2), 'float32', False),
    ('esm2', (1, 2, 2), 'float32', True),
    ('esm2', (2, 2, 2), 'float32', False),
    ('esmc', (1, 1, 2), 'float32', False),
    ('esm1b', (1, 1, 2), 'float32', False),
    ('esm2', (1, 1, 2), 'bfloat16', False),
]


@pytest.mark.parametrize('family,shape,dtype,ckpt', TRAIN_CASES)
def test_sharded_masked_plm_matches_jax(family, shape, dtype, ckpt,
                                        tmp_path):
    """The ranks of a ``(data, fsdp, seq)`` world run
    ``ShardedMaskedPLM(seq_axis='seq')`` on R = data batches of 1,024
    tokens: the loss and every leaf's gradient of one step (the same on
    every rank) against the single-device JAX gradient of the global
    masked mean; two steps' losses against JAX's ``ShardedMaskedPLM`` on a
    mesh of the same shape, and the validation loss after them against
    the second step's loss moved by the update; the params gathered back
    from the shards; ``seq_axis`` not in the mesh, a token count the seq
    axis does not divide and an optimizer that is not a factory refused
    (LoRA and trainable masks over a mesh are
    ``tests/test_torch_sharded_lora.py``'s)."""
    jcfg, tcfg = _configs(family, dtype)
    jp = _jax_params(family, dtype)
    params = tio.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    alphabet = CLASSES[family].alphabet
    batches = [_batch(10 * i + shape[2], alphabet) for i in range(shape[0])]
    n = int(np.prod(shape))
    ranks = _run(train_rank, n, shape, family, tcfg, params,
                 stack_batches(batches), ckpt, out=tmp_path, timeout=300)

    impl = 'reference' if dtype == 'bfloat16' else 'auto'
    jval, jgrads = _jax_grads(jcfg, jp, batches, impl)
    want = _flat_jax(jgrads)
    rtol = 1e-5 if dtype == 'float32' else 1e-3
    for res in ranks:
        np.testing.assert_allclose(float(res['loss']), float(jval),
                                   rtol=rtol)
        assert bool(res['refused'].all()) and len(res['refused']) == 3
        for name in want:
            np.testing.assert_array_equal(res[f'grad.{name}'],
                                          ranks[0][f'grad.{name}'])
            np.testing.assert_array_equal(res[f'param.{name}'],
                                          ranks[0][f'param.{name}'])
    got = {name: ranks[0][f'grad.{name}'] for name in want}
    assert got.keys() == want.keys()
    for name, r in want.items():
        g = got[name]
        if name == 'layers.attn.k.bias' and not tcfg.rotary:
            scale = np.abs(want['layers.attn.k.kernel']).max()
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-6 * scale
            continue
        if dtype == 'float32':
            err = np.abs(g - r).max()
            assert err <= 1e-4 * np.abs(r).max(), (name, err)
        else:
            a, b = g.ravel(), r.ravel()
            cos = a @ b / np.linalg.norm(a) / np.linalg.norm(b)
            err = np.abs(a - b).max() / np.abs(b).max()
            assert cos >= 0.999 and err <= 2.0 ** -4, (name, cos, err)

    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ('data', 'fsdp', 'seq'))
    # a copy of the weights: the JAX step donates its state
    jmodel = getattr(jesm, {'esm2': 'ESM2', 'esmc': 'ESMC',
                            'esm1b': 'ESM1b'}[family])(
        config=jcfg, params=jax.tree.map(jnp.copy, jp), checkpointing=ckpt)
    jt = JSharded(jmodel, mesh, learning_rate=1e-3, seq_axis='seq',
                  attn_impl=impl)
    jlosses = [jt.training_step(stack_batches(batches)) for _ in range(2)]
    np.testing.assert_allclose(ranks[0]['losses'], jlosses,
                               rtol=1e-4 if dtype == 'float32' else 2e-3)
    assert ranks[0]['losses'][1] < ranks[0]['losses'][0]
    assert float(ranks[0]['val']) < ranks[0]['losses'][1]
    for name, p0 in _flat_jax(jp).items():
        assert ranks[0][f'param.{name}'].shape == p0.shape, name


def test_sharded_fit_matches_masked_plm(tmp_path):
    """``fit`` of the sharded trainer with ``grad_accum=2`` and AdamW on
    a (1, 2, 2) world against the port's single-device ``MaskedPLM`` with
    the same options over the same batches: the per-step losses (1e-5
    relative: the same fp32 function), the validation loss, and every
    param after the one update within 0.1 · learning rate
    (``tests/test_torch_train.py``'s gate: Adam's update is ~lr whatever
    the gradient's size); the step count."""
    jcfg, tcfg = _configs('esm2', 'float32')
    params = tio.params_from_jax(
        jax.tree.map(np.asarray, _jax_params('esm2', 'float32')), tcfg)
    alphabet = CLASSES['esm2'].alphabet
    steps = [[_batch(40 + i, alphabet)] for i in range(2)]
    ranks = _run(fit_rank, 4, (1, 2, 2), tcfg, params, steps, out=tmp_path,
                 timeout=300)
    model = CLASSES['esm2'](config=tcfg, params=params, device='cpu')
    plm = MaskedPLM(model, learning_rate=1e-3, weight_decay=0.05,
                    grad_accum=2)
    history = plm.fit([b for b, in steps], val_dataset=[steps[0][0]])
    val = plm.validation_step(steps[0][0])
    for res in ranks:
        np.testing.assert_allclose(res['history'], history, rtol=1e-5)
        np.testing.assert_allclose(res['val'], [val], rtol=1e-5)
        assert int(res['step']) == plm.step == 2
        for name, ref in _flat(model.params).items():
            err = np.abs(res[f'param.{name}'] - ref).max()
            assert err <= 0.1 * 1e-3, (name, err)
