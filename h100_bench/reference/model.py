"""ESM2 and ESMC in plain float32 PyTorch, for the benchmark's check.

The forward follows the published models (ESM2: ``facebook/esm2_t33_650M_UR50D``;
ESMC: EvolutionaryScale's ``esmc-300m-2024-12``), as the program under test
serves them:

* token embedding; ESM2 zeroes the ``<mask>`` rows and, as the program does,
  applies no token-dropout rescale (the configuration files say so);
* per layer, pre-norm attention (LayerNorm, q/k/v projections, ESMC's q and k
  LayerNorms over the full width, rotary embeddings with the halves
  convention and base 10000 at positions counted from each sequence's
  ``<cls>``, softmax(q·kᵀ/√D) within each sequence only, the output
  projection), then the pre-norm MLP (ESM2: fc1, exact-erf GELU, fc2; ESMC:
  SiLU(h·W_gate) ⊙ (h·W_up) then W_down); each branch divided by
  ``sqrt(layers / 36)`` in ESMC and added to the residual stream;
* the final LayerNorm and the LM head (dense, GELU, LayerNorm, projection to
  the vocabulary).

Every operation runs in float32 with TF32 off (:func:`strict_fp32`).
Attention runs sequence by sequence (sequences of one length batched), so
nothing depends on how the program packed them.

``fp8=True`` is the control: the same model with every matrix product's
operands rounded to float8 (E4M3 with one scale per tensor; the gradients
that enter the backward's products in E5M2), the step below the bfloat16 the
configurations state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5
ROPE_BASE = 10000.0
BUCKET = 128     # sequences padded to this multiple for attention


def strict_fp32() -> None:
    """Float32 products in float32: no TF32, no reduced-precision sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision('highest')


@dataclass(frozen=True)
class Arch:
    """The shapes and options of one configuration file."""
    family: str
    layers: int
    width: int
    heads: int
    ffn: int
    vocab: int
    swiglu: bool
    qk_layernorm: bool
    residue_scaling: float
    zero_mask_embedding: bool
    mask_idx: int
    padding_idx: int

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @classmethod
    def from_config(cls, cfg: dict) -> 'Arch':
        kind = cfg['architecture']
        if kind == 'esm2':
            return cls('esm2', cfg['num_hidden_layers'], cfg['hidden_size'],
                       cfg['num_attention_heads'], cfg['intermediate_size'],
                       cfg['vocab_size'], False, False, 1.0,
                       True, cfg['mask_token_id'], cfg['pad_token_id'])
        if kind == 'esmc':
            return cls('esmc', cfg['n_layers'], cfg['d_model'],
                       cfg['n_heads'], cfg['ffn_hidden_size'],
                       cfg['vocab_size'], True, True,
                       math.sqrt(cfg['n_layers'] / 36), False,
                       cfg['mask_token_id'], cfg['pad_token_id'])
        raise ValueError(f'unknown architecture {kind!r}')


# -- float8 rounding (the control) -------------------------------------------

class _Round8(torch.autograd.Function):
    """Round to float8 with one scale per tensor; the gradient passes."""

    @staticmethod
    def forward(ctx, x, dtype):
        top = torch.finfo(dtype).max
        scale = x.detach().abs().amax().clamp_min(1e-30) / top
        return (x / scale).to(dtype).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def round8(x, dtype=torch.float8_e4m3fn):
    return _Round8.apply(x, dtype)


class _Fp8Matmul(torch.autograd.Function):
    """``x @ w`` on float8 operands, the backward's products too."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = round8(x), round8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dyq = round8(dy, torch.float8_e5m2)
        return dyq @ wq.T, xq.T @ dyq


def mm(x, w, fp8: bool):
    return _Fp8Matmul.apply(x, w) if fp8 else x @ w


# -- parameters ----------------------------------------------------------------

def _named(tree: dict, path: str = ''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f'{path}{k}.')
        else:
            yield f'{path}{k}', v


class Params:
    """The weights as float32 leaves of the reference's own: ``outer`` by
    dotted path, ``layers`` one dict per layer (paths under ``layers.``).
    Built from the benchmark's weight tree (stacked layer leaves), copied,
    so nothing the program holds is shared."""

    def __init__(self, tree: dict, requires_grad: bool = False):
        self.outer = {}
        self.layers = []
        for path, t in _named(tree):
            if path.startswith('layers.'):
                name = path[len('layers.'):]
                for i in range(t.shape[0]):
                    if len(self.layers) <= i:
                        self.layers.append({})
                    self.layers[i][name] = self._leaf(t[i], requires_grad)
            else:
                self.outer[path] = self._leaf(t, requires_grad)

    @staticmethod
    def _leaf(t, requires_grad):
        x = t.detach().to(torch.float32, copy=True)
        return x.requires_grad_(requires_grad)

    def views(self) -> list:
        """``((leaf path, layer), tensor)`` for every tensor: a layer tensor
        carries the path of the stacked leaf it belongs to and its layer,
        the others None (the program's optimizer names its views so)."""
        out = [((p, None), t) for p, t in self.outer.items()]
        for i, layer in enumerate(self.layers):
            out += [((f'layers.{n}', i), t) for n, t in layer.items()]
        return out


def leaf_norms(pairs) -> dict:
    """Per stacked leaf, the norm over its layers: ``{path: float}`` from
    ``(path, tensor)`` pairs, summed in float64."""
    sq = {}
    for path, t in pairs:
        sq[path] = sq.get(path, 0.0) + float(
            t.detach().double().pow(2).sum())
    return {k: math.sqrt(v) for k, v in sq.items()}


# -- the forward -----------------------------------------------------------------

class Segments:
    """Where each sequence lies in a flat token vector: positions from each
    ``<cls>``, and the sequences in groups of one padded length (a multiple
    of :data:`BUCKET`), each as row indices with a mask of its real keys,
    so that attention never crosses a sequence and runs in few launches."""

    def __init__(self, lengths, device):
        lengths = [int(n) for n in lengths]
        starts = [0]
        for n in lengths:
            starts.append(starts[-1] + n)
        self.total = starts[-1]
        self.pos = torch.cat([torch.arange(n) for n in lengths]).to(device)
        by_len = {}
        for st, n in zip(starts, lengths):
            by_len.setdefault(-(-n // BUCKET) * BUCKET, []).append((st, n))
        self.groups = []
        for w, seqs in sorted(by_len.items()):
            col = torch.arange(w)
            idx = torch.stack([st + col.clamp(max=n - 1) for st, n in seqs])
            real = torch.stack([col < n for _, n in seqs])
            self.groups.append((idx.to(device), real.to(device)))
        self.rows = torch.cat([idx[real] for idx, real in self.groups])
        self.inverse = torch.argsort(self.rows)


def rope_tables(pos, dim: int):
    inv = 1.0 / ROPE_BASE ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                           device=pos.device) / dim)
    ang = pos.double()[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


def apply_rope(x, cos, sin, heads: int):
    T = x.shape[0]
    x = x.view(T, heads, -1)
    x1, x2 = x.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (x * cos[:, None] + rot * sin[:, None]).reshape(T, -1)


def attention(q, k, v, seg: Segments, heads: int, fp8: bool):
    """softmax(q·kᵀ/√D)·v within each sequence; ``(T, H·D)`` in and out.
    Padded keys are masked out and padded queries dropped."""
    D = q.shape[1] // heads
    parts = []
    for idx, real in seg.groups:
        b, w = idx.shape
        qs, ks, vs = (x[idx.reshape(-1)].view(b, w, heads, D).transpose(1, 2)
                      for x in (q, k, v))
        if fp8:
            qs, ks, vs = round8(qs), round8(ks), round8(vs)
        s = qs @ ks.transpose(-1, -2) / math.sqrt(D)
        s = s.masked_fill(~real[:, None, None, :], float('-inf'))
        p = torch.softmax(s, dim=-1)
        if fp8:
            p = round8(p)
        o = (p @ vs).transpose(1, 2).reshape(b, w, heads * D)
        parts.append(o[real])
    return torch.cat(parts)[seg.inverse]


def layer_norm(x, p: dict, prefix: str):
    return F.layer_norm(x, x.shape[-1:], p[prefix + '.scale'],
                        p.get(prefix + '.bias'), LN_EPS)


def linear(x, p: dict, prefix: str, fp8: bool):
    y = mm(x, p[prefix + '.kernel'], fp8)
    bias = p.get(prefix + '.bias')
    return y if bias is None else y + bias


def block(x, p: dict, arch: Arch, seg: Segments, rope, fp8: bool):
    h = layer_norm(x, p, 'attn.norm')
    q, k, v = (linear(h, p, f'attn.{n}', fp8) for n in 'qkv')
    if arch.qk_layernorm:
        q, k = layer_norm(q, p, 'attn.ln_q'), layer_norm(k, p, 'attn.ln_k')
    q, k = (apply_rope(t, *rope, arch.heads) for t in (q, k))
    o = linear(attention(q, k, v, seg, arch.heads, fp8), p, 'attn.out', fp8)
    x = x + o / arch.residue_scaling
    h = layer_norm(x, p, 'mlp.norm')
    if arch.swiglu:
        m = mm(F.silu(mm(h, p['mlp.gate.kernel'], fp8))
               * mm(h, p['mlp.up.kernel'], fp8), p['mlp.down.kernel'], fp8)
    else:
        m = linear(F.gelu(linear(h, p, 'mlp.fc1', fp8)), p, 'mlp.fc2', fp8)
    return x + m / arch.residue_scaling


def logits(params: Params, arch: Arch, tokens, lengths, fp8: bool = False,
           ckpt: bool = False):
    """``(T, vocab)`` float32 logits of the flat ``tokens`` (the sequences
    of ``lengths`` one after another, each from its ``<cls>`` to its
    ``<eos>``). ``ckpt`` recomputes each layer in the backward."""
    tokens = tokens.long()
    seg = Segments(lengths, tokens.device)
    if seg.total != tokens.shape[0]:
        raise ValueError('the lengths do not cover the tokens')
    o = params.outer
    x = F.embedding(tokens, o['embed_tokens'])
    if arch.zero_mask_embedding:
        x = torch.where((tokens == arch.mask_idx)[:, None],
                        torch.zeros_like(x), x)
    rope = rope_tables(seg.pos, arch.head_dim)
    for p in params.layers:
        if ckpt and torch.is_grad_enabled():
            x = checkpoint(block, x, p, arch, seg, rope, fp8,
                           use_reentrant=False)
        else:
            x = block(x, p, arch, seg, rope, fp8)
    x = layer_norm(x, o, 'emb_norm_after')
    h = F.gelu(linear(x, o, 'lm_head.dense', fp8))
    h = layer_norm(h, o, 'lm_head.norm')
    return linear(h, o, 'lm_head.final', fp8)


@torch.no_grad()
def log_probs(params: Params, arch: Arch, tokens, lengths,
              fp8: bool = False, rows: int = 16384):
    """float32 log-probabilities of every token, sequences taken in groups
    of about ``rows`` tokens (the results do not depend on the grouping)."""
    out, lo, acc = [], 0, []
    lengths = [int(n) for n in lengths]
    for i, n in enumerate(lengths):
        acc.append(n)
        if sum(acc) >= rows or i == len(lengths) - 1:
            hi = lo + sum(acc)
            out.append(torch.log_softmax(
                logits(params, arch, tokens[lo:hi], acc, fp8), dim=-1))
            lo, acc = hi, []
    return torch.cat(out)


# -- masked-LM training -------------------------------------------------------------

def masked_loss(params: Params, arch: Arch, batch: dict, fp8: bool):
    """Mean cross-entropy over the masked positions of one batch
    (``tokens``: the model's input, ``targets``, ``mask``, ``lengths``)."""
    z = logits(params, arch, batch['tokens'], batch['lengths'], fp8,
               ckpt=True)
    ll = torch.log_softmax(z, dim=-1).gather(
        -1, batch['targets'].long()[:, None])[:, 0]
    w = batch['mask'].float()
    return -(ll * w).sum() / w.sum().clamp_min(1.0)


def halves(batch: dict) -> list:
    """The batch's first ``len // 2`` sequences and the rest, each a batch
    of its own."""
    lengths = list(batch['lengths'])
    k = len(lengths) // 2
    if k == 0:
        raise ValueError('a batch of one sequence has no halves')
    cut = sum(lengths[:k])
    return [{key: batch[key][lo:hi] for key in ('tokens', 'targets', 'mask')}
            | {'lengths': part}
            for lo, hi, part in ((0, cut, lengths[:k]),
                                 (cut, None, lengths[k:]))]


def _grads(params: Params, arch: Arch, batch: dict, ts: list, fp8: bool):
    loss = masked_loss(params, arch, batch, fp8)
    grads = torch.autograd.grad(loss, ts, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(t) if g is None else g
                                  for t, g in zip(ts, grads)]


def train(tree: dict, arch: Arch, batches: list, lr: float, betas, eps: float,
          storage=torch.bfloat16, fp8: bool = False) -> dict:
    """Adam steps over ``batches``, one each, from the weights ``tree``:
    float32 gradients and moments, each parameter stored in ``storage``
    after each update, as the configuration keeps it. The first step's
    gradient is taken over the batch's two :func:`halves` apart and
    combined by their masked targets (the whole batch's mean, to rounding).
    Returns each step's loss; the first step's gradient (per view ``(leaf
    path, layer)``, on the host), its norm per leaf and the difference of
    its halves' gradients; and the parameters' change norm per leaf after
    the last step."""
    params = Params(tree, requires_grad=True)
    pairs = params.views()
    ts = [t for _, t in pairs]
    start = [t.detach().clone() for t in ts]
    m = [torch.zeros_like(t) for t in ts]
    v = [torch.zeros_like(t) for t in ts]
    b1, b2 = betas
    losses = []
    for step, batch in enumerate(batches, start=1):
        if step > 1:
            loss, grads = _grads(params, arch, batch, ts, fp8)
        else:
            parts = halves(batch)
            n = [float(p['mask'].sum()) for p in parts]
            w = [x / max(sum(n), 1.0) for x in n]
            (la, ga), (lb, gb) = (_grads(params, arch, p, ts, fp8)
                                  for p in parts)
            loss = w[0] * la + w[1] * lb
            grads = [w[0] * a + w[1] * b for a, b in zip(ga, gb)]
            first = {view: g.cpu() for (view, _), g in zip(pairs, grads)}
            split = {view: (a - b).cpu() for (view, _), a, b in
                     zip(pairs, ga, gb)}
            del ga, gb
        losses.append(loss)
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for t, g, mi, vi in zip(ts, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                t.sub_(lr / c1 * mi / (vi.sqrt() / math.sqrt(c2) + eps))
                t.copy_(t.to(storage).float())
        del grads
    change = leaf_norms((path, t.detach() - s)
                        for ((path, _), t), s in zip(pairs, start))
    return {'losses': losses, 'first_grads': first,
            'grad_norms': leaf_norms((v[0], g) for v, g in first.items()),
            'halves_diff': split, 'change_norms': change}
