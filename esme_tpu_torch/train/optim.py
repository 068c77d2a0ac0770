"""8-bit Adam: Adam(W) with float8-quantized moments.

Counterpart of ``esme_tpu/train/optim.py`` (``adam8bit``, an optax
transform). Both moments are stored as ``float8_e5m2`` codes with one
fp32 scale per leaf, √ν in place of ν, and the scale is a running bound
that majorizes each new moment by induction, so the update needs one
reduction (the leaf's max |g|) and one elementwise pass. The JAX
module's docstring gives the reasons for each choice.

What a leaf is: in JAX a stacked layer leaf ``(L, ...)`` is one array,
and ``jnp.max`` and the scale cover all L layers. The port's trainers
update per-layer views of such a leaf (``train/trainer.py:train_views``),
so :class:`Adam8bit` takes one param group per JAX leaf: the group's
views share one scale, and the max is a reduction over all of them. The
elementwise update then runs over chunks of a group's views of at most
``_CHUNK`` elements, each op one ``torch._foreach_*`` call over the
chunk's views: one fp32 pass over a whole stacked leaf would hold
several temporaries of its size (about 0.9 GB each at ESM2-650M's
``fc1``), and an op per view costs a launch per view (~27 per view, so
~14k launches per ESM2-650M step). Under the sharded trainer each rank
holds its shards of the views, and ``reduce_max`` makes the max global.

Arithmetic: the same fp32 operations in JAX's order, so the codes,
scales and updates are bit-equal to JAX's op by op (a jitted JAX
update may contract a product and a sum into one FMA on XLA:CPU, which
moves a moment by an ulp; the tests state where that shows):

* the bias corrections ``1 - b**c`` in fp32 on the host (numpy's fp32
  ``pow``, the same values as XLA's), filled into device scalars without
  a host sync, and divisions by device tensors (a CUDA division by a CPU
  scalar multiplies by its reciprocal, which rounds differently);
* Python-float hyperparameters round to fp32 where they meet an fp32
  tensor, as JAX's weak types do; ``lr * weight_decay`` is a Python
  product, as in JAX when the learning rate is a float;
* the square roots correctly rounded: CUDA's fp32 ``sqrt`` is; the CPU's
  vectorised one is not always (one ulp off), so the CPU takes it in
  fp64 and rounds once, which gives the correctly rounded fp32 result;
* the update rounds to the gradient's dtype before it is added to the
  param, as ``optax.apply_updates`` adds it.

One departure, where JAX is not well defined (ROADMAP.md Queue 3, item
5): JAX floors the bound at ``1e-38``, an fp32 subnormal, so under
flush-to-zero a leaf whose bound is 0 (an all-zero gradient) gets scale 0
and NaN codes. The port floors the bound at ``_BOUND_FLOOR``, which
keeps every scale a normal fp32 number; the two agree wherever the bound
is at least that (about 3.3e-36). The port's params are never absent,
so weight decay is never skipped.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_F8 = torch.float8_e5m2
_F8_MID = 256.0     # codes span +-_F8_MID at the bound (e5m2 max 57344)
_SCALE_FLOOR = 2.0 ** -126                 # the smallest normal fp32
_BOUND_FLOOR = _SCALE_FLOOR * _F8_MID
# the most elements one chunk of the element-wise update covers: its fp32
# temporaries (five at once) stay under ~350 MB
_CHUNK = 2 ** 24


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an fp32 tensor."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _sqrts(xs: list) -> list:
    """:func:`_sqrt` of each tensor of ``xs``."""
    if xs[0].is_cuda:
        return torch._foreach_sqrt(xs)
    return [_sqrt(x) for x in xs]


def _cast(xs: list, dtype) -> list:
    """Copies of ``xs`` in ``dtype``."""
    out = [torch.empty(x.shape, dtype=dtype, device=x.device) for x in xs]
    torch._foreach_copy_(out, xs)
    return out


def _chunks(params: list) -> list:
    """``params`` in runs of consecutive tensors of at most ``_CHUNK``
    elements (a larger tensor alone)."""
    runs, run, n = [], [], 0
    for p in params:
        if run and n + p.numel() > _CHUNK:
            runs.append(run)
            run, n = [], 0
        run.append(p)
        n += p.numel()
    return runs + [run]


class Adam8bit(torch.optim.Optimizer):
    """Adam(W) with float8_e5m2 moments, as ``adam8bit`` in
    ``esme_tpu/train/optim.py``.

    Args:
        params: tensors (one group) or param groups (dicts with
            ``'params'``), each group one JAX leaf: its tensors share one
            scale per moment.
        lr: a float, or a callable of the step count (1 at the first
            update) returning one, as an optax schedule.
        betas, eps: Adam's.
        weight_decay: decoupled decay (AdamW) when non-zero.

    State: per tensor ``'mu'`` and ``'nu'`` (e5m2 codes of the first
    moment and of √ν, the tensor's shape, one byte an element); per group,
    in its first tensor's state, ``'mu_scale'`` and ``'nu_scale'`` (fp32
    scalars on the tensor's device) and ``'step'``. ``reduce_max``: None,
    or a function that makes the ``(G,)`` fp32 tensor of the groups' max
    |g| global in place (the sharded trainer's all-reduce over ``fsdp``).
    So the scales and the step are the same on every rank of a mesh, and
    a restore on a mesh of another shape takes them once and reshards
    ``mu`` and ``nu`` like their params (``train/checkpoint.py``).
    """

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.reduce_max = None

    def _head(self, group) -> dict:
        """The group's own state: its first tensor's."""
        return self.state[group['params'][0]]

    def _init_state(self):
        for group in self.param_groups:
            for p in group['params']:
                if 'mu' not in self.state[p]:
                    self.state[p]['mu'] = torch.zeros_like(p, dtype=_F8)
                    self.state[p]['nu'] = torch.zeros_like(p, dtype=_F8)
            head = self._head(group)
            if 'step' not in head:
                p = group['params'][0]
                head['step'] = 0
                head['mu_scale'] = torch.zeros((), dtype=torch.float32,
                                               device=p.device)
                head['nu_scale'] = torch.zeros((), dtype=torch.float32,
                                               device=p.device)

    @staticmethod
    def _grad(p):
        return torch.zeros_like(p) if p.grad is None else p.grad

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._init_state()
        groups = self.param_groups
        # the groups' max |g| (one fp32 vector), made global, and their
        # running bounds as JAX computes them per leaf
        gmax = torch.stack([torch.stack(torch._foreach_norm(
            [self._grad(p) for p in g['params']], float('inf'))).amax()
            for g in groups]).float()
        if self.reduce_max is not None:
            self.reduce_max(gmax)
        s_mu = torch.stack([self._head(g)['mu_scale'] for g in groups])
        s_nu = torch.stack([self._head(g)['nu_scale'] for g in groups])
        if len({tuple(g['betas']) for g in groups}) != 1:
            raise ValueError('Adam8bit: every param group takes the same '
                             'betas (the bounds are computed for all at once)')
        b1, b2 = groups[0]['betas']
        mb = s_mu * b1 * _F8_MID + (1.0 - b1) * gmax
        nb = s_nu * _F8_MID
        nb2 = b2 * (nb * nb) + (1.0 - b2) * (gmax * gmax)
        new_mu = torch.clamp_min(mb, _BOUND_FLOOR) / _F8_MID
        new_nu = torch.clamp_min(_sqrt(nb2), _BOUND_FLOOR) / _F8_MID
        # the bias corrections of this step's count, in fp32
        count = self._head(groups[0])['step'] + 1
        c = np.float32(count)
        bc = [torch.full((), float(np.float32(1.0) - np.float32(b) ** c),
                         dtype=torch.float32, device=gmax.device)
              for b in (b1, b2)]
        for i, group in enumerate(groups):
            head = self._head(group)
            head['step'] = count
            self._update(group, count, *bc, s_mu[i], s_nu[i], new_mu[i],
                         new_nu[i])
            head['mu_scale'], head['nu_scale'] = new_mu[i], new_nu[i]
        return loss

    def _update(self, group, count, bc1, bc2, s_mu, s_nu, new_mu, new_nu):
        """One group's element-wise pass in JAX's order
        (``esme_tpu/train/optim.py:upd``), chunk by chunk of its views."""
        b1, b2 = group['betas']
        eps, wd = group['eps'], group['weight_decay']
        lr = group['lr']
        lr = float(lr(count)) if callable(lr) else lr
        f32 = torch.float32
        for ps in _chunks(group['params']):
            gs = [self._grad(p) for p in ps]
            g32 = gs if gs[0].dtype == f32 else _cast(gs, f32)
            # mu = deq(mu) * b1 + (1 - b1) * g
            mu = _cast([self.state[p]['mu'] for p in ps], f32)
            torch._foreach_mul_(mu, s_mu)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g32, 1.0 - b1))
            # nu = deq(sqrt nu)^2 * b2 + (1 - b2) * g * g
            nu = _cast([self.state[p]['nu'] for p in ps], f32)
            torch._foreach_mul_(nu, s_nu)
            torch._foreach_mul_(nu, nu)
            torch._foreach_mul_(nu, b2)
            t = torch._foreach_mul(g32, 1.0 - b2)
            torch._foreach_mul_(t, g32)
            torch._foreach_add_(nu, t)
            del g32, t
            # u = -lr * (mu / bc1) / (sqrt(nu / bc2) + eps) [- lr wd p]
            u = torch._foreach_div(mu, bc1)
            torch._foreach_mul_(u, -lr)
            den = _sqrts(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, eps)
            torch._foreach_div_(u, den)
            del den
            if wd:
                torch._foreach_sub_(u, torch._foreach_mul(_cast(ps, f32),
                                                          lr * wd))
            # the codes against the new bounds
            torch._foreach_div_(mu, new_mu)
            torch._foreach_copy_([self.state[p]['mu'] for p in ps], mu)
            del mu
            nu = _sqrts(nu)
            torch._foreach_div_(nu, new_nu)
            torch._foreach_copy_([self.state[p]['nu'] for p in ps], nu)
            del nu
            torch._foreach_add_(ps, u if gs[0].dtype == f32
                                else _cast(u, gs[0].dtype))

    def load_state_dict(self, state_dict):
        """As ``torch.optim.Optimizer``'s, but every state tensor keeps its
        dtype (the base class casts floating state to the param's dtype,
        which would turn codes and fp32 scales into bf16) and moves to its
        param's device."""
        super().load_state_dict(state_dict)
        saved = state_dict['state']
        for group, sgroup in zip(self.param_groups,
                                 state_dict['param_groups']):
            for p, pid in zip(group['params'], sgroup['params']):
                if pid in saved:
                    self.state[p] = {
                        k: v.to(p.device) if torch.is_tensor(v) else v
                        for k, v in saved[pid].items()}


def adam8bit(learning_rate, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8, weight_decay: float = 0.0):
    """The optimizer factory that ``MaskedPLM(optimizer=...)`` and
    ``ShardedMaskedPLM(optimizer=...)`` take, as ``optax`` in JAX: called
    with the trainer's param groups (one per JAX leaf), it returns an
    :class:`Adam8bit`. ``learning_rate``: a float or a callable of the
    step count."""
    return functools.partial(Adam8bit, lr=learning_rate, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)
