"""The ranks of the port's context-parallel tests
(``tests/test_torch_context.py``): each runs in a process of its own,
spawned by the test, and joins a gloo group of ``n`` ranks on
``127.0.0.1``. This module imports neither JAX nor the JAX package, so
that a spawned rank loads only the port."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from esme_tpu_torch.models.esm import ESM1b, ESM1v, ESM2, ESMC, packed_meta
from esme_tpu_torch.parallel import (context_parallel_log_prob,
                                     forward_flat_cp, initialize_distributed,
                                     make_mesh)

CLASSES = {'esm2': ESM2, 'esmc': ESMC, 'esm1b': ESM1b, 'esm1v': ESM1v}
IMPLS = ('flash', 'reference')


def cp_rank(rank, n, port, family, cfg, params, tokens, cu, max_len, out):
    """Rank ``rank`` of ``n``: ``context_parallel_log_prob`` (every
    rank's gathered ``(T, V)``), its own rows of ``forward_flat_cp`` over
    the padded batch on both attention routes, and whether
    ``forward_flat_cp`` refuses a token count the axis does not divide;
    written to ``out``/rank<r>.npz."""
    torch.set_num_threads(1)
    initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu')
    try:
        mesh = make_mesh(seq=n, device='cpu')
        model = CLASSES[family](config=cfg, params=params, device='cpu')
        res = {'gathered': context_parallel_log_prob(
            model, tokens, (cu, max_len), mesh).numpy()}
        tok = torch.as_tensor(tokens, dtype=torch.int32)
        T = tok.shape[0]
        pad = (-T) % n
        tok = torch.cat([tok, tok.new_full((pad,), cfg.padding_idx)])
        seg, pos = packed_meta(torch.as_tensor(cu, dtype=torch.int32),
                               T + pad)
        with torch.inference_mode():
            for impl in IMPLS:
                res[impl] = forward_flat_cp(
                    model.params, cfg, tok, seg, pos, mesh=mesh,
                    log_prob=True, attn_impl=impl).numpy()
        try:
            forward_flat_cp(model.params, cfg, tok[:-1], seg[:-1],
                            pos[:-1], mesh=mesh)
            res['refused'] = np.array(False)
        except ValueError as e:
            res['refused'] = np.array('not divisible' in str(e))
        np.savez(f'{out}/rank{rank}.npz', **res)
    finally:
        dist.destroy_process_group()
