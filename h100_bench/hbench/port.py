"""The program under test, ``esme_tpu_torch``, as the benchmark drives it:
its model classes built from a configuration file and the benchmark's
weights, and its kernels' launch counters (read, never reset)."""

from __future__ import annotations

import sys

from reference.model import Arch

from .spec import ROOT


def package():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import esme_tpu_torch
    return esme_tpu_torch


def model(arch: Arch, params: dict, device, checkpointing: bool = False):
    """The port's ESM2 or ESMC over ``params``, its shapes from the
    configuration file; raises where the port would build other widths."""
    p = package()
    if arch.family == 'esm2':
        cfg = p.esm2_config(arch.layers, arch.width, arch.heads)
        cls = p.ESM2
    else:
        cfg = p.esmc_config(arch.layers, arch.width, arch.heads)
        cls = p.ESMC
    if (cfg.ffn_dim, cfg.vocab_size) != (arch.ffn, arch.vocab):
        raise ValueError(f'the port builds ffn {cfg.ffn_dim}, vocab '
                         f'{cfg.vocab_size}; the configuration states '
                         f'{arch.ffn}, {arch.vocab}')
    return cls(config=cfg, params=params, device=device,
               checkpointing=checkpointing)


def launches() -> dict:
    """H1's, H2's and H3's launch counters as the port keeps them."""
    package()
    from esme_tpu_torch.ops import flash, headsplit
    return {'H1': flash.segment_flash_fwd.launches,
            'H2': flash.segment_flash_bwd.launches,
            'H3': headsplit.rotary_qk.launches}
