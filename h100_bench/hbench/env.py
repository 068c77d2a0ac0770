"""The run's surroundings: the card, the caches, the card's state, and
what must not be loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'esme_tpu')
GPU_QUERY = ('name,clocks.sm,clocks.mem,power.draw,power.limit,'
             'temperature.gpu')


class NoCard(RuntimeError):
    pass


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc libraries already live in ``build/esme_tpu_torch``),
    so only a checkout's first run builds. Set before torch is
    imported."""
    base = root / 'build' / 'h100_bench'
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        path = base / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def require_card(chips: int) -> None:
    """Raise :class:`NoCard` unless CUDA sees ``chips`` cards."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard('torch.cuda.is_available() is false: this benchmark '
                     'measures the card and has no CPU fallback')
    n = torch.cuda.device_count()
    if n < chips:
        raise NoCard(f'the cell needs {chips} cards and CUDA sees {n}')


def card_state() -> str:
    """``nvidia-smi``'s name, SM and memory clocks, power draw and limit,
    and temperature of each card, one line each."""
    try:
        out = subprocess.run(
            ['nvidia-smi', f'--query-gpu={GPU_QUERY}',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi unavailable ({e})'
    return out.stdout.strip() or out.stderr.strip()


def forbidden_modules() -> list:
    """Top-level names of loaded modules (the part before the first dot,
    compared whole) that are JAX or the JAX package."""
    return sorted({m.split('.', 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
