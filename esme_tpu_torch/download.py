"""Pretrained weight distribution (reference: esme/download.py:4-52).

Copy of ``esme_tpu/download.py``: the same model registry and
HuggingFace Hub repo (``mhcelik/esm-efficient``), whose checkpoints are
safetensors in the key schema the port loads
(:mod:`esme_tpu_torch.models.io`). :func:`download_model` resolves a
local path first, then the cache, and only then fetches, through
``huggingface_hub`` if it is installed.
"""

from __future__ import annotations

import os
from pathlib import Path

# (reference: esme/download.py:4-22)
MODELS = [
    'esm1b',
    *[f'esm1v_{i}' for i in range(1, 6)],
    'esm2_8m', 'esm2_35m', 'esm2_150m', 'esm2_650m', 'esm2_3b', 'esm2_15b',
    'esmc_300m', 'esmc_600m',
]

# aliases (reference: esme/download.py:41-46)
ALIASES = {
    'esm1v': 'esm1v_1',
    'esm2': 'esm2_650m',
    'esmc': 'esmc_300m',
}

model_names = MODELS + list(ALIASES)

HF_REPO = 'mhcelik/esm-efficient'


def resolve_name(name: str) -> str:
    """A registry name for ``name`` (an alias resolved); raises
    ``ValueError`` for a name outside the registry."""
    name = ALIASES.get(name, name)
    if name not in MODELS:
        raise ValueError(
            f'Invalid model name: {name}. Must be one of {model_names}')
    return name


def download_model(name: str, cache_dir: str | None = None) -> str:
    """A local safetensors path for ``name``: ``name`` itself if it is a
    file, else ``<cache_dir>/<model>.safetensors`` if present
    (``cache_dir`` defaults to ``$ESME_TPU_CACHE`` or
    ``~/.cache/esme_tpu``, the JAX package's cache), else the HF hub's
    download (reference: esme/download.py:25-52). Without
    ``huggingface_hub`` a missing file raises ``RuntimeError``."""
    if os.path.isfile(name):
        return name
    name = resolve_name(name)
    filename = f'{name}.safetensors'

    cache_dir = cache_dir or os.environ.get(
        'ESME_TPU_CACHE', os.path.expanduser('~/.cache/esme_tpu'))
    local = Path(cache_dir) / filename
    if local.exists():
        return str(local)

    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError(
            f'{filename} not found locally at {local} and huggingface_hub '
            f'is unavailable; place the file there manually') from e
    return hf_hub_download(HF_REPO, filename, cache_dir=cache_dir)
