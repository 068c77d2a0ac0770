"""The port's CLI (``python -m esme_tpu_torch.cli``) and weight registry
(``esme_tpu_torch/download.py``) against the JAX package's
(``esme_tpu/cli.py``, ``esme_tpu/download.py``), offline: nothing is
fetched.

``score`` runs on the CPU (``--device cpu``) on a tiny ESM2 (2 layers,
width 64, 4 heads, seed 0) written by the JAX package; both CLIs load it
in bf16, their default. Gates: the same header and variants in the same
order; scores within ``BF16_SCORE_ATOL`` = 2^-4 of JAX's (scores reach
~3.5, where a bf16 log-prob's step is 2^-6, and each of the two
log-probs of a score can land a step or two apart when the packages
round their residual streams differently; measured max 0.033).
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from esme_tpu import ESM2 as JESM2
from esme_tpu import cli as jcli
from esme_tpu import download as jdl
from esme_tpu.models.config import esm2_config as jesm2_config

from esme_tpu_torch import ESM, ESM2
from esme_tpu_torch import cli as tcli
from esme_tpu_torch import download as tdl

SEQ = 'MPEAAPPVAPAPAAP'
BF16_SCORE_ATOL = 2.0 ** -4
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('cli') / 'esm2_t.safetensors')
    JESM2(config=jesm2_config(2, 64, 4, dtype='float32'),
          rng=0).save_pretrained(path)
    return path


def _read(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


def test_score_csv_matches_jax(weights, tmp_path):
    jout, tout = str(tmp_path / 'jax.csv'), str(tmp_path / 'port.csv')
    assert jcli.main(['score', '--model', weights, '--seq', SEQ,
                      '--batch-size', '8', '--out', jout]) == 0
    assert tcli.main(['score', '--model', weights, '--seq', SEQ,
                      '--batch-size', '8', '--out', tout,
                      '--device', 'cpu']) == 0
    got, ref = _read(tout), _read(jout)
    assert got[0] == ref[0] == ['variant', 'score']
    assert len(got) == len(SEQ) * 20 + 1
    assert [r[0] for r in got] == [r[0] for r in ref]
    err = np.abs(np.array([float(r[1]) for r in got[1:]])
                 - np.array([float(r[1]) for r in ref[1:]]))
    assert err.max() <= BF16_SCORE_ATOL, err.max()


def test_registry_matches_jax():
    assert tdl.MODELS == jdl.MODELS and tdl.ALIASES == jdl.ALIASES
    assert tdl.model_names == jdl.model_names and tdl.HF_REPO == jdl.HF_REPO
    for name in tdl.model_names:
        assert tdl.resolve_name(name) == jdl.resolve_name(name)
    for bad in ('esm3', 'esm2_650M', ''):
        with pytest.raises(ValueError, match='Invalid model name'):
            tdl.resolve_name(bad)


def test_download_model_offline(weights, tmp_path, monkeypatch):
    # a file path is returned as it is
    assert tdl.download_model(weights) == weights
    # a cache hit, by name and by alias
    cache = tmp_path / 'cache'
    cache.mkdir()
    hit = cache / 'esm2_650m.safetensors'
    hit.write_bytes(Path(weights).read_bytes())
    for name in ('esm2_650m', 'esm2'):
        assert tdl.download_model(name, cache_dir=str(cache)) == str(hit)
        assert jdl.download_model(name, cache_dir=str(cache)) == str(hit)
    monkeypatch.setenv('ESME_TPU_CACHE', str(cache))
    assert tdl.download_model('esm2') == str(hit)
    # ESM.from_pretrained resolves a registry name through the cache
    model = ESM.from_pretrained('esm2', dtype='float32', device='cpu')
    assert isinstance(model, ESM2) and model.config.num_layers == 2
    # a miss without huggingface_hub raises, and fetches nothing
    monkeypatch.setitem(sys.modules, 'huggingface_hub', None)
    with pytest.raises(RuntimeError, match='huggingface_hub'):
        tdl.download_model('esmc_300m', cache_dir=str(cache))
    with pytest.raises(FileNotFoundError, match='registry'):
        ESM.from_pretrained(str(tmp_path / 'missing.safetensors'),
                            device='cpu')


def test_module_entry_point(weights, tmp_path):
    """``python -m esme_tpu_torch.cli download`` prints the cached path;
    an unknown command exits with argparse's error."""
    cache = tmp_path / 'cache'
    cache.mkdir()
    (cache / 'esmc_300m.safetensors').write_bytes(b'')
    env = {**os.environ, 'ESME_TPU_CACHE': str(cache)}
    run = subprocess.run([sys.executable, '-m', 'esme_tpu_torch.cli',
                          'download', '--model', 'esmc'], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == str(cache / 'esmc_300m.safetensors')
    with pytest.raises(SystemExit) as e:
        tcli.main(['train'])
    assert e.value.code == 2
