"""Every name the JAX package's ``__init__`` files export resolves on the
port, at the same place, and every module of the JAX package has a
counterpart of the same name, but for the listed exceptions, each with
its reason. The names are read from the ``__init__`` sources (their
``from .module import`` lists), so a submodule attribute counts for
nothing.
The data-plane, variant, extension, CLI and quantization modules export
every public name of their JAX counterparts.

Every check is exact (names).
"""

import ast
import importlib
from pathlib import Path

import pytest

import esme_tpu

JAX_PKG = Path(esme_tpu.__file__).resolve().parent

# name (module, name) -> why the port has none
NAME_EXCEPTIONS = {
    ('esme_tpu.train', 'Adam8BitState'):
        "optax's state tuple of the float8 Adam; the port's Adam8bit is a "
        'torch.optim.Optimizer whose state lives in Adam8bit.state',
    ('esme_tpu.native', 'NATIVE_AVAILABLE'):
        "JAX's flag for its silent fallback; the port's reader builds or "
        "raises (FastaTokenDataset.reader says which one a dataset took)",
}
MODULE_EXCEPTIONS = {
    'esme_tpu.utils':
        "enable_compilation_cache configures JAX's persistent XLA cache; "
        'the port compiles nothing per shape, and esme_tpu_torch._build '
        'is its persistent kernel cache',
}
PORTED_MODULES = ('data', 'variant', 'extend', 'download', 'cli', 'native',
                  'fasta', 'quant')


def _exports(init: Path):
    tree = ast.parse(init.read_text())
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) and node.level > 0
                  for a in node.names if not a.name.startswith('_'))


INITS = sorted(JAX_PKG.rglob('__init__.py'))


@pytest.mark.parametrize('init', INITS,
                         ids=[str(p.relative_to(JAX_PKG)) for p in INITS])
def test_init_names_resolve_on_the_port(init):
    rel = init.parent.relative_to(JAX_PKG)
    jmod = '.'.join(('esme_tpu', *rel.parts))
    port = importlib.import_module(jmod.replace('esme_tpu',
                                                'esme_tpu_torch', 1))
    names = _exports(init)
    missing = [n for n in names if not hasattr(port, n)
               and (jmod, n) not in NAME_EXCEPTIONS]
    assert missing == []
    # no exception stands for a name the port now has
    assert not [n for (m, n) in NAME_EXCEPTIONS
                if m == jmod and hasattr(port, n)]


def test_every_jax_module_has_a_counterpart():
    mods = sorted('.'.join(('esme_tpu', *p.relative_to(JAX_PKG)
                            .with_suffix('').parts))
                  for p in JAX_PKG.rglob('*.py') if p.name != '__init__.py')
    missing = []
    for m in mods:
        try:
            importlib.import_module(m.replace('esme_tpu', 'esme_tpu_torch',
                                              1))
        except ModuleNotFoundError:
            missing.append(m)
    assert sorted(missing) == sorted(MODULE_EXCEPTIONS)


@pytest.mark.parametrize('name', PORTED_MODULES)
def test_ported_modules_export_jax_public_names(name):
    path = JAX_PKG / f'{name}.py'
    path = path if path.exists() else JAX_PKG / name / '__init__.py'
    tree = ast.parse(path.read_text())
    public = [n.name for n in tree.body
              if isinstance(n, (ast.FunctionDef, ast.ClassDef))
              and not n.name.startswith('_')]
    public += [t.id for n in tree.body if isinstance(n, ast.Assign)
               for t in n.targets if isinstance(t, ast.Name)
               and not t.id.startswith('_')]
    port = importlib.import_module(f'esme_tpu_torch.{name}')
    missing = [n for n in public if not hasattr(port, n)
               and (f'esme_tpu.{name}', n) not in NAME_EXCEPTIONS]
    assert public and missing == []


def test_apply_rotary_qk_matches_jax():
    """``ops.apply_rotary_qk`` (ported with the namespaces) against
    ``esme_tpu.ops.apply_rotary_qk`` on seeded fp32 q, k of 3 packed
    sequences: within 1e-6 (the same fp32 tables and products; cos and sin
    of the larger angles differ by an ulp between the two libraries)."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from esme_tpu import ops as jops
    from esme_tpu_torch import ops as tops
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((120, 4, 32)).astype(np.float32)
            for _ in range(2))
    pos = np.concatenate([np.arange(n) for n in (50, 7, 63)]) \
        .astype(np.int32)
    got = tops.apply_rotary_qk(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(pos))
    ref = jops.apply_rotary_qk(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(pos))
    for a, b in zip(got, ref):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6
