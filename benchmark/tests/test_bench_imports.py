"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the program.  Each imported module's name up
to its first dot is compared whole: ``exposure_tpu_torch`` begins with
``exposure_tpu`` and is not it."""

import ast
from pathlib import Path

from benchmark.lib.common import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


def imported(path):
    """Top-level names of every module ``path`` imports (relative imports
    stay inside the benchmark)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', '')) in (
                    'import_module', '__import__') and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split('.')[0])
    return out


def sources(sub=''):
    return [p for p in sorted((BENCH / sub).rglob('*.py'))
            if 'tests' not in p.relative_to(BENCH).parts[:1]
            and '.scratch' not in p.parts and '.cache' not in p.parts]


def test_no_jax_anywhere_in_the_harness():
    files = sources()
    assert len(files) > 20
    for p in files:
        bad = imported(p) & set(FORBIDDEN)
        assert not bad, '%s imports %s' % (p, bad)


def test_reference_imports_nothing_of_the_program():
    files = sources('reference')
    assert any(p.name == 'serve.py' for p in files)
    for p in files:
        names = imported(p)
        assert 'exposure_tpu_torch' not in names, p
        assert not names & set(FORBIDDEN), p


def test_forbidden_names_are_compared_whole():
    mods = {'exposure_tpu_torch': 1, 'exposure_tpu_torch.core': 1,
            'jaxtyping': 1, 'flaxen': 1, 'numpy': 1}
    assert forbidden_modules(mods) == []
    mods.update({'jax.numpy': 1, 'exposure_tpu.core': 1, 'flax': 1})
    assert forbidden_modules(mods) == ['exposure_tpu.core', 'flax',
                                       'jax.numpy']
