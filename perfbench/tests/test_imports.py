"""No module of the benchmark imports JAX or the JAX package, and the
plain references import nothing of the program.  Top-level names are
compared whole: the program's name begins with the JAX package's."""

import ast
import os

import pytest

from perfbench import harness

JAX = {'jax', 'jaxlib', 'flax', 'captioning_tpu'}
PROGRAM = 'captioning_tpu_torch'


def _sources():
    for d, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def _top_level_imports(path):
    """The top-level names of every module ``path`` imports, anywhere in
    it (a function's own imports included); a relative import is the
    benchmark's own."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', '') == 'import_module' and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(node.args[0].value.split('.')[0])
    return out


@pytest.mark.parametrize('path', sorted(_sources()))
def test_no_jax(path):
    assert not _top_level_imports(path) & JAX


@pytest.mark.parametrize('path', sorted(
    p for p in _sources()
    if os.path.dirname(p) == os.path.join(harness.HERE, 'reference')))
def test_reference_independent_of_the_program(path):
    assert PROGRAM not in _top_level_imports(path)


def test_whole_name_compare():
    """The run's own guard: the program is not the JAX package."""
    assert harness.forbidden_modules(['captioning_tpu_torch.models',
                                      'numpy']) == []
    assert harness.forbidden_modules(['captioning_tpu.models', 'jax',
                                      'flax.linen']) == [
        'captioning_tpu.models', 'flax.linen', 'jax']
