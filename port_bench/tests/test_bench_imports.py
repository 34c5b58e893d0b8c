"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import os

import pytest

from conftest import BENCH

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'virconv_tpu'}
PROGRAM = 'virconv_tpu_torch'


def sources(sub=''):
    top = os.path.join(BENCH, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize('path', sorted(sources('refnet')),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_is_not_the_program(path):
    assert PROGRAM not in set(imported(path))


def test_whole_names():
    """A prefix of a forbidden name is not forbidden, nor the other way."""
    import run
    names = {'virconv_tpu_torch', 'virconv_tpux', 'jaxtyping'}
    assert not names & set(run.FORBIDDEN)
    assert {'virconv_tpu', 'jax'} <= set(run.FORBIDDEN)


def test_shared_cells_know_no_model():
    """What every run mode shares imports nothing of the program, of the
    reference or of the detector's helpers, and names no detector."""
    path = os.path.join(BENCH, 'benchlib', 'cells.py')
    assert not set(imported(path)) & {PROGRAM, 'refnet'}
    local = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.ImportFrom) and node.level:
            local |= {node.module or ''} | {a.name for a in node.names}
    assert not local & {'detector', 'capture', 'traffic', 'weights',
                        'faults', 'work'}
    src = open(path).read()
    for name in ('Detector', 'Trainer', 'voxel_pool', 'STAGES'):
        assert name not in src
