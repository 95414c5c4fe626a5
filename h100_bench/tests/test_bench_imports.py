"""What the chip path and the reference import: no JAX, no JAX package
(the top-level name compared whole), and the reference nothing of the
port."""

import ast
from pathlib import Path

import pytest

from h100_bench import harness

HERE = Path(harness.__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob('*.py') if 'tests' not in p.parts)
REFERENCE = sorted((HERE / 'reference').rglob('*.py'))


def _tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split('.')[0])
    return out


@pytest.mark.parametrize('path', FILES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not _tops(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize('path', REFERENCE, ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not _tops(path) & set(harness.FORBIDDEN + (harness.PROGRAM,))
    assert _tops(path) <= {'__future__', 'contextlib', 'functools', 'typing',
                           'math', 'numpy', 'torch', 'h100_bench'}


def test_forbidden_modules_by_whole_name():
    found = harness.forbidden_modules({
        'jax': 0, 'jax.numpy': 0, 'jaxtyping': 0, 'flax.linen': 0,
        'esa_pose_estimation_tpu.ops': 0,
        'esa_pose_estimation_tpu_torch': 0,
        'esa_pose_estimation_tpu_torch.ops.pnp': 0, 'torch': 0})
    assert found == ['esa_pose_estimation_tpu.ops', 'flax.linen', 'jax',
                     'jax.numpy']


def test_program_found_here():
    assert harness.program_is_local()
