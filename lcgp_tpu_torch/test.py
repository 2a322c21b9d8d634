"""Install-verification test entry (counterpart of the JAX package's
``test.py``; reference test.py:4-25).

Runs the port's own tests, ``tests/test_torch_*.py``: from the source
tree, the ``tests/`` directory beside the package; from a wheel, the
suite the wheel installs beside it (the ``tests`` directory packaged
under the JAX package's name, located without importing that package).
Their parity tests import JAX on the CPU, as the repository's suite does.
"""
from __future__ import annotations

from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]


def _test_files():
    for tests_dir in (_ROOT / 'tests', _ROOT / 'lcgp_tpu' / 'tests'):
        files = sorted(tests_dir.glob('test_torch_*.py'))
        if files:
            return [str(f) for f in files]
    raise FileNotFoundError(
        f'no test_torch_*.py under {_ROOT / "tests"} or the installed suite')


def test(level: int = 0):
    """Run the port's test-suite.  Returns True if all tests passed."""
    import pytest

    VERBOSITY = [0, 1, 2]
    if level not in VERBOSITY:
        raise ValueError(f"level must be in {VERBOSITY}")
    return pytest.main([f"--verbosity={level}", *_test_files()]) == 0
