"""Which marker expressions make a GPU run (tests/conftest.py): only those
that select the ``gpu`` tests and no unmarked test leave JAX's platform
choice alone; every other run is held to the 8-device CPU mesh."""

import pytest

from conftest import _selects_gpu_alone


@pytest.mark.parametrize("markexpr, gpu_run", [
    ("gpu", True),
    ("gpu and not slow", True),
    ("(gpu)", True),
    ("not slow", False),
    ("not gpu", False),
    ("gpu or not slow", False),
    ("", False),
])
def test_selects_gpu_alone(markexpr, gpu_run):
    assert _selects_gpu_alone(markexpr) is gpu_run
