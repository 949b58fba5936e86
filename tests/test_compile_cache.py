"""Placement of the persistent XLA compilation cache (mp3stego_tpu/ops):
JAX_COMPILATION_CACHE_DIR is honoured as given, and without it the cache
sits at a fixed path inside the checkout that .gitignore lists."""

import os
import subprocess
import sys

from mp3stego_tpu import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_child(**env):
    code = ("import jax, mp3stego_tpu.ops; "
            "print(jax.config.jax_compilation_cache_dir)")
    child_env = {k: v for k, v in os.environ.items()
                 if k != "JAX_COMPILATION_CACHE_DIR"}
    child_env.update(env, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=child_env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_env_var_is_honoured(tmp_path):
    want = str(tmp_path / "xla_cache")
    assert _cache_dir_in_child(JAX_COMPILATION_CACHE_DIR=want) == want


def test_default_is_fixed_inside_checkout():
    got = _cache_dir_in_child()
    assert got == ops.default_cache_dir() == _cache_dir_in_child()
    assert got.startswith(os.path.join(REPO, ".jax_cache") + os.sep)
    assert str(os.getpid()) not in got


def test_gitignore_lists_cache_dir():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
