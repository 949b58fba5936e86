"""Test environment: force an 8-virtual-device CPU mesh before JAX initializes.

Multi-device sharding tests run on jax's CPU multi-device simulation (SURVEY.md §4:
the reference has no distributed-testing precedent; we test the pjit/shard_map
layer on virtual devices). The bit-exact float64 parity paths are CPU anyway.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them when JAX finds no GPU. A marker expression that
selects them alone (``-m gpu``, ``-m "gpu and not slow"``, also through
PYTEST_ADDOPTS) leaves JAX's platform choice alone, so on a machine with a
card they run there, and fail rather than skip if JAX finds none.
"""

import os

# smaller search-plane chunks: the CPU mesh compiles the search while_loop
# far faster at 128 lanes (results are chunk-size independent; chip_smoke.py
# exercises the production sizes on the card)
os.environ.setdefault("MP3STEGO_TPU_SEARCH_CHUNK", "128")
os.environ.setdefault("MP3STEGO_TPU_BATCH_BUCKET_G", "64")
# deterministic engine selections in CI: no hardware probing — the static
# calibration defaults (device terms unmeasured) reproduce the selections
# the tests pin (the probe itself is tested with synthetic Probe records)
os.environ.setdefault("MP3STEGO_TPU_PROBE", "0")
# selection tests pin the cost model, not device health — skip the bounded
# backend-reachability check
os.environ.setdefault("MP3STEGO_TPU_DEVICE_USABLE", "1")


_GPU_RUN = False


def _selects_gpu_alone(markexpr: str) -> bool:
    """True when the ``-m`` expression selects a test marked ``gpu`` and no
    unmarked test (``gpu``, ``gpu and not slow``, ...)."""
    if not markexpr:
        return False
    from _pytest.mark.expression import Expression
    expr = Expression.compile(markexpr)
    return (expr.evaluate(lambda name: name == "gpu")
            and not expr.evaluate(lambda name: False))


def pytest_configure(config):
    """Pick the platform before any test module can initialize a backend:
    the 8-device CPU mesh, unless the marker expression selects the GPU
    tests alone, which then run on JAX's own platform choice."""
    global _GPU_RUN
    _GPU_RUN = _selects_gpu_alone(config.getoption("markexpr", ""))
    if _GPU_RUN:
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    # jax may already be imported, so env vars alone can be too late: set
    # the config directly before any backend initializes
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden")
REFERENCE_FIXTURE = "/root/reference/tests/test.mp3"


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, decided here at run time, never while a module is
    imported. Without one the test skips, or fails when the run selected
    the GPU tests alone: they must not pass for having run nowhere."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus and _GPU_RUN:
        pytest.fail(f"-m selects the gpu tests, but JAX's backend is "
                    f"{jax.default_backend()!r}")
    if not gpus:
        pytest.skip("needs a GPU; run with -m gpu on a machine with a card")
    return gpus[0]


@pytest.fixture(scope="session")
def decode_golden():
    return np.load(os.path.join(GOLD, "decode_golden.npz"))


@pytest.fixture(scope="session")
def encode_golden():
    return np.load(os.path.join(GOLD, "encode_golden.npz"))


@pytest.fixture(scope="session")
def stego_golden():
    return np.load(os.path.join(GOLD, "stego_golden.npz"))


@pytest.fixture(scope="session")
def fixture_mp3(tmp_path_factory, encode_golden):
    """A 320kbps stereo MP3 test fixture.

    Uses the reference's fixture when mounted; otherwise synthesizes an
    equivalent one from the committed golden (the reference-identical clear
    re-encode), keeping the suite standalone.
    """
    if os.path.exists(REFERENCE_FIXTURE):
        return REFERENCE_FIXTURE
    p = tmp_path_factory.mktemp("fixture") / "test.mp3"
    p.write_bytes(encode_golden["mp3_bytes"].tobytes())
    return str(p)


@pytest.fixture(scope="session")
def original_fixture_mp3():
    """The reference's original fixture; golden stage tensors correspond to it."""
    if not os.path.exists(REFERENCE_FIXTURE):
        pytest.skip("reference fixture not mounted")
    return REFERENCE_FIXTURE
