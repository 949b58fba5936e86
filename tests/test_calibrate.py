"""Engine auto-selection cost model (utils/calibrate.py): the decisions must
adapt to measured host/link rates instead of the round-2 fixed thresholds,
while the env overrides keep absolute priority."""

import json

import pytest

from mp3stego_tpu.utils import calibrate as C


@pytest.fixture(autouse=True)
def _clear_env_and_cache(monkeypatch):
    for k in ("MP3STEGO_TPU_BATCH_HOST_G", "MP3STEGO_TPU_BATCH_ENC_HOST",
              "MP3STEGO_TPU_ENC_HOST"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(C, "_probe_cache", None)


def _probe(**kw):
    base = dict(C._DEFAULTS)
    base.update(kw, probed=True)
    return C.Probe(**base)


def test_slow_link_selects_host_even_for_huge_batches():
    """Over a ~30 MB/s link the PCM fetch alone caps the device path below
    the host plane's rate — host wins at every size."""
    p = _probe(link_out_mbps=30, link_in_mbps=30, host_plane_gps=65000)
    for g in (64, 2560, 100_000, 10_000_000):
        assert C.batch_decode_engine(g, p) == "host"


def test_fast_link_selects_device():
    """Over a GB/s link the device plane's throughput wins."""
    p = _probe(link_out_mbps=8000, link_in_mbps=8000,
               host_plane_gps=65000, device_gps=2_000_000)
    assert C.batch_decode_engine(100_000, p) == "device"


def test_slow_host_plane_selects_device():
    """A host with no fast native plane (slow plane rate) should offload even
    over a mediocre link."""
    p = _probe(link_out_mbps=200, link_in_mbps=200,
               host_plane_gps=2000, device_gps=1_000_000)
    assert C.batch_decode_engine(50_000, p) == "device"


def test_env_threshold_keeps_priority(monkeypatch):
    p = _probe(link_out_mbps=8000, link_in_mbps=8000)
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_HOST_G", "2560")
    assert C.batch_decode_engine(100, p) == "host"
    assert C.batch_decode_engine(100_000, p) == "device"
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_HOST_G", "0")
    assert C.batch_decode_engine(1, p) == "device"


def test_encode_model_and_overrides(monkeypatch):
    slow = _probe(link_out_mbps=30, link_in_mbps=30)
    fast = _probe(link_out_mbps=8000, link_in_mbps=8000,
                  device_search_gps=1_000_000)
    assert C.batch_encode_engine(10_000, slow) == "host"
    assert C.batch_encode_engine(10_000, fast) == "device"
    assert C.single_encode_engine(slow) == "host"
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_ENC_HOST", "0")
    assert C.batch_encode_engine(10, slow) == "device"
    monkeypatch.setenv("MP3STEGO_TPU_ENC_HOST", "0")
    assert C.single_encode_engine(slow) == "device"
    monkeypatch.setenv("MP3STEGO_TPU_ENC_HOST", "1")
    assert C.single_encode_engine(fast) == "host"


def test_probe_cache_roundtrip(tmp_path, monkeypatch):
    """get_probe() persists measurements per host fingerprint and reloads
    them without re-measuring."""
    path = tmp_path / "probe.json"
    monkeypatch.setattr(C, "_cache_path", lambda: str(path))
    monkeypatch.setenv("MP3STEGO_TPU_PROBE", "1")
    fake = _probe(link_out_mbps=123.0)
    monkeypatch.setattr(C, "measure_probe", lambda: fake)
    p1 = C.get_probe()
    assert p1.link_out_mbps == 123.0
    assert json.load(open(path))["link_out_mbps"] == 123.0
    # second process (fresh module cache) reads the file, never measures
    monkeypatch.setattr(C, "_probe_cache", None)
    monkeypatch.setattr(C, "measure_probe",
                        lambda: (_ for _ in ()).throw(AssertionError))
    p2 = C.get_probe()
    assert p2.link_out_mbps == 123.0


def test_probe_disabled_uses_static_defaults(monkeypatch):
    monkeypatch.setenv("MP3STEGO_TPU_PROBE", "0")
    monkeypatch.setattr(C, "measure_probe",
                        lambda: (_ for _ in ()).throw(AssertionError))
    p = C.get_probe()
    assert p.probed is False
    assert p.link_out_mbps == C._DEFAULTS["link_out_mbps"]


def test_measure_probe_runs_on_cpu():
    """measure_probe() must complete without a device (link probe skipped on
    the CPU backend) and return sane host rates."""
    p = C.measure_probe()
    assert p.probed is True
    assert p.host_plane_gps > 0
    assert p.host_search_gps > 0
