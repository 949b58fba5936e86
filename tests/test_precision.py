"""Quantified float32-vs-float64 decode deviation (VERDICT round-1 item 2).

The float32 device plane is NOT int16-byte-identical to the reference
(float64) output: XLA's single-rounding FMA contraction plus float32
accumulation perturb the PCM by ~1e-7, and a small fraction of samples sit
close enough to an int16 truncation boundary to flip. These tests pin the
measured contract: deviation is at most 1 LSB and affects < 0.1% of samples —
which is why ``precision="float64"`` stays the default parity mode and
``"float32"`` is the opt-in device throughput mode (models/decoder.py,
steganography.py).
"""

import os

import numpy as np
import pytest

from mp3stego_tpu.bitstream import decoder_host as dh
from mp3stego_tpu.ops import decode_plane as dp


@pytest.fixture(scope="module")
def fixture_pcm_pair(fixture_mp3):
    with open(fixture_mp3, "rb") as f:
        data = f.read()
    parsed = dh.parse_mp3(data, 0)
    pcm64 = dp.decode_pcm(parsed, "float64")
    pcm32 = dp.decode_pcm(parsed, "float32")
    return pcm64, pcm32


def test_f32_plane_deviation_bounds(fixture_pcm_pair):
    pcm64, pcm32 = fixture_pcm_pair
    i64 = (pcm64 * 32767).astype(np.int16)
    i32 = (pcm32 * 32767).astype(np.int16)
    d = np.abs(i64.astype(np.int32) - i32.astype(np.int32))
    assert d.max() <= 1, "float32 plane deviates by more than 1 int16 LSB"
    rate = (d != 0).mean()
    assert rate < 1e-3, f"float32 int16 mismatch rate {rate} regressed"


def test_f32_plane_float_error_small(fixture_pcm_pair):
    pcm64, pcm32 = fixture_pcm_pair
    assert np.abs(pcm64 - pcm32).max() < 1e-5


def test_facade_precision_kwarg(fixture_mp3, tmp_path):
    """precision="float32" is reachable through the façade and stays within
    1 LSB of the parity output; the default remains the bit-exact mode."""
    from mp3stego_tpu import Steganography

    def read_wav_int16(path):
        with open(path, "rb") as f:
            return np.frombuffer(f.read()[44:], dtype=np.int16)

    s64 = Steganography(quiet=True)
    assert s64.precision == "float64"
    s32 = Steganography(quiet=True, precision="float32")

    w64 = str(tmp_path / "p64.wav")
    w32 = str(tmp_path / "p32.wav")
    assert s64.decode_mp3_to_wav(fixture_mp3, w64) == \
        s32.decode_mp3_to_wav(fixture_mp3, w32)
    a = read_wav_int16(w64)
    b = read_wav_int16(w32)
    assert a.shape == b.shape
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_cli_precision_flag(fixture_mp3, tmp_path):
    from mp3stego_tpu.__main__ import main

    out = str(tmp_path / "cli32.wav")
    rc = main(["--precision", "float32", "decode", fixture_mp3, out])
    assert rc == 0
    assert os.path.exists(out)
