"""Multi-device sharding tests on the 8-virtual-CPU-device mesh (conftest sets
xla_force_host_platform_device_count=8): data-parallel file batching and
sequence-parallel frame-range sharding with halo exchange."""

import jax
import numpy as np
import pytest

from mp3stego_tpu.bitstream import decoder_host as dh
from mp3stego_tpu.ops import decode_plane as dp
from mp3stego_tpu.parallel import (decode_files_batched, decode_granules_sharded,
                                   make_mesh, prepare_batch)
from mp3stego_tpu.parallel.batch_decode import decode_batch_device


@pytest.fixture(scope="module")
def parsed(fixture_mp3):
    with open(fixture_mp3, "rb") as f:
        return dh.parse_mp3(f.read(), 0)


def test_mesh_shapes():
    assert len(jax.devices()) == 8
    m = make_mesh(files=4, frames=2)
    assert m.shape == {"files": 4, "frames": 2}
    m = make_mesh(frames=2)
    assert m.shape == {"files": 4, "frames": 2}
    with pytest.raises(ValueError):
        make_mesh(frames=3)


def test_frame_sharded_decode_matches_single(parsed):
    """Halo-exchanged frame-range sharding must reproduce the single-device
    pipeline exactly (same per-element op order, only the partitioning moves)."""
    prep = dp.host_prepare(parsed)
    single = np.asarray(dp._decode_call(prep, "float32"))
    for frames in (2, 4, 8):
        mesh = make_mesh(files=1, frames=frames)
        sharded = decode_granules_sharded(prep, mesh, "float32")
        np.testing.assert_array_equal(sharded, single,
                                      err_msg=f"frames={frames}")


def test_batched_files_match_per_file(parsed, fixture_mp3):
    mesh = make_mesh(files=8, frames=1)
    outs = decode_files_batched([fixture_mp3] * 3, mesh=mesh, dtype="float32")
    ref = dp.decode_pcm(parsed, "float32")
    assert len(outs) == 3
    for o in outs:
        np.testing.assert_allclose(o, ref, rtol=0, atol=1e-6)


def test_batched_i16_matches_per_file(parsed, fixture_mp3, monkeypatch):
    """out="int16" engine auto-select: small batches ride the bit-exact
    native host plane (byte-identical to the f64 parity product); with the
    threshold forced to 0 the float32 device plane serves the batch."""
    from mp3stego_tpu import native

    outs = decode_files_batched([fixture_mp3] * 2, out="int16")
    if native.available():
        # the native plane saturates clipping peaks, as dp.pcm_to_i16 does
        ref = dp.pcm_to_i16(dp.decode_pcm(parsed, "float64"))
    else:
        ref = dp.decode_pcm_i16(parsed)
    for o in outs:
        assert o.dtype == np.int16
        np.testing.assert_array_equal(o, ref)

    monkeypatch.setenv("MP3STEGO_TPU_BATCH_HOST_G", "0")
    outs = decode_files_batched([fixture_mp3] * 2, out="int16")
    ref32 = dp.decode_pcm_i16(parsed)
    host = dp.pcm_to_i16(dp.decode_pcm(parsed, "float32"))
    for o in outs:
        assert o.dtype == np.int16
        np.testing.assert_array_equal(o, ref32)
        np.testing.assert_array_equal(o, host)


def test_batched_pipelined_chunks_match_single_shot(parsed, fixture_mp3,
                                                    monkeypatch):
    """The chunked prep/compute pipeline (parse of chunk k+1 overlapped with
    the device stages of chunk k) must produce exactly the single-shot
    device-path result, including the ragged tail chunk."""
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_HOST_G", "0")   # force device path
    paths = [fixture_mp3] * 5
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_CHUNK_FILES", "2")  # 2+2+1
    chunked = decode_files_batched(paths, out="int16")
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_CHUNK_FILES", "0")  # one shot
    single = decode_files_batched(paths, out="int16")
    assert len(chunked) == len(single) == 5
    for a, b in zip(chunked, single):
        np.testing.assert_array_equal(a, b)


def test_batched_mixed_samplerates_device_path(tmp_path, monkeypatch):
    """Mixed-samplerate batches through the FORCED device path: the concat
    layout shares one set of constant tables per dispatch, so the pipeline
    groups files by samplerate and must restore the caller's order across
    interleaved groups (including the warm-up chunk split)."""
    from mp3stego_tpu.models.encoder import Encoder
    from mp3stego_tpu.utils.wav import write_wav

    rng = np.random.default_rng(11)
    paths = {}
    for sr in (44100, 32000):
        t = np.arange(int(sr * 0.3))
        pcm = np.clip(12000 * np.sin(2 * np.pi * 700 * t / sr)
                      + 900 * rng.standard_normal(len(t)),
                      -32768, 32767).astype(np.int16)
        wav = str(tmp_path / f"m{sr}.wav")
        write_wav(wav, sr, np.stack([pcm, pcm], axis=1))
        mp3 = str(tmp_path / f"m{sr}.mp3")
        Encoder(wav, mp3, bitrate=128).encode(quiet=True)
        paths[sr] = mp3

    order = [44100, 32000, 44100, 32000, 44100]
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_HOST_G", "0")   # force device
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_CHUNK_FILES", "2")
    outs = decode_files_batched([paths[sr] for sr in order], out="int16")
    refs = {sr: decode_files_batched([paths[sr]], out="int16")[0]
            for sr in (44100, 32000)}
    assert len(outs) == len(order)
    for sr, o in zip(order, outs):
        np.testing.assert_array_equal(o, refs[sr])


def test_batched_mono_files_slim_fetch(tmp_path, monkeypatch):
    """An all-mono batch decodes through the device path with the dead
    channel sliced off ON DEVICE before the fetch (slim), and still matches
    the per-file decode exactly."""
    from mp3stego_tpu.models.encoder import MP3Encoder
    from mp3stego_tpu.utils.wav import WavFile

    rng = np.random.default_rng(3)
    sr = 44100
    t = np.arange(sr)   # 1 s
    sig = 0.4 * np.sin(2 * np.pi * 330 * t / sr) + 0.05 * rng.standard_normal(sr)
    pcm = np.clip(sig * 20000, -32768, 32767).astype(np.int16)
    w = WavFile(file_path="mono.wav", bitrate=128, num_of_channels=1,
                samplerate=sr, bits_per_sample=16, num_of_samples=len(pcm),
                mpeg_mode=3, buffer=pcm)
    enc = MP3Encoder(w)
    enc.encode(quiet=True)
    mp3 = tmp_path / "mono.mp3"
    mp3.write_bytes(bytes(enc.out_buffer))
    p = dh.parse_mp3(mp3.read_bytes(), 0)
    assert p.header.channels == 1
    ref = dp.decode_pcm_i16(p)          # per-file float32 plane
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_HOST_G", "0")   # force device
    for chunk in ("0", "2"):            # single-shot AND pipelined
        monkeypatch.setenv("MP3STEGO_TPU_BATCH_CHUNK_FILES", chunk)
        outs = decode_files_batched([str(mp3)] * 3, out="int16")
        for o in outs:
            assert o.shape == ref.shape == (p.num_frames * 1152, 1)
            np.testing.assert_array_equal(o, ref)


def test_mono_encode_keeps_pitch(tmp_path):
    """Mono encode reads samples at stride 1 (regression: the reference's
    stride-2 feeder semantics were kept even for mono, encoding every OTHER
    sample — a 440 Hz sine came back as 880 Hz over half the duration; the
    reference itself crashes on mono, so stride-1 is the documented
    superset)."""
    from mp3stego_tpu.models.encoder import MP3Encoder
    from mp3stego_tpu.utils.wav import WavFile

    sr = 44100
    t = np.arange(sr)
    pcm = (18000 * np.sin(2 * np.pi * 440 * t / sr)).astype(np.int16)
    w = WavFile(file_path="m.wav", bitrate=128, num_of_channels=1,
                samplerate=sr, bits_per_sample=16, num_of_samples=len(pcm),
                mpeg_mode=3, buffer=pcm)
    enc = MP3Encoder(w)
    enc.encode(quiet=True)
    p = dh.parse_mp3(bytes(enc.out_buffer), 0)
    out = dp.decode_pcm_i16(p)[:, 0].astype(np.float64)
    spec = np.abs(np.fft.rfft(out[:sr]))
    peak_hz = float(np.argmax(spec))        # 1 s window -> bin == Hz
    assert abs(peak_hz - 440) < 3, peak_hz


def test_batched_ragged_lengths(parsed, fixture_mp3, tmp_path):
    """Files of different lengths batch correctly through padding."""
    with open(fixture_mp3, "rb") as f:
        data = f.read()
    short = tmp_path / "short.mp3"
    sizes = np.cumsum(parsed.frame_sizes)
    short.write_bytes(data[:int(sizes[9])])   # first 10 frames
    mesh = make_mesh(files=4, frames=2)
    outs = decode_files_batched([fixture_mp3, str(short)], mesh=mesh)
    assert outs[0].shape[0] == parsed.num_frames * 1152
    # truncated file: 10 frames (+ the stale-PCM duplication quirk when the
    # trailing garbage is a mid-file bad sync -> not triggered on clean cut)
    assert outs[1].shape[0] in (10 * 1152, 11 * 1152)


def test_prepare_batch_padding(parsed):
    prep = dp.host_prepare(parsed)
    t_full = prep["raw_i8"].shape[1]
    small = dict(prep)
    for k in dp.T_AXIS1_KEYS:
        small[k] = prep[k][:, :10]
    small["ms_mask"] = prep["ms_mask"][:10]
    keep = small["exc_t"] < 10
    for k in dp.EXC_KEYS:
        small[k] = small[k][keep]
    batch = prepare_batch([prep, small])
    assert batch["raw_i8"].shape[0] == 2
    assert batch["raw_i8"].shape[2] == t_full
    assert list(batch["lengths"]) == [t_full, 10]
    # the padded exception slots must scatter to an index that is STILL
    # out-of-bounds after XLA truncates scatter indices to s32 — the raw
    # sentinel _EXC_PAD_T*576 wraps to exactly 0 mod 2^32 and used to zero
    # sample (ch0, g0, s0) of every under-full file in the batch
    for j in range(2):
        tt = batch["raw_i8"].shape[2]
        idx = ((batch["exc_ch"][j].astype(np.int64) * tt
                + batch["exc_t"][j].astype(np.int64)) * 576
               + batch["exc_s"][j].astype(np.int64))
        idx = np.where(batch["exc_t"][j].astype(np.int64) < tt,
                       idx, np.int64(2**31 - 1))
        pad = batch["exc_t"][j] >= tt
        assert idx.max() < 2**31            # no s32 wraparound possible
        assert (idx[pad] >= 2 * tt * 576).all()   # padding stays OOB


def test_batched_decode_error_isolation(fixture_mp3, tmp_path):
    bad = tmp_path / "bad.mp3"
    bad.write_bytes(b"not an mp3 at all")
    from mp3stego_tpu.parallel import decode_files_batched
    outs = decode_files_batched([fixture_mp3, str(bad), fixture_mp3],
                                errors="isolate")
    assert isinstance(outs[1], Exception)
    np.testing.assert_array_equal(outs[0], outs[2])
    with pytest.raises(Exception):
        decode_files_batched([str(bad)], errors="raise")


def test_batched_encode_matches_single(stego_golden, encode_golden, tmp_path):
    wav = tmp_path / "g.wav"
    wav.write_bytes(stego_golden["wav_bytes"].tobytes())
    from mp3stego_tpu.parallel import encode_files_batched
    jobs = [(str(wav), str(tmp_path / "a.mp3")),
            (str(wav), str(tmp_path / "b.mp3"))]
    outs = encode_files_batched(jobs, bitrate=320)
    ref = encode_golden["mp3_bytes"].tobytes()
    for p in outs:
        with open(p, "rb") as f:
            assert f.read() == ref


def test_batched_encode_subbatched_matches_single(stego_golden, encode_golden,
                                                  tmp_path, monkeypatch):
    """A lane budget below one file's lane count forces the pipelined
    sub-batch path (one file per device program, prep overlapped on a worker
    thread) — bytes must stay identical to the whole-group program."""
    wav = tmp_path / "g.wav"
    wav.write_bytes(stego_golden["wav_bytes"].tobytes())
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_ENC_LANES", "1")
    monkeypatch.setenv("MP3STEGO_TPU_BATCH_ENC_HOST", "0")
    from mp3stego_tpu.parallel import encode_files_batched
    jobs = [(str(wav), str(tmp_path / f"sub{i}.mp3")) for i in range(3)]
    outs = encode_files_batched(jobs, bitrate=320)
    ref = encode_golden["mp3_bytes"].tobytes()
    for p in outs:
        with open(p, "rb") as f:
            assert f.read() == ref


def test_batched_encode_error_isolation(stego_golden, tmp_path):
    wav = tmp_path / "g.wav"
    wav.write_bytes(stego_golden["wav_bytes"].tobytes())
    from mp3stego_tpu.parallel import encode_files_batched
    jobs = [(str(tmp_path / "missing.wav"), str(tmp_path / "x.mp3")),
            (str(wav), str(tmp_path / "y.mp3"))]
    outs = encode_files_batched(jobs, errors="isolate")
    assert isinstance(outs[0], FileNotFoundError)
    assert outs[1].endswith("y.mp3")


def test_batched_encode_sharded_mesh(stego_golden, encode_golden, tmp_path):
    """File axis sharded over the 8-device mesh: bytes identical per file."""
    from mp3stego_tpu.parallel import encode_files_batched, make_mesh

    wav = tmp_path / "g.wav"
    wav.write_bytes(stego_golden["wav_bytes"].tobytes())
    mesh = make_mesh(files=8, frames=1)
    jobs = [(str(wav), str(tmp_path / f"s{i}.mp3")) for i in range(3)]
    outs = encode_files_batched(jobs, bitrate=320, mesh=mesh)
    ref = encode_golden["mp3_bytes"].tobytes()
    for p in outs:
        with open(p, "rb") as f:
            assert f.read() == ref


def test_batched_encode_mixed_lengths_and_rates(tmp_path):
    """Mixed durations and samplerates batch into separate device groups and
    still match per-file encodes byte for byte."""
    import os

    from mp3stego_tpu.models.encoder import MP3Encoder
    from mp3stego_tpu.parallel import encode_files_batched
    from mp3stego_tpu.utils.wav import read_wav, write_wav

    rng = np.random.default_rng(5)
    jobs = []
    for i, (sr, secs) in enumerate(((44100, 0.3), (44100, 0.7), (32000, 0.4))):
        t = np.arange(int(sr * secs))
        sig = 0.4 * np.sin(2 * np.pi * (200 + 100 * i) * t / sr) \
            + 0.05 * rng.standard_normal(len(t))
        pcm = np.clip(sig * 20000, -32768, 32767).astype(np.int16)
        stereo = np.stack([pcm, -pcm], axis=1)
        wav = tmp_path / f"mix{i}.wav"
        write_wav(str(wav), sr, stereo)
        jobs.append((str(wav), str(tmp_path / f"mix{i}.mp3")))

    outs = encode_files_batched(jobs, bitrate=128)
    for (wav_path, _), out in zip(jobs, outs):
        enc = MP3Encoder(read_wav(wav_path, 128))
        enc.encode()
        with open(out, "rb") as f:
            assert f.read() == bytes(enc.out_buffer), wav_path


def test_batched_encode_isolates_sys_exit(stego_golden, tmp_path):
    """read_wav validation failures raise SystemExit (reference parity);
    errors='isolate' must keep them in their slot, not kill the batch."""
    from mp3stego_tpu.parallel import encode_files_batched

    good = tmp_path / "g.wav"
    good.write_bytes(stego_golden["wav_bytes"].tobytes())
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFxxxxWAVEjunkjunkjunk" * 8)
    jobs = [(str(bad), str(tmp_path / "bad.mp3")),
            (str(good), str(tmp_path / "good.mp3"))]
    outs = encode_files_batched(jobs, errors="isolate")
    assert isinstance(outs[0], BaseException)
    assert outs[1].endswith("good.mp3")


def test_batched_encode_host_engine_matches_device(fixture_mp3, parsed,
                                                   tmp_path, monkeypatch):
    """encode_files_batched engine auto-select: the no-mesh host-engine path
    and the forced device group path must produce identical bytes."""
    from mp3stego_tpu.models.encoder import _native_rate_lib
    from mp3stego_tpu.parallel import encode_files_batched
    if _native_rate_lib() is None:
        pytest.skip("native library unavailable")
    from mp3stego_tpu.ops import decode_plane as dpp
    from mp3stego_tpu.utils.wav import write_wav

    pcm = dpp.decode_pcm_i16_host(parsed)
    wav = tmp_path / "b.wav"
    write_wav(str(wav), parsed.header.sampling_rate, pcm)
    jobs = [(str(wav), str(tmp_path / f"h{i}.mp3")) for i in range(2)]
    outs = encode_files_batched(jobs, bitrate=320)
    assert all(isinstance(o, str) for o in outs)
    host_bytes = open(jobs[0][1], "rb").read()
    assert open(jobs[1][1], "rb").read() == host_bytes

    monkeypatch.setenv("MP3STEGO_TPU_BATCH_ENC_HOST", "0")
    jobs2 = [(str(wav), str(tmp_path / f"d{i}.mp3")) for i in range(2)]
    outs = encode_files_batched(jobs2, bitrate=320)
    assert all(isinstance(o, str) for o in outs)
    assert open(jobs2[0][1], "rb").read() == host_bytes
