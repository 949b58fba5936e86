"""Unit-level bit-exactness of the decode pipeline against reference-captured
golden tensors (tools/gen_golden.py): side-info fields, raw Huffman samples,
main-data reservoir assembly, stage outputs of the device plane, PCM and the
stego bit channel."""

import numpy as np
import pytest

from mp3stego_tpu.bitstream import decoder_host as dh


@pytest.fixture(scope="module")
def parsed(original_fixture_mp3):
    with open(original_fixture_mp3, "rb") as f:
        data = f.read()
    # the python path is the golden-test oracle (it exposes side_infos)
    return dh.parse_mp3(data, 0, backend="python")


def test_native_parser_matches_python(original_fixture_mp3, parsed):
    """The C++ host parser must produce identical dense tensors to the python
    oracle (and the same stego bit channel)."""
    from mp3stego_tpu import native
    if not native.available():
        pytest.skip("native library unavailable")
    with open(original_fixture_mp3, "rb") as f:
        data = f.read()
    p_nat = dh.parse_mp3(data, 0, backend="native")
    for f_ in ("frame_sizes", "raw_samples", "block_type", "mixed_block_flag",
               "window_switching", "global_gain", "scale_fac_scale",
               "pre_flag", "sub_block_gain", "scale_fac_l", "scale_fac_s",
               "table_select"):
        np.testing.assert_array_equal(getattr(parsed, f_), getattr(p_nat, f_),
                                      err_msg=f_)
    np.testing.assert_array_equal(parsed.ms_stereo, p_nat.ms_stereo)
    assert parsed.duplicate_last_pcm == p_nat.duplicate_last_pcm
    assert dh.stego_bits(parsed) == dh.stego_bits(p_nat)
    assert p_nat.header.bit_rate == parsed.header.bit_rate


def test_frame_walk(parsed, decode_golden):
    assert parsed.num_frames == len(decode_golden["frame_sizes"])
    np.testing.assert_array_equal(parsed.frame_sizes,
                                  decode_golden["frame_sizes"])


def test_side_info_fields(parsed, decode_golden):
    g = decode_golden
    np.testing.assert_array_equal(parsed.block_type, g["side_block_type"])
    np.testing.assert_array_equal(parsed.global_gain, g["side_global_gain"])
    np.testing.assert_array_equal(parsed.table_select, g["side_table_select"])
    np.testing.assert_array_equal(parsed.scale_fac_scale,
                                  g["side_scale_fac_scale"])
    np.testing.assert_array_equal(parsed.pre_flag, g["side_pre_flag"])
    np.testing.assert_array_equal(parsed.sub_block_gain,
                                  g["side_sub_block_gain"])
    for fi, si in enumerate(parsed.side_infos):
        assert si.main_data_begin == g["side_main_data_begin"][fi]
        np.testing.assert_array_equal(si.scfsi, g["side_scfsi"][fi])
        np.testing.assert_array_equal(si.part2_3_length,
                                      g["side_part2_3_length"][fi])
        np.testing.assert_array_equal(si.big_value, g["side_big_value"][fi])


def test_scale_factors(parsed, decode_golden):
    np.testing.assert_array_equal(parsed.scale_fac_l, decode_golden["sfl"])
    np.testing.assert_array_equal(parsed.scale_fac_s, decode_golden["sfs"])


def test_main_data_reservoir(parsed, original_fixture_mp3, decode_golden):
    """Reservoir splicing must reproduce the reference's main_data bytes."""
    g = decode_golden
    cat = g["main_data"].tobytes()
    offs = g["main_data_offsets"]
    with open(original_fixture_mp3, "rb") as f:
        data = f.read()
    # re-walk frames to rebuild the same prev-size histories
    frames = []
    prev_hist = [0.0] * dh.NUM_PREV_FRAMES
    h = dh.parse_header(*data[0:4])
    frame_size = dh.frame_size_of(h)
    cur = 0
    while len(data) > cur + 4 and data[cur] == 0xFF and data[cur + 1] >= 0xE0:
        h = dh.parse_header(*data[cur:cur + 4])
        prev_hist = [frame_size] + prev_hist[:-1]
        frame_size = dh.frame_size_of(h)
        frames.append((cur, h, frame_size, list(prev_hist)))
        cur += frame_size
    for fi, (foff, h, fsize, prev) in enumerate(frames):
        si = parsed.side_infos[fi]
        md = dh.assemble_main_data(data, foff, fsize, prev, si, h)
        assert md == cat[offs[fi]:offs[fi + 1]], f"frame {fi}"


def test_raw_huffman_samples(parsed, decode_golden):
    """The unpacked Huffman sample tensor (pre-requantize) per granule-channel."""
    g = decode_golden
    raw = g["raw"]  # (144,576) in (frame, gr, ch) call order
    k = 0
    for fi in range(parsed.num_frames):
        for gr in range(2):
            for ch in range(2):
                np.testing.assert_array_equal(
                    parsed.raw_samples[fi, gr, ch], raw[k],
                    err_msg=f"frame {fi} gr {gr} ch {ch}")
                k += 1


def test_parity_plane_stages(parsed, decode_golden):
    """Every stage of the batched parity plane, float-for-float equal to the
    reference's per-granule captures (requantize, alias/reorder, IMDCT +
    overlap-add, frequency inversion, synthesis)."""
    from mp3stego_tpu.ops import decode_plane as dp

    g = decode_golden
    prep = dp.host_prepare(parsed)
    stages = {}
    pcm = dp.decode_granules_np(prep, stages=stages)
    stage_pairs = [
        ("requant", "requant"), ("pre_imdct", "pre_imdct"),
        ("post_imdct", "post_imdct"), ("pre_synth", "pre_synth"),
    ]
    k = 0
    for fi in range(parsed.num_frames):
        for gr in range(2):
            for ch in range(2):
                t = fi * 2 + gr
                for mine, gold in stage_pairs:
                    np.testing.assert_array_equal(
                        stages[mine][ch, t], g[gold][k],
                        err_msg=f"stage {mine} frame {fi} gr {gr} ch {ch}")
                np.testing.assert_array_equal(
                    pcm[ch, t], g["post_synth"][k],
                    err_msg=f"stage synth frame {fi} gr {gr} ch {ch}")
                k += 1


def test_device_plane_close_to_parity(parsed):
    """The jitted float64 device plane agrees with the parity plane to the
    last few ulps (XLA may contract mul+add into FMAs; anything larger is a
    real bug)."""
    from mp3stego_tpu.ops import decode_plane as dp

    prep = dp.host_prepare(parsed)
    ref = dp.decode_granules_np(prep)
    dev = np.asarray(dp._decode_call(prep, "float64"))
    np.testing.assert_allclose(dev, ref, rtol=1e-12, atol=1e-15)


def test_final_pcm(parsed, decode_golden):
    from mp3stego_tpu.ops import decode_plane as dp
    pcm = dp.decode_pcm(parsed, "float64")
    np.testing.assert_array_equal(pcm, decode_golden["pcm"])


def test_stego_bits(parsed, decode_golden):
    bits = dh.stego_bits(parsed)
    assert bits == decode_golden["output_bits"].tobytes().decode()


def test_wav_bytes(original_fixture_mp3, stego_golden, tmp_path):
    from mp3stego_tpu.models.decoder import Decoder
    wav = str(tmp_path / "o.wav")
    d = Decoder(original_fixture_mp3, wav)
    assert d.decode(quiet=True) == 320
    with open(wav, "rb") as f:
        assert f.read() == stego_golden["wav_bytes"].tobytes()


def test_float32_pcm_close(parsed):
    """The device throughput mode (float32) must stay within int16 quantization
    distance of the bit-exact path."""
    from mp3stego_tpu.ops import decode_plane as dp
    p64 = dp.decode_pcm(parsed, "float64")
    p32 = dp.decode_pcm(parsed, "float32")
    i64 = (p64 * 32767).astype(np.int16)
    i32 = (p32 * 32767).astype(np.int16)
    mismatch = np.abs(i64.astype(np.int32) - i32.astype(np.int32))
    assert mismatch.max() <= 1
    assert (mismatch > 0).mean() < 0.05


def test_header_secondary_fields():
    """Emphasis + private/copyright/original bits (FrameHeader.py:100-110):
    no decode effect, but the header object carries them like the reference."""
    from mp3stego_tpu.bitstream.decoder_host import parse_header

    # 0xFF 0xFB: MPEG-1 layer III no-CRC; b2 sets 320kbps/44.1k + private bit;
    # b3 sets stereo + copyright/original + CITT emphasis
    h = parse_header(0xFF, 0xFB, 0xE0 | 0x01, 0x08 | 0x04 | 0x03)
    assert h.emphasis == 3
    assert h.info == (True, True, True)
    h2 = parse_header(0xFF, 0xFB, 0xE0, 0x01)
    assert h2.emphasis == 1
    assert h2.info == (False, False, False)


def test_native_f64_plane_matches_numpy(parsed, original_fixture_mp3):
    """The fused C++ float64 decode plane (decode_plane_f64.cpp) must be
    float-for-float identical to the NumPy oracle — including on mutated
    side-info covering short/mixed blocks and MS stereo, which the encode
    corpus never emits."""
    from mp3stego_tpu import native
    from mp3stego_tpu.ops import decode_plane as dp
    if not native.available():
        pytest.skip("native library unavailable")

    ref = dp.decode_granules_np(dp.host_prepare(parsed))
    out = dp.decode_granules_f64_native(parsed)
    np.testing.assert_array_equal(ref, out)

    with open(original_fixture_mp3, "rb") as f:
        data = f.read()
    rng = np.random.default_rng(7)
    for _ in range(3):
        p = dh.parse_mp3(data, 0, backend="python")
        F = p.num_frames
        p.block_type = rng.integers(0, 4, (F, 2, 2)).astype(p.block_type.dtype)
        p.mixed_block_flag = (rng.random((F, 2, 2)) < 0.3).astype(
            p.mixed_block_flag.dtype)
        p.ms_stereo = (rng.random(2 * F) < 0.5).astype(p.ms_stereo.dtype)
        p.sub_block_gain = rng.integers(0, 8, (F, 2, 2, 3)).astype(
            p.sub_block_gain.dtype)
        p.scale_fac_s = rng.integers(0, 8, (F, 2, 2, 3, 13)).astype(
            p.scale_fac_s.dtype)
        p.scale_fac_scale = rng.integers(0, 2, (F, 2, 2)).astype(
            p.scale_fac_scale.dtype)
        p.pre_flag = rng.integers(0, 2, (F, 2, 2)).astype(p.pre_flag.dtype)
        assert (p.block_type == 2).sum() > 0 and p.ms_stereo.sum() > 0
        ref = dp.decode_granules_np(dp.host_prepare(p))
        out = dp.decode_granules_f64_native(p)
        np.testing.assert_array_equal(ref, out, err_msg="mutated side-info")


def test_native_i16_plane_matches_f64(parsed, original_fixture_mp3):
    """decode_pcm_i16_host must be byte-identical to the float64 parity
    path's WAV product, including the stale-PCM duplication quirk."""
    from mp3stego_tpu import native
    from mp3stego_tpu.ops import decode_plane as dp
    if not native.available():
        pytest.skip("native library unavailable")
    ref = dp.pcm_to_i16(dp.decode_pcm(parsed, "float64"))
    out = dp.decode_pcm_i16_host(parsed)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(ref, out)
