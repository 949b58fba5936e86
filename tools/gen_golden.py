#!/usr/bin/env python
"""Generate golden vectors from the reference implementation (/root/reference).

Runs the reference mp3stego library (with pure-Python numba/bitarray shims) on its
own test fixture and records:

  decode_golden.npz  — per-(frame,gr,ch) stage tensors through the decode pipeline:
                       raw Huffman samples, requantized, pre-IMDCT, post-IMDCT,
                       pre-synthesis, per-granule PCM; side-info fields; scalefactors;
                       main_data byte windows; final PCM + WAV int16; stego bits.
  encode_golden.npz  — per-frame encoder tensors: subband samples, MDCT freq (int32),
                       quantized ix, per-granule side-info fields, frame byte chunks,
                       final MP3 bytes (the "clear" re-encode of the decoded WAV).
  stego_golden.npz   — hide('ddd') output bytes + hide(longer) + too-long case.

These goldens are the bit-exactness contract for this rebuild.

    python tools/gen_golden.py
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLD = os.path.join(REPO, "tests", "golden")
FIXTURE = "/root/reference/tests/test.mp3"

sys.path.insert(0, os.path.join(HERE, "shims"))
sys.path.insert(0, "/root/reference")

os.makedirs(GOLD, exist_ok=True)
WORK = os.path.join(GOLD, "_work")
os.makedirs(WORK, exist_ok=True)

import mp3stego.decoder.Frame as FrameMod  # noqa: E402
from mp3stego.encoder.MP3_Encoder import MP3Encoder  # noqa: E402
from mp3stego.steganography import Steganography, str_to_binary_str  # noqa: E402

# ---------------------------------------------------------------- decode capture

cap = {
    "enabled": False,
    "raw": [], "requant": [], "pre_imdct": [], "post_imdct": [], "pre_synth": [],
    "post_synth": [], "gr": [], "ch": [],
    "side": [], "sfl": [], "sfs": [], "main_data": [], "frame_sizes": [],
}

_orig_requant = FrameMod.re_quantize
_orig_imdct = FrameMod.imdct
_orig_synth = FrameMod.synth_filter_bank


def rq_wrap(gr, ch, scale_fac_scale, block_type, mixed_block_flag, short_win,
            global_gain, scale_fac_s, long_win, scale_fac_l, pre_flag, samples,
            sub_block_gain):
    if cap["enabled"]:
        cap["raw"].append(samples[gr][ch].copy())
        cap["gr"].append(gr)
        cap["ch"].append(ch)
    _orig_requant(gr, ch, scale_fac_scale, block_type, mixed_block_flag, short_win,
                  global_gain, scale_fac_s, long_win, scale_fac_l, pre_flag, samples,
                  sub_block_gain)
    if cap["enabled"]:
        cap["requant"].append(samples[gr][ch].copy())


def imdct_wrap(gr, ch, block_type, samples, sine_block, prev_samples):
    if cap["enabled"]:
        cap["pre_imdct"].append(samples[gr][ch].copy())
    _orig_imdct(gr, ch, block_type, samples, sine_block, prev_samples)
    if cap["enabled"]:
        cap["post_imdct"].append(samples[gr][ch].copy())


def synth_wrap(gr, ch, samples, fifo, block):
    if cap["enabled"]:
        cap["pre_synth"].append(samples[gr][ch].copy())
    _orig_synth(gr, ch, samples, fifo, block)
    if cap["enabled"]:
        cap["post_synth"].append(samples[gr][ch].copy())


FrameMod.re_quantize = rq_wrap
FrameMod.imdct = imdct_wrap
FrameMod.synth_filter_bank = synth_wrap

_orig_init_frame = FrameMod.Frame.init_frame_params
SIDE_FIELDS = [
    "part2_3_length", "big_value", "global_gain", "scale_fac_compress",
    "window_switching", "block_type", "mixed_block_flag", "table_select",
    "sub_block_gain", "region0_count", "region1_count", "pre_flag",
    "scale_fac_scale", "count1table_select",
]


def init_frame_wrap(self, buffer, file_data, curr_offset):
    _orig_init_frame(self, buffer, file_data, curr_offset)
    if cap["enabled"]:
        si = self.side_info
        rec = {f: np.array(getattr(si, f), dtype=np.float64).copy() for f in SIDE_FIELDS}
        rec["main_data_begin"] = np.float64(si.main_data_begin)
        rec["scfsi"] = np.array(si.scfsi, dtype=np.float64).copy()
        cap["side"].append(rec)
        cap["sfl"].append(np.array(si.scale_fac_l).copy())
        cap["sfs"].append(np.array(si.scale_fac_s).copy())
        cap["main_data"].append(bytes(self._Frame__main_data))
        cap["frame_sizes"].append(self.frame_size)


FrameMod.Frame.init_frame_params = init_frame_wrap

# ---------------------------------------------------------------- encode capture

ecap = {"enabled": False, "frames": [], "chunks": []}

_orig_mdct_sub = MP3Encoder._MP3Encoder__mdct_sub
_orig_iter = MP3Encoder._MP3Encoder__iteration_loop
_orig_ebi = MP3Encoder._MP3Encoder__encode_buffer_internal

ESIDE_FIELDS = [
    "part2_3_length", "big_values", "count1", "global_gain", "scale_fac_compress",
    "region0_count", "region1_count", "preflag", "scale_fac_scale",
    "count1table_select", "quantizerStepSize", "address1", "address2", "address3",
    "part2_length",
]


def mdct_sub_wrap(self):
    _orig_mdct_sub(self)
    if ecap["enabled"]:
        ecap["frames"].append({
            "sb_sample": self._MP3Encoder__l3_sb_sample.copy(),
            "mdct_freq": self._MP3Encoder__mdct_freq.copy(),
        })


def iter_wrap(self):
    _orig_iter(self)
    if ecap["enabled"]:
        rec = ecap["frames"][-1]
        rec["l3_enc"] = self._MP3Encoder__l3_enc.copy()
        si = self._MP3Encoder__side_info
        for f in ESIDE_FIELDS:
            rec[f] = np.array(
                [[np.float64(getattr(si.gr[g].ch[c].tt, f)) for c in range(2)]
                 for g in range(2)])
        rec["table_select"] = np.array(
            [[si.gr[g].ch[c].tt.table_select.copy() for c in range(2)]
             for g in range(2)])
        rec["scfsi"] = si.scfsi.copy()
        rec["resv_drain"] = si.resv_drain
        rec["padding"] = self._MP3Encoder__mpeg.padding
        rec["mean_bits"] = self._MP3Encoder__mpeg.mean_bits
        rec["hide_str_offset"] = self._MP3Encoder__hide_str_offset
        rec["resv_size"] = np.float64(self._MP3Encoder__resv_size)


def ebi_wrap(self):
    written, data = _orig_ebi(self)
    if ecap["enabled"]:
        ecap["chunks"].append(bytes(data[:written]))
    return written, data


MP3Encoder._MP3Encoder__mdct_sub = mdct_sub_wrap
MP3Encoder._MP3Encoder__iteration_loop = iter_wrap
MP3Encoder._MP3Encoder__encode_buffer_internal = ebi_wrap


def save_decode(parser, path):
    sides = cap["side"]
    side_pack = {
        f"side_{f}": np.stack([r[f] for r in sides]) for f in sides[0].keys()
    }
    md = cap["main_data"]
    md_cat = b"".join(md)
    md_off = np.cumsum([0] + [len(b) for b in md])
    np.savez_compressed(
        path,
        raw=np.stack(cap["raw"]),
        requant=np.stack(cap["requant"]),
        pre_imdct=np.stack(cap["pre_imdct"]),
        post_imdct=np.stack(cap["post_imdct"]),
        pre_synth=np.stack(cap["pre_synth"]),
        post_synth=np.stack(cap["post_synth"]),
        gr=np.array(cap["gr"]),
        ch=np.array(cap["ch"]),
        sfl=np.stack(cap["sfl"]),
        sfs=np.stack(cap["sfs"]),
        main_data=np.frombuffer(md_cat, dtype=np.uint8),
        main_data_offsets=md_off,
        frame_sizes=np.array(cap["frame_sizes"]),
        pcm=parser._MP3Parser__pcm_data,
        output_bits=np.frombuffer(parser.output_bits.encode(), dtype=np.uint8),
        **side_pack,
    )


def save_encode(path, mp3_bytes):
    frames = ecap["frames"]
    pack = {}
    for key in frames[0]:
        pack[key] = np.stack([np.asarray(f[key]) for f in frames])
    chunks = ecap["chunks"]
    pack["chunk_offsets"] = np.cumsum([0] + [len(c) for c in chunks])
    pack["chunks"] = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    pack["mp3_bytes"] = np.frombuffer(mp3_bytes, dtype=np.uint8)
    np.savez_compressed(path, **pack)


def main():
    s = Steganography(quiet=True)
    wav_path = os.path.join(WORK, "golden.wav")
    clear_path = os.path.join(WORK, "clear.mp3")

    # 1. decode fixture with stage capture
    cap["enabled"] = True
    bitrate = s.decode_mp3_to_wav(FIXTURE, wav_path)
    cap["enabled"] = False
    assert bitrate == 320, bitrate
    parser = s._Steganography__decoder._Decoder__parser
    save_decode(parser, os.path.join(GOLD, "decode_golden.npz"))
    with open(wav_path, "rb") as f:
        wav_bytes = f.read()
    print("decode golden saved;", len(cap["raw"]), "granule-channel records")

    # 2. re-encode the decoded wav (the clear pass) with stage capture
    ecap["enabled"] = True
    s.encode_wav_to_mp3(wav_path, clear_path, bitrate)
    ecap["enabled"] = False
    with open(clear_path, "rb") as f:
        clear_bytes = f.read()
    save_encode(os.path.join(GOLD, "encode_golden.npz"), clear_bytes)
    print("encode golden saved;", len(ecap["frames"]), "frames,", len(clear_bytes), "bytes")

    # 3. stego cases (bytes-level goldens only)
    msg_short = "ddd"
    msg_long = "the quick brown fox jumps!"  # 26 chars, fits in fixture capacity
    hid1 = os.path.join(WORK, "hidden1.mp3")
    hid2 = os.path.join(WORK, "hidden2.mp3")
    hid3 = os.path.join(WORK, "hidden3.mp3")
    tl1 = s.hide_message(FIXTURE, hid1, msg_short)
    tl2 = s.hide_message(FIXTURE, hid2, msg_long)
    tl3 = s.hide_message(FIXTURE, hid3, "ddd" * 100)
    assert tl1 is False and tl2 is False and tl3 is True, (tl1, tl2, tl3)

    rev1 = os.path.join(WORK, "rev1.txt")
    s.reveal_massage(hid1, rev1)
    with open(rev1) as f:
        assert f.read() == msg_short

    def rd(p):
        with open(p, "rb") as fh:
            return np.frombuffer(fh.read(), dtype=np.uint8)

    np.savez_compressed(
        os.path.join(GOLD, "stego_golden.npz"),
        wav_bytes=np.frombuffer(wav_bytes, dtype=np.uint8),
        hidden_short=rd(hid1),
        hidden_long=rd(hid2),
        hidden_toolong=rd(hid3),
        msg_short=np.frombuffer(msg_short.encode(), dtype=np.uint8),
        msg_long=np.frombuffer(msg_long.encode(), dtype=np.uint8),
        bits_short=np.frombuffer(
            str_to_binary_str(f"{len(msg_short)}#{msg_short}").encode(), dtype=np.uint8),
    )
    print("stego golden saved")


if __name__ == "__main__":
    main()
