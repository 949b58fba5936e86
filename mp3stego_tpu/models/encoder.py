"""WAV -> MP3 encoder: device-batched analysis/MDCT plane + exact host rate control.

Behavioural reference (bit-for-bit): /root/reference/mp3stego/encoder/
  MP3_Encoder.py (frame loop 596-650, iteration loop 760-815, scfsi 817-892,
  reservoir 894-931/1097-1145, outer/bin-search/inner 933-996/1064-1095,
  bitstream formatting 1266-1547) and encoder.py:8-58 (driver + too_long).

Architecture: the whole file's polyphase analysis + MDCT runs as ONE batched
device computation (ops/encode_plane.analysis_mdct — matmuls in exact Q31
fixed point). The rate-control search and bitstream serialization are
irregular/sequential (reservoir + stego-cursor carries, SURVEY.md §2.2) and run
on host with dense per-granule vector primitives (ops/quant). The stego channel
injects the Huffman pair transform at table-selection time exactly like the
reference (tables.TRANSFORM_HUF == IDX_TO_TRANSFORM_HUF, MP3_Encoder.py:419-449).
"""

import os
import sys

import numpy as np

from mp3stego_tpu import tables as T
from mp3stego_tpu.bitstream.bits import BitWriter
from mp3stego_tpu.ops import quant as Q
from mp3stego_tpu.utils.wav import WavFile, read_wav

_LN2 = 0.69314718  # the reference's constant (encoder/util.py:13), not log(2)

import functools as _ft  # noqa: E402


@_ft.lru_cache(maxsize=1)
def _huff_code_u32():
    return np.ascontiguousarray(T.HUFF_CODE.reshape(-1).astype(np.uint32))


@_ft.lru_cache(maxsize=1)
def _huff_len_u8():
    return np.ascontiguousarray(T.HUFF_LEN.reshape(-1).astype(np.uint8))


@_ft.lru_cache(maxsize=1)
def _linbits_i32():
    return np.ascontiguousarray(T.HUFF_LINBITS.astype(np.int32))


@_ft.lru_cache(maxsize=1)
def _slen1_i32():
    return np.ascontiguousarray(T.SLEN1_TAB.astype(np.int32))


@_ft.lru_cache(maxsize=1)
def _slen2_i32():
    return np.ascontiguousarray(T.SLEN2_TAB.astype(np.int32))


@_ft.lru_cache(maxsize=None)
def _band_row_i32(band_row):
    return np.ascontiguousarray(T.BAND_ALL[band_row].astype(np.int32))


def _init_rate_tables(lib) -> bool:
    """Initialize a loaded rate-search library's table globals (also used
    by tests on alternative builds, e.g. the forced-scalar .so)."""
    st, sti, i2i = T.loop_tables()
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    rc = lib.rate_tables_init(
        np.ascontiguousarray(st, np.float64), i32(sti), i32(i2i),
        i32(T.HUFF_LEN), i32(T.HUFF_XLEN), i32(T.HUFF_LINBITS),
        i32(T.HUFF_LINMAX), i32(Q._QLEN0), i32(Q._QLEN1),
        i32(T.BAND_ALL), T.BAND_ALL.size,
        i32(T.SUBDV_TABLE), i32(T.TRANSFORM_HUF))
    return rc == 0


@_ft.lru_cache(maxsize=1)
def _native_rate_lib():
    """The native rate-search twin (native/src/rate_search.cpp) with its
    table globals initialized, or None when the toolchain is unavailable.
    Bit-identical to the ops/quant NumPy primitives (integer math + IEEE
    sqrt only); pinned by tests/test_units.py::test_native_rate_search."""
    from mp3stego_tpu import native
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "rate_bin_search"):
        return None
    return lib if _init_rate_tables(lib) else None


_EMPTY_HIDE = np.zeros(1, np.uint8)


def _rate_lib():
    """The native search twin, honouring the MP3STEGO_TPU_NATIVE_RATE=0
    kill-switch (used by tests to pin native == NumPy byte-identity)."""
    if os.environ.get("MP3STEGO_TPU_NATIVE_RATE") == "0":
        return None
    return _native_rate_lib()


def _state_of(cod_info) -> np.ndarray:
    """GrInfo -> the int64[12] state layout shared with rate_search.cpp."""
    s = np.empty(12, np.int64)
    s[0] = cod_info.quantizerStepSize
    s[1] = cod_info.address1
    s[2] = cod_info.address2
    s[3] = cod_info.address3
    s[4] = cod_info.big_values
    s[5] = cod_info.count1
    s[6] = cod_info.count1table_select
    s[7] = cod_info.region0_count
    s[8] = cod_info.region1_count
    s[9:12] = cod_info.table_select
    return s


def _state_back(s: np.ndarray, cod_info):
    cod_info.quantizerStepSize = int(s[0])
    cod_info.address1 = int(s[1])
    cod_info.address2 = int(s[2])
    cod_info.address3 = int(s[3])
    cod_info.big_values = int(s[4])
    cod_info.count1 = int(s[5])
    cod_info.count1table_select = int(s[6])
    cod_info.region0_count = int(s[7])
    cod_info.region1_count = int(s[8])
    cod_info.table_select[:] = s[9:12]


_EN_TOT_KRIT = 10
_EN_DIF_KRIT = 100
_EN_SCFSI_BAND_KRIT = 10
_XM_SCFSI_BAND_KRIT = 10
_SCFSI_BAND_LONG = (0, 6, 11, 16, 21)


def _trim_fused_result(resF: dict, n: int) -> dict:
    """Slice a fused single-dispatch search result to the real lane count,
    copying the read-only fetched buffers (``_plane_redo`` patches rows in
    place). ``ixw`` is keyed by lane; ``_log_dev``/None entries (the lazy
    approx-log device refs, see search_plane._unpack_single) pass through."""
    out = {}
    for k, v in resF.items():
        if k == "ixw":
            out[k] = {lane: r for lane, r in v.items() if lane < n}
        elif k == "_log_dev" or v is None:
            out[k] = v
        else:
            out[k] = np.array(v[:n])
    return out


def _find_bitrate_index(bitrate: int, mpeg_version: int) -> int:
    for i in range(16):
        if bitrate == int(T.BIT_RATES[i][mpeg_version]):
            return i
    return -1


def _find_samplerate_index(samplerate: int) -> int:
    for i in range(9):
        if samplerate == int(T.SAMPLE_RATES[i]):
            return i
    return -1


def _find_mpeg_version(sr_idx: int) -> int:
    if sr_idx < 3:
        return 3  # MPEG-I
    if sr_idx < 6:
        return 2  # MPEG-II
    return 0      # MPEG-2.5


class MP3Encoder:
    """Encode a WavFile into MP3 bytes, optionally embedding a hidden bit string.

    :param wav_file: parsed WAV (utils.wav.read_wav).
    :param hide_str: bit string ('0'/'1' chars) to embed via Huffman-pair
        steganography; empty disables embedding.
    """

    def __init__(self, wav_file: WavFile, hide_str: str = "",
                 device_search: bool = True, lsf_compliant: bool = None,
                 vbr: bool = False):
        w = wav_file
        self.wav = w
        self.hide_str = hide_str
        # Constant-quality VBR (beyond the reference, which is CBR-only):
        # wav_file.bitrate becomes the TARGET AVERAGE rate. A device cost
        # grid evaluates every granule at all 128 quantizer steps, a global
        # step is picked whose whole-file cost best matches the target
        # average, and each frame then gets the smallest standard rate whose
        # budget clears that step's cost — constant quality, CBR-grade
        # frames where the audio is simple. The stream carries a Xing tag
        # (bitstream/vbr.py reads it back). Incompatible with hide_str: the
        # stego contract is defined on the reference's CBR layout.
        self.vbr = bool(vbr)
        if self.vbr and hide_str:
            raise ValueError("hide is defined on CBR streams only; "
                             "encode with vbr=False to embed a message")
        self._vbr_rate_idx = None        # (F,) int32, set by _vbr_framing
        # MPEG-2/2.5 only: write the ISO 13818-3 LSF side info correctly
        # (scale_fac_scale + count1table_select bits, byte-aligned frames)
        # instead of the reference's layout, which omits those 2 bits per
        # (gr, ch) and emits half-byte-misaligned frames no decoder can
        # fully read (count1 table choice is lost). Default stays reference-
        # byte-identical; opt in per call or via MP3STEGO_TPU_LSF_COMPLIANT=1.
        if lsf_compliant is None:
            lsf_compliant = os.environ.get(
                "MP3STEGO_TPU_LSF_COMPLIANT", "0") == "1"
        self.lsf_compliant = lsf_compliant
        self.hide_str_offset = 0
        # hide bits as 0/1 bytes for the native search twin
        self._hide_u8 = (np.frombuffer(hide_str.encode(), np.uint8)
                         - ord('0')).astype(np.uint8) if hide_str \
            else _EMPTY_HIDE
        # device-parallel all-steps costing (ops/quant_batch); False forces the
        # pure host search (oracle mode)
        self.device_search = device_search
        self._cost = None
        self._tg = 0
        self._frame_idx = 0
        self._nat_ser = None
        self._last_exact_step = None

        self.mode = w.mpeg_mode
        self.bitrate = w.bitrate
        self.emphasis = w.emphasis
        self.copyright = w.copyright
        self.original = w.original
        self.layer = 1          # header code for Layer III
        self.crc = 0
        self.ext = 0
        self.mode_ext = 0
        self.bits_per_slot = 8

        self.samplerate_index = _find_samplerate_index(w.samplerate)
        self.version = _find_mpeg_version(self.samplerate_index)
        self.bitrate_index = _find_bitrate_index(self.bitrate, self.version)
        self.granules_per_frame = 2 if self.version == 3 else 1
        # Band-table row for every engine (tables.BAND_ALL): the compliant
        # LSF writer uses the ISO/ecosystem rows (+9) so third-party decoders
        # map its serialized region counts back to the same sample
        # boundaries (the reference rows deviate at 16/24 kHz); the
        # reference-layout writer keeps the reference rows byte-for-byte.
        self.band_row = self.samplerate_index + (
            9 if (self.version != 3 and self.lsf_compliant) else 0)

        if self.version != 3 and self.lsf_compliant:
            # Exact rational slot arithmetic for the spec-valid LSF writer.
            # The reference's float formula loses the last ulp on exact-
            # integer slot counts (576/16000*6000 = 215.999...97), flipping
            # the padding chain so the header promises one more byte than
            # the frame carries — every decoder loses sync at frame 1. The
            # same float bug is behind the reference's documented 32k/192
            # MPEG-1 self-desync quirk, which the default layout reproduces
            # byte-for-byte (tests/test_multirate.py).
            num = self.granules_per_frame * 576 * 1000 * self.bitrate
            den = self.bits_per_slot * w.samplerate
            self.whole_slots_per_frame = num // den
            self.frac_slots_per_frame = (num % den) / den
        else:
            avg_slots_per_frame = (
                self.granules_per_frame * 576.0 / w.samplerate) * (
                1000.0 * self.bitrate / self.bits_per_slot)
            self.whole_slots_per_frame = int(avg_slots_per_frame)
            self.frac_slots_per_frame = (avg_slots_per_frame
                                         - self.whole_slots_per_frame)
        self.slot_lag = -self.frac_slots_per_frame
        self.padding = 0

        nch = w.num_of_channels
        if self.granules_per_frame == 2:
            self.side_info_len = 8 * ((4 + 17) if nch == 1 else (4 + 32))
        else:
            self.side_info_len = 8 * ((4 + 9) if nch == 1 else (4 + 17))

        self.resv_max = 0
        self.resv_size = 0.0
        self.scfsi = np.zeros((2, 4), dtype=np.int32)
        self.private_bits = 0
        self.resv_drain = 0
        # persistent per-(gr,ch) coding state (stale-field semantics preserved)
        self.gr_info = [[Q.GrInfo() for _ in range(2)] for _ in range(2)]
        self.scale_factor_l = np.zeros((2, 2, 22), dtype=np.int32)
        self.l3_enc = np.zeros((nch, 2, 576), dtype=np.int32)
        # per-channel scfsi energy state (reference L3Loop en/en_tot/xrmaxl)
        self.en_tot = np.zeros(2, dtype=np.int32)
        self.en = np.zeros((2, 21), dtype=np.int32)
        self.xrmaxl = np.zeros(2, dtype=np.int32)

        self.bw = BitWriter(4096)
        self.out_buffer = bytearray()

    # ------------------------------------------------------------------ encode

    def print_info(self):
        """Print info about the file about to be created (MP3_Encoder.py:581-594)."""
        version_names = ["2.5", "reserved", "II", "I"]
        mode_names = ["stereo", "joint-stereo", "dual-channel", "mono"]
        demp_names = ["none", "50/15us", "", "CITT"]
        print(f"MPEG-{version_names[self.version]} layer III, {mode_names[self.mode]}"
              f" Psychoacoustic Model: Shine")
        print(f"Bitrate: {self.bitrate} kbps ", end='')
        print(f"De-emphasis: {demp_names[self.emphasis]}\t"
              f"{'Original' if self.original else ''}\t"
              f"{'(C)' if self.copyright else ''}")
        print(f"Encoding \"{self.wav.file_path}\" to "
              f"\"{self.wav.file_path[:-3]}mp3\"\n")

    def _num_frames(self) -> int:
        samples_per_pass = self.granules_per_frame * 576 * self.wav.num_of_channels
        total = self.wav.num_of_samples * self.wav.num_of_channels
        return total // samples_per_pass + (1 if total % samples_per_pass else 0)

    def _channel_streams(self, num_frames: int) -> np.ndarray:
        """(nch, F*1152) int32<<16 streams. The reference's two-cursor interleaved
        stepping (WAV_Reader.py:160-164, buffer_pos starts {0:0,1:1}, +2 per read)
        reduces to stream[c, t] = buffer[c + 2t]."""
        return self._channel_streams_i16(num_frames).astype(np.int32) << 16

    def _channel_streams_i16(self, num_frames: int) -> np.ndarray:
        """(nch, F*1152) raw int16 streams — the device plane upshifts by 16
        on chip (encode_plane.analysis_mdct_i16), so the PCM upload crosses
        the link at half the bytes of the int32<<16 form.

        Mono reads at stride 1: the reference's feeder steps its cursor by 2
        regardless of channel count (WAV_Reader.py:160-164), which on mono
        input walks past the buffer and crashes partway through the file —
        there is no reference behavior to be byte-identical to, so mono
        encodes the actual samples instead of every other one (deliberate
        superset, see PARITY.md)."""
        nch = self.wav.num_of_channels
        need = num_frames * self.granules_per_frame * 576
        out = np.zeros((nch, need), dtype=np.int16)
        for c in range(nch):
            s = (self.wav.buffer if nch == 1
                 else self.wav.buffer[c::2])[:need]
            out[c, :len(s)] = s
        return out

    def encode(self, quiet: bool = True):
        """Encode the full file: one device pass for analysis+MDCT, then the
        rate-control search and bitstream serialization (MP3_Encoder.py:596-618).

        Engines, all byte-identical:
          * search plane (default): bisection + inner loop run ON DEVICE for
            all granules at once (ops/search_plane);
          * hide hybrid (default with ``hide_str``): sequential host search
            while the stego bit cursor is live (its position depends on every
            earlier granule's table choices), then the plane for the rest of
            the file;
          * cost grid (MP3STEGO_TPU_SEARCH_PLANE=0): all-steps device costing
            + sequential host replay (ops/quant_batch);
          * host oracle (``device_search=False``): pure NumPy reference twin.
        ``quiet=False`` shows frame progress and a per-stage timing report."""
        import os as _os

        from mp3stego_tpu.ops import encode_plane  # deferred jax import
        from mp3stego_tpu.utils.profiling import StageTimer, progress, trace
        timer = StageTimer(enabled=not quiet)
        num_frames = self._num_frames()
        if num_frames == 0:
            return
        if (self.device_search
                and _os.environ.get("MP3STEGO_TPU_SEARCH_PLANE", "1") != "0"):
            with trace():
                # engine order: measured cost model (utils/calibrate.py —
                # fully-host C++ wherever the link is the bottleneck;
                # MP3STEGO_TPU_ENC_HOST=1/0 keeps absolute priority), then
                # the device search plane
                from mp3stego_tpu.utils.calibrate import single_encode_engine
                done = False
                if single_encode_engine() == "host":
                    done = self._encode_host(num_frames, timer)
                if not done:
                    if self.hide_str:
                        # cursor-pinned parallel hide; the sequential-head
                        # hybrid only ever runs if the fixpoint fails to
                        # converge (MP3STEGO_TPU_HIDE_PARALLEL=0 forces it)
                        par = _os.environ.get(
                            "MP3STEGO_TPU_HIDE_PARALLEL", "1") != "0"
                        if not (par and self._encode_hide_parallel(
                                num_frames, timer)):
                            self._encode_hide_hybrid(num_frames, timer,
                                                     quiet)
                    else:
                        self._encode_plane(num_frames, timer)
            if self.vbr:
                self.out_buffer = (bytearray(self._xing_frame(num_frames))
                                   + self.out_buffer)
            if not quiet:
                timer.print_report()
            return
        with trace():
            with timer.stage("analysis+mdct (device)"):
                streams = self._channel_streams(num_frames)
                tg = num_frames * self.granules_per_frame
                # (nch, Tg, 576) int32, exact Q31
                mdct_all = encode_plane.run_analysis(streams, tg)

            if self.device_search:
                from mp3stego_tpu.ops import quant_batch as QB
                with timer.stage("step-cost grid (device)"):
                    self._cost = QB.cost_all_steps(
                        mdct_all.reshape(-1, 576), self.band_row,
                        with_hide=bool(self.hide_str))
                    self._tg = tg
            if self.vbr:
                # sets _vbr_rate_idx/_vbr_rates; _encode_frame reads them
                self._vbr_framing(mdct_all.reshape(-1, 576), num_frames)

            with timer.stage("rate control + serialize (host)"):
                for f in progress(range(num_frames), desc="encoding",
                                  enabled=not quiet):
                    self._frame_idx = f
                    mdct_frame = mdct_all[:, f * self.granules_per_frame:
                                          (f + 1) * self.granules_per_frame]
                    self._encode_frame(mdct_frame)
                    self.out_buffer += self.bw.take_frame()
                # final flush (MP3_Encoder.py:616-618)
                self.out_buffer += self.bw.take_frame()
        if self.vbr:
            self.out_buffer = (bytearray(self._xing_frame(num_frames))
                               + self.out_buffer)
        if not quiet:
            timer.print_report()

    # ---------------------------------------------------------- search plane

    def _encode_plane(self, num_frames: int, timer):
        """Whole-file encode via the device-resident search (ops/search_plane):
        analysis + rate-control search + final quantization never leave the
        device; the host verifies float-fallback cells, redoes flagged granules
        with the exact oracle, applies the reservoir chain and serializes.
        Byte-identical to the sequential path (tests/test_search_plane.py)."""
        from mp3stego_tpu.ops import encode_plane
        from mp3stego_tpu.ops import search_plane as SP

        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        tg = num_frames * gpf

        with timer.stage("analysis+mdct (device)"):
            streams = self._channel_streams_i16(num_frames)
            mdct_dev = encode_plane.run_analysis_device(streams, tg)
            xr_dev = mdct_dev.reshape(-1, 576)   # lane g = ch*tg + f*gpf + gr

        paddings, mean_bits_f = self._framing(xr_dev, num_frames)
        maxb_f = np.minimum(np.asarray(mean_bits_f, np.int64) // nch,
                            Q.MAX_BITS_ALLOWANCE)
        max_bits_lanes = np.tile(np.repeat(maxb_f, gpf), nch).astype(np.int32)

        en_tot_raw = en_raw = None
        n = tg * nch
        fuse_budget = int(os.environ.get("MP3STEGO_TPU_BATCH_ENC_LANES",
                                         "49152"))
        n_pad = -(-max(n, 1) // 2048) * 2048
        if n_pad <= fuse_budget:
            # whole file in ONE dispatch (search + scfsi sums), padded to a
            # 2048-lane bucket so file length doesn't recompile
            import jax.numpy as jnp
            with timer.stage("rate search+scfsi (device, fused)"):
                if n_pad > n:
                    xr_s = jnp.pad(xr_dev, ((0, n_pad - n), (0, 0)))
                    mb_s = np.concatenate(
                        [max_bits_lanes, np.zeros(n_pad - n, np.int32)])
                else:
                    xr_s, mb_s = xr_dev, max_bits_lanes
                resF, scf = SP.search_single_fused(
                    xr_s, mb_s, self.band_row,
                    want_scfsi=self.version == 3)
            # copies: fetched buffers are read-only, _plane_redo patches rows
            res = _trim_fused_result(resF, n)
            if scf is not None:
                en_tot_raw, en_raw = scf[0][:n], scf[1][:n]
        else:
            with timer.stage("rate search (device)"):
                res = SP.search_all(xr_dev, max_bits_lanes, self.band_row)
            if self.version == 3:
                with timer.stage("scfsi sums (device)"):
                    en_tot_raw, en_raw = SP.scfsi_sums(xr_dev,
                                                       self.band_row)
        with timer.stage("verify+redo (host)"):
            self._plane_redo(res, xr_dev, max_bits_lanes, tg)
        with timer.stage("assemble+serialize (host)"):
            self._plane_finish(res, en_tot_raw, en_raw, num_frames, paddings,
                               mean_bits_f, tg)

    def _encode_host(self, num_frames: int, timer) -> bool:
        """Fully-host encode engine: C++ analysis plane + C++ sequential
        whole-file rate search (reference frame order, live stego cursor,
        per-slot stale-address chains) + batched C serializer. Spectra never
        cross the device link — on hosts with a slow or high-latency link
        this beats the device plane for single streams; byte-identical to both. Returns
        False when the native library is unavailable (callers fall back)."""
        from mp3stego_tpu.ops import encode_plane

        lib = _native_rate_lib()
        if lib is None or not hasattr(lib, "rate_search_file"):
            return False
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        tg = num_frames * gpf

        with timer.stage("analysis+mdct (host C++)"):
            streams = self._channel_streams_i16(num_frames)
            xr = encode_plane.run_analysis_native(streams, tg)
            if xr is None:
                return False
            xr = np.ascontiguousarray(xr.reshape(-1, 576))

        paddings, mean_bits_f = self._framing(xr, num_frames)
        maxb_f = np.minimum(np.asarray(mean_bits_f, np.int64) // nch,
                            Q.MAX_BITS_ALLOWANCE)
        max_bits_lanes = np.tile(np.repeat(maxb_f, gpf), nch).astype(np.int32)

        with timer.stage("rate search (host C++)"):
            lanes = nch * tg
            raw = np.zeros((lanes, 12), np.int64)
            ix = np.zeros((lanes, 576), np.int32)
            en_tot = np.zeros(lanes, np.int32)
            en21 = np.zeros((lanes, 21), np.int32)
            lib.rate_search_file(
                xr, max_bits_lanes, nch, tg, gpf,
                self.band_row * 23,
                self._hide_u8, len(self.hide_str), self.hide_str_offset,
                raw, ix, en_tot, en21,
                np.zeros(2 * 2 * 12, np.int64),
                np.zeros(2 * 2 * 576, np.int32), 0)
            res = {k: np.ascontiguousarray(raw[:, c]) for c, k in enumerate(
                ("step", "bits", "bv", "c1", "cts", "r0c", "r1c",
                 "ch0", "ch1", "ch2", "xrmax0"))}
            res["ix"] = ix
        with timer.stage("assemble+serialize (host)"):
            self._plane_finish(res, en_tot if self.version == 3 else None,
                               en21 if self.version == 3 else None,
                               num_frames, paddings, mean_bits_f, tg)
        return True

    def _plane_framing(self, num_frames: int):
        """Per-frame padding + mean_bits — the data-independent preamble of
        _encode_frame (MP3_Encoder.py:630-641), run for the whole file."""
        paddings = []
        mean_bits_f = []
        for _ in range(num_frames):
            if self.frac_slots_per_frame:
                self.padding = 1 if self.slot_lag <= (
                    self.frac_slots_per_frame - 1.0) else 0
                self.slot_lag += self.padding - self.frac_slots_per_frame
            paddings.append(self.padding)
            bits_per_frame = 8 * (self.whole_slots_per_frame + self.padding)
            mean_bits_f.append(int((bits_per_frame - self.side_info_len)
                                   / self.granules_per_frame))
        return paddings, mean_bits_f

    # ------------------------------------------------------------------ VBR

    def _frame_rate_indices(self, nf: int) -> np.ndarray:
        """Per-frame header bitrate indices for the serializer: the VBR
        choice when set, else the constant CBR index."""
        if self._vbr_rate_idx is not None:
            return self._vbr_rate_idx.astype(np.int32)
        return np.full(nf, self.bitrate_index, np.int32)

    def _vbr_valid_rates(self):
        """Ascending valid Layer III rates (kbps) for this MPEG version."""
        from mp3stego_tpu import tables as T
        return [int(r[self.version]) for r in T.BIT_RATES
                if int(r[self.version]) > 0]

    def _vbr_slots(self, rate_kbps: int) -> int:
        """Whole slots per frame at ``rate_kbps`` (padding-free VBR frame)."""
        return int((self.granules_per_frame * 576.0 / self.wav.samplerate)
                   * (1000.0 * rate_kbps / self.bits_per_slot))

    def _vbr_framing(self, xr: np.ndarray, num_frames: int):
        """Constant-quality VBR framing (beyond the reference, CBR-only).

        A single global quantizer step s* is chosen (by bisection over the
        monotone whole-file cost) whose slot total best matches the
        target-average rate (``wav.bitrate``); each frame then gets the
        smallest standard rate whose per-cell budget clears that step's cost
        — constant quality across the file, with quiet frames dropping to
        cheap rates and dense frames rising toward 320. Frames use
        padding=0 (size fully determined by their own header). Returns
        (paddings, mean_bits_f) and records the per-frame header indices in
        ``self._vbr_rate_idx``.

        The per-step lane costs come from the AVX-512 C++ pass
        (``rate_cost_step``, ~8 ms per visited step for a 30 s stereo file)
        when the native library builds, else from the device cost grid
        (ops/quant_batch — exact but gather-heavy). The bisection
        visits the same steps either way; the two sources agree except on
        the rare quantize-float-fallback lanes (the grid's f32 approximation
        of the reference's f64 expression), where a frame may land one rate
        notch apart — both outcomes are valid, deterministic per host.
        """
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        tg = num_frames * gpf
        lanes_n = nch * tg
        big = np.int64(1) << 20
        sr_off = self.band_row * 23

        xr_np = None
        lib = _native_rate_lib()
        grid = [self._cost] if (self._cost is not None
                                and self._tg == tg) else []

        def lane_bits(s: int) -> np.ndarray:
            """Exact bits to code each lane at grid step s (big = the
            search's ixmax<=8192 gate fails there)."""
            nonlocal xr_np
            if lib is not None and hasattr(lib, "rate_cost_step"):
                if xr_np is None:
                    xr_np = np.ascontiguousarray(
                        np.asarray(xr).reshape(-1, 576), np.int32)
                out = np.empty(lanes_n, np.int64)
                lib.rate_cost_step(xr_np, lanes_n, s - 127, sr_off, big, out)
                return out
            if not grid:
                from mp3stego_tpu.ops import quant_batch as QB
                grid.append(QB.cost_all_steps(np.ascontiguousarray(
                    np.asarray(xr).reshape(-1, 576)), self.band_row))
            c = grid[0]
            return np.where(
                c["bail"][:, s] | (c["ixmax"][:, s] > Q.MAX_QUANTIZE_STEP),
                big, c["bits_total"][:, s].astype(np.int64))

        rates = self._vbr_valid_rates()
        slots = np.array([self._vbr_slots(r) for r in rates], np.int64)
        budgets = np.array(
            [min(int((8 * s - self.side_info_len) / gpf) // nch,
                 Q.MAX_BITS_ALLOWANCE) for s in slots], np.int64)

        cache = {}

        def plan(s: int):
            """(slot total, per-frame rate choice) at grid step s."""
            if s not in cache:
                need = lane_bits(s).reshape(nch, num_frames, gpf) \
                    .max(axis=(0, 2))
                ridx = np.minimum(np.searchsorted(budgets, need),
                                  len(rates) - 1)
                cache[s] = (int(slots[ridx].sum()), ridx)
            return cache[s]

        target = num_frames * (gpf * 576.0 / self.wav.samplerate) * (
            1000.0 * self.bitrate / self.bits_per_slot)
        # cost is non-increasing in s (coarser step -> fewer bits): bisect
        # the crossing, then take the best of the crossing's neighborhood
        lo, hi = 0, 127
        while lo < hi:
            mid = (lo + hi) // 2
            if plan(mid)[0] > target:
                lo = mid + 1
            else:
                hi = mid
        s_star = min((s for s in (lo - 1, lo, lo + 1) if 0 <= s <= 127),
                     key=lambda s: (abs(plan(s)[0] - target), s))
        self._vbr_step = s_star
        chosen = plan(s_star)[1]                         # (F,) rate index
        self._vbr_rate_idx = np.array(
            [_find_bitrate_index(rates[i], self.version) for i in
             range(len(rates))], np.int32)[chosen]
        self._vbr_rates = np.asarray(rates, np.int64)[chosen]
        mean_bits_f = [int((8 * int(slots[i]) - self.side_info_len) / gpf)
                       for i in chosen]
        return [0] * num_frames, mean_bits_f

    def _framing(self, xr, num_frames: int):
        """Engine-facing framing: VBR when requested, else the reference's
        CBR padding/slot-lag machinery."""
        if self.vbr:
            return self._vbr_framing(xr, num_frames)
        return self._plane_framing(num_frames)

    def _xing_frame(self, num_frames: int) -> bytes:
        """Build the Xing tag frame for a VBR stream (bitstream/vbr.py is
        the reader): fourcc + flags + frames + bytes + 100-point TOC +
        quality, inside the smallest valid silent frame that fits it."""
        from mp3stego_tpu.bitstream.bits import BitWriter

        si = 32 if (self.version == 3 and self.wav.num_of_channels == 2) \
            else 17 if (self.version == 3
                        or self.wav.num_of_channels == 2) else 9
        payload = 4 + 4 + 4 + 4 + 100 + 4     # fourcc/flags/frames/bytes/toc/q
        rates = self._vbr_valid_rates()
        tag_rate = next((r for r in rates
                         if self._vbr_slots(r) >= 4 + si + payload),
                        rates[-1])
        size = self._vbr_slots(tag_rate)

        bw = BitWriter()
        bw.put(0x7FF, 11)
        bw.put(self.version, 2)
        bw.put(self.layer, 2)
        bw.put(0 if self.crc else 1, 1)
        bw.put(_find_bitrate_index(tag_rate, self.version), 4)
        bw.put(self.samplerate_index % 3, 2)
        bw.put(0, 1)                          # padding
        bw.put(self.ext, 1)
        bw.put(self.mode, 2)
        bw.put(self.mode_ext, 2)
        bw.put(self.copyright, 1)
        bw.put(self.original, 1)
        bw.put(self.emphasis, 2)
        head = bytes(bw.take_frame())
        assert len(head) == 4

        # a Layer III slot is one byte: frame bytes == slots (padding-free).
        # The byte count comes from the buffer, not the slot sum: the final
        # flush drops residual cache bits (reference quirk), so the last
        # frame on disk can be up to 3 bytes short.
        frame_sizes = np.asarray(
            [self._vbr_slots(int(r)) for r in self._vbr_rates], np.int64)
        total_bytes = size + len(self.out_buffer)
        # 100-point TOC: byte offset (scaled to 0..255) of the frame at each
        # percent of stream time
        starts = size + np.concatenate([[0], np.cumsum(frame_sizes)[:-1]])
        pick = (np.arange(100, dtype=np.int64) * num_frames) // 100
        toc = np.minimum(255, (256 * starts[pick]) // total_bytes) \
            .astype(np.uint8)

        buf = bytearray(size)
        buf[0:4] = head
        pos = 4 + si
        buf[pos:pos + 4] = b"Xing"
        import struct as _struct
        _struct.pack_into(">I", buf, pos + 4, 0xF)          # all fields
        _struct.pack_into(">I", buf, pos + 8, num_frames)
        _struct.pack_into(">I", buf, pos + 12, total_bytes)
        buf[pos + 16:pos + 116] = toc.tobytes()
        _struct.pack_into(">I", buf, pos + 116,
                          min(100, int(round(100 * self._vbr_step / 127))))
        return bytes(buf)

    # finer observability for the verify+redo pass: cumulative wall-clock of
    # the device gather / host cell verification / host redo oracle across
    # the most recent encode (read next to last_hide_parallel_stats)
    last_redo_split = None

    def _plane_redo(self, res: dict, xr_dev, max_bits_lanes, tg: int,
                    addr_seed=None, hide_ctx=None) -> int:
        """Verify float-fallback (approx) evaluations against the exact host
        formula and redo flagged granules with the sequential oracle, carrying
        true cross-granule address state per (gr, ch) slot. ``hide_ctx`` =
        (bits_u8, per-lane cursors) threads the stego transform state through
        both the cell verification and the redo oracle (parallel-hide mode)."""
        from mp3stego_tpu.ops import quant_np
        from mp3stego_tpu.ops import search_plane as SP

        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        import time as _time
        split = {"lanes_gathered": 0, "gather_ms": 0.0, "verify_ms": 0.0,
                 "redo_lanes": 0, "redo_ms": 0.0}
        MP3Encoder.last_redo_split = split
        redo = res["flags"] != 0
        nlog = np.minimum(res["nlog"], SP.S_MAXLOG)
        verify = (nlog > 0) & ~redo
        need = np.flatnonzero(verify | redo)
        if len(need) == 0:
            return 0
        # ONE device round trip for everything this pass might touch:
        # spectra rows + approx logs for the verify AND flag-redo lanes
        # (verification failures only ever add lanes already in the verify
        # set, so their rows are covered too). Each extra device call would
        # cost its full dispatch+sync latency.
        t0 = _time.perf_counter()
        if res.get("_log_dev") is not None:
            rows_all, ls_g, lb_g = SP.fetch_rows_logs(
                xr_dev, *res["_log_dev"], need)
        else:
            rows_all = SP.fetch_rows(xr_dev, need)
            ls_g = res["log_steps"][need]
            lb_g = res["log_bits"][need]
        split["lanes_gathered"] = int(len(need))
        split["gather_ms"] = round(
            (_time.perf_counter() - t0) * 1e3, 1)
        pos_of = np.full(len(res["flags"]), -1, np.int64)
        pos_of[need] = np.arange(len(need))
        if verify.any():
            t0 = _time.perf_counter()
            lanes = np.flatnonzero(verify)
            reps = nlog[lanes]
            cell_lane = np.repeat(lanes, reps)
            cell_j = np.concatenate([np.arange(r) for r in reps])
            steps = ls_g[pos_of[cell_lane], cell_j]
            dbits = lb_g[pos_of[cell_lane], cell_j]
            rows = rows_all[pos_of[cell_lane]]
            if hide_ctx is None:
                hbits, hbvs = quant_np.verify_cells(rows, steps,
                                                    self.band_row)
            else:
                hbits, hbvs = quant_np.verify_cells_hide(
                    rows, steps, self.band_row,
                    hide_ctx[0], hide_ctx[1][cell_lane])
            bad = (hbits != dbits) | (hbvs <= 0)
            if bad.any():
                redo[np.unique(cell_lane[bad])] = True
            split["verify_cells"] = int(len(cell_lane))
            split["verify_ms"] = round(
                (_time.perf_counter() - t0) * 1e3, 1)

        lanes = np.flatnonzero(redo)
        if len(lanes) == 0:
            return 0
        t0 = _time.perf_counter()
        rowmap = {int(l): rows_all[pos_of[l]] for l in lanes}
        searched = res["xrmax0"] == 0
        nf = tg // gpf
        for ch in range(nch):
            for gr in range(gpf):
                addr = (0, 0, 0) if addr_seed is None else \
                    tuple(int(a) for a in addr_seed[gr, ch])
                for f in range(nf):
                    g = ch * tg + f * gpf + gr
                    if g in rowmap:
                        hide = None if hide_ctx is None else \
                            (hide_ctx[0], int(hide_ctx[1][g]))
                        r = quant_np.oracle_search(
                            rowmap[g], int(max_bits_lanes[g]), addr,
                            self.band_row, hide=hide)
                        for k in ("step", "bits", "bv", "c1", "a1", "a2",
                                  "a3", "r0c", "r1c", "cts"):
                            res[k][g] = r[k]
                        res["ch0"][g], res["ch1"][g], res["ch2"][g] = r["ch"]
                        if res["ix"].dtype == np.int8:
                            # int8 wire plane: redone rows go in as patches
                            res.setdefault("ixw", {})[g] = \
                                np.asarray(r["ix"], np.int32)
                        else:
                            res["ix"][g] = r["ix"]
                        addr = (r["a1"], r["a2"], r["a3"])
                    elif searched[g]:
                        addr = (int(res["a1"][g]), int(res["a2"][g]),
                                int(res["a3"][g]))
        split["redo_lanes"] = int(len(lanes))
        split["redo_ms"] = round((_time.perf_counter() - t0) * 1e3, 1)
        return len(lanes)

    def _plane_scfsi(self, tot_raw, en_raw, searched, nf: int, tg: int):
        """Vectorized _calc_scfsi (MP3_Encoder.py:817-892) from the device's
        int32 energy sums: the int-truncated log2 energies and the four
        band criteria, per (frame, ch). Returns (nf, ch, 4) int32."""
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        with np.errstate(all="ignore"):
            vals = np.log(tot_raw.astype(np.float64) * 4.768371584e-7) / _LN2
            en_tot = np.where(tot_raw != 0, vals, 0.0).astype(np.int32)
            vv = np.log(en_raw.astype(np.float64) * 4.768371584e-7) / _LN2
            en = np.where(en_raw != 0, vv, 0.0).astype(np.int32)
        et = en_tot.reshape(nch, nf, gpf)
        eb = en.reshape(nch, nf, gpf, 21)
        xm = searched.reshape(nch, nf, gpf)
        cond = (2 + xm[..., 0].astype(np.int64) + xm[..., 1].astype(np.int64)
                + (np.abs(et[..., 0].astype(np.int64) - et[..., 1])
                   < _EN_TOT_KRIT)
                + (np.abs(eb[..., 0, :].astype(np.int64)
                          - eb[..., 1, :]).sum(-1) < _EN_DIF_KRIT))
        scfsi = np.zeros((nch, nf, 4), np.int32)
        for b in range(4):
            s, e = _SCFSI_BAND_LONG[b], _SCFSI_BAND_LONG[b + 1]
            d = np.abs(eb[..., 0, s:e].astype(np.int64)
                       - eb[..., 1, s:e]).sum(-1)
            scfsi[..., b] = d < _EN_SCFSI_BAND_KRIT
        scfsi = np.where((cond == 6)[..., None], scfsi, 0)
        return scfsi.transpose(1, 0, 2)

    def _plane_finish(self, res: dict, en_tot_raw, en_raw, nf: int, paddings,
                      mean_bits_f, tg: int, step_seed=None):
        """Reservoir chain, stuffing, scfsi, global-gain slot chain and frame
        serialization from the plane's per-granule results."""
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        searched = res["xrmax0"] == 0

        # the stego cursor advances even when not hiding (MP3_Encoder.py:808)
        self.hide_str_offset += int(
            (res["ch0"][searched] > 0).sum() + (res["ch1"][searched] > 0).sum()
            + (res["ch2"][searched] > 0).sum())

        scfsi_f = None
        if self.version == 3:
            scfsi_f = self._plane_scfsi(en_tot_raw, en_raw, searched, nf, tg)

        # global_gain: quantizerStepSize persists per (gr, ch) slot across
        # frames, so skipped (xrmax==0) granules reuse the last searched step
        steps = res["step"].reshape(nch, nf, gpf)
        smask = searched.reshape(nch, nf, gpf)
        last = np.where(smask, np.arange(nf)[None, :, None], -1)
        np.maximum.accumulate(last, axis=1, out=last)
        seed = np.zeros((nch, 1, gpf), np.int64) if step_seed is None \
            else step_seed.reshape(nch, 1, gpf)
        carried = np.where(
            last >= 0,
            np.take_along_axis(steps, np.maximum(last, 0), axis=1), seed)
        gg = carried + 210

        # reservoir chain + stuffing (exact float order, MP3_Encoder.py:812,
        # 1097-1145); stuffing mutates the serialized part2_3_length
        p23 = res["bits"].astype(np.float64)
        for f in range(nf):
            mb = mean_bits_f[f]
            self.mean_bits = mb
            for ch in range(nch):
                for gr in range(gpf):
                    g = ch * tg + f * gpf + gr
                    self.resv_size += (mb / nch) - float(res["bits"][g])
            if nch == 2 and (mb & 1):
                self.resv_size += 1
            over = max(0.0, self.resv_size - self.resv_max)
            self.resv_size -= over
            stuffing = over
            over = self.resv_size % 8
            if over:
                stuffing += over
                self.resv_size -= over
            if stuffing:
                g00 = f * gpf
                if p23[g00] + stuffing < Q.MAX_BITS_ALLOWANCE:
                    p23[g00] += stuffing
                else:
                    for gr in range(gpf):
                        for ch in range(nch):
                            g = ch * tg + f * gpf + gr
                            if not stuffing:
                                break
                            extra = Q.MAX_BITS_ALLOWANCE - p23[g]
                            bits_this = min(extra, stuffing)
                            p23[g] += bits_this
                            stuffing -= bits_this
                    self.resv_drain = stuffing  # never serialized (ref quirk)

        # serialize: one batched native call for the whole file when the C
        # library is available, else the per-frame python writers
        ix_l = res["ix"].reshape(nch, nf, gpf, 576)
        from mp3stego_tpu import native
        lib = native.get_lib()
        if (lib is not None and hasattr(lib, "mp3_format_frames")
                and not (self.version != 3 and self.lsf_compliant)):
            # (the C serializer writes the reference's LSF layout; compliant
            # LSF mode uses the python writers)
            self._plane_serialize_native(lib, res, p23, gg, scfsi_f, paddings,
                                         ix_l, nf, tg)
            return

        zeros_mdct = np.zeros((nch, gpf, 576), np.int32)
        patches = {}
        for g, row in res.get("ixw", {}).items():
            ch_, rem = divmod(int(g), tg)
            f_, gr_ = divmod(rem, gpf)
            patches.setdefault(f_, []).append((ch_, gr_, row))
        for f in range(nf):
            self.padding = int(paddings[f])
            if self._vbr_rate_idx is not None:
                self.bitrate_index = int(self._vbr_rate_idx[f])
            if self.version == 3:
                for ch in range(nch):
                    self.scfsi[ch, :4] = scfsi_f[f, ch]
            for gr in range(gpf):
                for ch in range(nch):
                    g = ch * tg + f * gpf + gr
                    gi = self.gr_info[gr][ch]
                    gi.part2_3_length = p23[g]
                    gi.big_values = int(res["bv"][g])
                    gi.count1 = int(res["c1"][g])
                    gi.global_gain = int(gg[ch, f, gr])
                    gi.scale_fac_compress = 0
                    gi.region0_count = int(res["r0c"][g])
                    gi.region1_count = int(res["r1c"][g])
                    gi.preflag = 0
                    gi.scale_fac_scale = 0
                    gi.count1table_select = int(res["cts"][g])
                    gi.part2_length = 0
                    gi.table_select[0] = int(res["ch0"][g])
                    gi.table_select[1] = int(res["ch1"][g])
                    gi.table_select[2] = int(res["ch2"][g])
            # l3_enc always carries 2 granule slots: the serializer indexes
            # (ch*2+gr)*576 regardless of granules_per_frame (C twin layout)
            l3 = np.zeros((nch, 2, 576), np.int32)
            l3[:, :gpf] = ix_l[:, f]
            for ch_, gr_, row in patches.get(f, ()):
                l3[ch_, gr_] = row
            self.l3_enc = l3
            self._format_bitstream(zeros_mdct)
            self.out_buffer += self.bw.take_frame()
        self.out_buffer += self.bw.take_frame()

    def _plane_serialize_native(self, lib, res, p23, gg, scfsi_f, paddings,
                                ix_l, nf, tg):
        """Whole-file serialization in ONE C call (mp3_format_frames): all
        per-frame side info is assembled as vectorized arrays, so no Python
        per-frame loop remains on the encode path."""
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels

        def lanes_to_fgc(a):
            # (nch*tg,) lane layout -> (nf, gpf, nch)
            return np.moveaxis(a.reshape(nch, nf, gpf), 0, 2)

        gi = np.zeros((nf, 2, 2, 11), np.int64)
        gi[:, :gpf, :nch, 0] = lanes_to_fgc(p23).astype(np.int64)
        gi[:, :gpf, :nch, 1] = lanes_to_fgc(res["bv"])
        gi[:, :gpf, :nch, 2] = np.moveaxis(gg, 0, 2)
        gi[:, :gpf, :nch, 4] = lanes_to_fgc(res["r0c"])
        gi[:, :gpf, :nch, 5] = lanes_to_fgc(res["r1c"])
        gi[:, :gpf, :nch, 8] = lanes_to_fgc(res["cts"])
        gi[:, :gpf, :nch, 9] = lanes_to_fgc(res["c1"])

        ts = np.zeros((nf, 2, 2, 3), np.int32)
        for r, key in enumerate(("ch0", "ch1", "ch2")):
            ts[:, :gpf, :nch, r] = lanes_to_fgc(res[key])
        sfl = np.zeros((nf, 2, 2, 22), np.int32)
        scfsi = np.zeros((nf, 2, 4), np.int32)
        if self.version == 3 and scfsi_f is not None:
            scfsi[:, :nch] = scfsi_f[:, :nch]
        l3 = np.zeros((nf, 2, 2, 576), np.int32)
        l3[:, :nch, :gpf] = np.moveaxis(ix_l, 0, 1)
        # wide (linbits-scale) and redone lanes: patch the int32 staging
        # buffer (the int8 wire plane clips them; see search_plane.dense_ix)
        for g, row in res.get("ixw", {}).items():
            ch_, rem = divmod(int(g), tg)
            f_, gr_ = divmod(rem, gpf)
            l3[f_, ch_, gr_] = row

        out = np.zeros(nf * 2016 + 4096, np.uint8)
        # continue the persistent 32-bit bitstream cache when a sequential
        # head already serialized frames (hide hybrid): up to 3 of its bytes
        # are still cached and flush into the first tail word. Residual bits
        # at EOF are dropped — the reference's __flush does the same
        # (MP3_Encoder.py:1549-1552).
        if self._nat_ser and getattr(self, "_nat_cache", None) is not None:
            cache, cache_bits = self._nat_cache, self._nat_cache_bits
        else:
            cache = np.zeros(1, dtype=np.uint32)
            cache_bits = np.full(1, 32, dtype=np.int32)
        written = lib.mp3_format_frames(
            cache, cache_bits, out, len(out), nf,
            self.version, self.layer, self.crc,
            np.ascontiguousarray(self._frame_rate_indices(nf)),
            self.samplerate_index % 3,
            np.ascontiguousarray(np.asarray(paddings, np.int32)),
            self.ext, self.mode, self.mode_ext, self.copyright,
            self.original, self.emphasis, self.private_bits, nch, gpf,
            np.ascontiguousarray(scfsi.reshape(-1)),
            np.ascontiguousarray(gi.reshape(-1)),
            np.ascontiguousarray(ts.reshape(-1)),
            np.ascontiguousarray(sfl.reshape(-1)),
            _slen1_i32(), _slen2_i32(),
            np.ascontiguousarray(l3.reshape(-1)),
            _huff_code_u32(), _huff_len_u8(), _linbits_i32(),
            _band_row_i32(self.band_row))
        if written < 0:
            raise RuntimeError("native serializer buffer overflow")
        self.out_buffer += out[:written].tobytes()

    # observability: the parallel hide's fixpoint record for the most recent
    # run in this process (read by bench.py; VERDICT r3 item 4 convergence
    # data). {"fused": one-program A+pin+B path taken, "extra_rounds": pass-B
    # re-pin rounds beyond the first search, "lanes": granule lanes}.
    last_hide_parallel_stats = None

    def _encode_hide_parallel(self, num_frames: int, timer) -> bool:
        """Parallel hide: the WHOLE file searched on device with a live stego
        cursor, no sequential head (VERDICT r2 item 1 / SURVEY §7.3).

        The only cross-granule coupling the stego channel adds is the
        embedded-bit cursor: granule G's cursor position is the count of
        nonzero table selections in every earlier granule (reference order
        f▸ch▸gr, MP3_Encoder.py:808-809). Since the pair transform never
        zeroes a table (and never un-zeroes one), those counts are almost
        always the same with and without the transform — so:

          A. search every granule WITHOUT the transform (existing plane),
          B. prefix-sum the region counts to pin every granule's cursor,
             then re-search every granule WITH the transform at its pinned
             cursor (ops/search_plane hide mode) — fully parallel,
          C. verify the counts the transformed searches produced; where a
             count changed (the transformed table altered the rate-loop
             trajectory enough to change region structure), re-pin and
             repeat. Converges in 1 extra round on real audio; bails to the
             sequential-head hybrid if it somehow does not.

        Returns True when the file was encoded; False = state untouched,
        caller falls back."""
        import contextlib

        from mp3stego_tpu.ops import encode_plane
        from mp3stego_tpu.ops import search_plane as SP
        from mp3stego_tpu.utils.profiling import StageTimer

        # always-on local stage timer: the split lands in
        # last_hide_parallel_stats["stage_ms"] (bench records it per round)
        # even when the caller's timer is quiet-disabled
        tloc = StageTimer(enabled=True)

        @contextlib.contextmanager
        def st(name):
            with timer.stage(name), tloc.stage(name):
                yield

        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        tg = num_frames * gpf
        snap = (self.padding, self.slot_lag, self.hide_str_offset)

        with st("analysis+mdct (device)"):
            streams = self._channel_streams_i16(num_frames)
            mdct_dev = encode_plane.run_analysis_device(streams, tg)
            xr_dev = mdct_dev.reshape(-1, 576)

        paddings, mean_bits_f = self._plane_framing(num_frames)
        maxb_f = np.minimum(np.asarray(mean_bits_f, np.int64) // nch,
                            Q.MAX_BITS_ALLOWANCE)
        max_bits_lanes = np.tile(np.repeat(maxb_f, gpf),
                                 nch).astype(np.int32)

        # reference cursor order (f, ch, gr); lane layout g = ch*tg + f*gpf+gr
        lanes_in_order = (np.arange(num_frames)[:, None, None] * gpf
                          + np.arange(nch)[None, :, None] * tg
                          + np.arange(gpf)[None, None, :]).reshape(-1)
        off0 = self.hide_str_offset

        def counts_of(res):
            return ((res["ch0"] > 0).astype(np.int64)
                    + (res["ch1"] > 0) + (res["ch2"] > 0))

        def pin(counts):
            co = counts[lanes_in_order]
            cur_o = off0 + np.concatenate([[0], np.cumsum(co[:-1])])
            cur = np.empty(tg * nch, np.int64)
            cur[lanes_in_order] = cur_o
            return cur.astype(np.int32)

        res = None
        en_tot_raw = en_raw = None
        scf = None
        converged = False
        n = tg * nch
        # round 0: pass A + cursor pinning + pass B + scfsi as ONE device
        # program (search_plane.search_hide_fused) when the file fits one
        # dispatch's lane budget; pass A's planes never cross the link.
        fuse_budget = int(os.environ.get("MP3STEGO_TPU_BATCH_ENC_LANES",
                                         "49152"))
        n_pad = -(-max(n, 1) // 2048) * 2048
        if n_pad <= fuse_budget:
            import jax.numpy as jnp
            with st("hide fused A+pin+B+scfsi (device)"):
                if n_pad > n:
                    xr_s = jnp.pad(xr_dev, ((0, n_pad - n), (0, 0)))
                    mb_s = np.concatenate(
                        [max_bits_lanes, np.zeros(n_pad - n, np.int32)])
                    order = np.concatenate(
                        [lanes_in_order, np.arange(n, n_pad)])
                else:
                    xr_s, mb_s, order = xr_dev, max_bits_lanes, lanes_in_order
                resF, cur_h, scf = SP.search_hide_fused(
                    xr_s, mb_s, self.band_row, self._hide_u8, order, off0,
                    want_scfsi=self.version == 3)
            # copies: the fetched buffers are read-only and _plane_redo
            # patches rows in place
            res = _trim_fused_result(resF, n)
            cursors = cur_h[:n]
            with st("verify+redo (host)"):
                self._plane_redo(res, xr_dev, max_bits_lanes, tg,
                                 hide_ctx=(self._hide_u8, cursors))
            cur2 = pin(counts_of(res))
            converged = np.array_equal(cur2, cursors)
            cursors = cur2
        else:
            with st("hide pass A (device, no transform)"):
                resA = SP.search_all(xr_dev, max_bits_lanes,
                                     self.band_row)
            cursors = pin(counts_of(resA))

        rounds = 0
        while not converged and rounds < 8:
            rounds += 1
            with st("hide pass B (device, pinned cursors)"):
                res = SP.search_all(xr_dev, max_bits_lanes,
                                    self.band_row,
                                    hide_bits=self._hide_u8,
                                    hide_cur=cursors)
            with st("verify+redo (host)"):
                self._plane_redo(res, xr_dev, max_bits_lanes, tg,
                                 hide_ctx=(self._hide_u8, cursors))
            cur2 = pin(counts_of(res))
            if np.array_equal(cur2, cursors):
                converged = True
                break
            cursors = cur2
        MP3Encoder.last_hide_parallel_stats = {
            "fused": n_pad <= fuse_budget, "extra_rounds": rounds,
            "lanes": n, "converged": converged,
            "stage_ms": {k: round(v * 1e3, 1)
                         for k, v in tloc.times.items()}}
        if not converged:
            self.padding, self.slot_lag, self.hide_str_offset = snap
            return False

        if self.version == 3:
            if scf is not None:
                en_tot_raw, en_raw = scf[0][:n], scf[1][:n]
            else:
                with st("scfsi sums (device)"):
                    en_tot_raw, en_raw = SP.scfsi_sums(xr_dev,
                                                       self.band_row)
        with st("assemble+serialize (host)"):
            self._plane_finish(res, en_tot_raw, en_raw, num_frames, paddings,
                               mean_bits_f, tg)
        MP3Encoder.last_hide_parallel_stats["stage_ms"] = {
            k: round(v * 1e3, 1) for k, v in tloc.times.items()}
        return True

    def _encode_hide_hybrid(self, num_frames: int, timer, quiet: bool):
        """Hide-mode encode: the embedded-bit cursor advances by the number of
        nonzero table selections per granule (MP3_Encoder.py:808-809), so
        granule searches are order-dependent WHILE bits remain to embed. Run
        the exact sequential search frame by frame until the cursor exhausts,
        then hand the remaining frames to the device search plane, seeding its
        cross-granule carries (stale addresses, quantizerStepSize slot chain)
        from the boundary state."""
        import jax.numpy as jnp

        from mp3stego_tpu.ops import encode_plane
        from mp3stego_tpu.ops import search_plane as SP

        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        tg = num_frames * gpf

        with timer.stage("analysis+mdct (device)"):
            streams = self._channel_streams_i16(num_frames)
            mdct_dev = encode_plane.run_analysis_device(streams, tg)
            xr_dev = mdct_dev.reshape(-1, 576)

        # head: sequential exact search while the cursor is live; spectra
        # rows are fetched in blocks
        self._cost = None
        block = {}
        blk_n = 32
        f = 0
        with timer.stage("hide head (host search)"):
            while f < num_frames and self.hide_str_offset < len(self.hide_str):
                if f not in block:
                    lo = f
                    hi = min(num_frames, f + blk_n)
                    lanes = np.concatenate(
                        [ch * tg + np.arange(lo * gpf, hi * gpf)
                         for ch in range(nch)])
                    rows = SP.fetch_rows(xr_dev, lanes)
                    rows = rows.reshape(nch, (hi - lo) * gpf, 576)
                    block = {lo + i: rows[:, i * gpf:(i + 1) * gpf]
                             for i in range(hi - lo)}
                self._encode_frame(block.pop(f))
                self.out_buffer += self.bw.take_frame()
                f += 1
        if f == num_frames:
            self.out_buffer += self.bw.take_frame()
            return

        # tail: device plane over the remaining frames, carries seeded
        nf_t = num_frames - f
        tg_t = nf_t * gpf
        lanes = np.concatenate(
            [ch * tg + np.arange(f * gpf, num_frames * gpf)
             for ch in range(nch)])
        xr_tail = xr_dev[jnp.asarray(lanes)]
        paddings, mean_bits_f = self._plane_framing(nf_t)
        maxb_f = np.minimum(np.asarray(mean_bits_f, np.int64) // nch,
                            Q.MAX_BITS_ALLOWANCE)
        max_bits_lanes = np.tile(np.repeat(maxb_f, gpf), nch).astype(np.int32)

        addr_seed = np.zeros((gpf, nch, 3), np.int64)
        step_seed = np.zeros((nch, gpf), np.int64)
        for gr in range(gpf):
            for ch in range(nch):
                gi = self.gr_info[gr][ch]
                addr_seed[gr, ch] = (gi.address1, gi.address2, gi.address3)
                step_seed[ch, gr] = gi.quantizerStepSize

        with timer.stage("rate search (device)"):
            res = SP.search_all(xr_tail, max_bits_lanes,
                                self.band_row)
        en_tot_raw = en_raw = None
        if self.version == 3:
            with timer.stage("scfsi sums (device)"):
                en_tot_raw, en_raw = SP.scfsi_sums(xr_tail,
                                                   self.band_row)
        with timer.stage("verify+redo (host)"):
            self._plane_redo(res, xr_tail, max_bits_lanes, tg_t,
                             addr_seed=addr_seed)
        with timer.stage("assemble+serialize (host)"):
            self._plane_finish(res, en_tot_raw, en_raw, nf_t, paddings,
                               mean_bits_f, tg_t, step_seed=step_seed)

    # ------------------------------------------------------------- frame logic

    def _encode_frame(self, mdct_frame: np.ndarray):
        if self._vbr_rate_idx is not None:
            # VBR: this frame's size comes from its own chosen rate
            f = self._frame_idx
            self.padding = 0
            self.bitrate_index = int(self._vbr_rate_idx[f])
            self.bits_per_frame = 8 * self._vbr_slots(int(self._vbr_rates[f]))
        else:
            if self.frac_slots_per_frame:
                self.padding = 1 if self.slot_lag <= (
                    self.frac_slots_per_frame - 1.0) else 0
                self.slot_lag += self.padding - self.frac_slots_per_frame
            self.bits_per_frame = 8 * (self.whole_slots_per_frame
                                       + self.padding)
        self.mean_bits = int((self.bits_per_frame - self.side_info_len)
                             / self.granules_per_frame)

        self._iteration_loop(mdct_frame)
        self._format_bitstream(mdct_frame)

    def _iteration_loop(self, mdct_frame: np.ndarray):
        """Bit allocation + rate control (MP3_Encoder.py:760-815)."""
        nch = self.wav.num_of_channels
        for ch in range(nch):
            for gr in range(self.granules_per_frame):
                xr = mdct_frame[ch, gr]
                xrabs = np.abs(xr)            # int32 wrap on INT32_MIN, like ref
                xrmax = int(max(0, xrabs.max()))
                cod_info = self.gr_info[gr][ch]
                cod_info.sfb_lmax = 21

                if self.version == 3:
                    self._calc_scfsi(ch, gr, xr, xrmax)

                max_bits = self._max_reservoir_bits()

                self.scale_factor_l[gr][ch][:] = 0
                cod_info.s_len[:] = 0
                cod_info.part2_3_length = 0
                cod_info.big_values = 0
                cod_info.count1 = 0
                cod_info.scale_fac_compress = 0
                cod_info.table_select[:] = 0
                cod_info.region0_count = 0
                cod_info.region1_count = 0
                cod_info.part2_length = 0
                cod_info.preflag = 0
                cod_info.scale_fac_scale = 0
                cod_info.count1table_select = 0

                if xrmax:
                    cod_info.part2_3_length = self._outer_loop(
                        max_bits, xr, xrabs, xrmax, gr, ch)
                    self.hide_str_offset += int(cod_info.table_select[0] > 0) \
                        + int(cod_info.table_select[1] > 0) \
                        + int(cod_info.table_select[2] > 0)

                self.resv_size += (self.mean_bits / nch) - cod_info.part2_3_length
                cod_info.global_gain = cod_info.quantizerStepSize + 210

        self._resv_frame_end()

    def _calc_scfsi(self, ch, gr, xr, xrmax):
        """Scalefactor-select-information (MP3_Encoder.py:817-892). en/en_tot are
        int32 arrays in the reference, so every energy is truncated to int."""
        xr64 = xr.astype(np.int64)
        xrsq = (((xr64 * xr64) + 1073741824) >> 31).astype(np.int32)  # mulsr
        terms = xrsq >> 10
        self.xrmaxl[gr] = xrmax

        band = T.BAND_ALL[self.band_row]
        with np.errstate(all="ignore"):
            temp = int(terms.sum(dtype=np.int32))
            if temp:
                self.en_tot[gr] = np.float64(
                    np.log(np.float64(temp * 4.768371584e-7)) / _LN2)
            else:
                self.en_tot[gr] = 0
            for sfb in range(20, -1, -1):
                t = int(terms[int(band[sfb]):int(band[sfb + 1])].sum(dtype=np.int32))
                if t:
                    self.en[gr][sfb] = np.float64(
                        np.log(np.float64(t * 4.768371584e-7)) / _LN2)
                else:
                    self.en[gr][sfb] = 0

        if gr == 1:
            condition = 2 + int(self.xrmaxl[0] != 0) + int(self.xrmaxl[1] != 0)
            if abs(int(self.en_tot[0]) - int(self.en_tot[1])) < _EN_TOT_KRIT:
                condition += 1
            tp = int(np.abs(self.en[0].astype(np.int64)
                            - self.en[1].astype(np.int64)).sum())
            if tp < _EN_DIF_KRIT:
                condition += 1

            if condition == 6:
                for scfsi_band in range(4):
                    start = _SCFSI_BAND_LONG[scfsi_band]
                    end = _SCFSI_BAND_LONG[scfsi_band + 1]
                    sum0 = int(np.abs(self.en[0][start:end].astype(np.int64)
                                      - self.en[1][start:end].astype(np.int64)).sum())
                    sum1 = 0  # xm stays all-zero in the reference
                    if sum0 < _EN_SCFSI_BAND_KRIT and sum1 < _XM_SCFSI_BAND_KRIT:
                        self.scfsi[ch][scfsi_band] = 1
                    else:
                        self.scfsi[ch][scfsi_band] = 0
            else:
                self.scfsi[ch, :] = 0

    def _max_reservoir_bits(self) -> int:
        """MP3_Encoder.py:894-931. resv_max is never raised above 0 in the
        reference, so the perceptual-entropy branch is dead code there and here."""
        mean_bits = self.mean_bits // self.wav.num_of_channels
        max_bits = min(mean_bits, Q.MAX_BITS_ALLOWANCE)
        if not self.resv_max:
            return max_bits
        return max_bits  # unreachable with resv_max == 0

    # --------------------------------------------------------------- the search

    def _eval(self, ix, cod_info):
        """calc_run_len -> count1 bits -> subdivide -> table select (with stego
        transform) -> big-values bits; the shared body of both search loops."""
        Q.calc_run_len(ix, cod_info)
        bits = Q.count1_bit_count(ix, cod_info)
        Q.subdivide(cod_info, self.band_row)
        self._big_v_tab_select(ix, cod_info)
        bits += Q.big_v_bit_count(ix, cod_info)
        return bits

    def _big_v_tab_select(self, ix, cod_info):
        """Table choice per region + stego pair transform
        (MP3_Encoder.py:1147-1264). The message-bit cursor within a granule
        advances only over regions whose chosen table is nonzero."""
        idx = self.hide_str_offset
        cod_info.table_select[0] = 0 if cod_info.address1 <= 0 else \
            self._choose(ix, 0, cod_info.address1, self.hide_str_offset)
        if cod_info.table_select[0] > 0:
            idx += 1
        cod_info.table_select[1] = 0 if cod_info.address2 <= cod_info.address1 else \
            self._choose(ix, cod_info.address1, cod_info.address2, idx)
        if cod_info.table_select[1] > 0:
            idx += 1
        cod_info.table_select[2] = 0 if (cod_info.big_values << 1) <= cod_info.address2 \
            else self._choose(ix, cod_info.address2, cod_info.big_values << 1, idx)

    def _choose(self, ix, begin, end, idx):
        choice = Q.choose_table(ix, begin, end)
        if self.hide_str != "":
            if idx < len(self.hide_str):
                bit = int(self.hide_str[idx])
                return int(T.TRANSFORM_HUF[choice, bit])
            return choice
        return choice

    def _outer_loop(self, max_bits, xr, xrabs, xrmax, gr, ch):
        """MP3_Encoder.py:933-956. With device_search, both loops replay the
        reference's trajectory over the precomputed (granule, step) cost grid
        (ops/quant_batch) instead of re-quantizing per visited step; the final
        state is always materialized by one exact host evaluation."""
        cod_info = self.gr_info[gr][ch]
        if self._cost is not None:
            return self._outer_loop_cached(max_bits, xr, xrabs, xrmax, gr, ch,
                                           cod_info)
        cod_info.quantizerStepSize = self._bin_search_step_size(
            max_bits, xr, xrabs, xrmax, gr, ch, cod_info)
        cod_info.part2_length = self._part2_length(gr, ch)
        huff_bits = max_bits - cod_info.part2_length
        bits = self._inner_loop(xr, xrabs, xrmax, huff_bits, gr, ch, cod_info)
        cod_info.part2_3_length = cod_info.part2_length + bits
        return cod_info.part2_3_length

    # ------------------------------------------------- cached-search replay

    def _gidx(self, gr, ch):
        return ch * self._tg + self._frame_idx * self.granules_per_frame + gr

    def _cached_eval(self, g, step, xr, xrabs, xrmax, gr, ch, cod_info):
        """One search evaluation from the device cost grid; exact host
        fallback for flagged cells (float-path quantize, big_values==0 stale
        addresses). Mirrors the quantize->run-length->count1->subdivide->
        table-select->bit-count body (MP3_Encoder.py:977-985)."""
        C = self._cost
        s = step + 127
        if not (0 <= s < C["bail"].shape[1]):
            bits = self._exact_eval(step, xr, xrabs, xrmax, gr, ch, cod_info)
            self._last_exact_step = step if bits != 100000 else None
            return bits
        if C["bail"][g, s]:
            self._last_exact_step = None
            return 100000
        if C["approx"][g, s] or C["bv"][g, s] == 0 \
                or C["ixmax"][g, s] > Q.MAX_QUANTIZE_STEP:
            bits = self._exact_eval(step, xr, xrabs, xrmax, gr, ch, cod_info)
            self._last_exact_step = step if bits != 100000 else None
            return bits
        self._last_exact_step = None

        if self.hide_str != "":
            from mp3stego_tpu.ops import quant_batch as QB
            from mp3stego_tpu import tables as TT
            bits = int(min(C["sum0"][g, s], C["sum1"][g, s]))
            idx = self.hide_str_offset
            for r in range(3):
                pre = int(C["choice"][g, s, r])
                if pre == 0:
                    continue
                if idx < len(self.hide_str):
                    t = int(TT.TRANSFORM_HUF[pre, int(self.hide_str[idx])])
                else:
                    t = pre
                bits += QB.table_cost(C, g, s, r, t)
                idx += 1
        else:
            bits = int(C["bits_total"][g, s])
        # keep the stale-address state the reference would carry
        # (addresses survive into later big_values==0 evaluations)
        cod_info.address1 = int(C["a1"][g, s])
        cod_info.address2 = int(C["a2"][g, s])
        cod_info.address3 = 2 * int(C["bv"][g, s])
        return bits

    def _rate_native_call(self, fn_name, xr, xrabs, xrmax, arg, gr, ch,
                          cod_info):
        """One native rate_search.cpp call with GrInfo<->state[12] sync;
        the granule's l3_enc slice is the shared inout ix buffer."""
        lib = _rate_lib()
        state = _state_of(cod_info)
        r = getattr(lib, fn_name)(
            np.ascontiguousarray(xr, np.int32),
            np.ascontiguousarray(xrabs, np.int32),
            xrmax, arg, self.band_row * 23,
            self._hide_u8, len(self.hide_str), self.hide_str_offset,
            state, self.l3_enc[ch][gr])
        _state_back(state, cod_info)
        return int(r)

    def _exact_eval(self, step, xr, xrabs, xrmax, gr, ch, cod_info):
        if _rate_lib() is not None:
            return self._rate_native_call("rate_exact_eval", xr, xrabs,
                                          xrmax, step, gr, ch, cod_info)
        ix, ix_max = Q.quantize(xr, xrabs, xrmax, step)
        if ix_max > Q.MAX_QUANTIZE_STEP:
            return 100000
        self.l3_enc[ch][gr] = ix
        return self._eval(self.l3_enc[ch][gr], cod_info)

    def _cached_ixmax(self, g, step, xr, xrabs, xrmax):
        C = self._cost
        s = step + 127
        if not (0 <= s < C["bail"].shape[1]):
            _, ix_max = Q.quantize(xr, xrabs, xrmax, step)
            return ix_max
        if C["bail"][g, s]:
            return 16384
        if C["approx"][g, s]:
            _, ix_max = Q.quantize(xr, xrabs, xrmax, step)
            return ix_max
        return int(C["ixmax"][g, s])

    def _outer_loop_cached(self, max_bits, xr, xrabs, xrmax, gr, ch, cod_info):
        g = self._gidx(gr, ch)

        # bin search (MP3_Encoder.py:958-996)
        nxt = -120
        count = 120
        while True:
            half = count // 2
            bits = self._cached_eval(g, nxt + half, xr, xrabs, xrmax, gr, ch,
                                     cod_info)
            if bits < max_bits:
                count = half
            else:
                nxt += half
                count -= half
            if count <= 1:
                break
        cod_info.quantizerStepSize = nxt

        cod_info.part2_length = self._part2_length(gr, ch)
        huff_bits = max_bits - cod_info.part2_length

        # inner loop (MP3_Encoder.py:1064-1095)
        if huff_bits < 0:
            cod_info.quantizerStepSize -= 1
        while True:
            while self._cached_ixmax(g, cod_info.quantizerStepSize + 1,
                                     xr, xrabs, xrmax) > Q.MAX_QUANTIZE_STEP:
                cod_info.quantizerStepSize += 1
            cod_info.quantizerStepSize += 1
            bits = self._cached_eval(g, cod_info.quantizerStepSize, xr, xrabs,
                                     xrmax, gr, ch, cod_info)
            if bits <= huff_bits:
                break

        # materialize the final state exactly (ix tensor + all side-info
        # fields + stego table selection) with one host evaluation — unless
        # the last search evaluation already ran the exact path at this step
        if self._last_exact_step == cod_info.quantizerStepSize:
            final_bits = bits
        else:
            final_bits = self._exact_eval(cod_info.quantizerStepSize, xr,
                                          xrabs, xrmax, gr, ch, cod_info)
        cod_info.part2_3_length = cod_info.part2_length + final_bits
        return cod_info.part2_3_length

    def _bin_search_step_size(self, desired_rate, xr, xrabs, xrmax, gr, ch, cod_info):
        """MP3_Encoder.py:958-996."""
        if _rate_lib() is not None:
            return self._rate_native_call("rate_bin_search", xr, xrabs,
                                          xrmax, desired_rate, gr, ch,
                                          cod_info)
        nxt = -120
        count = 120
        while True:
            half = count // 2
            ix, ix_max = Q.quantize(xr, xrabs, xrmax, nxt + half)
            if ix_max > Q.MAX_QUANTIZE_STEP:
                bit = 100000
            else:
                self.l3_enc[ch][gr] = ix
                bit = self._eval(self.l3_enc[ch][gr], cod_info)
            if bit < desired_rate:
                count = half
            else:
                nxt += half
                count -= half
            if count <= 1:
                break
        return nxt

    def _part2_length(self, gr, ch) -> int:
        """Scalefactor bits (MP3_Encoder.py:1038-1062); always 0 with
        scale_fac_compress==0 since slen tables start at 0, kept for parity."""
        gi = self.gr_info[gr][ch]
        slen1 = int(T.SLEN1_TAB[gi.scale_fac_compress])
        slen2 = int(T.SLEN2_TAB[gi.scale_fac_compress])
        bits = 0
        if gr == 0 or self.scfsi[ch][0] == 0:
            bits += 6 * slen1
        if gr == 0 or self.scfsi[ch][1] == 0:
            bits += 5 * slen1
        if gr == 0 or self.scfsi[ch][2] == 0:
            bits += 5 * slen2
        if gr == 0 or self.scfsi[ch][3] == 0:
            bits += 5 * slen2
        return bits

    def _inner_loop(self, xr, xrabs, xrmax, max_bits, gr, ch, cod_info):
        """MP3_Encoder.py:1064-1095."""
        if _rate_lib() is not None:
            return self._rate_native_call("rate_inner_loop", xr, xrabs,
                                          xrmax, max_bits, gr, ch, cod_info)
        if max_bits < 0:
            cod_info.quantizerStepSize -= 1
        while True:
            while True:
                ix, ix_max = Q.quantize(xr, xrabs, xrmax,
                                        cod_info.quantizerStepSize + 1)
                if ix is not None:
                    self.l3_enc[ch][gr] = ix
                if ix_max <= Q.MAX_QUANTIZE_STEP:
                    break
                cod_info.quantizerStepSize += 1
            cod_info.quantizerStepSize += 1
            bits = self._eval(self.l3_enc[ch][gr], cod_info)
            if bits <= max_bits:
                return bits

    def _resv_frame_end(self):
        """Reservoir drain + stuffing-bit planning (MP3_Encoder.py:1097-1145)."""
        if self.wav.num_of_channels == 2 and (self.mean_bits & 1):
            self.resv_size += 1
        over_bits = max(0.0, self.resv_size - self.resv_max)
        self.resv_size -= over_bits
        stuffing_bits = over_bits

        over_bits = self.resv_size % 8
        if over_bits:
            stuffing_bits += over_bits
            self.resv_size -= over_bits

        if stuffing_bits:
            gi = self.gr_info[0][0]
            if gi.part2_3_length + stuffing_bits < Q.MAX_BITS_ALLOWANCE:
                gi.part2_3_length += stuffing_bits
            else:
                for gr in range(self.granules_per_frame):
                    for ch in range(self.wav.num_of_channels):
                        gi = self.gr_info[gr][ch]
                        if not stuffing_bits:
                            break
                        extra_bits = Q.MAX_BITS_ALLOWANCE - gi.part2_3_length
                        bits_this_gr = min(extra_bits, stuffing_bits)
                        gi.part2_3_length += bits_this_gr
                        stuffing_bits -= bits_this_gr
                self.resv_drain = stuffing_bits  # never serialized (ref quirk)

    # ----------------------------------------------------------- serialization

    def _format_bitstream(self, mdct_frame):
        """MP3_Encoder.py:1266-1360. Uses the native C serializer when the
        library is available; the python BitWriter path below is the
        fallback/oracle (identical bytes)."""
        for ch in range(self.wav.num_of_channels):
            for gr in range(self.granules_per_frame):
                neg = (mdct_frame[ch][gr] < 0) & (self.l3_enc[ch][gr] > 0)
                self.l3_enc[ch][gr][neg] *= -1

        if self._nat_ser is None:
            from mp3stego_tpu import native
            lib = native.get_lib()
            use = (lib is not None and hasattr(lib, "mp3_format_frame")
                   and not (self.version != 3 and self.lsf_compliant))
            self._nat_ser = lib if use else False
            if use:
                self._nat_cache = np.zeros(1, dtype=np.uint32)
                self._nat_cache_bits = np.full(1, 32, dtype=np.int32)
                self._nat_out = np.zeros(1 << 16, dtype=np.uint8)
        if self._nat_ser:
            self._format_bitstream_native()
        else:
            self._encode_side_info()
            self._encode_main_data()

    def _format_bitstream_native(self):
        gi = np.zeros((2, 2, 11), dtype=np.int64)
        for gr in range(2):
            for ch in range(2):
                g = self.gr_info[gr][ch]
                gi[gr, ch] = (int(g.part2_3_length), int(g.big_values),
                              int(g.global_gain), int(g.scale_fac_compress),
                              int(g.region0_count), int(g.region1_count),
                              int(g.preflag), int(g.scale_fac_scale),
                              int(g.count1table_select), int(g.count1),
                              int(g.part2_length))
        ts = np.stack([[self.gr_info[gr][ch].table_select for ch in range(2)]
                       for gr in range(2)]).astype(np.int32)
        written = self._nat_ser.mp3_format_frame(
            self._nat_cache, self._nat_cache_bits, self._nat_out,
            len(self._nat_out),
            self.version, self.layer, self.crc, self.bitrate_index,
            self.samplerate_index % 3, self.padding, self.ext, self.mode,
            self.mode_ext, self.copyright, self.original, self.emphasis,
            self.private_bits, self.wav.num_of_channels,
            self.granules_per_frame,
            np.ascontiguousarray(self.scfsi), gi.reshape(-1),
            np.ascontiguousarray(ts.reshape(-1)),
            np.ascontiguousarray(self.scale_factor_l.reshape(-1)),
            _slen1_i32(), _slen2_i32(),
            np.ascontiguousarray(self.l3_enc.reshape(-1)),
            _huff_code_u32(), _huff_len_u8(), _linbits_i32(),
            _band_row_i32(self.band_row))
        if written < 0:
            raise RuntimeError("native serializer buffer overflow")
        self.out_buffer += self._nat_out[:written].tobytes()

    def _encode_side_info(self):
        bw = self.bw
        bw.put(0x7FF, 11)
        bw.put(self.version, 2)
        bw.put(self.layer, 2)
        bw.put(0 if self.crc else 1, 1)
        bw.put(self.bitrate_index, 4)
        bw.put(self.samplerate_index % 3, 2)
        bw.put(self.padding, 1)
        bw.put(self.ext, 1)
        bw.put(self.mode, 2)
        bw.put(self.mode_ext, 2)
        bw.put(self.copyright, 1)
        bw.put(self.original, 1)
        bw.put(self.emphasis, 2)

        nch = self.wav.num_of_channels
        if self.version == 3:
            bw.put(0, 9)
            bw.put(self.private_bits, 3 if nch == 2 else 5)
            for ch in range(nch):
                for band in range(4):
                    bw.put(int(self.scfsi[ch][band]), 1)
        else:
            bw.put(0, 8)
            bw.put(self.private_bits, 2 if nch == 2 else 1)

        for gr in range(self.granules_per_frame):
            for ch in range(nch):
                gi = self.gr_info[gr][ch]
                bw.put(int(gi.part2_3_length), 12)
                bw.put(int(gi.big_values), 9)
                bw.put(int(gi.global_gain), 8)
                bw.put(int(gi.scale_fac_compress), 4 if self.version == 3 else 9)
                bw.put(0, 1)  # window_switching_flag
                for region in range(3):
                    bw.put(int(gi.table_select[region]), 5)
                bw.put(int(gi.region0_count), 4)
                bw.put(int(gi.region1_count), 3)
                if self.version == 3:
                    bw.put(int(gi.preflag), 1)
                    bw.put(int(gi.scale_fac_scale), 1)
                    bw.put(int(gi.count1table_select), 1)
                elif self.lsf_compliant:
                    # ISO 13818-3 LSF: these two bits ARE in the stream; the
                    # reference omits them (MP3_Encoder.py:1335-1337 guard)
                    bw.put(int(gi.scale_fac_scale), 1)
                    bw.put(int(gi.count1table_select), 1)

    def _encode_main_data(self):
        bw = self.bw
        for gr in range(self.granules_per_frame):
            for ch in range(self.wav.num_of_channels):
                gi = self.gr_info[gr][ch]
                slen1 = int(T.SLEN1_TAB[gi.scale_fac_compress])
                slen2 = int(T.SLEN2_TAB[gi.scale_fac_compress])
                sfl = self.scale_factor_l[gr][ch]
                if gr == 0 or self.scfsi[ch][0] == 0:
                    for sfb in range(6):
                        bw.put(int(sfl[sfb]), slen1)
                if gr == 0 or self.scfsi[ch][1] == 0:
                    for sfb in range(6, 11):
                        bw.put(int(sfl[sfb]), slen1)
                if gr == 0 or self.scfsi[ch][2] == 0:
                    for sfb in range(11, 16):
                        bw.put(int(sfl[sfb]), slen2)
                if gr == 0 or self.scfsi[ch][3] == 0:
                    for sfb in range(16, 21):
                        bw.put(int(sfl[sfb]), slen2)
                self._huffman_code_bits(gr, ch)

    def _huffman_code_bits(self, gr, ch):
        """MP3_Encoder.py:1394-1446, incl. the all-ones stuffing padding."""
        bw = self.bw
        gi = self.gr_info[gr][ch]
        scale_fac = T.BAND_ALL[self.band_row]
        bits_before = bw.bits_count()

        big_values = int(gi.big_values) << 1
        idx0 = gi.region0_count + 1
        region1_start = int(scale_fac[idx0])
        region2_start = int(scale_fac[idx0 + gi.region1_count + 1])

        enc = self.l3_enc[ch][gr]
        for i in range(0, big_values, 2):
            region = (i >= region1_start) + (i >= region2_start)
            table_index = int(gi.table_select[region])
            if table_index != 0:
                self._huffman_code(table_index, int(enc[i]), int(enc[i + 1]))

        count1_table = 32 + gi.count1table_select
        count1_end = big_values + (gi.count1 << 2)
        for i in range(big_values, count1_end, 4):
            self._huffman_coder_count1(
                count1_table, int(enc[i]), int(enc[i + 1]),
                int(enc[i + 2]), int(enc[i + 3]))

        written = bw.bits_count() - bits_before
        stuff = int(gi.part2_3_length - gi.part2_length - written)
        if stuff:
            for _ in range(stuff // 32):
                bw.put(0xFFFFFFFF, 32)
            rem = stuff % 32
            if rem:
                bw.put((1 << rem) - 1, rem)

    def _huffman_code(self, table_select, x, y):
        """MP3_Encoder.py:1448-1513."""
        bw = self.bw
        sign_x = 1 if x <= 0 and x != 0 else 0
        sign_y = 1 if y <= 0 and y != 0 else 0
        x = abs(x)
        y = abs(y)
        y_len = 16  # all pair tables are stored on the 16x16 grid
        if table_select > 15:
            lin_bits = int(T.HUFF_LINBITS[table_select])
            lin_bits_x = lin_bits_y = 0
            if x > 14:
                lin_bits_x = x - 15
                x = 15
            if y > 14:
                lin_bits_y = y - 15
                y = 15
            code = int(T.HUFF_CODE[table_select, x, y])
            c_bits = int(T.HUFF_LEN[table_select, x, y])
            ext = 0
            x_bits = 0
            if x > 14:
                ext |= lin_bits_x
                x_bits += lin_bits
            if x != 0:
                ext = (ext << 1) | sign_x
                x_bits += 1
            if y > 14:
                ext = (ext << lin_bits) | lin_bits_y
                x_bits += lin_bits
            if y != 0:
                ext = (ext << 1) | sign_y
                x_bits += 1
            bw.put(code, c_bits)
            bw.put(ext, x_bits)
        else:
            code = int(T.HUFF_CODE[table_select, x, y])
            c_bits = int(T.HUFF_LEN[table_select, x, y])
            if x != 0:
                code = (code << 1) | sign_x
                c_bits += 1
            if y != 0:
                code = (code << 1) | sign_y
                c_bits += 1
            bw.put(code, c_bits)
        _ = y_len

    def _huffman_coder_count1(self, table, v, w, x, y):
        """MP3_Encoder.py:1515-1547."""
        bw = self.bw
        sv, sw, sx, sy = (1 if t < 0 else 0 for t in (v, w, x, y))
        v, w, x, y = abs(v), abs(w), abs(x), abs(y)
        p = v + (w << 1) + (x << 2) + (y << 3)
        bw.put(int(T.HUFF_CODE[table, 0, p]), int(T.HUFF_LEN[table, 0, p]))
        code = 0
        cbits = 0
        if v:
            code = sv
            cbits = 1
        if w:
            code = (code << 1) | sw
            cbits += 1
        if x:
            code = (code << 1) | sx
            cbits += 1
        if y:
            code = (code << 1) | sy
            cbits += 1
        bw.put(code, cbits)

    def write_mp3_file(self, output_file: str):
        """Write the accumulated MP3 bytes (MP3_Encoder.py:1554-1563)."""
        with open(output_file, "wb") as f:
            f.write(bytes(self.out_buffer))


class Encoder:
    """Driver wrapping MP3Encoder (reference encoder/encoder.py:8-58).

    :param file_path: the wav file path.
    :param output_file_path: the mp3 output file path.
    :param bitrate: target bitrate in kbps (the target AVERAGE when vbr).
    :param hide_str: bit string to embed (empty = no embedding).
    :param vbr: constant-quality VBR with a Xing tag (beyond the reference;
        see MP3Encoder); also enabled by MP3STEGO_TPU_VBR=1.
    """

    def __init__(self, file_path: str, output_file_path: str, bitrate: int = 320,
                 hide_str: str = '', vbr: bool = None):
        self.__file_path = file_path
        self.__output_file_path = output_file_path
        if not os.path.exists(self.__file_path):
            sys.exit(f'File {self.__file_path} not found.')
        self.__wav_file = read_wav(self.__file_path, bitrate)
        self.__hide_str = hide_str
        if vbr is None:
            vbr = os.environ.get("MP3STEGO_TPU_VBR", "0") == "1"
        self.__encoder = MP3Encoder(self.__wav_file, hide_str=hide_str,
                                    vbr=vbr)

    def encode(self, quiet: bool = True) -> bool:
        """Encode; returns True if the message was too long to embed fully
        (the reference's off-by-one contract at encoder.py:49-51 included)."""
        if not quiet:
            self.__encoder.print_info()
        self.__encoder.encode(quiet=quiet)
        self.__encoder.write_mp3_file(self.__output_file_path)
        too_long = self.__encoder.hide_str_offset < len(self.__hide_str) - 1
        if not quiet:
            if too_long:
                print("File too short for this message length, your message has "
                      "been trimmed.")
            print(f"MP3 file created on {self.__output_file_path}")
        return too_long
