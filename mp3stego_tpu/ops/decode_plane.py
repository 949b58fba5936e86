"""Batched device decode numeric plane.

The reference decodes granule-by-granule with carried state
(decoder/Frame.py:65-218: requantize, IMDCT + overlap-add, synthesis FIFO).
Here the whole file is one dense batch:

* requantize     — sign * pow43[|ix|] * 2^(exp1/4 - exp2/2), with NO
                   data-dependent gathers: pow43 rows come off the int8
                   sample plane through an exact one-hot matmul, per-band
                   exponents are computed on a compact 61-slot grid from
                   side-info fields and expanded to samples by one matmul
                   (``_expand_slots``), and the
                   2^(q/4) scale is an exponent-bit construction. Only
                   compact int8/int16 fields cross the host->HBM link.
* MS stereo      — masked vector op.
* reorder        — static permutation (with the reference's zero-filled tail for
                   short blocks, Frame.py:574-602).
* alias          — static butterfly index arrays.
* IMDCT          — 18->36 matmul against the cosine basis, windowed; the
                   inter-granule overlap-add is a shifted add over the time axis
                   (out_t = blk_t[:18] + blk_{t-1}[18:]), not a scan.
* freq inversion — static sign mask.
* synthesis      — V_t = N @ s_t for all 18*T sub-steps as one (18T,32)@(32,64)
                   matmul, then PCM_t[n] = sum_{j<16} D[32j+n] *
                   V_{t-j}[(j%2)*32+n]: a 16-tap FIR over the V history,
                   accumulated in the reference's j-order for bit-exactness.

The jitted plane is the float32 device throughput mode; the float64 parity twin
(``decode_granules_np``) reproduces the reference float-for-float on host
(XLA's FMA contraction perturbs the last ulp, see its docstring).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from mp3stego_tpu import tables as T

SQRT2 = math.sqrt(2)

# ------------------------------------------------------------------ host maps

_EXP1_OFF = 266          # exp1 in [-266, 45]
_EXP2X2_MAX = 64


@functools.lru_cache(maxsize=None)
def _requant_walk(sr_idx: int, bt2: bool, mixed: bool, iso: bool = True):
    """Replicates the sfb/window walk of re_quantize (Frame.py:176-208) for a
    whole granule, returning static per-sample maps (is_short, sfb, window).

    ``iso=True`` (default) uses the spec-correct band tables
    (T.BAND_INDEX_ISO / T.BAND_WIDTH_SHORT_ISO, 13 short bands covering all
    576 samples — cross-verified against libmpg123). ``iso=False``
    reproduces the reference's walk: 12-band short tables whose sfb counter
    runs past the table end for the top of the spectrum
    (MP3STEGO_TPU_REF_SHORT_BANDS=1; only meaningful for MPEG-1 rows —
    LSF rows are always ISO since the reference cannot decode LSF)."""
    if iso:
        long_win = T.BAND_INDEX_ISO[sr_idx]
        short_win = T.BAND_WIDTH_SHORT_ISO[sr_idx]      # 13 bands, sum 192
    else:
        long_win = T.SCALE_FACT_BAND_INDEX[sr_idx]
        short_win = (T.BAND_WIDTH_SHORT[sr_idx] if sr_idx < 3
                     else np.zeros(12, np.int32))
    is_short = np.zeros(576, dtype=bool)
    sfb_map = np.zeros(576, dtype=np.int32)
    win_map = np.zeros(576, dtype=np.int32)
    window = 0
    sfb = 0
    i = 0
    for sample in range(576):
        if bt2 or (mixed and sfb >= 8):
            swv = short_win[sfb] if sfb < len(short_win) else 0
            if i == swv:
                i = 0
                if window == 2:
                    window = 0
                    sfb += 1
                else:
                    window += 1
            is_short[sample] = True
            # non-ISO walk: the reference's sfb counter runs past the 12-band
            # table for the top of the spectrum and its njit requantize reads
            # scale_fac_s out of bounds there — those samples are then
            # DROPPED by its 12-band reorder, so the net output is a zero
            # tail regardless of the garbage exponent. Clamp to keep the
            # gather in bounds; the 12-band reorder_perm still zero-fills,
            # so the net output matches the reference exactly.
            sfb_map[sample] = min(sfb, 12)
            win_map[sample] = window
        else:
            if sample == long_win[sfb + 1]:
                sfb += 1
            sfb_map[sample] = sfb
        i += 1
    return is_short, sfb_map, win_map


def _mix_geometry(sr_idx: int):
    """(boundary_sample S, n_long_window_subbands K) for ISO mixed blocks.

    S — the requantize/reorder boundary: the long-walk region covers
    scalefactor bands 0..7 (MPEG-1) / 0..5 (LSF, ISO 13818-3 partitions),
    and at every one of the 9 samplerates that boundary
    S = BAND_INDEX_ISO[n_long] equals 3*sum(short bands 0..2) — 36
    everywhere except 8 kHz, where both are 72 — so the short region
    starts exactly at short scalefactor band 3 with reorder output
    offset S.

    K — the hybrid-stage long count: exactly 2 polyphase subbands are
    decoded with long (block_type 0) windows and ONE alias butterfly,
    at every samplerate. This matches libmpg123 and libavcodec (which
    agree with each other at ~79 dB on crafted 8 kHz mixed streams,
    tests/test_mixed_blocks.py): both hard-code 2 long subbands / 1
    butterfly for mixed blocks independent of the scalefactor-band
    boundary. At 8 kHz this means subbands 2-3 (samples 36..71) carry
    long-walk, UNREORDERED spectrum under short windows — a spec-side
    oddity, but the ecosystem behavior. (An earlier revision derived
    K = S//18 = 4 at 8 kHz, long-windowing all 72 samples; it measured
    2.6 dB vs both oracles.)"""
    n_long = 8 if sr_idx < 3 else 6
    s = int(T.BAND_INDEX_ISO[sr_idx][n_long])
    assert s == 3 * int(T.BAND_WIDTH_SHORT_ISO[sr_idx][:3].sum()) \
        and s % 18 == 0, (sr_idx, s)
    return s, 2


@functools.lru_cache(maxsize=None)
def _requant_walk_mixed_iso(sr_idx: int):
    """ISO-correct requantize walk for mixed blocks (ISO 11172-3 2.4.3.4.6 /
    13818-3): long bands 0..7 (MPEG-1) or 0..5 (LSF) for the first S
    samples, then the short (sfb, window) walk STARTING at short band 3.
    The reference instead keeps running its long sfb counter into the
    short-width table (Frame.py:186, ``sfb >= 8`` with ``short_win[sfb]``),
    which reads the wrong widths and the wrong scalefactors — that walk is
    preserved as mode 2 for MP3STEGO_TPU_REF_MIXED=1."""
    long_win = T.BAND_INDEX_ISO[sr_idx]
    short_win = T.BAND_WIDTH_SHORT_ISO[sr_idx]
    s_mix, _ = _mix_geometry(sr_idx)
    is_short = np.zeros(576, dtype=bool)
    sfb_map = np.zeros(576, dtype=np.int32)
    win_map = np.zeros(576, dtype=np.int32)
    sfb = 0
    for sample in range(s_mix):
        if sample == long_win[sfb + 1]:
            sfb += 1
        sfb_map[sample] = sfb
    sfb, window, i = 3, 0, 0
    for sample in range(s_mix, 576):
        swv = int(short_win[sfb]) if sfb < len(short_win) else 0
        if i == swv:
            i = 0
            if window == 2:
                window = 0
                sfb += 1
            else:
                window += 1
        is_short[sample] = True
        sfb_map[sample] = min(sfb, 12)
        win_map[sample] = window
        i += 1
    return is_short, sfb_map, win_map


@functools.lru_cache(maxsize=None)
def _reorder_perm(sr_idx: int, iso: bool = True):
    """Static permutation for short-block reorder (Frame.py:574-602).

    ``iso=True`` (default) walks all 13 short bands — every one of the 576
    outputs is written (ISO behavior, matches libmpg123). ``iso=False``
    reproduces the reference's 12-band walk: outputs past the 12-band
    coverage are never written and stay 0 (the top short band of the
    spectrum is silently dropped)."""
    short_win = (T.BAND_WIDTH_SHORT_ISO[sr_idx] if iso
                 else (T.BAND_WIDTH_SHORT[sr_idx] if sr_idx < 3
                       else np.zeros(12, np.int32)))
    perm = np.full(576, -1, dtype=np.int32)
    total = start = block = 0
    for sb in range(len(short_win)):
        w = int(short_win[sb])
        for ss in range(w):
            perm[start + block + 0] = total + ss + w * 0
            perm[start + block + 6] = total + ss + w * 1
            perm[start + block + 12] = total + ss + w * 2
            if block != 0 and block % 5 == 0:
                start += 18
                block = 0
            else:
                block += 1
        total += w * 3
    return perm


@functools.lru_cache(maxsize=None)
def _alias_indices():
    sb = np.arange(1, 32)[:, None]
    s = np.arange(8)[None, :]
    off1 = (18 * sb - s - 1).reshape(-1)
    off2 = (18 * sb + s).reshape(-1)
    cs = np.tile(T.ALIAS_CS, 31)
    ca = np.tile(T.ALIAS_CA, 31)
    return off1, off2, cs, ca


@functools.lru_cache(maxsize=None)
def _freq_inv_mask():
    m = np.ones((32, 18))
    band = np.arange(32)[:, None]
    t = np.arange(18)[None, :]
    m[(band % 2 == 1) & (t % 2 == 1)] = -1.0
    return m.reshape(576)


@functools.lru_cache(maxsize=None)
def _walk_maps(sr_idx: int, iso: bool = True):
    """(4,576) per-mode walk tables + pre_tab. Rows: 0 long, 1 short,
    2 reference-mixed (Frame.py:186 — the walk kept for
    MP3STEGO_TPU_REF_MIXED=1 and for mixed flags on non-short block types),
    3 ISO mixed (long prefix + short from band 3)."""
    rows = [_requant_walk(sr_idx, m == 1, m == 2, iso) for m in range(3)]
    # mode 3 exists only when the ISO band tables are active (_iso_mixed_on
    # requires _iso_bands); under the reference band emulation duplicate
    # row 2 instead of mixing table families in one walk array
    rows.append(_requant_walk_mixed_iso(sr_idx) if iso else rows[2])
    maps = [np.stack([r[k] for r in rows]) for k in range(3)]
    pre_ext = np.concatenate([T.PRE_TAB, [0]]).astype(np.int32)
    return (maps[0].astype(np.int32), maps[1].astype(np.int32),
            maps[2].astype(np.int32), pre_ext)


def _slot_maps(walk_is_short, walk_sfb, walk_win):
    """Static sample->slot maps for the matmul expansion of per-band values.

    Instead of gathers with data-dependent indices, the decode plane
    computes per-band quantities on a compact slot grid and
    expands them to the 576-sample axis with one one-hot matmul
    (``_expand_slots``). Two grids:

    * exponent grid (61 slots): long sfb 0..21 read ``sfl`` (+preemphasis);
      short (win, sfb) slots 22 + win*13 + sfb read ``sfs`` — mirroring the
      index arithmetic of ``exponent_indices`` exactly.
    * intensity grid (88 slots): win*22 + sfb over the (T,4,22) ``is_pos``
      layout, window = walk window for short samples, row 3 for long ones.
    """
    short = walk_is_short.astype(bool)
    sfb_c = np.minimum(walk_sfb, 21)
    slot_exp = np.where(short, 22 + walk_win * 13 + walk_sfb,
                        sfb_c).astype(np.int16)
    slot_is = (np.where(short, walk_win, 3) * 22 + sfb_c).astype(np.int16)
    return slot_exp, slot_is


def _iso_bands(sr_idx: int) -> bool:
    """Band-table mode for a decode: LSF rows are always ISO; MPEG-1 rows
    are ISO unless MP3STEGO_TPU_REF_SHORT_BANDS=1 restores the reference's
    12-band short walk/reorder."""
    return sr_idx >= 3 or not T.ref_short_bands()


def _iso_mixed_on(sr_idx: int) -> bool:
    """True when bt==2 + mixed_block_flag granules take the ISO mixed
    decode (mode 3). Off under MP3STEGO_TPU_REF_MIXED=1 and under the
    reference band emulation (REF_SHORT_BANDS), whose walk tables encode
    the reference's all-short treatment."""
    return _iso_bands(sr_idx) and not T.ref_mixed()


@functools.lru_cache(maxsize=1)
def _is_coef():
    """(6,2,16) float64 intensity-stereo coefficient tables, [row][A/B][pos]:
    L' = x*A[p], R' = x*B[p] applied to the post-MS left channel. Rows
    (mpg123's tabs[lsf + (sfc & lsf)][ms_stereo] layout, fitted exactly on
    crafted streams — tests/test_intensity.py):

      0  MPEG-1 (ISO 11172-3 2.4.3.4.9.3): ratio tan(p*pi/12), p=0..6
         (p=6 is the +90-degree edge, A=1/B=0; p=7 is the illegal-position
         sentinel, pre-marked -1 by _intensity_positions)
      1  MPEG-1 when the granule is also MS (mode_ext=3): row 0 * sqrt(2)
      2  LSF (ISO 13818-3), intensity_scale=0: base=2^-1/4; p odd ->
         A=base^((p+1)/2), B=1; p even -> A=1, B=base^(p/2); p=0 -> A=B=1
      3  row 2 * sqrt(2) (LSF + MS)
      4  LSF, intensity_scale=1: base=2^-1/2
      5  row 4 * sqrt(2)
    """
    out = np.zeros((6, 2, 16))
    for p in range(7):
        if p == 6:
            out[0, 0, p], out[0, 1, p] = 1.0, 0.0
        else:
            t = math.tan(p * math.pi / 12.0)
            out[0, 0, p] = t / (1.0 + t)
            out[0, 1, p] = 1.0 / (1.0 + t)
    for j in range(2):
        base = 2.0 ** (-0.25 * (j + 1.0))
        for p in range(16):
            a = b = 1.0
            if p > 0:
                if p & 1:
                    a = base ** ((p + 1.0) * 0.5)
                else:
                    b = base ** (p * 0.5)
            out[2 + 2 * j, 0, p] = a
            out[2 + 2 * j, 1, p] = b
    out[1] = math.sqrt(2.0) * out[0]
    out[3] = math.sqrt(2.0) * out[2]
    out[5] = math.sqrt(2.0) * out[4]
    return out


def _intensity_positions(p, bt_ct, mixed_ct):
    """(T,4,22) int8 intensity positions for IS-flagged granules (-1 = band
    not intensity-processed), the (T,) flag mask, and the (T,) int8
    coefficient-table row (_is_coef first axis) per granule. Rows 0..2 are
    the short windows; row 3 carries long-band positions (whole-granule
    long blocks, and the long prefix of mixed blocks) — the planes index
    the row with the walk's window for short samples and 3 for long ones,
    so mixed granules can carry independent long- and short-band
    positions without aliasing.

    Semantics (validated against libmpg123 on hand-crafted streams,
    tests/test_intensity.py): intensity applies to the scalefactor bands at
    and above the RIGHT channel's zero part (the bands from the band holding
    the last nonzero right-channel sample upward are NOT processed — only
    fully-zero bands are); the intensity position is the right channel's
    scalefactor for that band; the top band (21 long / 12 short), which has
    no transmitted scalefactor, reuses the previous band's position. A
    position equal to the illegal sentinel — 7 for MPEG-1, and for LSF the
    MP3STEGO_TPU_LSF_IS_ILLEGAL convention (iso: (1<<slen)-1 per band group
    via ParsedMP3.lsf_is_illegal; mpg123: constant 7; ffmpeg: never — see
    tables.lsf_is_illegal_mode) — leaves the band on the MS/LR path;
    illegal bands are pre-marked -1 here so the planes apply coefficients
    unconditionally wherever pos >= 0 (but they do NOT bound the IS region:
    only bands with content do)."""
    Tn = 2 * p.num_frames
    isg = np.zeros(Tn, bool) if p.is_stereo is None \
        else np.asarray(p.is_stereo, bool).copy()
    out = np.full((Tn, 4, 22), -1, np.int8)
    tab = np.zeros(Tn, np.int8)
    if not isg.any():
        return out, isg, tab
    lsf = bool(p.lsf_granules) and p.lsf_is_scale is not None
    ms = np.asarray(p.ms_stereo, bool).astype(np.int8)
    if lsf:
        tab = np.where(isg, 2 + 2 * np.maximum(p.lsf_is_scale, 0) + ms,
                       0).astype(np.int8)
    else:
        tab = np.where(isg, ms, 0).astype(np.int8)
    sr = p.header.sr_idx
    long_win = T.BAND_INDEX_ISO[sr]
    width_s = T.BAND_WIDTH_SHORT_ISO[sr]
    sfl = p.scale_fac_l      # (F,2,2,22)
    sfs = p.scale_fac_s      # (F,2,2,3,13)
    ill_mode = T.lsf_is_illegal_mode() if lsf else "iso"
    for t in np.flatnonzero(isg):
        f, gr = divmod(int(t), 2)
        right = p.raw_samples[f, gr, 1]
        short = bt_ct[1, t] == 2
        if not lsf:
            illegal = np.full((3, 22), 7, np.int8)
        elif ill_mode == "iso":
            illegal = p.lsf_is_illegal[t]
        elif ill_mode == "mpg123":
            illegal = np.full((3, 22), 7, np.int8)
        else:                       # ffmpeg: nothing illegal
            illegal = np.full((3, 22), -2, np.int8)
        if short and mixed_ct[1, t]:
            # mixed blocks: per-window zero tails over the short bands
            # (3..12, starting at the walk boundary S) + long-prefix bands
            # that sit above the WHOLE right spectrum's last content
            # (validated vs mpg123/avcodec on crafted IS+mixed streams,
            # tests/test_mixed_blocks.py::test_is_mixed*)
            s_mix, _ = _mix_geometry(sr)
            n_long = 6 if lsf else 8
            zero = np.zeros((3, 13), bool)
            pos = s_mix
            for sfb in range(3, 13):
                w = int(width_s[sfb])
                for win in range(3):
                    zero[win, sfb] = not right[
                        pos + win * w: pos + (win + 1) * w].any()
                pos += 3 * w
            for win in range(3):
                for sfb in range(3, 13):
                    if zero[win, sfb]:
                        ip = int(sfs[f, gr, 1, win, sfb]) if sfb < 12 \
                            else int(sfs[f, gr, 1, win, 11])
                        if ip != int(illegal[win, sfb]):
                            out[t, win, sfb] = ip
                blocked = False
                for sfb in range(12, 2, -1):
                    if not zero[win, sfb]:
                        blocked = True
                    elif blocked:
                        out[t, win, sfb] = -1
            nz = np.flatnonzero(right)
            rz = int(nz[-1]) + 1 if len(nz) else 0
            for sfb in range(n_long):
                if int(long_win[sfb]) >= rz:
                    ip = int(sfl[f, gr, 1, sfb])
                    if ip != int(illegal[0, sfb]):
                        out[t, 3, sfb] = ip
            continue
        if short:
            zero = np.zeros((3, 13), bool)
            pos = 0
            for sfb in range(13):
                w = int(width_s[sfb])
                for win in range(3):
                    zero[win, sfb] = not right[
                        pos + win * w: pos + (win + 1) * w].any()
                pos += 3 * w
            for win in range(3):
                for sfb in range(13):
                    if zero[win, sfb]:
                        ip = int(sfs[f, gr, 1, win, sfb]) if sfb < 12 \
                            else int(sfs[f, gr, 1, win, 11])
                        if ip != int(illegal[win, sfb]):
                            out[t, win, sfb] = ip
            # a window's IS region must be a contiguous tail: zero bands
            # that sit below a band with content stay on the MS/LR path
            # (illegal-position bands above the bound don't re-block it)
            for win in range(3):
                blocked = False
                for sfb in range(12, -1, -1):
                    if not zero[win, sfb]:
                        blocked = True
                    elif blocked:
                        out[t, win, sfb] = -1
        else:
            nz = np.flatnonzero(right)
            rz = int(nz[-1]) + 1 if len(nz) else 0
            for sfb in range(22):
                if int(long_win[sfb]) >= rz:
                    ip = (int(sfl[f, gr, 1, sfb]) if sfb < 21
                          else int(sfl[f, gr, 1, 20]))
                    if ip != int(illegal[0, sfb]):
                        out[t, 3, sfb] = ip
    return out, isg, tab


def _pack_raw_native(raw_samples: np.ndarray, F: int):
    """C++ int8 sample-plane pack (native/src/raw_pack.cpp); None -> NumPy."""
    from mp3stego_tpu import native
    lib = native.get_lib()
    if lib is None or F == 0:
        return None
    raw = np.ascontiguousarray(raw_samples, dtype=np.int32)
    out = np.empty((2, 2 * F, 576), np.int8)
    cap = 4096
    while True:
        exc_t = np.empty(cap, np.int32)
        exc_ch = np.empty(cap, np.int8)
        exc_s = np.empty(cap, np.int16)
        exc_val = np.empty(cap, np.int16)
        n = int(lib.pack_raw_plane(raw.reshape(-1), F, out.reshape(-1),
                                   exc_t, exc_ch, exc_s, exc_val, cap))
        if n <= cap:
            return (out, exc_t[:n], exc_ch[:n], exc_s[:n], exc_val[:n])
        cap = n  # rare: many linbits samples; retry with the exact count


def host_prepare(p, native_pack: bool = True) -> dict:
    """Turn a ParsedMP3 into the device-plane input pytree.

    Only per-granule side-info fields cross to the device (a few hundred bytes
    per granule); the per-sample exponent index maps are reconstructed on
    device by ``exponent_indices`` from static walk tables — host->HBM traffic
    is dominated by the int16 Huffman sample tensor.

    The int8 sample-plane packing (the only pass over the ~full-file int32
    tensor) runs in C++ when the native library is loadable (one fused pass vs
    three NumPy passes, ~6x on a single-core host); ``native_pack=False``
    forces the NumPy oracle. Exception list order differs between the two
    (t-major vs ch-major) — downstream is a scatter, so order is free."""
    F = p.num_frames
    sr = p.header.sr_idx
    G = F * 2  # time-ordered granules

    # (F,2,2,...) -> (2ch, T=2F, ...) time order = frame-major, gr-within-frame
    def to_ct(a):
        return np.ascontiguousarray(np.moveaxis(a, 2, 0).reshape((2, G) + a.shape[3:]))

    # Huffman sample plane as int8 + sparse int16 escapes: almost all values
    # are |x| <= 15; only linbits samples exceed int8. This halves (vs int16)
    # the dominant host->HBM transfer.
    packed = _pack_raw_native(p.raw_samples, F) if native_pack else None
    if packed is not None:
        raw_i8, exc_t, exc_ch, exc_s, exc_val = packed
    else:
        raw = to_ct(p.raw_samples)                  # (2, T, 576) int32
        exc_ch, exc_t, exc_s = np.nonzero((raw > 127) | (raw < -128))
        exc_val = raw[exc_ch, exc_t, exc_s].astype(np.int16)
        raw_i8 = np.clip(raw, -128, 127).astype(np.int8)

    bt = to_ct(p.block_type)                        # (2, T)
    mixed = to_ct(p.mixed_block_flag).astype(bool)

    # per-granule walk mode: 0 long, 1 short (bt==2), 2 the reference's
    # mixed walk (kept for REF_MIXED=1 and for mixed flags on non-short
    # block types, where the reference's sfb>=8 branch is what executes),
    # 3 ISO mixed (bt==2 + mixed_block_flag, the default decode)
    mode = np.where(bt == 2, 1, np.where(mixed, 2, 0)).astype(np.int8)
    if _iso_mixed_on(sr):
        mode = np.where((bt == 2) & mixed, 3, mode).astype(np.int8)
    walk_is_short, walk_sfb, walk_win, pre_ext = _walk_maps(sr, _iso_bands(sr))
    slot_exp, slot_is = _slot_maps(walk_is_short, walk_sfb, walk_win)
    is_pos, is_mask, is_tab = _intensity_positions(p, bt, mixed)
    s_mix, k_mix = _mix_geometry(sr)
    col = np.arange(576)

    return dict(
        is_pos=is_pos,                               # (T,4,22) int8
        is_mask=is_mask,                             # (T,) bool
        is_tab=is_tab,                               # (T,) int8 coef row
        raw_i8=raw_i8,
        exc_t=exc_t.astype(np.int32),
        exc_ch=exc_ch.astype(np.int8),
        exc_s=exc_s.astype(np.int16),
        exc_val=exc_val,
        mode=mode,
        gg=to_ct(p.global_gain).astype(np.int16),
        sfscale=to_ct(p.scale_fac_scale).astype(np.int8),
        pre=to_ct(p.pre_flag).astype(np.int8),
        sbg=to_ct(p.sub_block_gain).astype(np.int8),     # (2, T, 3)
        sfl=to_ct(p.scale_fac_l).astype(np.int8),        # (2, T, 22)
        sfs=np.ascontiguousarray(
            to_ct(p.scale_fac_s).reshape(2, G, 39)).astype(np.int8),
        reorder_mask=((bt == 2) | mixed),            # (2,T)
        ms_mask=np.asarray(p.ms_stereo, bool),       # (T,) per granule
        # sine_block row: block_type, except ISO-mixed granules whose long
        # subbands window with block_type 0 (the long-path result is only
        # consumed for those subbands; pure short granules never read it)
        win_row=np.where(mode == 3, 0, bt).astype(np.int8),
        is_short_blk=(bt == 2),
        reorder_perm=_reorder_perm(sr, _iso_bands(sr)),
        walk_is_short=walk_is_short,                 # (4,576)
        walk_sfb=walk_sfb,
        walk_win=walk_win,
        pre_ext=pre_ext,
        slot_exp=slot_exp,                           # (4,576) int16
        slot_is=slot_is,                             # (4,576) int16
        # ISO-mixed statics: the short/reordered region (col >= S); the
        # columns whose full-alias result must revert to the raw spectrum
        # (boundary K's lower butterfly half, 18K-8..18K-1 — only
        # butterflies 1..K-1 apply to mixed blocks); the 8 kHz-only
        # unreordered middle (cols 18K..S-1, strided short-window read —
        # see granule_blocks); and the subbands decoded with long windows
        # (band < K)
        mix_short_cols=(col >= s_mix),               # (576,)
        mix_raw_cols=((col >= 18 * k_mix - 8) & (col < 18 * k_mix)),
        mix_lin_cols=((col >= 18 * k_mix) & (col < s_mix)),
        mix_long_band=(np.arange(32) < k_mix),       # (32,)
    )


def exponent_indices(prep, xp=np):
    """Per-sample requantize exponent indices from per-granule fields
    (re_quantize's exp1/exp2 walk, Frame.py:176-208). Runs under jit (xp=jnp)
    or NumPy (parity path). Inputs are narrow ints; everything upcasts to
    int32 before arithmetic."""
    mode = prep["mode"].astype(xp.int32)
    is_short = prep["walk_is_short"][mode].astype(bool)     # (2,T,576)
    sfb = prep["walk_sfb"][mode].astype(xp.int32)
    win = prep["walk_win"][mode].astype(xp.int32)

    sbg_s = xp.take_along_axis(prep["sbg"].astype(xp.int32), win, axis=2)
    exp1 = prep["gg"].astype(xp.int32)[..., None] - 210 \
        - xp.where(is_short, 8 * sbg_s, 0)

    sf_short = xp.take_along_axis(prep["sfs"].astype(xp.int32),
                                  win * 13 + sfb, axis=2)
    sfb_c = xp.minimum(sfb, 21)
    sf_long = xp.take_along_axis(prep["sfl"].astype(xp.int32), sfb_c, axis=2) \
        + prep["pre"].astype(xp.int32)[..., None] \
        * prep["pre_ext"].astype(xp.int32)[sfb_c]
    mult2 = xp.where(prep["sfscale"].astype(xp.int32) == 0, 1, 2)[..., None]
    exp2x2 = mult2 * xp.where(is_short, sf_short, sf_long)
    return (exp1 + _EXP1_OFF).astype(xp.int32), exp2x2.astype(xp.int32)


# ----------------------------------------------------------------- device plane


def _luts(dtype):
    pow43 = np.array([float(i) ** (4.0 / 3.0) for i in range(8207)], dtype=np.float64)
    e1 = np.array([2.0 ** ((i - _EXP1_OFF) / 4.0) for i in range(512)], dtype=np.float64)
    e2 = np.array([2.0 ** (-(i / 2.0)) for i in range(_EXP2X2_MAX)], dtype=np.float64)
    return (jnp.asarray(pow43, dtype), jnp.asarray(e1, dtype), jnp.asarray(e2, dtype))


_HIGHEST = jax.lax.Precision.HIGHEST


def _expand_slots(vals, slot_map, mode, dtype):
    """Expand per-slot values (..., T, K) to per-sample (..., T, 576) by
    matmul: out[.., t, s] = vals[.., t, slot_map[mode[.., t], s]].

    This replaces data-dependent ``take_along_axis`` over tiny axes with one (.., 4K) @ (4K, 576) matmul against a
    static {0,1} expansion matrix, selection over ``mode`` folded in via a
    one-hot product. Exact for any float32 payload at HIGHEST precision
    (full float32, no TF32): each sum has one nonzero 1.0-weighted term."""
    n_modes, n_samp = slot_map.shape
    k = vals.shape[-1]
    w = (slot_map[:, None, :] == jnp.arange(k, dtype=jnp.int32)[None, :, None])
    w = w.reshape(n_modes * k, n_samp).astype(dtype)          # (4K, 576)
    moh = (mode[..., None] == jnp.arange(n_modes, dtype=jnp.int32))
    a = moh[..., :, None].astype(dtype) * vals[..., None, :]  # (.., 4, K)
    a = a.reshape(a.shape[:-2] + (n_modes * k,))
    return jnp.einsum("...k,ks->...s", a, w,
                      preferred_element_type=dtype, precision=_HIGHEST)


def _onehot_rows(idx, table, dtype):
    """table[idx] for a tiny table (rows, ...) via an exact one-hot matmul
    (same gather avoidance as ``_expand_slots``); idx (...,), returns
    (..., *table.shape[1:])."""
    rows = table.shape[0]
    oh = (idx[..., None] == jnp.arange(rows, dtype=jnp.int32)).astype(dtype)
    flat = table.reshape(rows, -1)
    out = jnp.einsum("...r,rj->...j", oh, flat,
                     preferred_element_type=dtype, precision=_HIGHEST)
    return out.reshape(idx.shape + table.shape[1:])


def _onehot_rows_2l(idx, table, dtype, lo: int = 16):
    """``table[idx]`` as a TWO-STAGE exact one-hot select: a hi-part one-hot
    matmul picks a ``lo``-row block, a lo-part one-hot mul+reduce folds
    within it. Building the flat ``rows``-way one-hot is compare-bound;
    the two stages cost ~(rows/lo + lo) compares per element instead.
    Exact for any payload: every
    product carries a 0/1 factor and each reduction has one nonzero term."""
    rows = table.shape[0]
    nhi = -(-rows // lo)
    flat = table.reshape(rows, -1)
    if nhi * lo != rows:
        flat = jnp.concatenate(
            [flat, jnp.zeros((nhi * lo - rows, flat.shape[1]), flat.dtype)],
            axis=0)
    ohhi = ((idx // lo)[..., None]
            == jnp.arange(nhi, dtype=jnp.int32)).astype(dtype)
    tmp = jnp.einsum("...r,rj->...j", ohhi, flat.reshape(nhi, -1),
                     preferred_element_type=dtype, precision=_HIGHEST)
    tmp = tmp.reshape(idx.shape + (lo, flat.shape[1]))
    ohlo = ((idx % lo)[..., None]
            == jnp.arange(lo, dtype=jnp.int32)).astype(dtype)
    out = jnp.sum(tmp * ohlo[..., None], axis=-2)
    return out.reshape(idx.shape + table.shape[1:])


def _pow2_int(e, dtype):
    """Exact 2**e for integer-valued e within the normal range of ``dtype``,
    built by writing the exponent bits directly (no transcendental, no LUT
    gather). e float (integer-valued), f32: e in [-126, 127]."""
    if dtype == jnp.float64:
        bits = (e.astype(jnp.int64) + 1023) << 52
        return jax.lax.bitcast_convert_type(bits, jnp.float64)
    bits = ((e.astype(jnp.int32) + 127) << 23)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _imdct_mats(dtype):
    sine = T.sine_block()
    c_long = T.imdct_long_cos()        # (36,18)
    c_short = T.imdct_short_cos()      # (12,6)
    return (jnp.asarray(c_long, dtype), jnp.asarray(c_short, dtype),
            jnp.asarray(sine, dtype))


# input pytree key groups (used by batching/sharding layers)
T_AXIS1_KEYS = ("raw_i8", "mode", "gg", "sfscale", "pre", "sbg", "sfl", "sfs",
                "reorder_mask", "win_row", "is_short_blk")
T_AXIS0_KEYS = ("ms_mask", "is_mask", "is_pos", "is_tab")
# sparse int16 escape values for the rare |sample| > 127 (linbits) entries;
# padded entries use an out-of-bounds index and are dropped by the scatter
EXC_KEYS = ("exc_t", "exc_ch", "exc_s", "exc_val")
CONST_KEYS = ("reorder_perm", "walk_is_short", "walk_sfb", "walk_win",
              "pre_ext", "slot_exp", "slot_is", "mix_short_cols",
              "mix_raw_cols", "mix_lin_cols", "mix_long_band")
ALL_KEYS = T_AXIS1_KEYS + T_AXIS0_KEYS + EXC_KEYS + CONST_KEYS

_EXC_PAD_T = 1 << 28  # out-of-range granule index marks padding


def dense_raw(prep, xp=np):
    """Reconstruct the dense int32 Huffman sample tensor from the int8 plane +
    sparse int16 exceptions (or pass through a pre-densified "raw_dense",
    used by the frame-sharded path where exception indices are global)."""
    if "raw_dense" in prep:
        return prep["raw_dense"].astype(xp.int32)
    raw = prep["raw_i8"].astype(xp.int32)
    ch, tt = raw.shape[0], raw.shape[1]
    flat = raw.reshape(-1)
    if xp is np:
        idx = ((prep["exc_ch"].astype(np.int64) * tt
                + prep["exc_t"].astype(np.int64)) * 576
               + prep["exc_s"].astype(np.int64))
        ok = prep["exc_t"] < tt
        flat[idx[ok]] = prep["exc_val"][ok].astype(np.int32)
        return flat.reshape(ch, tt, 576)
    flat = flat.at[_exc_indices(prep, tt, xp)].set(
        prep["exc_val"].astype(xp.int32), mode="drop")
    return flat.reshape(ch, tt, 576)


def _exc_indices(prep, tt, xp):
    """Flat scatter indices of the linbits escapes into a (2, tt, 576) plane.

    Padding sentinels must stay out-of-bounds under 32-BIT index math: XLA
    may truncate scatter indices to s32, and the raw sentinel
    _EXC_PAD_T*576 = 9*2^34 wraps to exactly 0 — which silently zeroed
    sample (ch0, granule0, s0) of any batched file with fewer escapes than
    the batch max. Clamp dropped entries to 2^31-1 (OOB for any flat plane
    below ~6.7 h of audio) so mode="drop" actually drops them."""
    idx = ((prep["exc_ch"].astype(xp.int64) * tt
            + prep["exc_t"].astype(xp.int64)) * 576
           + prep["exc_s"].astype(xp.int64))
    return xp.where(prep["exc_t"].astype(xp.int64) < tt, idx,
                    xp.int64(2**31 - 1))


def granule_blocks(prep, dtype):
    """Granule-local half of the decode plane: requantize -> MS stereo ->
    reorder/alias -> windowed IMDCT blocks. No cross-granule dependencies, so
    this stage shards freely over the time axis. Returns (ch, T, 32, 36).

    Each stage is a ``jax.named_scope``-decorated function so profiler traces
    attribute device time per stage (tools/profile_planes.py builds the
    utilization table from the scopes; they don't change the lowered program).
    """
    x = _requantize_stage(prep, dtype)
    x = _stereo_stage(prep, x, dtype)
    x = _reorder_alias_stage(prep, x, dtype)
    return _imdct_stage(prep, x, dtype)


@jax.named_scope("requantize")
def _requantize_stage(prep, dtype):
    pow43, _, _ = _luts(dtype)

    # ---- requantize (Frame.py:157-218). Same math as exponent_indices +
    # the three LUTs, restructured for matmuls: per-band exponents are
    # computed on the compact 61-slot grid (22 long sfb + 3x13 short) and
    # expanded to samples by one one-hot matmul; the combined scale
    # 2^(exp1/4 - exp2x2/2) = 2^(q/4) is then an exact exponent-bit
    # construction (q>>2) times a 4-entry quarter-power select — no
    # data-dependent gathers anywhere.
    #
    # |x|^(4/3): exact LUT rows via one-hot matmul for |x| <= 128 (the int8
    # sample plane's full range, including -128); the rare linbits escapes
    # (|x| up to 8206) take the transcendental path, whose ~ulp-level error
    # is immaterial at their population (<1e-4 of samples). The 129-way
    # split is identical in the int8 and pre-densified (sharded) paths so
    # both produce bit-equal planes.
    def pow43_big(v):
        return jnp.exp2(dtype.type(4.0 / 3.0)
                        * jnp.log2(jnp.maximum(v, 1).astype(dtype)))

    if "raw_dense" in prep:
        raw = prep["raw_dense"].astype(jnp.int32)
        sign = jnp.where(raw < 0, dtype.type(-1.0), dtype.type(1.0))
        absx = jnp.abs(raw)
        a = jnp.where(absx <= 128,
                      _onehot_rows_2l(jnp.minimum(absx, 128), pow43[:129],
                                      dtype),
                      pow43_big(absx))
    else:
        # skip densifying int32 samples entirely: |x|^(4/3) comes straight
        # off the int8 plane (sign survives the clip), and only the escape
        # fix-ups scatter into the float result
        r32 = prep["raw_i8"].astype(jnp.int32)
        sign = jnp.where(r32 < 0, dtype.type(-1.0), dtype.type(1.0))
        a = _onehot_rows_2l(jnp.abs(r32), pow43[:129], dtype)
        ev = jnp.abs(prep["exc_val"].astype(jnp.int32))
        a_exc = jnp.where(ev <= 128, pow43[jnp.minimum(ev, 128)],
                          pow43_big(ev))
        ch_, tt_ = r32.shape[0], r32.shape[1]
        a = a.reshape(-1).at[_exc_indices(prep, tt_, jnp)].set(
            a_exc, mode="drop").reshape(ch_, tt_, 576)

    gg = prep["gg"].astype(jnp.int32)                     # (2,T)
    sbg = prep["sbg"].astype(jnp.int32)                   # (2,T,3)
    pre_l = prep["pre"].astype(jnp.int32)[..., None] \
        * prep["pre_ext"].astype(jnp.int32)[:22]
    sf_long = prep["sfl"].astype(jnp.int32) + pre_l       # (2,T,22)
    mult2 = jnp.where(prep["sfscale"].astype(jnp.int32) == 0, 1, 2)[..., None]
    exp1_slot = jnp.concatenate(
        [jnp.broadcast_to((gg - 210)[..., None], gg.shape + (22,)),
         jnp.repeat((gg[..., None] - 210 - 8 * sbg), 13, axis=-1)], axis=-1)
    val_slot = jnp.concatenate(
        [sf_long, prep["sfs"].astype(jnp.int32)], axis=-1)  # (2,T,61)
    exp1_idx = jnp.clip(exp1_slot + _EXP1_OFF, 0, 511)
    exp2x2 = jnp.clip(mult2 * val_slot, 0, _EXP2X2_MAX - 1)
    q_slot = (exp1_idx - _EXP1_OFF - 2 * exp2x2).astype(dtype)
    q = _expand_slots(q_slot, prep["slot_exp"], prep["mode"].astype(jnp.int32),
                      dtype)                               # (2,T,576)
    qi = jnp.floor(q * dtype.type(0.25))
    frac = q - dtype.type(4.0) * qi                        # in {0,1,2,3}
    c14, c12, c34 = (dtype.type(2.0 ** 0.25), dtype.type(2.0 ** 0.5),
                     dtype.type(2.0 ** 0.75))
    fr = jnp.where(frac == 0, dtype.type(1.0),
                   jnp.where(frac == 1, c14,
                             jnp.where(frac == 2, c12, c34)))
    return (sign * a) * (fr * _pow2_int(qi, dtype))


@jax.named_scope("stereo")
def _stereo_stage(prep, x, dtype):
    # ---- MS stereo (Frame.py:561-572)
    mid, side = x[0], x[1]
    l = (mid + side) / dtype.type(SQRT2)
    r = (mid - side) / dtype.type(SQRT2)
    ms = prep["ms_mask"][None, :, None]
    x = jnp.where(ms, jnp.stack([l, r]), x)

    # ---- intensity stereo overlay (beyond-reference; validated vs mpg123).
    # Flagged bands replace BOTH channels from the left spectrum:
    # L' = L*A[pos], R' = L*B[pos]; other samples keep the MS/LR result, so
    # streams without the intensity mode_ext bit are bit-for-bit unchanged.
    # Per-band positions live on the (4,22)=88-slot intensity grid (window
    # rows 0..2 short, row 3 long); the A/B coefficients and the active mask
    # are computed per slot, then all three expand to samples through one
    # one-hot matmul (slot_is carries the short-window/long-row-3 walk).
    #
    # Empty ``is_pos`` (shape (0,4,22)) is the static no-IS contract: a
    # batch prep that knows no granule carries intensity passes empty
    # tensors and the whole overlay (two expansion matmuls — measured ~8%
    # of plane time, all overhead FLOPs) compiles away.
    if prep["is_pos"].shape[0] == 0:
        return x
    mode1 = prep["mode"].astype(jnp.int32)[1]
    tt1 = mode1.shape[0]
    pos_slot = prep["is_pos"].astype(jnp.int32).reshape(tt1, 88)
    coef = jnp.asarray(_is_coef(), dtype)                  # (6,2,16)
    crow = _onehot_rows(prep["is_tab"].astype(jnp.int32), coef, dtype)
    ohp = (jnp.clip(pos_slot, 0, 15)[..., None]
           == jnp.arange(16, dtype=jnp.int32)).astype(dtype)  # (T,88,16)
    clr_slot = jnp.einsum("tkp,tjp->jtk", ohp, crow,
                          preferred_element_type=dtype,
                          precision=_HIGHEST)              # (2,T,88)
    ok_slot = (pos_slot >= 0).astype(dtype)
    vals = jnp.concatenate([clr_slot, ok_slot[None]], axis=0)  # (3,T,88)
    expd = _expand_slots(vals, prep["slot_is"],
                         jnp.broadcast_to(mode1, (3, tt1)), dtype)
    cl, cr = expd[0], expd[1]
    active = (expd[2] > dtype.type(0.5)) & prep["is_mask"][:, None]
    left0 = x[0]
    return jnp.where(active[None], jnp.stack([left0 * cl, left0 * cr]), x)


@jax.named_scope("reorder_alias")
def _reorder_alias_stage(prep, x, dtype):
    # ---- reorder (short) / alias reduction (long) / ISO-mixed blend.
    # Mixed (mode 3) granules take a 3-way column split: the short region
    # (col >= S) reorders exactly like a pure short granule (geometry note
    # in _mix_geometry: the full-short perm's entries above S ARE the mixed
    # reorder); cols below 18K-8 take the full-alias result (identical to
    # applying only butterflies 1..K-1 there); cols 18K-8..S-1 revert to
    # the raw spectrum (no butterfly at or above boundary K, and at 8 kHz
    # the unreordered long-walk samples 36..71 feed short windows raw —
    # the mpg123/ffmpeg behavior).
    perm = prep["reorder_perm"]
    reord = jnp.where(perm[None, None, :] >= 0,
                      jnp.take(x, jnp.maximum(perm, 0), axis=2),
                      dtype.type(0.0))
    off1, off2, cs_np, ca_np = _alias_indices()
    cs = jnp.asarray(cs_np, dtype)
    ca = jnp.asarray(ca_np, dtype)
    s1 = x[..., off1]
    s2 = x[..., off2]
    aliased = x.at[..., off1].set(s1 * cs - s2 * ca).at[..., off2].set(s2 * cs + s1 * ca)
    m3 = (prep["mode"] == 3)                                   # (2,T)
    sel_reord = jnp.where(m3[..., None], prep["mix_short_cols"][None, None],
                          prep["reorder_mask"][..., None])
    out = jnp.where(sel_reord, reord, aliased)
    # 8 kHz-only middle (cols 18K..S-1 = 36..71): long-walk, UNREORDERED
    # spectrum under short windows — mpg123's dct12 reads it with stride 3
    # (window w, coef s <- x[36+3s+w]); in this plane's window-major layout
    # that is a per-18-chunk transpose (pinned on avcodec/mpg123 impulse
    # responses, tests/test_mixed_blocks.py). mix_lin_cols is empty at
    # every other samplerate.
    nch0, nt0 = x.shape[0], x.shape[1]
    mid = jnp.swapaxes(x[..., 36:72].reshape(nch0, nt0, 2, 6, 3), -1, -2)
    mid_full = jnp.concatenate(
        [x[..., :36], mid.reshape(nch0, nt0, 36), x[..., 72:]], axis=-1)
    out = jnp.where(m3[..., None] & prep["mix_lin_cols"][None, None],
                    mid_full, out)
    return jnp.where(m3[..., None] & prep["mix_raw_cols"][None, None], x, out)


@jax.named_scope("imdct")
def _imdct_stage(prep, x, dtype):
    c_long, c_short, sine = _imdct_mats(dtype)
    m3 = (prep["mode"] == 3)                                   # (2,T)
    # ---- IMDCT + windowing (Frame.py:106-154); x layout is [band*18 + k]
    ch, tt = x.shape[0], x.shape[1]
    s = x.reshape(ch, tt, 32, 18)

    # long path: X = S @ C^T then window row per granule (one matmul)
    xi_long = jnp.einsum("ctbk,ik->ctbi", s, c_long,
                         preferred_element_type=dtype,
                         precision=jax.lax.Precision.HIGHEST)
    win_long = _onehot_rows(
        jnp.clip(prep["win_row"], 0, 3).astype(jnp.int32), sine, dtype)
    blk_long = xi_long * win_long[:, :, None, :]

    # short path: 3 windows of 6 inputs -> 12 outputs each, windowed + merged
    s3 = s.reshape(ch, tt, 32, 3, 6)
    xi_s = jnp.einsum("ctbwk,ik->ctbwi", s3, c_short,
                      preferred_element_type=dtype,
                      precision=jax.lax.Precision.HIGHEST)  # (ch,T,32,3,12)
    xi_s = xi_s * sine[2][:12]
    z6 = jnp.zeros(xi_s.shape[:3] + (6,), dtype)
    blk_short = jnp.concatenate([
        z6,
        xi_s[..., 0, 0:6],
        xi_s[..., 0, 6:12] + xi_s[..., 1, 0:6],
        xi_s[..., 1, 6:12] + xi_s[..., 2, 0:6],
        xi_s[..., 2, 6:12],
        z6,
    ], axis=-1)

    # ISO-mixed granules keep long (block_type 0) windows on the first K
    # subbands; win_row is already 0 for them (host_prepare), so blk_long
    # carries the right windowing there
    short_band = prep["is_short_blk"][..., None] \
        & ~(m3[..., None] & prep["mix_long_band"][None, None])   # (2,T,32)
    blk = jnp.where(short_band[..., None], blk_short, blk_long)
    return blk


def synth_from_blocks(blk, dtype, tail_halo=None, v_halo=None):
    """Sequential half of the decode plane: IMDCT overlap-add -> frequency
    inversion -> polyphase synthesis (V matmul + 16-tap FIR over V history).

    The two carried states cross granule boundaries by exactly one granule:
    ``tail_halo`` (ch, 1, 32, 18) is the previous granule's window tail
    (prev_samples, Frame.py:150-154) and ``v_halo`` (ch, 15, 64) the previous
    15 synthesis sub-steps (the 1024-FIFO, Frame.py:80-101). None = stream
    start (zeros). Frame-range sharding passes neighbours' halos here.

    Returns (pcm (ch,T,576), last_tail (ch,1,32,18), last_v (ch,15,64)).
    """
    ch, tt = blk.shape[0], blk.shape[1]

    with jax.named_scope("overlap_freqinv"):
        head = blk[..., :18]
        tail = blk[..., 18:]
        if tail_halo is None:
            tail_halo = jnp.zeros_like(tail[:, :1])
        prev = jnp.concatenate([tail_halo, tail[:, :-1]], axis=1)
        y = head + prev                                # (ch,T,32,18)

        # ---- frequency inversion (Frame.py:624-631)
        y = y * jnp.asarray(_freq_inv_mask().reshape(32, 18), dtype)

    with jax.named_scope("synth_v"):
        # ---- synthesis filterbank (Frame.py:65-103): matmul + 16-tap FIR
        n_mat = jnp.asarray(T.synth_filter_matrix(), dtype)    # (64,32)
        st = y.transpose(0, 1, 3, 2).reshape(ch, tt * 18, 32)  # step major
        # HIGHEST: the synthesis matmul feeds int16 PCM; a bf16 or TF32
        # matmul would cost ~3e-3 absolute error (audible floor)
        v = jnp.einsum("cts,is->cti", st, n_mat, preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)

    with jax.named_scope("synth_fir"):
        if v_halo is None:
            v_halo = jnp.zeros((ch, 15, 64), dtype)
        v_ext = jnp.concatenate([v_halo, v], axis=1)
        ts_total = tt * 18

        va_p, vb_p = v_ext[..., :32], v_ext[..., 32:]
        d_win = jnp.asarray(T.SYNTH_WINDOW.reshape(16, 32), dtype)
        pcm_steps = jnp.zeros((ch, ts_total, 32), dtype)
        for j in range(16):  # reference sums j ascending (Frame.py:97-101)
            src = va_p if j % 2 == 0 else vb_p
            pcm_steps = pcm_steps + d_win[j] * jax.lax.dynamic_slice_in_dim(
                src, 15 - j, ts_total, axis=1)

    pcm = pcm_steps.reshape(ch, tt, 576)
    return pcm, tail[:, -1:], v[:, -15:]


def decode_granules_impl(prep, dtype_name="float64"):
    """Input pytree (see host_prepare) -> (2ch, T, 576) PCM, fully batched.
    Unjitted form, vmappable over a leading file axis."""
    dtype = jnp.dtype(dtype_name)
    blk = granule_blocks(prep, dtype)
    pcm, _, _ = synth_from_blocks(blk, dtype)
    return pcm


decode_granules = jax.jit(decode_granules_impl, static_argnames=("dtype_name",))


def decode_granules_np(prep: dict, stages: dict = None) -> np.ndarray:
    """Bit-exact float64 parity path: the same batched pipeline as
    ``decode_granules`` evaluated with NumPy on host.

    Exists because XLA contracts multiply+add chains into FMAs (single
    rounding), which perturbs the float64 stream in the last ulp relative to
    the reference's separate mul/add arithmetic (Frame.py:65-218). NumPy never
    emits FMAs, so this path reproduces the reference float-for-float; the
    jitted float32 path is the device throughput mode. Pass ``stages={}`` to
    capture per-stage tensors for golden tests."""
    raw = dense_raw(prep, xp=np)
    pow43 = np.array([float(i) ** (4.0 / 3.0) for i in range(8207)])
    e1lut = np.array([2.0 ** ((i - _EXP1_OFF) / 4.0) for i in range(512)])
    e2lut = np.array([2.0 ** (-(i / 2.0)) for i in range(_EXP2X2_MAX)])

    # requantize
    exp1_idx, exp2x2 = exponent_indices(prep, xp=np)
    ix = raw.astype(np.int64)
    sign = np.where(raw < 0, -1.0, 1.0)
    x = ((sign * pow43[np.abs(ix)])
         * e1lut[np.clip(exp1_idx, 0, 511)]) \
        * e2lut[np.clip(exp2x2, 0, _EXP2X2_MAX - 1)]
    if stages is not None:
        stages["requant"] = x.copy()

    # MS stereo
    l = (x[0] + x[1]) / SQRT2
    r = (x[0] - x[1]) / SQRT2
    ms = prep["ms_mask"][None, :, None]
    x = np.where(ms, np.stack([l, r]), x)

    # intensity stereo overlay (beyond-reference; validated vs mpg123):
    # flagged bands replace both channels from the left spectrum; other
    # samples keep the MS/LR result bit-for-bit
    if prep["is_mask"].any():
        mode1 = prep["mode"].astype(np.int32)[1]
        sfb_r = prep["walk_sfb"][mode1]                              # (T,576)
        win_r = np.where(prep["walk_is_short"][mode1].astype(bool),
                         prep["walk_win"][mode1], 3)
        tix = np.arange(sfb_r.shape[0])[:, None]
        pos = prep["is_pos"].astype(np.int32)[tix, win_r, sfb_r]
        active = (pos >= 0) & prep["is_mask"][:, None]
        coef = _is_coef()
        msr = prep["is_tab"].astype(np.int32)[:, None]    # (T,1) table row
        pc = np.clip(pos, 0, 15)
        cl = coef[msr, 0, pc]
        cr = coef[msr, 1, pc]
        left0 = x[0]
        x = np.where(active[None], np.stack([left0 * cl, left0 * cr]), x)

    # reorder / alias / ISO-mixed blend (same 3-way split as granule_blocks)
    perm = prep["reorder_perm"]
    reord = np.where(perm[None, None, :] >= 0,
                     np.take(x, np.maximum(perm, 0), axis=2), 0.0)
    off1, off2, cs, ca = _alias_indices()
    s1 = x[..., off1].copy()
    s2 = x[..., off2].copy()
    aliased = x.copy()
    aliased[..., off1] = s1 * cs - s2 * ca
    aliased[..., off2] = s2 * cs + s1 * ca
    m3 = (prep["mode"] == 3)
    sel_reord = np.where(m3[..., None], prep["mix_short_cols"][None, None],
                         prep["reorder_mask"][..., None])
    out = np.where(sel_reord, reord, aliased)
    # 8 kHz-only unreordered middle under short windows (see granule_blocks)
    nch0, nt0 = x.shape[0], x.shape[1]
    mid = np.swapaxes(x[..., 36:72].reshape(nch0, nt0, 2, 6, 3), -1, -2)
    mid_full = np.concatenate(
        [x[..., :36], mid.reshape(nch0, nt0, 36), x[..., 72:]], axis=-1)
    out = np.where(m3[..., None] & prep["mix_lin_cols"][None, None],
                   mid_full, out)
    x = np.where(m3[..., None] & prep["mix_raw_cols"][None, None], x, out)
    if stages is not None:
        stages["pre_imdct"] = x.copy()

    # IMDCT (ascending-k accumulation, Frame.py:126-130)
    nch, tt = x.shape[0], x.shape[1]
    s = x.reshape(nch, tt, 32, 18)
    c_long = T.imdct_long_cos()
    c_short = T.imdct_short_cos()
    sine = T.sine_block()
    xi_long = np.zeros(s.shape[:3] + (36,))
    for k in range(18):
        xi_long += s[..., k, None] * c_long[None, None, None, :, k]
    win_long = sine[np.clip(prep["win_row"], 0, 3)]
    blk_long = xi_long * win_long[:, :, None, :]

    s3 = s.reshape(nch, tt, 32, 3, 6)
    xi_s = np.zeros(s3.shape[:4] + (12,))
    for k in range(6):
        xi_s += s3[..., k, None] * c_short[None, None, None, None, :, k]
    xi_s = xi_s * sine[2][:12]
    z6 = np.zeros(xi_s.shape[:3] + (6,))
    blk_short = np.concatenate([
        z6, xi_s[..., 0, 0:6], xi_s[..., 0, 6:12] + xi_s[..., 1, 0:6],
        xi_s[..., 1, 6:12] + xi_s[..., 2, 0:6], xi_s[..., 2, 6:12], z6,
    ], axis=-1)
    short_band = prep["is_short_blk"][..., None] \
        & ~(m3[..., None] & prep["mix_long_band"][None, None])
    blk = np.where(short_band[..., None], blk_short, blk_long)

    head = blk[..., :18]
    tail = blk[..., 18:]
    prev = np.concatenate([np.zeros_like(tail[:, :1]), tail[:, :-1]], axis=1)
    y = head + prev
    if stages is not None:
        stages["post_imdct"] = y.reshape(nch, tt, 576).copy()

    y = y * _freq_inv_mask().reshape(32, 18)
    if stages is not None:
        stages["pre_synth"] = y.reshape(nch, tt, 576).copy()

    # synthesis: V matmul (ascending-j) + 16-tap FIR (ascending-j)
    n_mat = T.synth_filter_matrix()
    st = y.transpose(0, 1, 3, 2).reshape(nch, tt * 18, 32)
    v = np.zeros((nch, tt * 18, 64))
    for j in range(32):
        v += st[..., j, None] * n_mat[None, None, :, j]
    va_p = np.concatenate([np.zeros((nch, 15, 32)), v[..., :32]], axis=1)
    vb_p = np.concatenate([np.zeros((nch, 15, 32)), v[..., 32:]], axis=1)
    d_win = T.SYNTH_WINDOW.reshape(16, 32)
    ts_total = tt * 18
    pcm_steps = np.zeros((nch, ts_total, 32))
    for j in range(16):
        src = va_p if j % 2 == 0 else vb_p
        pcm_steps += src[:, 15 - j:15 - j + ts_total] * d_win[j]
    return pcm_steps.reshape(nch, tt, 576)


def _f64_tables():
    """C-contiguous float64 constant tables for the native f64 plane, keyed
    on the start-window mode so tests can flip
    MP3STEGO_TPU_REF_START_WINDOW without stale tables."""
    return _f64_tables_impl(T.ref_start_window())


@functools.lru_cache(maxsize=2)
def _f64_tables_impl(ref_start_window: bool):
    pow43 = np.array([float(i) ** (4.0 / 3.0) for i in range(8207)])
    e1lut = np.array([2.0 ** ((i - _EXP1_OFF) / 4.0) for i in range(512)])
    e2lut = np.array([2.0 ** (-(i / 2.0)) for i in range(_EXP2X2_MAX)])
    cc = lambda a: np.ascontiguousarray(a, np.float64)
    return (cc(pow43), cc(e1lut), cc(e2lut),
            cc(T.ALIAS_CS), cc(T.ALIAS_CA),
            cc(T.imdct_long_cos()), cc(T.imdct_short_cos()),
            cc(T.sine_block()), cc(T.synth_filter_matrix()),
            cc(T.SYNTH_WINDOW.reshape(16, 32)))


def _native_plane_args(p):
    """(lib, marshalled argument tuple) for the native f64/i16 decode plane,
    or None when the native library is unavailable."""
    from mp3stego_tpu.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "decode_plane_f64"):
        return None
    sr = p.header.sr_idx
    walk_is_short, walk_sfb, walk_win, pre_ext = _walk_maps(sr, _iso_bands(sr))
    bt_ct = np.moveaxis(p.block_type, 2, 0).reshape(2, -1)
    mixed_ct = np.moveaxis(p.mixed_block_flag, 2, 0).reshape(2, -1) != 0
    is_pos, is_mask, is_tab = _intensity_positions(p, bt_ct, mixed_ct)
    c32 = lambda a: np.ascontiguousarray(a, np.int32)
    return lib, (
        p.num_frames,
        c32(p.raw_samples), c32(p.block_type), c32(p.mixed_block_flag),
        c32(p.global_gain), c32(p.scale_fac_scale), c32(p.pre_flag),
        c32(p.sub_block_gain), c32(p.scale_fac_l), c32(p.scale_fac_s),
        np.ascontiguousarray(p.ms_stereo, np.uint8),
        np.ascontiguousarray(is_mask, np.uint8),
        np.ascontiguousarray(is_pos, np.int8),
        np.ascontiguousarray(is_tab, np.int8),
        np.ascontiguousarray(_is_coef().reshape(-1), np.float64),
        c32(walk_is_short), c32(walk_sfb), c32(walk_win), c32(pre_ext),
        c32(_reorder_perm(sr, _iso_bands(sr))),
        *_f64_tables(),
        _mix_geometry(sr)[1] if _iso_mixed_on(sr) else 0,
        _mix_geometry(sr)[0])


def decode_granules_f64_native(p) -> "np.ndarray | None":
    """Fused native float64 decode plane (native/src/decode_plane_f64.cpp):
    float-for-float identical to ``decode_granules_np`` (pinned by
    test_native_f64_plane_matches_numpy), one pass per granule instead of ~40
    full-array NumPy passes. Returns None when the native library is
    unavailable (callers fall back to the NumPy oracle). Consumes the
    ParsedMP3 (F,2,2,...) layout directly — no host transpose."""
    la = _native_plane_args(p)
    if la is None:
        return None
    lib, args = la
    out = np.empty((2, 2 * p.num_frames, 576), np.float64)
    lib.decode_plane_f64(*args, out)
    return out


def _finish_inter(p, inter: np.ndarray) -> np.ndarray:
    """Trim virtual-frame padding (LSF), apply the stale-PCM duplication
    quirk (MP3_Parser.py:79; one real frame = 576 samples for LSF), and drop
    a Xing/Info/VBRI tag frame's silence (bitstream/vbr.py) — the single
    finishing step shared by every PCM producer."""
    spf = 576 if p.lsf_granules else 1152
    if p.lsf_granules:
        inter = inter[:p.lsf_granules * 576]
    if p.duplicate_last_pcm:
        inter = np.concatenate([inter, inter[-spf:]], axis=0)
    if p.skip_first_pcm:
        inter = inter[spf:]
    return inter


def decode_pcm_i16_host(p) -> "np.ndarray | None":
    """ParsedMP3 -> interleaved int16 PCM (samples, channels) straight from
    the native f64 plane — byte-identical to
    ``(decode_pcm(p, "float64") * 32767).astype(int16)`` without ever
    materializing the float64 PCM on the Python side (the host is
    page-fault-bandwidth-bound, so skipping the transpose/scale/cast numpy
    passes is ~2x end-to-end on long files). None when native is unavailable."""
    if p.num_frames == 0:
        return np.zeros((0, 2), np.int16)
    la = _native_plane_args(p)
    if la is None:
        return None
    lib, args = la
    ch = p.header.channels
    out = np.empty((2 * p.num_frames * 576, ch), np.int16)
    lib.decode_plane_i16(*args, out, ch, 1 if T.ref_pcm_wrap() else 0)
    return _finish_inter(p, out)


def decode_pcm(p, dtype: str = "float64") -> np.ndarray:
    """ParsedMP3 -> interleaved PCM (samples, channels) float array, including the
    reference's stale-frame duplication quirk (MP3_Parser.py:79)."""
    if p.num_frames == 0:
        return np.zeros((0, 2))
    if dtype == "float64":
        # bit-exact parity plane on host: fused C++ when available,
        # float-for-float NumPy twin otherwise
        pcm = decode_granules_f64_native(p)
        if pcm is None:
            pcm = decode_granules_np(host_prepare(p))
    else:
        pcm = np.asarray(_decode_call(host_prepare(p), dtype))
    ch = p.header.channels
    t = pcm.shape[1]
    inter = pcm[:ch].transpose(1, 2, 0).reshape(t * 576, ch)
    return _finish_inter(p, inter)


_DEC_BUCKET = 128  # granule bucket: any file length reuses a few compiles


def _pad_prep_granules(prep: dict, t_pad: int) -> dict:
    """Zero-pad the granule axis (padded granules decode to silence and the
    synthesis chain is causal, so real output is unchanged; callers trim)."""
    out = dict(prep)
    for k in T_AXIS1_KEYS:
        a = prep[k]
        width = [(0, 0)] * a.ndim
        width[1] = (0, t_pad - a.shape[1])
        out[k] = np.pad(a, width)
    for k in T_AXIS0_KEYS:
        a = prep[k]
        width = [(0, 0)] * a.ndim
        width[0] = (0, t_pad - a.shape[0])
        out[k] = np.pad(a, width)
    return out


def _decode_call(prep, dtype, to_i16=False):
    from mp3stego_tpu.utils.transfer import fetch_pieces, put_pieces
    t = prep["raw_i8"].shape[1]
    t_pad = -(-t // _DEC_BUCKET) * _DEC_BUCKET
    if t_pad != t:
        prep = _pad_prep_granules(prep, t_pad)
    args = {k: put_pieces(prep[k]) for k in ALL_KEYS}
    if to_i16:
        out = _decode_granules_i16(args, wrap=T.ref_pcm_wrap())
    else:
        out = decode_granules(args, dtype_name=dtype)
    ch = out.shape[0]
    flat = fetch_pieces([out.reshape(ch * t_pad, 576)])[0]
    return flat.reshape(ch, t_pad, 576)[:, :t]


@functools.partial(jax.jit, static_argnames=("wrap",))
def _decode_granules_i16(args, wrap=False):
    """float32 plane + the WAV int16 conversion ON DEVICE (halves the fetch).
    Default saturates clipping peaks (tables.ref_pcm_wrap); ``wrap=True``
    reproduces numpy's ``(pcm * 32767).astype(int16)`` (truncate toward
    zero, wrap mod 2^16 — the reference's conversion)."""
    pcm = decode_granules_impl(args, dtype_name="float32")
    x = pcm * jnp.float32(32767)
    if not wrap:
        x = jnp.clip(x, jnp.float32(-32768), jnp.float32(32767))
    return x.astype(jnp.int32).astype(jnp.int16)


def pcm_to_i16(pcm: np.ndarray) -> np.ndarray:
    """float PCM -> int16 WAV samples on host: saturating by default,
    or the reference's truncate+wrap when MP3STEGO_TPU_REF_PCM_WRAP=1."""
    x = pcm * 32767.0
    if not T.ref_pcm_wrap():
        x = np.clip(x, -32768.0, 32767.0)
    return x.astype(np.int16)


def decode_pcm_i16(p) -> np.ndarray:
    """ParsedMP3 -> interleaved int16 PCM (samples, channels): the float32
    device path fused with the WAV conversion, fetched at half the bytes."""
    if p.num_frames == 0:
        return np.zeros((0, 2), np.int16)
    prep = host_prepare(p)
    pcm = _decode_call(prep, "float32", to_i16=True)
    ch = p.header.channels
    t = pcm.shape[1]
    inter = pcm[:ch].transpose(1, 2, 0).reshape(t * 576, ch)
    return _finish_inter(p, inter)
