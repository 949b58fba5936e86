"""Batched device encode numeric plane: polyphase analysis filterbank + forward MDCT
+ alias butterflies, in exact Q31 fixed point.

The reference feeds a 512-sample ring buffer 32 samples at a time
(MP3_Encoder.py:321-370, 751-758); the ring arithmetic reduces to a pure sliding
window over the per-channel PCM stream:

    tmp_t[i]  = sum_k mul(s[32t + 31 - i - 64k], enwindow[i + 64k])   k<8, i<64
    sb_t[b]   = sum_j mul(fl[b][j], tmp_t[j])                          j<64

so the whole file becomes one dense batched gather + multiply + reduce. The MDCT
input for granule g is [subband(g-1) ; subband(g)] per band (MP3_Encoder.py:681-701)
— a shifted concat over the granule axis, not a scan. Alias butterflies
(MP3_Encoder.py:703-744) only ever read unmodified MDCT outputs, so they batch
cleanly.

int32 sums wrap mod 2^32 (associative), hence every reduction is order-free and
bit-exact vs the sequential reference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mp3stego_tpu import tables as T
from mp3stego_tpu.ops import fixedpoint as fx


_PAST = 480  # deepest lookback: 31-63-448 = -480


@jax.jit
def analysis_mdct(pcm):
    """PCM (ch, N) int32 (already <<16) -> mdct_freq (ch, Tg, 576) int32.

    ``pcm`` must be front-padded with 480 zeros; N-480 must be a multiple of
    576 (= 18 steps * 32). Tg granules = (N-480)//576.
    """
    ch, n = pcm.shape
    ts = (n - _PAST) // 32                 # window steps
    tg = ts // 18                          # granules

    # ---- windowing over sliding 512-sample frames, gather-free.
    # W[t, j] = pcm[32t + j] (j < 512) built from 16 strided slices; the
    # needed sample for (i, k) is pcm[32t + 511 - i - 64k], i.e. index
    # j' = 511 - j maps bijectively to (k, i) = divmod(j', 64) — so reversing
    # W and reshaping to (8, 64) aligns it with the window table directly.
    # (no 3D-index gather: the static reshape needs none)
    with jax.named_scope("an_window"):
        z = pcm.reshape(ch, (n // 32), 32)               # 32-sample frames
        w = jnp.concatenate([z[:, r:r + ts] for r in range(16)],
                            axis=2)                      # (ch,ts,512)
        v = w[..., ::-1].reshape(ch, ts, 8, 64)          # [k, i] layout
        win = jnp.asarray(T.ENWINDOW.reshape(8, 64))     # en[i+64k] -> [k,i]
        prod = fx.mul(v, win[None, None], xp=jnp)        # int32
        tmp = jnp.sum(prod.astype(jnp.int32), axis=2,
                      dtype=jnp.int32)                   # (ch,ts,64)

    # ---- 32-band filter: sum_j mul(fl[b,j], tmp[j])
    with jax.named_scope("an_filter"):
        fl = jnp.asarray(T.subband_filter_fixed())       # (32,64)
        prod2 = fx.mul(fl[None, None], tmp[:, :, None, :],
                       xp=jnp)                           # (ch,ts,32,64)
        sb = jnp.sum(prod2.astype(jnp.int32), axis=-1,
                     dtype=jnp.int32)                    # (ch,ts,32)

        # ---- analysis-inversion: odd step within granule, odd band
        step_in_gr = jnp.arange(ts) % 18
        inv = jnp.where((step_in_gr[:, None] % 2 == 1)
                        & (jnp.arange(32)[None] % 2 == 1),
                        -1, 1).astype(jnp.int32)
        sb = sb * inv[None]

    sbg = sb.reshape(ch, tg, 18, 32)

    # ---- MDCT over [prev granule ; current granule] per band
    with jax.named_scope("an_mdct"):
        prev = jnp.concatenate([jnp.zeros_like(sbg[:, :1]), sbg[:, :-1]],
                               axis=1)
        mdct_in = jnp.concatenate([prev, sbg], axis=2)   # (ch,tg,36,32)
        mdct_in = mdct_in.transpose(0, 1, 3, 2)          # (ch,tg,32,36)
        cos_l = jnp.asarray(T.mdct_cos_fixed())          # (18,36)
        prod3 = fx.mul(mdct_in[:, :, :, None, :], cos_l[None, None, None],
                       xp=jnp)
        freq = jnp.sum(prod3.astype(jnp.int32), axis=-1,
                       dtype=jnp.int32)                  # (ch,tg,32,18)

    # ---- alias butterflies: band b slot i (bu) with band b-1 slot 17-i (bd)
    with jax.named_scope("an_alias"):
        cs = jnp.asarray(T.MDCT_CS_FIX)                  # (8,)
        ca = jnp.asarray(T.MDCT_CA_FIX)
        up = freq[:, :, 1:, :8]                          # (ch,tg,31,8) "bu"
        dn = freq[:, :, :-1, 17:9:-1]                    # band-1 slots 17..10
        bu, bd = fx.cmuls(up, dn, cs[None, None, None], ca[None, None, None],
                          xp=jnp)
        freq = freq.at[:, :, 1:, :8].set(bu)
        freq = freq.at[:, :, :-1, 17:9:-1].set(bd)

    return freq.reshape(ch, tg, 576)


@jax.jit
def analysis_mdct_i16(pcm_i16):
    """analysis_mdct fed by raw int16 PCM, upshifted on device: the <<16 is
    free next to the link cost, so the PCM upload crosses at half the bytes."""
    return analysis_mdct(pcm_i16.astype(jnp.int32) << 16)


def _analysis_call(pcm_dev):
    return (analysis_mdct_i16(pcm_dev) if pcm_dev.dtype == jnp.int16
            else analysis_mdct(pcm_dev))


_CHUNK_G = 128       # granules per dispatch for small files (fixed shape)
_CHUNK_G_BIG = 1024  # for long files: fewer host<->device round trips


def _an_chunk(num_granules: int) -> int:
    return _CHUNK_G if num_granules <= 4 * _CHUNK_G else _CHUNK_G_BIG


def run_analysis(pcm_ch: np.ndarray, num_granules: int) -> np.ndarray:
    """Host wrapper: pad, run, return (ch, Tg, 576) int32 numpy.

    Dispatches in fixed-size granule chunks with one granule of left context
    (the MDCT reads the previous granule's subband output) and 480 samples of
    filterbank history, so any file length reuses a single compiled program.
    """
    ch, n = pcm_ch.shape
    need = num_granules * 576
    pad_front = np.zeros((ch, _PAST), dtype=pcm_ch.dtype)
    if n < need:
        pcm_ch = np.concatenate(
            [pcm_ch, np.zeros((ch, need - n), dtype=pcm_ch.dtype)], axis=1)
    else:
        pcm_ch = pcm_ch[:, :need]
    full = np.concatenate([pad_front, pcm_ch], axis=1)

    cg = _an_chunk(num_granules)
    if num_granules <= cg + 1:
        out = _analysis_call(_pad_to(full, _PAST + (cg + 1) * 576))
        return np.asarray(out)[:, :num_granules]

    pending = []
    bounds = []
    a = 0
    while a < num_granules:
        s = max(0, a - 1)                       # 1 granule of MDCT context
        e = min(num_granules, s + cg + 1)
        sl = full[:, s * 576: e * 576 + _PAST]  # front 480 = history before s
        pending.append(_analysis_call(_pad_to(sl, _PAST + (cg + 1) * 576)))
        bounds.append((a - s, e - s))
        a = e
    fetched = jax.device_get(pending)
    return np.concatenate(
        [r[:, lo:hi] for r, (lo, hi) in zip(fetched, bounds)], axis=1)


def run_analysis_device(pcm_ch: np.ndarray, num_granules: int):
    """Like :func:`run_analysis` but returns a RESIDENT (ch, Tg, 576) device
    array — no host fetch. The search plane (ops/search_plane) consumes the
    spectra on device, so the 4·Tg·576-byte transfer is skipped entirely."""
    ch, n = pcm_ch.shape
    need = num_granules * 576
    pad_front = np.zeros((ch, _PAST), dtype=pcm_ch.dtype)
    if n < need:
        pcm_ch = np.concatenate(
            [pcm_ch, np.zeros((ch, need - n), dtype=pcm_ch.dtype)], axis=1)
    else:
        pcm_ch = pcm_ch[:, :need]
    full = np.concatenate([pad_front, pcm_ch], axis=1)

    cg = _an_chunk(num_granules)
    if num_granules <= cg + 1:
        out = _analysis_call(_pad_to(full, _PAST + (cg + 1) * 576))
        return out[:, :num_granules]

    parts = []
    a = 0
    while a < num_granules:
        s = max(0, a - 1)
        e = min(num_granules, s + cg + 1)
        sl = full[:, s * 576: e * 576 + _PAST]
        r = _analysis_call(_pad_to(sl, _PAST + (cg + 1) * 576))
        parts.append(r[:, a - s:e - s])
        a = e
    return jnp.concatenate(parts, axis=1)


def _pad_to(a: np.ndarray, n: int):
    if a.shape[1] < n:
        a = np.concatenate(
            [a, np.zeros((a.shape[0], n - a.shape[1]), a.dtype)], axis=1)
    return jnp.asarray(a)


@functools.lru_cache(maxsize=1)
def _analysis_tables():
    cc = lambda a, d: np.ascontiguousarray(a, d)
    return (cc(T.ENWINDOW, np.int64),
            cc(T.subband_filter_fixed(), np.int32),
            cc(T.mdct_cos_fixed(), np.int32),
            cc(T.MDCT_CS_FIX, np.int32), cc(T.MDCT_CA_FIX, np.int32))


def run_analysis_native(pcm_i16: np.ndarray, num_granules: int):
    """Host C++ twin of :func:`analysis_mdct` (native/src/encode_plane.cpp):
    raw int16 streams -> (ch, Tg, 576) int32 spectra, bit-identical to the
    device plane (all-integer Q31 arithmetic). Returns None when the native
    library is unavailable. Spectra never cross the device link — this is
    the front half of the fully-host encode engine."""
    from mp3stego_tpu.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "encode_analysis"):
        return None
    ch, n = pcm_i16.shape
    need = num_granules * 576
    full = np.zeros((ch, _PAST + need), np.int16)
    full[:, _PAST:_PAST + min(n, need)] = pcm_i16[:, :need]
    out = np.empty((ch, num_granules, 576), np.int32)
    lib.encode_analysis(full, ch, num_granules, *_analysis_tables(), out)
    return out
