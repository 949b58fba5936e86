#!/usr/bin/env python
"""On-device smoke run: drive the codec's device paths once on a GPU.

Every phase goes through the entry points a user calls (the ``Steganography``
façade and the ``parallel`` batch functions) at full size, with the device
engines forced by the documented ``MP3STEGO_TPU_*`` knobs, and checks the
result against the host oracles:

  1. corpus decode: 64 tracks, ~3 h of stereo audio at 32/44.1/48 kHz
     (two LSF tracks at 22.05/24 kHz), ``decode_files_batched(out="int16")``
     vs the native float64 host plane, at most 1 LSB on < 1e-3 of samples;
  2. façade float32 decode + reveal of a 240 s track carrying a message;
  3. the same decode with the Huffman bit-scan on the device: identical PCM;
  4. 240 s encode at 320 kbps on the device search plane: identical bytes;
  5. hide at exactly ``message_capacity`` chars on a 180 s track, reveal,
     clear: identical bytes to the host engine;
  6. batch encode of 16 x 60 s jobs: identical bytes to per-file encodes;
  7. a profiler trace of one steady decode and one steady encode: device ms
     per named stage and the device-busy share of the window.

Inputs are generated from ``--seed`` with the repo's own host encoder.
Each phase prints one line; the last line is a JSON object naming the
device. ``--four`` runs only the multi-device paths (files mesh, frames
mesh, sharded batch encode), each once and compared with the one-card
result; ``--only`` picks some of them.

Usage:  python chip_smoke.py [--seed N] [--four [--only files,frames,encode]]

Exits non-zero, before any phase and without a result line, when JAX finds
no GPU.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
_compiles = []                 # (function name, seconds) per XLA compile

DECODE_STAGES = ["requantize", "stereo", "reorder_alias", "imdct",
                 "overlap_freqinv", "synth_v", "synth_fir"]
SEARCH_STAGES = ["quant_scale", "quant_rank", "quant_float", "cost_runlen",
                 "cost_count1", "cost_subdivide", "cost_pair",
                 "cost_regions", "cost_select"]
# HBM bandwidth by JAX device_kind, from the data sheet (H100 SXM5, rated at
# 700 W): the memory roof phase 7 sets synth_fir's kernel time against. A
# card held to a lower power limit may not reach it; the run prints the
# card's limit beside the share.
HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}
MESH_PHASES = ("files", "frames", "encode")


class PhaseError(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ----------------------------------------------------------------- plumbing

def _on_duration(event, duration, fun_name="?", **_):
    if event == _COMPILE_EVENT:
        _compiles.append((fun_name, duration))


@contextlib.contextmanager
def _env(**kw):
    """Set MP3STEGO_TPU_* knobs for the block, restoring the old values."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _witness(module, name):
    """Record the devices of every output of ``module.name`` while the block
    runs: proof that the path under test dispatched its device program."""
    import jax
    orig = getattr(module, name)
    seen = []

    def wrapped(*a, **k):
        out = orig(*a, **k)
        seen.append({str(d) for leaf in jax.tree.leaves(out)
                     if hasattr(leaf, "devices") for d in leaf.devices()})
        return out

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def _devices_of(seen, name):
    _check(seen, f"device program {name} never ran")
    devs = sorted(set().union(*seen))
    return f"{','.join(devs)} via {name} x{len(seen)}"


def _timed(fn, steady=True):
    """Run ``fn`` twice, or once when ``steady`` is false: (result, compiles
    of the first call, first-call s, steady s or None). Wall times end after
    ``block_until_ready`` on whatever ``fn`` returns."""
    import jax
    c0 = len(_compiles)
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    compiles = _compiles[c0:]
    if not steady:
        return out, compiles, first, None
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, compiles, first, time.perf_counter() - t0


def _peak_gb():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "n/a" if peak is None else f"{peak / 1e9:.2f} GB"


def _report(label, title, timing, device, compare):
    _, compiles, first, steady = timing
    per = {}
    for name, sec in compiles:
        per[name] = per.get(name, 0.0) + sec
    top = ", ".join(f"{n} {t:.1f}" for n, t in
                    sorted(per.items(), key=lambda kv: -kv[1])[:3])
    print(f"phase {label} {title}: compile {sum(per.values()):.1f} s "
          f"({top}), first call {first:.1f} s, steady "
          f"{'not run' if steady is None else f'{steady:.1f} s'} | "
          f"device {device} | {compare} | peak device memory {_peak_gb()}",
          flush=True)


def _lsb_compare(pairs, label):
    """1-LSB contract over (got, want) int16 pairs: max |diff| <= 1 on
    fewer than 1e-3 of the samples (tests/test_precision.py)."""
    n = bad = worst = 0
    for got, want in pairs:
        _check(got.shape == want.shape,
               f"{label}: shape {got.shape} != {want.shape}")
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        n += d.size
        bad += int(np.count_nonzero(d))
        worst = max(worst, int(d.max()) if d.size else 0)
    frac = bad / max(n, 1)
    _check(worst <= 1 and frac < 1e-3,
           f"{label}: max |diff| {worst} LSB on {frac:.2e} of samples")
    return (f"vs {label}: max |diff| {worst} LSB on {frac:.2e} of {n} "
            f"samples (limit 1 LSB on < 1e-3)")


def _wav_i16(path):
    with open(path, "rb") as f:
        return np.frombuffer(f.read()[44:], np.int16)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------------- inputs

def synth_wav(path, seconds, sr, rng):
    """A stereo WAV of tones, a beating partial and noise, from ``rng``, at
    about -21 dBFS RMS. The float32 plane's 1-LSB flip rate grows with the
    level: it is ~9e-4 at -15 dBFS on the CPU backend, at the contract's
    1e-3 limit."""
    from mp3stego_tpu.utils.wav import write_wav
    n = int(sr * seconds)
    t = np.arange(n, dtype=np.float64) / sr
    f0, f1 = rng.uniform(110, 880), rng.uniform(900, 5000)
    sig = (0.35 * np.sin(2 * np.pi * f0 * t)
           + 0.2 * np.sin(2 * np.pi * f1 * t) * np.sin(2 * np.pi * 0.5 * t)
           + 0.06 * rng.standard_normal(n))
    pcm = np.clip(sig * 11000, -32768, 32767).astype(np.int16)
    write_wav(path, sr, np.stack([pcm, np.roll(pcm, sr // 100)], axis=1))
    return path


def host_encode(jobs):
    """(wav, mp3, kbps) jobs -> MP3 files, on the fully-host engine."""
    from mp3stego_tpu.models.encoder import Encoder

    def one(job):
        wav, mp3, kbps = job
        Encoder(wav, mp3, bitrate=kbps).encode(quiet=True)
        return mp3

    with _env(MP3STEGO_TPU_ENC_HOST=1, MP3STEGO_TPU_LSF_COMPLIANT=1), \
            ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        return list(ex.map(one, jobs))


def track_lengths(rng, n, total_s, lo, hi):
    """``n`` lognormal track lengths in [lo, hi] s summing to ~total_s."""
    x = rng.lognormal(0.0, 0.7, n)
    for _ in range(20):
        x = np.clip(x * total_s / x.sum(), lo, hi)
    return x


def make_corpus(work, rng, n_tracks=64, total_s=10800.0, lo=30.0, hi=420.0):
    """Mixed corpus: MPEG-1 at 32/44.1/48 kHz and 128-320 kbps, plus two
    LSF tracks (22.05 and 24 kHz at 128 kbps, ISO-compliant side info)."""
    secs = track_lengths(rng, n_tracks, total_s, lo, hi)
    jobs = []
    for i, s in enumerate(secs):
        if i < 2:
            sr, kbps = (22050, 24000)[i], 128
        else:
            sr = int(rng.choice([32000, 44100, 48000]))
            kbps = int(rng.choice([128, 160, 192, 224, 256, 320]))
        jobs.append((os.path.join(work, f"c{i}.wav"), s, sr,
                     np.random.default_rng(rng.integers(1 << 62)),
                     os.path.join(work, f"c{i}.mp3"), kbps))
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        list(ex.map(lambda j: synth_wav(*j[:4]), jobs))
    jobs = [(j[0], j[4], j[5]) for j in jobs]
    paths = host_encode(jobs)
    for wav, _, _ in jobs:
        os.remove(wav)
    return paths, float(secs.sum())


def _host_i16(path):
    """Native float64 host plane -> int16 (the bit-exact oracle)."""
    from mp3stego_tpu.bitstream import decoder_host as dh
    from mp3stego_tpu.bitstream.id3 import parse_id3
    from mp3stego_tpu.ops import decode_plane as dp
    data = _read(path)
    id3 = parse_id3(data)
    parsed = dh.parse_mp3(data, id3.offset if id3.is_valid else 0)
    out = dp.decode_pcm_i16_host(parsed)
    if out is None:
        out = dp.pcm_to_i16(dp.decode_pcm(parsed, "float64"))
    return out


# ------------------------------------------------------------------- phases

def phase_corpus_decode(work, rng, n_tracks=64, total_s=10800.0, lo=30.0,
                        hi=420.0, mesh=None, corpus=None, want=None,
                        steady=True):
    """Phase 1: batched corpus decode on the device plane vs the host
    plane (or vs ``want`` = (PCM list, label)). Returns the corpus and the
    decoded PCM for reuse."""
    from mp3stego_tpu import parallel
    from mp3stego_tpu.parallel import batch_decode as bd
    paths, audio_s = corpus or make_corpus(work, rng, n_tracks, total_s,
                                           lo, hi)
    name = "_decode_batch_concat" if mesh is None else "_decode_batch_i16"
    with _env(MP3STEGO_TPU_BATCH_HOST_G=0), _witness(bd, name) as seen:
        timing = _timed(lambda: parallel.decode_files_batched(
            paths, mesh=mesh, out="int16"), steady)
    got = timing[0]
    if want is None:
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
            want = (list(ex.map(_host_i16, paths)), "native f64 host plane")
    cmp = _lsb_compare(zip(got, want[0]), want[1])
    where = "1 card" if mesh is None else f"mesh {dict(mesh.shape)}"
    _report(1, f"corpus decode ({len(paths)} tracks, {audio_s / 3600:.2f} h,"
               f" {where})", timing, _devices_of(seen, name), cmp)
    return (paths, audio_s), got


def _stego_track(work, rng, seconds, name, message=None):
    """A 320 kbps track (optionally carrying ``message``), host-encoded."""
    from mp3stego_tpu import Steganography
    wav = synth_wav(os.path.join(work, f"{name}.wav"), seconds, 44100, rng)
    mp3 = host_encode([(wav, os.path.join(work, f"{name}.mp3"), 320)])[0]
    if message is None:
        return wav, mp3
    hidden = os.path.join(work, f"{name}_hidden.mp3")
    with _env(MP3STEGO_TPU_ENC_HOST=1):
        _check(not Steganography().hide_message(mp3, hidden, message),
               "input message did not fit")
    return wav, hidden


def phase_facade_decode(work, rng, seconds=240.0, msg_chars=200):
    """Phase 2: façade float32 decode (1-LSB contract vs float64) and
    reveal. Returns (hidden track, float32 WAV bytes)."""
    from mp3stego_tpu import Steganography
    from mp3stego_tpu.ops import decode_plane as dp
    msg = "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), msg_chars))
    _, hidden = _stego_track(work, rng, seconds, "facade", msg)
    s32 = Steganography(precision="float32")
    w32, w64 = (os.path.join(work, f"facade{p}.wav") for p in (32, 64))
    with _witness(dp, "_decode_granules_i16") as seen:
        timing = _timed(lambda: s32.decode_mp3_to_wav(hidden, w32))
        txt = os.path.join(work, "facade.txt")
        s32.reveal_massage(hidden, txt)
    Steganography(precision="float64").decode_mp3_to_wav(hidden, w64)
    cmp = _lsb_compare([(_wav_i16(w32), _wav_i16(w64))],
                       'precision="float64"')
    with open(txt) as f:
        _check(f.read() == msg, "revealed message differs")
    _report(2, f"façade float32 decode + reveal ({seconds:.0f} s)", timing,
            _devices_of(seen, "_decode_granules_i16"),
            cmp + f"; reveal returned all {len(msg)} chars")
    return hidden, _read(w32)


def phase_device_huffman(work, hidden, want_wav):
    """Phase 3: the phase-2 decode with the Huffman scan on the device:
    WAV identical to the host-parse float32 path."""
    from mp3stego_tpu import Steganography
    from mp3stego_tpu.ops import huffman_device as hd
    out = os.path.join(work, "devhuff.wav")
    s32 = Steganography(precision="float32")
    with _env(MP3STEGO_TPU_DEVICE_HUFFMAN=1), \
            _witness(hd, "decode_samples_device") as seen:
        timing = _timed(lambda: s32.decode_mp3_to_wav(hidden, out))
    got = _read(out)
    _check(got == want_wav, "device-Huffman WAV differs from host parse")
    _report(3, "device Huffman scan decode", timing,
            _devices_of(seen, "decode_samples_device"),
            f"WAV identical to host-parse float32 path ({len(got)} bytes)")


def phase_encode(work, rng, seconds=240.0):
    """Phase 4: single-stream encode on the device search plane vs host."""
    from mp3stego_tpu import Steganography
    from mp3stego_tpu.models.encoder import MP3Encoder
    from mp3stego_tpu.ops import search_plane as SP
    wav = synth_wav(os.path.join(work, "enc.wav"), seconds, 44100, rng)
    dev, host = (os.path.join(work, f"enc_{e}.mp3") for e in ("dev", "host"))
    s = Steganography()
    with _env(MP3STEGO_TPU_ENC_HOST=0), \
            _witness(SP, "_search_scfsi_jit") as seen:
        timing = _timed(lambda: s.encode_wav_to_mp3(wav, dev, 320))
    split = dict(MP3Encoder.last_redo_split or {})
    with _env(MP3STEGO_TPU_ENC_HOST=1):
        s.encode_wav_to_mp3(wav, host, 320)
    _check(_read(dev) == _read(host), "device encode bytes differ from host")
    _report(4, f"encode {seconds:.0f} s @320 kbps", timing,
            _devices_of(seen, "_search_scfsi_jit"),
            f"bytes identical to host engine ({len(_read(dev))} B); "
            f"verify-flagged lanes {split.get('lanes_gathered', 0)}, "
            f"cells {split.get('verify_cells', 0)}, "
            f"redone lanes {split.get('redo_lanes', 0)}")


def phase_hide_capacity(work, rng, seconds=180.0):
    """Phase 5: hide at exactly message_capacity chars on the fused parallel
    hide, reveal, then clear; bytes identical to the host engine."""
    from mp3stego_tpu import Steganography
    from mp3stego_tpu.models.encoder import MP3Encoder
    from mp3stego_tpu.ops import search_plane as SP
    _, mp3 = _stego_track(work, rng, seconds, "cap")
    s = Steganography()
    with _env(MP3STEGO_TPU_ENC_HOST=1):
        cap = s.message_capacity(mp3)
    _check(cap > 0, "zero capacity")
    msg = "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), cap))
    out = {e: os.path.join(work, f"cap_{e}.mp3") for e in ("dev", "host")}
    clr = {e: os.path.join(work, f"clr_{e}.mp3") for e in ("dev", "host")}
    with _env(MP3STEGO_TPU_ENC_HOST=0), \
            _witness(SP, "_hide_fused_jit") as seen:
        timing = _timed(lambda: s.hide_message(mp3, out["dev"], msg))
        stats = dict(MP3Encoder.last_hide_parallel_stats or {})
    _check(timing[0] is False, "message reported too long")
    _check(stats.get("fused") and stats.get("converged"),
           f"hide left the fused device path: {stats}")
    with _env(MP3STEGO_TPU_ENC_HOST=0), \
            _witness(SP, "_search_scfsi_jit") as seen_clr:
        s.clear_file(out["dev"], clr["dev"])
    with _env(MP3STEGO_TPU_ENC_HOST=1):
        s.hide_message(mp3, out["host"], msg)
        s.clear_file(out["host"], clr["host"])
    _check(_read(out["dev"]) == _read(out["host"]),
           "device hide bytes differ from host")
    _check(_read(clr["dev"]) == _read(clr["host"]),
           "device clear bytes differ from host")
    txt = os.path.join(work, "cap.txt")
    s.reveal_massage(out["dev"], txt)
    with open(txt) as f:
        _check(f.read() == msg, "revealed message differs")
    _report(5, f"hide at capacity ({cap} chars, {seconds:.0f} s) + clear",
            timing, _devices_of(seen, "_hide_fused_jit") + "; clear "
            + _devices_of(seen_clr, "_search_scfsi_jit"),
            f"hide and clear bytes identical to host engine, reveal whole; "
            f"extra rounds {stats.get('extra_rounds')}")


def phase_batch_encode(work, rng, n_jobs=16, seconds=60.0, mesh=None,
                       wavs=None, want=None, steady=True):
    """Phase 6: encode_files_batched on the device vs per-file host encodes
    (or vs ``want`` = (MP3 paths, label)). Returns the WAV inputs."""
    from mp3stego_tpu.parallel import encode_files_batched
    from mp3stego_tpu.ops import search_plane as SP
    wavs = wavs or [synth_wav(os.path.join(work, f"b{i}.wav"), seconds,
                              44100, rng) for i in range(n_jobs)]
    jobs = [(w, w[:-4] + "_dev.mp3") for w in wavs]
    with _env(MP3STEGO_TPU_BATCH_ENC_HOST=0), \
            _witness(SP, "_search_batch_jit") as seen:
        timing = _timed(lambda: encode_files_batched(jobs, 320, mesh=mesh),
                        steady)
    if want is None:
        want = (host_encode([(w, w[:-4] + "_host.mp3", 320) for w in wavs]),
                "per-file host encodes")
    for (_, got), ref in zip(jobs, want[0]):
        _check(_read(got) == _read(ref), f"{got} differs from {ref}")
    where = "1 card" if mesh is None else f"mesh {dict(mesh.shape)}"
    _report(6, f"batch encode ({len(wavs)} x {seconds:.0f} s, {where})",
            timing, _devices_of(seen, "_search_batch_jit"),
            f"all {len(wavs)} files byte-identical to {want[1]}")
    return wavs


def _fir_bytes(granules, ch=2):
    """HBM bytes the 16-tap FIR must move: read the (ch, 15+S, 64) f32 V
    history once, write the (ch, S, 32) f32 sub-steps (S = 18 * granules)."""
    steps = 18 * granules
    return 4 * ch * ((steps + 15) * 64 + steps * 32)


def phase_trace(work, hidden, wav):
    """Phase 7: trace one steady decode-plane call (the phase-2 track) and
    one steady search-plane call (a chunk of the phase-4 WAV's spectra),
    compiled without command buffers so every kernel maps to its named
    scope; device ms per stage, synth_fir's kernels and HBM-roof share, and
    the device-busy share."""
    import jax
    import jax.numpy as jnp

    from mp3stego_tpu.bitstream import decoder_host as dh
    from mp3stego_tpu.models.encoder import MP3Encoder
    from mp3stego_tpu.ops import decode_plane as dp
    from mp3stego_tpu.ops import encode_plane
    from mp3stego_tpu.ops import quant as Q
    from mp3stego_tpu.ops import search_plane as SP
    from mp3stego_tpu.utils import profiling as prof
    from mp3stego_tpu.utils.wav import read_wav

    prep = dp.host_prepare(dh.parse_mp3(_read(hidden), 0))
    t = prep["raw_i8"].shape[1]
    t_pad = -(-t // dp._DEC_BUCKET) * dp._DEC_BUCKET
    prep = dp._pad_prep_granules(prep, t_pad)
    dec_args = ({k: jnp.asarray(prep[k]) for k in dp.ALL_KEYS},)
    dec = dp._decode_granules_i16.lower(*dec_args, wrap=False)

    enc = MP3Encoder(read_wav(wav, 320))
    nf, gpf, nch = enc._num_frames(), enc.granules_per_frame, 2
    xr = encode_plane.run_analysis_device(enc._channel_streams_i16(nf),
                                          nf * gpf).reshape(-1, 576)
    _, mean_bits_f = enc._plane_framing(nf)
    mb = np.tile(np.repeat(np.minimum(np.asarray(mean_bits_f, np.int64)
                                      // nch, Q.MAX_BITS_ALLOWANCE), gpf),
                 nch).astype(np.int32)
    # one CHUNK_BIG-lane chunk of the file, as search_all dispatches it:
    # the search program's compile time grows with its lane count
    srch_args = (xr[:SP.CHUNK_BIG], jnp.asarray(mb[:SP.CHUNK_BIG]))
    srch = SP._search_chunk_packed.lower(*srch_args, enc.band_row)

    runs = {}
    for label, lowered, args, stages in (
            ("decode", dec, dec_args, DECODE_STAGES),
            ("search", srch, srch_args, SEARCH_STAGES)):
        tdir = tempfile.mkdtemp(dir=work, prefix=f"trace_{label}_")
        tr, untraced_s = prof.profile_compiled(lowered, args, tdir)
        table = prof.stage_utilization(tr["ops"], stages)
        per = ", ".join(
            f"{s} {table[s]['ms']:.3f} ms/{table[s]['n_ops']} ops"
            + (f" (+fused in {len(table[s]['in_kernels'])})"
               if set(table[s]["in_kernels"]) - set(table[s]["kernels"])
               else "")
            for s in stages if s in table)
        other = table.get("other", {})
        print(f"phase 7 trace {label} plane: untraced {untraced_s * 1e3:.2f}"
              f" ms | device busy {tr['busy_ms']:.2f} ms = "
              f"{tr['busy_share']:.1%} of the {tr['window_ms']:.2f} ms window"
              f" | {per} | other {other.get('ms', 0.0):.3f} ms/"
              f"{other.get('n_ops', 0)} ops", flush=True)
        runs[label] = (tr, table, [s for s in stages if s not in table])

    kind = jax.devices()[0].device_kind
    _check(kind in HBM_GBPS, f"no data-sheet HBM bandwidth for {kind!r}")
    fir = [op for op in runs["decode"][0]["ops"] if "synth_fir" in op["scope"]]
    fir_ms = sum(op["dur_us"] for op in fir) / 1e3
    with_ = sorted({seg for op in fir for seg in op["scope"]}
                   & set(DECODE_STAGES) - {"synth_fir"})
    roof_ms = _fir_bytes(t_pad) / (HBM_GBPS[kind] * 1e9) * 1e3
    print(f"phase 7 synth_fir: {fir_ms:.4f} ms in "
          f"{len({op['name'] for op in fir})} kernel(s) "
          f"({', '.join(sorted({op['name'] for op in fir}))}) that also ran "
          f"[{', '.join(with_)}]; its own bytes "
          f"({_fir_bytes(t_pad) / 1e6:.1f} MB) at the HBM roof take "
          f"{roof_ms:.4f} ms at {HBM_GBPS[kind]:.0f} GB/s = "
          f"{roof_ms / max(fir_ms, 1e-9):.1%} of that kernel time", flush=True)
    for label in runs:
        _check(not runs[label][2],
               f"{label} stages with no device ops: {runs[label][2]}")
    return runs


def phase_frames_mesh(work, rng, mesh, seconds=600.0, steady=True):
    """--four: one long stream decoded with its granule axis sharded over
    ``frames`` (ppermute halos) vs the one-card plane."""
    from mp3stego_tpu.bitstream import decoder_host as dh
    from mp3stego_tpu.ops import decode_plane as dp
    from mp3stego_tpu.parallel import decode_granules_sharded
    from mp3stego_tpu.parallel import frame_shard as fs
    _, mp3 = _stego_track(work, rng, seconds, "long")
    prep = dp.host_prepare(dh.parse_mp3(_read(mp3), 0))
    with _witness(fs, "_decode_sharded") as seen:
        timing = _timed(lambda: decode_granules_sharded(prep, mesh), steady)
    one = dp._decode_call(prep, "float32")
    got = timing[0]
    _check(got.shape == one.shape, f"shape {got.shape} != {one.shape}")
    err = float(np.abs(got - one).max())
    _check(err < 1e-5, f"frames-sharded plane differs by {err}")
    cmp = _lsb_compare([(dp.pcm_to_i16(got), dp.pcm_to_i16(one))],
                       "one-card plane (int16)")
    _report("mesh", f"frames-sharded decode ({seconds:.0f} s, mesh "
               f"{dict(mesh.shape)})", timing,
            _devices_of(seen, "_decode_sharded"),
            f"max |float diff| {err:.2e} (limit 1e-5); {cmp}")


# --------------------------------------------------------------------- main

def _card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip() or r.stderr.strip()


def _on_gpu():
    import jax
    return (jax.default_backend() == "gpu"
            and jax.devices()[0].platform == "gpu")


def _run(phases):
    failed = []
    for name, fn in phases:
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - reported, exit is non-zero
            failed.append(name)
            print(f"phase {name} FAILED: {type(e).__name__}: {e}",
                  flush=True)
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh paths")
    ap.add_argument("--only", default=",".join(MESH_PHASES),
                    help="with --four: the mesh phases to run, of "
                    f"{','.join(MESH_PHASES)} (default all)")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    if not set(only) <= set(MESH_PHASES):
        ap.error(f"--only takes phases of {','.join(MESH_PHASES)}")

    import jax
    if not _on_gpu():
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    from mp3stego_tpu import native
    from mp3stego_tpu.parallel import make_mesh
    cache = jax.config.jax_compilation_cache_dir
    warm = len(os.listdir(cache)) if cache and os.path.isdir(cache) else 0
    print(f"native host library loaded: {native.get_lib() is not None} | "
          f"compile cache {cache} ({warm} entries at start)", flush=True)
    rng = np.random.default_rng(args.seed)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four:
            if len(jax.devices()) < 4:
                print("--four needs 4 GPUs", file=sys.stderr)
                return 2

            def files_mesh():
                from mp3stego_tpu.parallel import decode_files_batched
                corpus = make_corpus(work, rng)
                with _env(MP3STEGO_TPU_BATCH_HOST_G=0):
                    one = decode_files_batched(corpus[0], out="int16")
                _, four = phase_corpus_decode(
                    work, rng, mesh=make_mesh(files=4), corpus=corpus,
                    want=(one, "one-card PCM"), steady=False)
                same = sum(np.array_equal(a, b) for a, b in zip(one, four))
                print(f"phase 1 files mesh: {same}/{len(one)} files "
                      "bit-identical to one card", flush=True)

            def batch_encode_mesh():
                # compared with the per-file host encodes that phase 6
                # holds the one-card batch encode to, byte for byte: the
                # one-card program (8 files, 73,728 lanes) alone compiles
                # for minutes, the mesh's (one file per card) far faster
                phase_batch_encode(work, rng, mesh=make_mesh(files=4),
                                   steady=False)

            failed = _run([p for p in [
                ("files mesh", files_mesh),
                ("frames mesh", lambda: phase_frames_mesh(
                    work, rng, make_mesh(files=1, frames=4), steady=False)),
                ("encode mesh", batch_encode_mesh),
            ] if p[0].split()[0] in only])
        else:
            state = {}

            def facade():
                state["hidden"], state["wav32"] = phase_facade_decode(
                    work, rng)

            failed = _run([
                ("1", lambda: phase_corpus_decode(work, rng)),
                ("2", facade),
                ("3", lambda: phase_device_huffman(work, state["hidden"],
                                                   state["wav32"])),
                ("4", lambda: phase_encode(work, rng)),
                ("5", lambda: phase_hide_capacity(work, rng)),
                ("6", lambda: phase_batch_encode(work, rng)),
                ("7", lambda: phase_trace(work, state["hidden"],
                                          os.path.join(work, "enc.wav"))),
            ])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(_card(), flush=True)
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
