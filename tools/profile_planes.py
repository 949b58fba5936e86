#!/usr/bin/env python
"""Per-stage device-time profile of the two device planes: what share of
device time each pipeline stage takes, and which kernels and kernel classes
(XLA fusion, cuBLAS matrix product, copy) carry it.

Method: the corpus-scale decode and encode programs (the same shapes as
bench.py's "plane corpus (on-chip, resident inputs)" rows) are compiled
without command buffers and run under a ``jax.profiler`` trace; the GPU
timeline's per-kernel records (duration, HLO instruction, and the
``jax.named_scope`` path from the compiled module's op_name metadata) are
aggregated per stage by utils/profiling.parse_device_trace /
stage_utilization. Caveat: XLA fuses across scope boundaries; a fusion
carries one representative op's scope, so attribution is at fusion
granularity. The GPU trace carries no per-kernel FLOP or byte counts, so
there is no roofline column here.

Run standalone (writes PROFILE_PLANES.json at the repo root and prints the
tables) or through bench.py. Reference hot loops being profiled:
decoder/Frame.py:65-218 and encoder/MP3_Encoder.py:958-996 of the
reference.
"""

import functools
import json
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

DECODE_STAGES = ["requantize", "stereo", "reorder_alias", "imdct",
                 "overlap_freqinv", "synth_v", "synth_fir"]
ENCODE_STAGES = ["an_window", "an_filter", "an_mdct", "an_alias",
                 "quant_scale", "quant_rank", "quant_float",
                 "cost_runlen", "cost_count1", "cost_subdivide",
                 "cost_pair", "cost_regions", "cost_select", "cost_hide"]


def _trace_stage_table(fn, args, stages, dispatches=3):
    """Compile ``fn(args)`` without command buffers, trace ``dispatches``
    steady calls and aggregate the device ops per stage; returns (stage
    table, untraced seconds per dispatch)."""
    import jax

    from mp3stego_tpu.utils import profiling as prof

    tmp = tempfile.mkdtemp(prefix="mp3stego_prof_")
    try:
        tr, untraced_s = prof.profile_compiled(jax.jit(fn).lower(args),
                                               (args,), tmp, dispatches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    table = prof.stage_utilization(tr["ops"], stages, runs=dispatches)
    return table, untraced_s


def _finish(table):
    """Per-stage device ms, share, kernels and dominant kernel class."""
    out = {name: dict(ms=s["ms"], share=s["share"], n_ops=s["n_ops"],
                      kernels=s["kernels"][:3], dominant=s["dominant"])
           for name, s in table.items()}
    return {"stages": out, "summary": dict(
        total_device_ms=round(sum(s["ms"] for s in out.values()), 3))}


def _synth_corpus_files(n_files, seconds=120.0):
    """The bench corpus fixtures (synth WAV -> 320 kbps MP3), cached in /tmp."""
    sys.path.insert(0, REPO)
    import bench
    out = []
    for i in range(n_files):
        wav = bench._synth_wav(f"/tmp/bench_corpus{i}.wav", seconds, 44100,
                               100 + i)
        out.append(bench._mp3_of(wav, f"/tmp/bench_corpus{i}.mp3", 320))
    return out


def profile_decode_plane(n_files=4, dispatches=3):
    """Utilization table of the corpus-scale decode plane (requantize ->
    stereo -> reorder/alias -> IMDCT -> synthesis), resident inputs."""
    import jax

    from mp3stego_tpu.bitstream import decoder_host as dh
    from mp3stego_tpu.ops import decode_plane as dp
    from mp3stego_tpu.parallel.batch_decode import (_decode_batch_concat,
                                                    prepare_batch_concat)

    preps = []
    g_total = 0
    for mp3 in _synth_corpus_files(n_files):
        with open(mp3, "rb") as f:
            parsed = dh.parse_mp3(f.read(), 0)
        preps.append(dp.host_prepare(parsed))
        g_total += parsed.num_frames * 2
    batch = prepare_batch_concat(preps)
    args = {k: jax.device_put(batch[k]) for k in dp.ALL_KEYS}

    def full(a):
        return _decode_batch_concat(a, num_files=batch["num_files"],
                                    dtype_name="float32")

    table, untraced_s = _trace_stage_table(full, args, DECODE_STAGES,
                                           dispatches)
    rec = _finish(table)
    rec["summary"]["granules_per_dispatch"] = g_total
    rec["summary"]["untraced_ms"] = round(untraced_s * 1e3, 2)
    rec["summary"]["untraced_gps"] = round(g_total / untraced_s)
    return rec


def profile_encode_plane(n_files=2, dispatches=3):
    """Utilization table of the corpus-scale encode plane (Q31 analysis+MDCT
    + the full 9-evaluation rate search), resident inputs. Stage FLOPs are
    summed over all evaluations of the bisection+inner loop."""
    import jax

    from mp3stego_tpu.models.encoder import MP3Encoder
    from mp3stego_tpu.ops import quant as Q
    from mp3stego_tpu.ops import search_plane as SP
    from mp3stego_tpu.ops.encode_plane import _PAST, analysis_mdct_i16
    from mp3stego_tpu.utils.wav import read_wav

    import bench
    wav = bench._synth_wav("/tmp/bench_enc_corpus.wav", 120.0, 44100, 7)
    enc = MP3Encoder(read_wav(wav, 320))
    nf = enc._num_frames()
    gpf = enc.granules_per_frame
    tg = nf * gpf
    tg_max = -(-tg // 256) * 256
    nch, F = 2, n_files
    s = enc._channel_streams_i16(nf)
    pcm = np.zeros((F, nch, _PAST + tg_max * 576), np.int16)
    pcm[:, :, _PAST:_PAST + s.shape[1]] = s
    _, mean_bits_f = enc._plane_framing(nf)
    lane_block = np.repeat(np.minimum(
        np.asarray(mean_bits_f, np.int64) // nch,
        Q.MAX_BITS_ALLOWANCE), gpf)
    max_bits = np.zeros((F, nch * tg_max), np.int32)
    for ch in range(nch):
        max_bits[:, ch * tg_max: ch * tg_max + tg] = lane_block

    pcm_dev = jax.device_put(pcm)
    mb_dev = jax.device_put(max_bits)
    sr_idx = enc.samplerate_index

    @functools.partial(jax.jit, static_argnames=("sr",))
    def full(a, sr=sr_idx):
        p, mb = a
        xr = jax.vmap(analysis_mdct_i16)(p).reshape(F, nch * tg_max, 576)
        fin, *_ = jax.vmap(
            lambda x, b: SP._search_body_packed(x, b, sr))(xr, mb)
        return fin

    table, untraced_s = _trace_stage_table(
        full, (pcm_dev, mb_dev), ENCODE_STAGES, dispatches)
    lanes = F * nch * tg
    rec = _finish(table)
    rec["summary"]["lanes_per_dispatch"] = lanes
    rec["summary"]["untraced_ms"] = round(untraced_s * 1e3, 2)
    rec["summary"]["untraced_lanes_ps"] = round(lanes / untraced_s)
    rec["per_eval"] = _profile_one_eval(pcm_dev, mb_dev, F, nch, tg_max,
                                        lanes, sr_idx, dispatches)
    return rec


def _profile_one_eval(pcm_dev, mb_dev, F, nch, tg_max, lanes, sr_idx,
                      dispatches):
    """The per-evaluation on-chip split the opaque search loop hides: ONE
    search evaluation (quantize -> run-length -> count1 -> subdivide ->
    pair-cost -> select), unrolled outside any device loop so every stage's
    scope survives into the trace. The real search runs ~9 of these
    (8 bisection rounds + 1 inner round, measured convergence) in lockstep;
    the per-lane preamble (abs/max) runs once per search. Spectra come in
    PRE-COMPUTED so analysis doesn't pollute the eval's "other" row."""
    import jax
    import jax.numpy as jnp

    from mp3stego_tpu import tables as T
    from mp3stego_tpu.ops import search_plane as SP
    from mp3stego_tpu.ops.encode_plane import analysis_mdct_i16

    band = T.BAND_ALL[sr_idx].astype(np.int32)
    xr_res = jax.device_put(np.asarray(
        jax.jit(jax.vmap(analysis_mdct_i16))(pcm_dev)).reshape(-1, 576))

    @jax.jit
    def one_eval(xr):
        c = SP._sconsts()
        with jax.named_scope("search_prep"):
            labs64 = jnp.abs(xr.astype(jnp.int64))
            xrabs32 = jnp.abs(xr)
            xrabs_f32 = xrabs32.astype(jnp.float32)
            xrmax64 = jnp.max(jnp.maximum(xrabs32, 0),
                              axis=1).astype(jnp.int64)
            s = jnp.full(xr.shape[0], -60, jnp.int32)  # round-1 step
        ix, ixmax_eff, approx, oob = SP._quantize(labs64, xrabs_f32,
                                                  xrmax64, s, c)
        co = SP._cost(ix, jnp.zeros((xr.shape[0], 3), jnp.int32), band, c,
                      None)
        return (co["bits"] + ixmax_eff + approx + oob
                + co["a1"] + co["cts"] + co["r0c"])

    stages = ["search_prep"] + [s for s in ENCODE_STAGES
                                if not s.startswith("an_")]
    table, untraced_s = _trace_stage_table(one_eval, xr_res, stages,
                                           dispatches)
    per_eval = {}
    tot_us = sum(v["ms"] for v in table.values())
    for k, v in table.items():
        per_eval[k] = dict(ms=v["ms"], share=round(v["ms"] / tot_us, 3),
                           dominant=v["dominant"])
    return {"stages": per_eval,
            "eval_ms": round(tot_us, 2),
            "us_per_lane_eval": round(tot_us * 1e3 / lanes, 3)}


def fmt_table(rec, title):
    lines = [f"== {title} ==",
             f"{'stage':<16}{'ms':>8}{'share':>7}{'ops':>6}  dominant / "
             "top kernels"]
    for name, s in rec["stages"].items():
        lines.append(f"{name:<16}{s['ms']:>8.3f}{s['share']:>7.1%}"
                     f"{s['n_ops']:>6}  {s['dominant']} / "
                     f"{', '.join(s['kernels'])}")
    su = rec["summary"]
    lines.append(f"total {su['total_device_ms']:.3f} device ms per dispatch; "
                 f"untraced {su['untraced_ms']:.2f} ms")
    if "per_eval" in rec:
        pe = rec["per_eval"]
        lines.append(f"-- one search evaluation, unrolled "
                     f"({pe['eval_ms']:.3f} ms) --")
        for name, s in pe["stages"].items():
            lines.append(f"{name:<16}{s['ms']:>8.3f}{s['share']:>7.1%}"
                         f"{'':>6}  {s['dominant']}")
    return "\n".join(lines)


def main():
    import jax
    rec = {
        "decode": profile_decode_plane(),
        "encode": profile_encode_plane(),
        "device_kind": jax.devices()[0].device_kind,
    }
    print(fmt_table(rec["decode"], "decode plane (corpus, resident)"))
    print()
    print(fmt_table(rec["encode"], "encode plane (corpus, resident)"))
    with open(os.path.join(REPO, "PROFILE_PLANES.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"\nwritten: {os.path.join(REPO, 'PROFILE_PLANES.json')}")


if __name__ == "__main__":
    main()
