"""Device-sharded batched encode: many WAV files as one stacked device program.

The encode twin of parallel/batch_decode: per-file PCM streams are padded to a
common (bucketed) granule count and stacked on a file axis; the analysis/MDCT
plane and the FULL rate-control search (ops/search_plane) then run as one
vmapped device program with the file axis laid out on the mesh's ``files``
axis (NamedSharding — encoding is file-parallel, zero collectives). Only the
reservoir/stuffing chain and frame serialization stay on host, overlapped in a
thread pool (the native serializer releases the GIL).

The reference has no multi-file mode at all (SURVEY.md §2.2); this layer is
the accelerator throughput construct for it.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# granule-count bucket: bounds the number of compiled shapes (env knob so the
# CPU test mesh can compile small programs)
_BUCKET_G = int(os.environ.get("MP3STEGO_TPU_BATCH_BUCKET_G", "256"))


def _bucket(n: int) -> int:
    return -(-n // _BUCKET_G) * _BUCKET_G


def _bucket_files(f: int) -> int:
    """Round the file axis up to a power of two (padded files are silent and
    cost one skipped lane pass) so batch sizes reuse compiled programs."""
    n = 1
    while n < f:
        n <<= 1
    return n


def encode_files_batched(jobs: list, bitrate: int = 320, mesh=None,
                         max_workers: int = None,
                         errors: str = "raise") -> list:
    """Encode many WAV files: ``jobs`` is a list of (wav_path, mp3_path).

    Output bytes are identical to per-file :class:`MP3Encoder` runs. Files are
    grouped by (samplerate, channel count) — each group is one stacked device
    program. ``mesh``: optional jax Mesh with a ``files`` axis to shard over.

    ``errors``: "raise" propagates the first failure; "isolate" encodes the
    healthy files and returns the exception object in the failed file's slot
    (read_wav validation failures raise SystemExit — isolated too).
    """
    from mp3stego_tpu.models.encoder import MP3Encoder
    from mp3stego_tpu.utils.wav import read_wav

    items = []
    failures = {}
    for i, (wav_path, mp3_path) in enumerate(jobs):
        try:
            if not os.path.exists(wav_path):
                raise FileNotFoundError(wav_path)
            enc = MP3Encoder(read_wav(wav_path, bitrate))
            nf = enc._num_frames()
            if nf == 0:
                raise ValueError(f"{wav_path}: no samples to encode")
            items.append((i, mp3_path, enc, nf))
        except BaseException as e:  # noqa: BLE001 - incl. SystemExit from read_wav
            if errors != "isolate" or isinstance(e, KeyboardInterrupt):
                raise
            failures[i] = e

    results = [None] * len(jobs)

    # Engine auto-select: with no explicit mesh, the measured cost model
    # (utils/calibrate.py: probed link bandwidth vs the C++ whole-file
    # search rate) picks between the fully-host engine per file
    # (models/encoder._encode_host — zero link traffic, zero XLA compiles)
    # and the stacked device program. An explicit ``mesh`` always requests
    # the sharded device path; MP3STEGO_TPU_BATCH_ENC_HOST=1/0 keeps
    # absolute priority without one.
    from mp3stego_tpu.utils.calibrate import batch_encode_engine
    total_g = sum(nf for (_, _, _, nf) in items) * 2
    if (items and mesh is None
            and batch_encode_engine(total_g) == "host"):
        from mp3stego_tpu.models.encoder import _native_rate_lib
        lib = _native_rate_lib()
        if (lib is not None and hasattr(lib, "rate_search_file")
                and hasattr(lib, "encode_analysis")):
            from mp3stego_tpu.utils.profiling import StageTimer

            def host_one(it):
                i, mp3_path, enc, nf = it
                assert enc._encode_host(nf, StageTimer(enabled=False))
                enc.write_mp3_file(mp3_path)
                return mp3_path

            workers = max_workers or min(8, (os.cpu_count() or 1))
            with ThreadPoolExecutor(max_workers=workers) as ex:
                futures = {ex.submit(host_one, it): it[0] for it in items}
                for fut, i in futures.items():
                    try:
                        results[i] = fut.result()
                    except BaseException as e:  # noqa: BLE001 - isolation
                        if errors != "isolate" or isinstance(
                                e, KeyboardInterrupt):
                            raise
                        results[i] = e
            for i, e in failures.items():
                results[i] = e
            return results

    groups = {}
    for it in items:
        enc = it[2]
        groups.setdefault(
            (enc.samplerate_index, enc.wav.num_of_channels), []).append(it)
    for (sr_idx, nch), group in groups.items():
        _encode_group(group, sr_idx, nch, mesh, max_workers, results, errors)
    for i, e in failures.items():
        results[i] = e
    return results


def _encode_group(group, sr_idx, nch, mesh, max_workers, results, errors):
    # per-device-program lane budget (lanes = files x channels x granules):
    # the analysis and search temps scale with it (8x30s stereo = 37k
    # lanes; one 120s stereo file is 18.4k). 49152 is a fixed budget, not
    # derived from the card's memory; chip_smoke.py prints the peak device
    # memory it reaches.
    # Groups above the budget run as pipelined sub-batches: sub-batch k+1's
    # PCM prep/stacking runs on a worker thread while the device runs k,
    # and host finishers overlap in the pool.
    max_lanes = int(os.environ.get("MP3STEGO_TPU_BATCH_ENC_LANES", "49152"))
    gpf = group[0][2].granules_per_frame
    tg_max = _bucket(max(nf * gpf for (_, _, _, nf) in group))
    per = max(1, max_lanes // (nch * tg_max))
    if mesh is not None:
        m = mesh.shape["files"]
        per = max(m, per - per % m)           # whole mesh rows per sub-batch
    workers = max_workers or min(8, (os.cpu_count() or 1))
    subs = [group[i:i + per] for i in range(0, len(group), per)]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futures = {}
        prep = ex.submit(_prep_subbatch, subs[0], sr_idx, nch, tg_max, mesh)
        for k, sub in enumerate(subs):
            staged = prep.result()
            if k + 1 < len(subs):
                prep = ex.submit(_prep_subbatch, subs[k + 1], sr_idx, nch,
                                 tg_max, mesh)
            for fut, i in _run_subbatch(sub, staged, sr_idx, nch, tg_max,
                                        mesh, ex).items():
                futures[fut] = i
        for fut, i in futures.items():
            try:
                results[i] = fut.result()
            except BaseException as e:  # noqa: BLE001 - isolation mode
                if errors != "isolate" or isinstance(e, KeyboardInterrupt):
                    raise
                results[i] = e


def _prep_subbatch(group, sr_idx, nch, tg_max, mesh):
    """Host half of one sub-batch: stacked front-padded PCM (raw int16 — the
    device plane upshifts on chip, halving the upload; zero tail granules
    decode to xrmax==0 lanes), per-lane bit budgets, per-file framing."""
    from mp3stego_tpu.ops.encode_plane import _PAST
    from mp3stego_tpu.ops import quant as Q

    gpf = group[0][2].granules_per_frame
    f_pad = _bucket_files(len(group))
    if mesh is not None:
        f_pad += (-f_pad) % mesh.shape["files"]
    pcm = np.zeros((f_pad, nch, _PAST + tg_max * 576), np.int16)
    max_bits = np.zeros((f_pad, nch * tg_max), np.int32)
    framing = []
    for j, (_, _, enc, nf) in enumerate(group):
        s = enc._channel_streams_i16(nf)
        pcm[j, :, _PAST:_PAST + s.shape[1]] = s
        paddings, mean_bits_f = enc._plane_framing(nf)
        framing.append((paddings, mean_bits_f))
        maxb_f = np.minimum(np.asarray(mean_bits_f, np.int64) // nch,
                            Q.MAX_BITS_ALLOWANCE)
        lane_block = np.repeat(maxb_f, gpf)              # (tg,)
        tg = nf * gpf
        for ch in range(nch):
            max_bits[j, ch * tg_max: ch * tg_max + tg] = lane_block
    return pcm, max_bits, framing


def _run_subbatch(group, staged, sr_idx, nch, tg_max, mesh, ex):
    """Device half of one sub-batch + its host finisher submissions."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mp3stego_tpu.ops import search_plane as SP
    from mp3stego_tpu.ops.encode_plane import analysis_mdct_i16

    pcm, max_bits, framing = staged
    f_pad = pcm.shape[0]
    tgs = [nf * group[0][2].granules_per_frame for (_, _, _, nf) in group]

    if mesh is not None:
        spec = NamedSharding(mesh, P("files"))
        pcm_dev = jax.device_put(pcm, spec)
    else:
        from mp3stego_tpu.utils.transfer import put_pieces
        pcm_dev = put_pieces(pcm)

    xr = jax.vmap(analysis_mdct_i16)(pcm_dev)            # (F, nch, TG, 576)
    xr = xr.reshape(f_pad, nch * tg_max, 576)
    version3 = group[0][2].version == 3
    # scfsi sums fused into the search program: one dispatch + fetch round
    res_all = SP.search_batch(xr, max_bits, sr_idx, want_scfsi=version3)
    if version3:
        tot_all, en_all = res_all["scfsi"]
    # each file's spectra as a one-device array, cut from the shard that
    # holds it: the finishers run in threads, and indexing the mesh-sharded
    # xr there would launch multi-device programs from several threads at
    # once, which can stall in the cards' collective rendezvous
    xr_file = _per_file(xr)

    def finish(j):
        i, mp3_path, enc, nf = group[j]
        tg = tgs[j]
        # compact the padded per-channel lane blocks to the enc layout
        # (g = ch * tg + f * gpf + gr)
        lanes = np.concatenate(
            [np.arange(ch * tg_max, ch * tg_max + tg) for ch in range(nch)])
        res = {k: np.ascontiguousarray(res_all[k][j][lanes])
               for k in SP._FIN_ROWS}
        res["ix"] = np.ascontiguousarray(res_all["ix"][j][lanes])  # int8
        # remap this file's wide-lane patches from padded (file, lane) keys
        # to the compact g = ch * tg + local layout
        res["ixw"] = {}
        for (fj, lane), row in res_all.get("ixw", {}).items():
            if fj != j:
                continue
            ch, off = divmod(lane, tg_max)
            if off < tg:
                res["ixw"][ch * tg + off] = row
        res["log_steps"] = res_all["log_steps"][j][lanes]
        res["log_bits"] = res_all["log_bits"][j][lanes]
        xr_c = xr_file[j][jnp.asarray(lanes)]
        enc._plane_redo(res, xr_c, max_bits[j][lanes], tg)
        en_tot_raw = en_raw = None
        if version3:
            en_tot_raw = tot_all[j][lanes]
            en_raw = en_all[j][lanes]
        paddings, mean_bits_f = framing[j]
        enc._plane_finish(res, en_tot_raw, en_raw, nf, paddings,
                          mean_bits_f, tg)
        enc.write_mp3_file(mp3_path)
        return mp3_path

    return {ex.submit(finish, j): group[j][0] for j in range(len(group))}


def _per_file(xr) -> list:
    """(F, N, 576) spectra, sharded or not -> F one-device (N, 576) arrays,
    each sliced from the addressable shard that holds that file."""
    out = [None] * xr.shape[0]
    for sh in xr.addressable_shards:
        lo = sh.index[0].start or 0
        for k in range(sh.data.shape[0]):
            out[lo + k] = sh.data[k]
    return out
