"""Data-parallel batched decode: many MP3 files at once, sharded over a mesh.

The directory-decode throughput mode ("frames vmapped across files"): host
parses each file into dense granule tensors (bitstream plane),
pads to a common granule count, stacks a file axis, and the whole batch decodes
as one vmapped device program with the file axis sharded over the mesh's
``files`` axis. Decoding is embarrassingly parallel across files, so this path
needs zero collectives.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mp3stego_tpu.bitstream import decoder_host as dh
from mp3stego_tpu import tables as T
from mp3stego_tpu.ops import decode_plane as dp


def prepare_batch(preps: list, t_pad_to: int = 1) -> dict:
    """Stack per-file host_prepare outputs into one padded batch.

    Padded granules carry raw==0 / exp indices 0 and decode to silence; callers
    trim with the returned ``lengths``. ``t_pad_to`` rounds the granule axis up
    to a multiple (the pipelined chunk path uses it to bound the number of
    distinct compiled shapes).
    """
    if not preps:
        raise ValueError("prepare_batch: no files to batch")
    n = len(preps)
    t_max = max(p["raw_i8"].shape[1] for p in preps)
    t_max += (-t_max) % max(1, t_pad_to)

    def stack(key, axis=1):
        # preallocate once and slice-assign (np.pad+np.stack would copy twice)
        proto = preps[0][key]
        shape = list(proto.shape)
        shape[axis] = t_max
        out = np.zeros([n] + shape, dtype=proto.dtype)
        for i, p in enumerate(preps):
            a = p[key]
            idx = [i] + [slice(None)] * a.ndim
            idx[1 + axis] = slice(0, a.shape[axis])
            out[tuple(idx)] = a
        return out

    batch = {k: stack(k, axis=1) for k in dp.T_AXIS1_KEYS}
    batch.update({k: stack(k, axis=0) for k in dp.T_AXIS0_KEYS})
    # sparse exception lists: pad to the max count with an out-of-range granule
    # index (the device scatter drops them)
    e_max = max(1, max(len(p["exc_t"]) for p in preps))
    for k in dp.EXC_KEYS:
        proto = preps[0][k]
        fill = dp._EXC_PAD_T if k == "exc_t" else 0
        out = np.full((n, e_max), fill, dtype=proto.dtype)
        for i, p in enumerate(preps):
            out[i, :len(p[k])] = p[k]
        batch[k] = out
    # per-file constant tables (tiny; stacked so mixed-samplerate batches work)
    batch.update({k: np.stack([p[k] for p in preps]) for k in dp.CONST_KEYS})
    batch["lengths"] = np.array([p["raw_i8"].shape[1] for p in preps])
    batch["num_files"] = n
    return batch


@functools.partial(jax.jit, static_argnames=("dtype_name",))
def _decode_batch(args, dtype_name="float32"):
    fn = functools.partial(dp.decode_granules_impl, dtype_name=dtype_name)
    return jax.vmap(fn)(args)


def prepare_batch_concat(preps: list, t_pad_to: int = 1) -> dict:
    """Stack per-file host_prepare outputs as ONE concatenated granule axis.

    The granule half of the decode plane is granule-local, so a batch of
    files is just a longer granule axis to it — no file axis, no vmap.
    Under ``vmap``, the plane's exception scatter and reorder gather (whose
    indices are per-file tensors) lower to a while loop over files whose
    every iteration dynamic-slices and re-writes the FULL batch plane,
    scaling O(F^2). On the concat layout they are one scatter/gather.
    Synthesis (the only cross-granule stage) still runs per file — the
    concat decode reshapes to a file axis only for that half.

    Requires every file to share the constant tables (same samplerate and
    band-mode — callers group by samplerate). Returns the concat prep with
    ``lengths`` / ``num_files`` / ``t_max`` bookkeeping keys.
    """
    if not preps:
        raise ValueError("prepare_batch_concat: no files to batch")
    n = len(preps)
    t_max = max(p["raw_i8"].shape[1] for p in preps)
    t_max += (-t_max) % max(1, t_pad_to)

    batch = {}
    for k in dp.T_AXIS1_KEYS:
        proto = preps[0][k]
        shape = list(proto.shape)
        shape[1] = n * t_max
        out = np.zeros(shape, dtype=proto.dtype)
        for i, p in enumerate(preps):
            a = p[k]
            idx = [slice(None)] * a.ndim
            idx[1] = slice(i * t_max, i * t_max + a.shape[1])
            out[tuple(idx)] = a
        batch[k] = out
    has_is = any(p["is_mask"].any() for p in preps)
    for k in dp.T_AXIS0_KEYS:
        proto = preps[0][k]
        if not has_is and k in ("is_pos", "is_tab"):
            # static no-IS contract: empty tensors compile the intensity
            # overlay away (decode_plane._stereo_stage)
            batch[k] = np.zeros((0,) + proto.shape[1:], proto.dtype)
            continue
        shape = list(proto.shape)
        shape[0] = n * t_max
        out = np.zeros(shape, dtype=proto.dtype)
        for i, p in enumerate(preps):
            a = p[k]
            out[i * t_max: i * t_max + a.shape[0]] = a
        batch[k] = out
    if not has_is:
        batch["is_pos"] = np.zeros((0, 4, 22), preps[0]["is_pos"].dtype)
    # exception lists: shift each file's granule index into the concat axis
    # (the existing single-file scatter path then applies verbatim)
    exc = {k: [] for k in dp.EXC_KEYS}
    for i, p in enumerate(preps):
        t_shift = np.where(p["exc_t"] < dp._EXC_PAD_T,
                           p["exc_t"].astype(np.int64) + i * t_max,
                           dp._EXC_PAD_T).astype(np.int32)
        exc["exc_t"].append(t_shift)
        for k in ("exc_ch", "exc_s", "exc_val"):
            exc[k].append(p[k])
    n_exc = sum(len(a) for a in exc["exc_t"])
    for k in dp.EXC_KEYS:
        if n_exc:
            batch[k] = np.concatenate(exc[k])
        else:  # one padded entry keeps the scatter shape nonzero
            fill = dp._EXC_PAD_T if k == "exc_t" else 0
            batch[k] = np.full(1, fill, dtype=preps[0][k].dtype)
    for k in dp.CONST_KEYS:
        for p in preps[1:]:
            if not np.array_equal(p[k], preps[0][k]):
                raise ValueError(
                    f"prepare_batch_concat: files disagree on constant {k} "
                    "(mixed samplerates must be grouped per batch)")
        batch[k] = preps[0][k]
    batch["lengths"] = np.array([p["raw_i8"].shape[1] for p in preps])
    batch["num_files"] = n
    batch["t_max"] = t_max
    return batch


@functools.partial(jax.jit,
                   static_argnames=("num_files", "dtype_name", "to_i16",
                                    "wrap"))
def _decode_batch_concat(args, num_files, dtype_name="float32",
                         to_i16=False, wrap=False):
    """Concat-layout batch decode: granule half over one long granule axis,
    synthesis vmapped per file (see prepare_batch_concat). Output matches
    the stacked path: (files, ch, T, 576)."""
    dtype = jnp.dtype(dtype_name)
    blk = dp.granule_blocks(args, dtype)            # (2, F*T, 32, 36)
    ch, ft = blk.shape[0], blk.shape[1]
    t = ft // num_files
    with jax.named_scope("file_split"):
        # vmap over the file axis IN PLACE (in_axes=1 on the (ch, F, T, ...)
        # view) — no materialized (F, ch, T, ...) transpose
        blkf = blk.reshape(ch, num_files, t, 32, 36)
    pcm = jax.vmap(lambda b: dp.synth_from_blocks(b, dtype)[0],
                   in_axes=1, out_axes=0)(blkf)
    if to_i16:
        with jax.named_scope("pcm_i16"):
            x = pcm * jnp.float32(32767)
            if not wrap:
                x = jnp.clip(x, jnp.float32(-32768), jnp.float32(32767))
            return x.astype(jnp.int32).astype(jnp.int16)
    return pcm


@functools.partial(jax.jit, static_argnames=("wrap",))
def _decode_batch_i16(args, wrap=False):
    """float32 plane + the WAV int16 conversion ON DEVICE (halves the batch
    fetch) — the stacked twin of decode_plane._decode_granules_i16."""
    pcm = jax.vmap(functools.partial(dp.decode_granules_impl,
                                     dtype_name="float32"))(args)
    x = pcm * jnp.float32(32767)
    if not wrap:
        x = jnp.clip(x, jnp.float32(-32768), jnp.float32(32767))
    return x.astype(jnp.int32).astype(jnp.int16)


def decode_batch_device(batch: dict, mesh: Mesh = None,
                        dtype: str = "float32", to_i16: bool = False):
    """Run the stacked batch on device; file axis sharded over ``files``."""
    if mesh is not None:
        n_shard = mesh.shape["files"]
        spec = NamedSharding(mesh, P("files"))
        put = lambda a: jax.device_put(_pad_files(a, n_shard), spec)  # noqa: E731
    else:
        from mp3stego_tpu.utils.transfer import put_pieces
        put = put_pieces
    args = {k: put(batch[k]) for k in dp.ALL_KEYS}
    if to_i16:
        out = _decode_batch_i16(args, wrap=T.ref_pcm_wrap())
    else:
        out = _decode_batch(args, dtype_name=dtype)
    return out[:batch["num_files"]]


def _pad_files(a: np.ndarray, n_shard: int) -> np.ndarray:
    pad = (-a.shape[0]) % n_shard
    if pad == 0:
        return a
    width = [(0, 0)] * a.ndim
    width[0] = (0, pad)
    return np.pad(a, width)


def decode_files_batched(paths: list, mesh: Mesh = None,
                         dtype: str = "float32",
                         errors: str = "raise",
                         out: str = "float") -> list:
    """Decode many MP3 files in one batched device program.

    Returns a list of interleaved PCM arrays (samples, channels), one per
    file, matching Decoder/decode_pcm output per file. ``out="int16"`` fuses
    the WAV conversion (*32767, truncate) on device and fetches int16 — half
    the bytes over the host link; use it when the destination is a WAV file.

    ``errors``: "raise" propagates the first per-file parse failure;
    "isolate" decodes the healthy files and returns the exception object in
    the failed file's slot (a corrupt file cannot poison the batch).

    Engine auto-select for ``out="int16"``: the measured cost model in
    utils/calibrate.py (probed link bandwidth + host-plane rate, cached per
    host fingerprint) picks the bit-exact native host plane or the float32
    device plane (≤1 LSB int16 deviation at ~1e-4 rate) per batch.
    ``MP3STEGO_TPU_BATCH_HOST_G=<granules>`` keeps absolute priority as a
    fixed threshold (0 forces the device path).
    """
    metas = []
    failures = {}
    for i, path in enumerate(paths):
        try:
            with open(path, "rb") as f:
                data = f.read()
            from mp3stego_tpu.bitstream.id3 import parse_id3
            id3 = parse_id3(data)
            parsed = dh.parse_mp3(data, id3.offset if id3.is_valid else 0)
            if parsed.num_frames == 0:
                raise ValueError(f"{path}: no MP3 frames found")
            metas.append(parsed)
        except Exception as e:  # noqa: BLE001 - isolation mode surfaces them
            if errors != "isolate":
                raise
            failures[i] = e

    results = [None] * len(paths)
    from mp3stego_tpu.utils.calibrate import batch_decode_engine
    total_g = sum(m.num_frames for m in metas) * 2
    if (out == "int16" and dtype == "float32" and metas
            and batch_decode_engine(total_g) == "host"):
        host = [dp.decode_pcm_i16_host(m) for m in metas]
        if all(h is not None for h in host):   # native lib available
            j = 0
            for i in range(len(paths)):
                if i in failures:
                    continue
                results[i] = host[j]
                j += 1
            for i, e in failures.items():
                results[i] = e
            return results

    if metas:
        decoded = _decode_device_pipelined(metas, mesh, dtype,
                                           to_i16=(out == "int16"))
        j = 0
        for i in range(len(paths)):
            if i in failures:
                continue
            results[i] = decoded[j]
            j += 1
    for i, e in failures.items():
        results[i] = e
    return results


def _unpack_chunk(planes: np.ndarray, batch: dict, metas: list) -> list:
    """Trim the padded (files, ch, T, 576) planes back to per-file
    interleaved PCM (samples, channels). LSF virtual-frame trimming and the
    stale-PCM duplication quirk are shared with every other PCM producer
    (decode_plane._finish_inter)."""
    out = []
    for j, parsed in enumerate(metas):
        t = int(batch["lengths"][j])
        pcm = planes[j, :, :t]
        ch = parsed.header.channels
        inter = pcm[:ch].transpose(1, 2, 0).reshape(t * 576, ch)
        out.append(dp._finish_inter(parsed, inter))
    return out


def _decode_device_pipelined(metas: list, mesh, dtype: str, to_i16: bool,
                             chunk_files: int = None) -> list:
    """Device-path batch decode with the host stages pipelined against the
    device stages (VERDICT r2 item 2).

    The batch is split into chunks of ``chunk_files`` files; a single prep
    worker thread runs host_prepare + stacking for chunk k+1 while the main
    thread uploads/decodes/fetches chunk k. The host work is C++/NumPy
    (releases the GIL) and the device stages block on link I/O, so the two
    genuinely overlap even on one core. Granule counts are padded to a
    bucket so at most a few shapes compile. MP3STEGO_TPU_BATCH_CHUNK_FILES
    sets the chunk size (0 disables chunking/pipelining).
    """
    import os as _os

    from concurrent.futures import ThreadPoolExecutor

    from mp3stego_tpu.utils.transfer import fetch_pieces

    if chunk_files is None:
        chunk_files = int(_os.environ.get(
            "MP3STEGO_TPU_BATCH_CHUNK_FILES", "16"))
    t_bucket = 32

    def slim(dev, ms):
        # all-mono chunk: drop the dead channel ON DEVICE before the fetch
        # (halves the d2h bytes — the link is this path's binding resource)
        return dev[:, :1] if all(m.header.channels == 1 for m in ms) else dev

    if mesh is None:
        # concat layout (no file axis in the granule half — see
        # prepare_batch_concat); constants must match within a dispatch, so
        # chunks group by samplerate. Output order is restored per index.
        from mp3stego_tpu.utils.transfer import put_pieces

        def prep(ms):
            return prepare_batch_concat([dp.host_prepare(m) for m in ms],
                                        t_pad_to=t_bucket)

        def dispatch(batch, ms):
            args = {k: put_pieces(batch[k]) for k in dp.ALL_KEYS}
            out = _decode_batch_concat(args, num_files=batch["num_files"],
                                       dtype_name=dtype, to_i16=to_i16,
                                       wrap=T.ref_pcm_wrap() and to_i16)
            return slim(out, ms)

        by_sr = {}
        for idx, m in enumerate(metas):
            by_sr.setdefault(m.header.sr_idx, []).append(idx)
        chunks = []          # lists of original indices
        step = chunk_files if chunk_files > 0 else len(metas)
        for idxs in by_sr.values():
            chunks += [idxs[i:i + step] for i in range(0, len(idxs), step)]
        results = [None] * len(metas)

        def finish(dev, batch, idxs):
            planes = fetch_pieces([dev])[0]
            out = _unpack_chunk(planes, batch, [metas[i] for i in idxs])
            for i, pcm in zip(idxs, out):
                results[i] = pcm

        # three-stage software pipeline: prep(k+1) ∥ upload+compute(k) ∥
        # fetch(k-1). Whether the fetch gets its OWN thread (so chunk k+1's
        # upload overlaps chunk k's PCM drain) is decided by the probed
        # duplex gain — the measured concurrent up+down aggregate over the
        # half-duplex model: >1 means the link's directions genuinely
        # overlap, <=1 means they contend and the fetch
        # stays inline, trailing the async dispatch by one chunk.
        # MP3STEGO_TPU_FETCH_THREAD=1/0 overrides.
        env = _os.environ.get("MP3STEGO_TPU_FETCH_THREAD")
        if env is not None:
            threaded_fetch = env == "1"
        else:
            from mp3stego_tpu.utils.calibrate import get_probe
            threaded_fetch = get_probe().duplex_gain > 1.05
        with ThreadPoolExecutor(max_workers=1) as pool, \
                ThreadPoolExecutor(max_workers=1) as fetcher:
            fut = pool.submit(prep, [metas[i] for i in chunks[0]])
            fetches = []
            pending = None
            for k, idxs in enumerate(chunks):
                batch = fut.result()
                if k + 1 < len(chunks):
                    fut = pool.submit(prep,
                                      [metas[i] for i in chunks[k + 1]])
                dev = dispatch(batch, [metas[i] for i in idxs])
                if threaded_fetch:
                    fetches.append(fetcher.submit(finish, dev, batch, idxs))
                    if len(fetches) >= 2:
                        fetches[-2].result()
                else:
                    if pending is not None:
                        finish(*pending)
                    pending = (dev, batch, idxs)
            if threaded_fetch:
                fetches[-1].result()
            else:
                finish(*pending)
        return results

    def prep(ms):
        return prepare_batch([dp.host_prepare(m) for m in ms],
                             t_pad_to=t_bucket)

    if chunk_files <= 0 or len(metas) <= chunk_files:
        batch = prep(metas)
        dev = slim(decode_batch_device(batch, mesh, dtype, to_i16=to_i16),
                   metas)
        return _unpack_chunk(fetch_pieces([dev])[0], batch, metas)

    chunks = [metas[i:i + chunk_files]
              for i in range(0, len(metas), chunk_files)]
    outs = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(prep, chunks[0])
        pending = None   # (dev ref, batch, metas) — dispatched, not fetched
        for k, ms in enumerate(chunks):
            batch = fut.result()
            if k + 1 < len(chunks):
                fut = pool.submit(prep, chunks[k + 1])
            dev = slim(decode_batch_device(batch, mesh, dtype, to_i16=to_i16),
                       ms)
            if pending is not None:
                outs.extend(_unpack_chunk(fetch_pieces([pending[0]])[0],
                                          pending[1], pending[2]))
            pending = (dev, batch, ms)
        outs.extend(_unpack_chunk(fetch_pieces([pending[0]])[0],
                                  pending[1], pending[2]))
    return outs
