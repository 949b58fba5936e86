"""Sequence parallelism over the granule/time axis of one MP3 stream.

The reference decodes granules strictly sequentially because of two carries
(SURVEY.md §2.2): the IMDCT overlap-add `prev_samples` (one granule of lookback,
Frame.py:150-154) and the synthesis FIFO (15 sub-steps < 1 granule,
Frame.py:80-101). Both carries are *bounded halos*, so a time-range shard only
needs its left neighbour's boundary state: this module shard_maps the decode
plane over a ``frames`` mesh axis and exchanges the halos with a single
`jax.lax.ppermute` shift between devices. Everything else is granule-local and runs
without communication.

This is the workload's context parallelism (SURVEY.md §5.7): the frame axis is
the "sequence", the halo exchange is the ring collective.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from mp3stego_tpu.ops import decode_plane as dp


def _shard_body(prep, dtype):
    """Per-shard decode: local blocks, then halo exchange of the two carries."""
    blk = dp.granule_blocks(prep, dtype)

    n = jax.lax.axis_size("frames")
    shift_right = [(i, i + 1) for i in range(n - 1)]  # shard i -> i+1

    # halo 1: previous shard's last granule tail (zeros into shard 0)
    tail_halo = jax.lax.ppermute(blk[:, -1:, :, 18:], "frames", shift_right)

    # overlap-add + V matmul happen locally; the FIR needs the previous
    # shard's last 15 V sub-steps. V depends only on local blk + tail_halo,
    # so each shard recomputes its boundary V and ships it right.
    pcm, _, last_v = dp.synth_from_blocks(blk, dtype, tail_halo=tail_halo)
    v_halo = jax.lax.ppermute(last_v, "frames", shift_right)

    # redo only the FIR with the true left-neighbour V history: cheap —
    # implemented by re-running synth with both halos (XLA dedups the matmul)
    pcm, _, _ = dp.synth_from_blocks(blk, dtype, tail_halo=tail_halo,
                                     v_halo=v_halo)
    return pcm


def _specs(mesh):
    # the sharded path ships a pre-densified sample plane (exception indices
    # are stream-global, so the int8+escape form can't split on T)
    t_spec = P(None, "frames")                 # (ch, T, ...) split on time
    in_specs = {k: t_spec for k in dp.T_AXIS1_KEYS if k != "raw_i8"}
    in_specs["raw_dense"] = t_spec
    in_specs.update({k: P("frames") for k in dp.T_AXIS0_KEYS})
    in_specs.update({k: P() for k in dp.CONST_KEYS})
    return in_specs, t_spec


@functools.partial(jax.jit, static_argnames=("mesh", "dtype_name"))
def _decode_sharded(args, mesh: Mesh, dtype_name="float32"):
    dtype = jnp.dtype(dtype_name)
    in_specs, t_spec = _specs(mesh)
    body = shard_map(
        functools.partial(_shard_body, dtype=dtype),
        mesh=mesh,
        in_specs=(in_specs,),
        out_specs=t_spec,
    )
    return body(args)


def decode_granules_sharded(prep: dict, mesh: Mesh,
                            dtype: str = "float32") -> np.ndarray:
    """Decode one parsed stream with its granule axis sharded over the mesh's
    ``frames`` axis. Pads T up to a multiple of the axis size (padded granules
    decode as silence and are trimmed)."""
    n = mesh.shape["frames"]
    t = prep["raw_i8"].shape[1]
    t_pad = (-t) % n

    def pad(a, axis):
        if t_pad == 0:
            return a
        width = [(0, 0)] * a.ndim
        width[axis] = (0, t_pad)
        return np.pad(a, width)

    in_specs, _ = _specs(mesh)
    host = dict(prep)
    host["raw_dense"] = dp.dense_raw(prep).astype(np.int16)
    args = {}
    for k, spec in in_specs.items():
        axis = 1 if (k in dp.T_AXIS1_KEYS or k == "raw_dense") else \
            (0 if k in dp.T_AXIS0_KEYS else None)
        a = host[k] if axis is None else pad(host[k], axis)
        args[k] = jax.device_put(a, NamedSharding(mesh, spec))
    out = _decode_sharded(args, mesh=mesh, dtype_name=dtype)
    return np.asarray(out)[:, :t]
