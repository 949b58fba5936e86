"""Device mesh construction for the codec's two parallel axes.

Axes:
  * ``files``  — data parallelism: independent MP3/WAV streams (no collectives;
                 pure throughput scaling across devices).
  * ``frames`` — sequence parallelism: granule/time ranges of one stream;
                 shards exchange the codec's carried state (one granule of
                 IMDCT overlap + 15 synthesis V sub-steps) as halos.
"""

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(files: int = 0, frames: int = 1, devices=None) -> Mesh:
    """Build a (files, frames) mesh. ``files=0`` means "use all remaining
    devices on the files axis"."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if files == 0:
        if n % frames:
            raise ValueError(f"{n} devices not divisible by frames={frames}")
        files = n // frames
    if files * frames > n:
        raise ValueError(f"mesh {files}x{frames} needs {files * frames} devices,"
                         f" have {n}")
    dev = np.asarray(devices[:files * frames]).reshape(files, frames)
    return Mesh(dev, axis_names=("files", "frames"))
