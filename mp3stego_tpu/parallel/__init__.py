"""Scale-out layer: device meshes, sharded batch decode, frame-range sharding.

The reference is strictly single-threaded (SURVEY.md §2.2/§5.8 — no parallel
machinery exists there); this package is the accelerator equivalent built from
first principles: `jax.sharding.Mesh` + `shard_map`, data parallelism over
files on one mesh axis, sequence parallelism over the granule/time axis on the
other, with the codec's two sequential carries (IMDCT overlap-add tail and the
synthesis FIR's 15-substep V history) exchanged between shards as halos via
`jax.lax.ppermute` between devices.
"""

from mp3stego_tpu.parallel.mesh import make_mesh  # noqa: F401
from mp3stego_tpu.parallel.batch_decode import (  # noqa: F401
    decode_files_batched, prepare_batch,
)
from mp3stego_tpu.parallel.batch_encode import encode_files_batched  # noqa: F401
from mp3stego_tpu.parallel.frame_shard import decode_granules_sharded  # noqa: F401
