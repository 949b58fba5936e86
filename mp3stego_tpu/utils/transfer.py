"""Host<->device transfers split into ~4 MB pieces.

:func:`put_pieces` / :func:`fetch_pieces` move a large tensor as several
medium buffers instead of one, in both directions. Whether that is faster
than one transfer over PCIe to a GPU is not measured yet; the helpers are
byte-transparent either way.
"""

import jax
import jax.numpy as jnp
import numpy as np

PIECE_BYTES = 4 << 20


def put_pieces(arr: np.ndarray, device=None):
    """device_put with a large host array split into ~PIECE_BYTES pieces of
    its flat buffer (re-joined by a device-side concatenate + reshape, which
    is HBM-local and free next to the link cost). Small arrays go through one
    plain device_put."""
    nbytes = arr.size * arr.dtype.itemsize
    if nbytes <= 2 * PIECE_BYTES:
        return jax.device_put(arr, device)
    flat = np.ascontiguousarray(arr).reshape(-1)
    per = max(1, PIECE_BYTES // arr.dtype.itemsize)
    pieces = [jax.device_put(flat[i:i + per], device)
              for i in range(0, flat.shape[0], per)]
    return jnp.concatenate(pieces, axis=0).reshape(arr.shape)


def put_tree(prep: dict, device=None) -> dict:
    """put_pieces over every array of an input pytree (dict of ndarrays)."""
    return {k: put_pieces(np.asarray(v), device) for k, v in prep.items()}


def fetch_pieces(bufs, piece_bytes: int = PIECE_BYTES):
    """device_get with every buffer split into ~piece_bytes row slices."""
    split = []
    plan = []
    for b in bufs:
        nbytes = b.size * b.dtype.itemsize
        if nbytes <= piece_bytes or b.ndim == 0 or b.shape[0] <= 1:
            split.append(b)
            plan.append(None)
            continue
        rows_per = max(1, int(piece_bytes // max(1, (nbytes // b.shape[0]))))
        pieces = [b[i:i + rows_per] for i in range(0, b.shape[0], rows_per)]
        plan.append(len(pieces))
        split.extend(pieces)
    got = jax.device_get(split)
    out = []
    pos = 0
    for p in plan:
        if p is None:
            out.append(got[pos])
            pos += 1
        else:
            out.append(np.concatenate(got[pos:pos + p], axis=0))
            pos += p
    return out
