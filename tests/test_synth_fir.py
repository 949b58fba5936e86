"""Synthesis half of the decode plane (``decode_plane.synth_from_blocks``)
against a NumPy reference: IMDCT overlap-add, frequency inversion, the V
matmul and the 16-tap FIR over the V history, at granule counts whose
sub-step total is and is not a multiple of 256, and across a stream split
carried by the two halos (the frame-sharded decode relies on it)."""

import numpy as np
import pytest

import jax.numpy as jnp

from mp3stego_tpu import tables as T
from mp3stego_tpu.ops import decode_plane as dp


def _fir_reference(v_ext, s):
    """The 16 shifted multiply-adds over a (ch, 15+s, 64) V history
    (decoder/Frame.py:80-101 windowing sum), in NumPy."""
    d = T.SYNTH_WINDOW.reshape(16, 32)
    va, vb = v_ext[..., :32], v_ext[..., 32:]
    ref = np.zeros(v_ext.shape[:1] + (s, 32), v_ext.dtype)
    for j in range(16):
        src = va if j % 2 == 0 else vb
        ref = ref + d[j] * src[:, 15 - j:15 - j + s]
    return ref


def _synth_reference(blk):
    """float64 NumPy twin of synth_from_blocks from a zero stream start."""
    ch, tt = blk.shape[:2]
    prev = np.concatenate([np.zeros_like(blk[:, :1, :, 18:]),
                           blk[:, :-1, :, 18:]], axis=1)
    y = (blk[..., :18] + prev) * dp._freq_inv_mask().reshape(32, 18)
    st = y.transpose(0, 1, 3, 2).reshape(ch, tt * 18, 32)
    v = st @ T.synth_filter_matrix().T
    v_ext = np.concatenate([np.zeros((ch, 15, 64)), v], axis=1)
    return _fir_reference(v_ext, tt * 18).reshape(ch, tt, 576)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
@pytest.mark.parametrize("granules", [128, 7])   # 18T = 9*256 / unaligned
def test_synth_matches_numpy_reference(granules, dtype, tol):
    rng = np.random.default_rng(granules)
    blk = rng.standard_normal((2, granules, 32, 36)) * 0.05
    pcm, _, _ = dp.synth_from_blocks(jnp.asarray(blk, dtype),
                                     jnp.dtype(dtype))
    assert pcm.shape == (2, granules, 576)
    np.testing.assert_allclose(np.asarray(pcm), _synth_reference(blk),
                               rtol=tol, atol=tol)


def test_synth_halo_continuity():
    """Two halves carried by (tail_halo, v_halo) equal one pass."""
    rng = np.random.default_rng(5)
    blk = jnp.asarray(rng.standard_normal((2, 20, 32, 36)) * 0.05,
                      jnp.float32)
    whole, _, _ = dp.synth_from_blocks(blk, jnp.float32)
    first, tail, v = dp.synth_from_blocks(blk[:, :9], jnp.float32)
    second, _, _ = dp.synth_from_blocks(blk[:, 9:], jnp.float32,
                                        tail_halo=tail, v_halo=v)
    np.testing.assert_allclose(
        np.concatenate([np.asarray(first), np.asarray(second)], axis=1),
        np.asarray(whole), rtol=1e-6, atol=1e-6)
