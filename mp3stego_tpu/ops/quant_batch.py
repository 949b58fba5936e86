"""Device-parallel rate-control costing: all 128 quantizer step sizes for all
granules in ONE batched device program.

The reference's bin-search/inner-loop (MP3_Encoder.py:958-996, 1064-1095)
evaluates quantize + run-length + table-select + bit-count sequentially per
visited step (~7-15 evaluations per granule). Here the full (granule, step)
grid is costed at once on device — integer-exact Q31/LUT arithmetic throughout
— and the host merely *replays* the reference's exact search trajectory as
O(#evals) table lookups (models/encoder.py). Two rare cases are flagged for
exact host fallback instead of being approximated:

  * ``approx``: a sample hit quantize's float64 fallback (ln >= 10000,
    MP3_Encoder.py:403-409) — the device evaluates it in float32, so those
    evaluations rerun on host;
  * ``bv == 0``: the reference then reads stale region addresses from the
    previous evaluation (its subdivide leaves address1..3 untouched), which a
    stateless batched program cannot know.

Per (granule, step) the device also emits the 5 cost channels + region maxima
needed to recost a region under ANY candidate Huffman table — this is what
makes the steganographic pair transform (hide mode) replayable on host without
re-scanning samples: cost(t) = c13/c15 for the no-linbits pair, or
c{16,24}base + linbits(t) * n_esc for the ESC families (tables 16..23 share
codebook 16; 24..31 share codebook 24).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mp3stego_tpu import tables as T
from mp3stego_tpu.ops import quant as Q

S_STEPS = 128          # step_size + 127 in [0, 127]
_BAIL = 165140         # 8192**(4/3), quantize's quick-reject threshold


@functools.lru_cache(maxsize=None)
def _consts():
    steptab, steptabi, int2idx = T.loop_tables()
    hlen = T.HUFF_LEN.astype(np.int32)
    return dict(
        steptabi=steptabi.astype(np.int64),
        int2idx=int2idx.astype(np.int32),
        h13=hlen[13], h15=hlen[15], h16=hlen[16], h24=hlen[24],
        q0=hlen[32, 0, :16], q1=hlen[33, 0, :16],
        linmax=T.HUFF_LINMAX.astype(np.int32),
        linbits=T.HUFF_LINBITS.astype(np.int32),
        subdv=T.SUBDV_TABLE.astype(np.int32),
    )


def _cost_all_steps(xr, band, consts):
    """xr (N, 576) int32 -> per-(N, S) costing tensors. Integer-exact."""
    c = consts
    n = xr.shape[0]
    steptabi = jnp.asarray(c["steptabi"])          # (128,) int64
    int2idx = jnp.asarray(c["int2idx"])

    xrabs32 = jnp.abs(xr)                          # int32 wrap like reference
    labs64 = jnp.abs(xr.astype(jnp.int64))
    xrmax = jnp.max(jnp.maximum(xrabs32, 0), axis=1)       # (N,) int32

    # quick bail per (N,S): mulr(xrmax, scalei) > 165140
    mr = (xrmax.astype(jnp.int64)[:, None] * steptabi[None, :]
          + 2147483648) >> 32
    bail = mr > _BAIL                                       # (N,S)

    # quantize: ln = mulr(|xr|, scalei); ix = int2idx[ln] (flag ln >= 10000)
    ln = ((labs64[:, None, :] * steptabi[None, :, None] + 2147483648)
          >> 32).astype(jnp.int32)                          # (N,S,576)
    approx = jnp.any(ln >= 10000, axis=2) & ~bail           # (N,S)
    ix = int2idx[jnp.clip(ln, 0, 9999)]                     # (N,S,576) int32
    ixmax = jnp.max(ix, axis=2)

    # ---- run lengths (calc_run_len, MP3_Encoder.py:266-291)
    pos = jnp.arange(576, dtype=jnp.int32)
    nz = ix != 0
    any_nz = jnp.any(nz, axis=2)
    last_nz = jnp.max(jnp.where(nz, pos, -1), axis=2)
    i0 = jnp.where(any_nz, ((last_nz + 2) >> 1) << 1, 0)    # round up to even
    gt1 = ix > 1
    lim = jnp.max(jnp.where(gt1, pos + 1, 0), axis=2)       # 0 if none
    k = jnp.maximum(0, jnp.minimum((i0 - lim) // 4, i0 // 4))
    c1 = k
    i_final = i0 - 4 * k
    bv = i_final >> 1                                       # big_values

    # ---- subdivide (MP3_Encoder.py:998-1036), vectorized
    bvr = 2 * bv                                            # (N,S)
    bandj = jnp.asarray(band)                               # (23,)
    # scfb_anz = first idx with band[idx] >= bvr
    scfb_anz = jnp.sum((bandj[None, None, :] < bvr[..., None]), axis=-1)
    # largest j with band[j] <= bvr
    kmax = jnp.sum((bandj[None, None, :] <= bvr[..., None]), axis=-1) - 1
    subdv = jnp.asarray(c["subdv"])                         # (23,2)
    sd = subdv[jnp.clip(scfb_anz, 0, 22)]                   # (N,S,2)
    tc0 = jnp.maximum(0, jnp.minimum(sd[..., 0], kmax - 1))
    a1 = bandj[tc0 + 1]
    # region 1 works on band[tc0+1:]: largest j2 with band[tc0+1+j2] <= bvr
    kmax2 = kmax - (tc0 + 1)
    tc1 = jnp.maximum(0, jnp.minimum(sd[..., 1], kmax2 - 1))
    a2 = bandj[jnp.clip(tc0 + 1 + tc1 + 1, 0, 22)]
    r0c = tc0
    r1c = tc1

    # ---- per-pair cost channels
    x = ix[..., 0::2]                                       # (N,S,288)
    y = ix[..., 1::2]
    xc = jnp.minimum(x, 15)
    yc = jnp.minimum(y, 15)
    signs = (x != 0).astype(jnp.int32) + (y != 0).astype(jnp.int32)
    nesc = (x > 14).astype(jnp.int32) + (y > 14).astype(jnp.int32)
    h13 = jnp.asarray(c["h13"])
    h15 = jnp.asarray(c["h15"])
    h16 = jnp.asarray(c["h16"])
    h24 = jnp.asarray(c["h24"])
    ch13 = h13[xc, yc] + signs
    ch15 = h15[xc, yc] + signs
    ch16 = h16[xc, yc] + signs
    ch24 = h24[xc, yc] + signs

    # region masks over pair start positions
    ppos = pos[0::2]                                        # (288,)
    starts = jnp.stack([jnp.zeros_like(a1), a1, a2], axis=-1)   # (N,S,3)
    ends = jnp.stack([a1, a2, bvr], axis=-1)
    pm = ((ppos[None, None, None, :] >= starts[..., None])
          & (ppos[None, None, None, :] < ends[..., None]))      # (N,S,3,288)

    def rsum(chan):  # (N,S,288) -> (N,S,3)
        return jnp.sum(jnp.where(pm, chan[..., None, :], 0), axis=-1)

    rc13 = rsum(ch13)
    rc15 = rsum(ch15)
    rc16 = rsum(ch16)
    rc24 = rsum(ch24)
    rnesc = rsum(nesc)

    # region sample maxima (ix >= 0)
    sm = ((pos[None, None, None, :] >= starts[..., None])
          & (pos[None, None, None, :] < ends[..., None]))       # (N,S,3,576)
    m = jnp.max(jnp.where(sm, ix[..., None, :], 0), axis=-1)    # (N,S,3)

    # ---- count1 quad costs, both alignments (region starts at 2bv mod 4)
    q0t = jnp.asarray(c["q0"])
    q1t = jnp.asarray(c["q1"])

    def quad_costs(vals):  # vals (N,S,Q,4) -> (cost0, cost1)
        sb = jnp.sum((vals != 0).astype(jnp.int32), axis=-1)
        p = jnp.clip(vals[..., 0] + (vals[..., 1] << 1)
                     + (vals[..., 2] << 2) + (vals[..., 3] << 3), 0, 15)
        return q0t[p] + sb, q1t[p] + sb

    quads_e = ix.reshape(n, S_STEPS, 144, 4)
    qe0, qe1 = quad_costs(quads_e)
    quads_o = ix[..., 2:574].reshape(n, S_STEPS, 143, 4)
    qo0, qo1 = quad_costs(quads_o)

    qidx_e = jnp.arange(144, dtype=jnp.int32)
    qidx_o = jnp.arange(143, dtype=jnp.int32)
    # quad j of the count1 region sits at samples 2bv + 4j
    first_e = bvr >> 2                                       # when bvr % 4 == 0
    first_o = (bvr - 2) >> 2                                 # when bvr % 4 == 2
    me = ((qidx_e[None, None, :] >= first_e[..., None])
          & (qidx_e[None, None, :] < first_e[..., None] + c1[..., None]))
    mo = ((qidx_o[None, None, :] >= first_o[..., None])
          & (qidx_o[None, None, :] < first_o[..., None] + c1[..., None]))
    sum0_e = jnp.sum(jnp.where(me, qe0, 0), axis=-1)
    sum1_e = jnp.sum(jnp.where(me, qe1, 0), axis=-1)
    sum0_o = jnp.sum(jnp.where(mo, qo0, 0), axis=-1)
    sum1_o = jnp.sum(jnp.where(mo, qo1, 0), axis=-1)
    even = (bvr & 3) == 0
    sum0 = jnp.where(even, sum0_e, sum0_o)
    sum1 = jnp.where(even, sum1_e, sum1_o)

    # ---- table choice per region (exact __new_choose_table replay)
    linmax = jnp.asarray(c["linmax"])
    linbits = jnp.asarray(c["linbits"])
    # no-linbits family: descending scan lands on 13, refined to 15 on <=
    nl_choice = jnp.where(rc15 <= rc13, 15, 13)
    nl_cost = jnp.where(rc15 <= rc13, rc15, rc13)
    # ESC families
    ixm = m - 15
    t16 = 15 + jnp.sum(linmax[None, None, None, 15:24] < ixm[..., None],
                       axis=-1)
    t24 = 24 + jnp.sum(linmax[None, None, None, 24:32] < ixm[..., None],
                       axis=-1)
    cost16 = jnp.where(t16 == 15, rc15, rc16 + linbits[jnp.clip(t16, 0, 31)]
                       * rnesc)
    cost24 = rc24 + linbits[jnp.clip(t24, 24, 31)] * rnesc
    esc_choice = jnp.where(cost24 < cost16, t24, t16)
    esc_cost = jnp.where(cost24 < cost16, cost24, cost16)

    choice = jnp.where(m == 0, 0,
                       jnp.where(m < 15, nl_choice, esc_choice))
    rcost = jnp.where(m == 0, 0, jnp.where(m < 15, nl_cost, esc_cost))

    # region-active gating (big_v_tab_select, MP3_Encoder.py:1156-1168)
    active = jnp.stack([a1 > 0, a2 > a1, bvr > a2], axis=-1)
    choice = jnp.where(active, choice, 0)
    rcost = jnp.where(active & (choice != 0), rcost, 0)

    bits_total = jnp.sum(rcost, axis=-1) + jnp.minimum(sum0, sum1)

    i16 = lambda a: a.astype(jnp.int16)  # noqa: E731  (halves the fetch)
    out = dict(
        bail=bail, approx=approx, ixmax=i16(ixmax), bv=i16(bv),
        a1=i16(a1), a2=i16(a2), bits_total=i16(bits_total),
    )
    # hide-mode replay channels (fetched only when embedding)
    out_hide = dict(
        sum0=i16(sum0), sum1=i16(sum1), choice=choice.astype(jnp.int8),
        rc13=i16(rc13), rc15=i16(rc15), rc16=i16(rc16), rc24=i16(rc24),
        rnesc=i16(rnesc),
    )
    return out, out_hide


# packed row layout: scalar (N,S) keys are one row; (N,S,3) keys are 3 rows
_BASE_KEYS = ("bail", "approx", "ixmax", "bv", "a1", "a2", "bits_total")
_HIDE_SCALAR = ("sum0", "sum1")
_HIDE_R3 = ("choice", "rc13", "rc15", "rc16", "rc24", "rnesc")


def _cost_pack(xr, sr_idx, with_hide):
    band = T.BAND_ALL[sr_idx].astype(np.int32)
    out, out_hide = _cost_all_steps(xr, band, _consts())
    if with_hide:
        out.update(out_hide)
    # pack everything into ONE int16 tensor: a single fetch (dozens of small
    # buffers cost more in per-transfer latency than in bytes)
    rows = [out[k].astype(jnp.int16) for k in _BASE_KEYS]
    if with_hide:
        rows += [out[k].astype(jnp.int16) for k in _HIDE_SCALAR]
        for k in _HIDE_R3:
            rows += [out[k][..., r].astype(jnp.int16) for r in range(3)]
    return jnp.stack(rows)


_cost_all_steps_jit = functools.partial(
    jax.jit, static_argnames=("sr_idx", "with_hide"))(_cost_pack)


@functools.partial(jax.jit, static_argnames=("sr_idx", "with_hide"))
def _cost_map_jit(xr_kc, sr_idx, with_hide):
    """(K, chunk, 576) -> (K, rows, chunk, S): the whole chunk loop as ONE
    compiled sequential lax.map — a single dispatch and a single fetch
    instead of K host round trips, while the
    per-chunk intermediates keep device memory at O(chunk)."""
    return jax.lax.map(lambda x: _cost_pack(x, sr_idx, with_hide), xr_kc)


def _unpack(packed: np.ndarray, with_hide: bool) -> dict:
    out = {}
    i = 0
    for k in _BASE_KEYS:
        out[k] = packed[i]
        i += 1
    out["bail"] = out["bail"].astype(bool)
    out["approx"] = out["approx"].astype(bool)
    if with_hide:
        for k in _HIDE_SCALAR:
            out[k] = packed[i]
            i += 1
        for k in _HIDE_R3:
            out[k] = np.stack([packed[i + r] for r in range(3)], axis=-1)
            i += 3
    return out


def cost_all_steps(xr: np.ndarray, sr_idx: int, with_hide: bool = False,
                   chunk: int = 256) -> dict:
    """(N, 576) int32 spectra -> dict of (N, 128) numpy costing arrays.
    ``with_hide`` additionally fetches the per-region cost channels needed to
    replay the steganographic table transform.

    The work runs as chunk-sized body iterations of a single jitted lax.map:
    one pieced h2d upload, one dispatch, one pieced d2h fetch instead of K
    separate chunk dispatches and K round trips. The chunk count is bucketed so file
    lengths share compiled programs; zero-padded lanes are trimmed off."""
    from mp3stego_tpu.utils.transfer import fetch_pieces, put_pieces

    n = xr.shape[0]
    k = -(-max(n, 1) // chunk)
    k += (-k) % 4                              # bucket the trip count
    if isinstance(xr, np.ndarray):
        staged = np.zeros((k * chunk, 576), np.int32)
        staged[:n] = xr
        dev = put_pieces(np.ascontiguousarray(
            staged.reshape(k, chunk, 576)))
    else:                                      # already device-resident
        dev = jnp.pad(xr, ((0, k * chunk - n), (0, 0))) \
            .reshape(k, chunk, 576)
    packed = fetch_pieces([_cost_map_jit(dev, sr_idx, with_hide)])[0]
    out = _unpack(np.concatenate(list(packed), axis=1), with_hide)
    return {key: v[:n] for key, v in out.items()}


# ------------------------------------------------------------- host-side recost

def table_cost(cache: dict, g: int, s: int, region: int, table: int) -> int:
    """Bits to code ``region`` of granule g at step s under ``table``, from the
    device cost channels (used by hide-mode replay to price transformed
    tables)."""
    if table == 0:
        return 0
    idx = (g, s, region)
    if table == 13:
        return int(cache["rc13"][idx])
    if table == 15:
        return int(cache["rc15"][idx])
    if 16 <= table <= 23:
        return int(cache["rc16"][idx]
                   + int(T.HUFF_LINBITS[table]) * cache["rnesc"][idx])
    if 24 <= table <= 31:
        return int(cache["rc24"][idx]
                   + int(T.HUFF_LINBITS[table]) * cache["rnesc"][idx])
    raise ValueError(f"unexpected table {table}")
