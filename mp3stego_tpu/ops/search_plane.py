"""Device-resident rate-control search: the encoder's full bisection + inner
loop for EVERY granule as one batched device program.

The reference searches sequentially per granule (~8 evaluations of quantize ->
run-length -> table-select -> bit-count each, MP3_Encoder.py:958-996,
1064-1095). ops/quant_batch costs all 128 steps and replays on host — exact,
but 128x the needed compute. Here the search itself runs on device: an 8-round
bisection (``fori_loop``) followed by a masked ``while_loop`` for the inner
loop, all granules advancing in lockstep on their own step sizes. Only ~8-12
evaluations ever happen per granule, each a dense (lanes, 576) vector pass.

Bit-exactness strategy (the reference mixes an integer LUT path with a float64
fallback, MP3_Encoder.py:403-409; the device plane runs in float32):

  * LUT region (ln < 10000): ``int2idx[ln]`` is reproduced EXACTLY without
    the 10k-entry gather — as a threshold RANK (#{k: th[k] <= ln}, a fused
    compare+reduce instead of a data-dependent gather). Verified exhaustively
    over the full domain by tests/test_search_plane.py.
  * float region (ln >= 10000): evaluated in float32 and LOGGED (step, bits).
    After the batch, the host re-evaluates every logged cell with the exact
    float64 formula (ops/quant_np) and compares the bits the trajectory
    consumed; any mismatch sends that granule to the exact host oracle.
  * stale-address semantics (subdivide leaves address1..3 untouched when
    big_values == 0, MP3_Encoder.py:1010-1012): the address triple is carried
    per lane through the search. A lane that CONSUMES its cross-granule
    initial addresses in a bits-affecting way (big_values==0 & count1>0 while
    still "virgin") is flagged for host redo, because the true initial value
    chains through the previous granule of the same (gr, ch) slot.

Flag bits returned per lane (``FLAG_*``): any set bit means the granule must
be redone by the sequential host oracle (models/encoder.py); on real audio
corpora the redo rate is well under 1%.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from mp3stego_tpu import tables as T
from mp3stego_tpu.ops.decode_plane import _onehot_rows
from mp3stego_tpu.utils.transfer import fetch_pieces as _fetch_pieces

_HIGHEST = jax.lax.Precision.HIGHEST

S_MAXLOG = 24          # logged approx evaluations per lane
# lanes per device dispatch; the env knob lets the CPU test mesh compile a
# smaller while_loop program (results are chunk-size independent)
CHUNK = int(os.environ.get("MP3STEGO_TPU_SEARCH_CHUNK", "512"))
CHUNK_BIG = 4 * CHUNK  # for long files: fewer dispatches
_BAIL = 165140         # 8192**(4/3): quantize's quick-reject threshold
MAX_STEP = 8192        # MAX_QUANTIZE_STEP

FLAG_ADDR = 1          # consumed virgin (cross-granule) stale addresses
FLAG_LOGOVF = 2        # approx-eval log overflow
FLAG_OOB = 4           # step outside the 128-entry steptab (reference IndexError)
FLAG_ITER = 8          # inner-loop iteration cap hit
FLAG_FINAL_APPROX = 16  # final (serialized) eval had float-path samples
FLAG_IXBAND = 32       # approx eval with ixmax near the 8192 gate


@functools.lru_cache(maxsize=None)
def _sconsts():
    steptab, steptabi, int2idx = T.loop_tables()
    # thresholds th[k] = first ln with int2idx[ln] == k (int2idx is monotone,
    # increments are <= 1 so every k in [0, int2idx[9999]] is hit)
    kmax = int(int2idx[9999])
    # th[k] = first ln with int2idx[ln] == k; int2idx[ln] == #{k >= 1: th[k] <= ln}
    th = np.searchsorted(int2idx, np.arange(1, kmax + 1),
                         side="left").astype(np.int32)         # (kmax,)
    # two-level threshold rank (see _quantize): th padded to whole blocks of
    # 32 with an out-of-range sentinel (lnc <= 9999 < 10000 never counts it);
    # at least one sentinel must exist so the coarse rank stays < n_blk
    n_blk = kmax // 32 + 1
    th_pad = np.full(n_blk * 32, 10000, np.int32)
    th_pad[:kmax] = th
    th_blocks = th_pad.reshape(n_blk, 32)
    th_coarse = th_blocks[:, 31].copy()                        # (n_blk,)
    hlen = T.HUFF_LEN.astype(np.int32)
    pair_pack = (hlen[13] | (hlen[15] << 8) | (hlen[16] << 16)
                 | (hlen[24] << 24)).reshape(-1)               # (256,)
    # unpacked twin of pair_pack for the matmul path: h_len of the four
    # representative tables per (x,y) pair value, one column each
    pair_tab = np.stack([hlen[13].reshape(-1), hlen[15].reshape(-1),
                         hlen[16].reshape(-1), hlen[24].reshape(-1)],
                        axis=1)                                # (256, 4)
    # two-stage factorization of the same table: x -> the 64 (y, table)
    # channels. h[x*16+y, t] = (onehot_x @ pair_tab_x)[y*4 + t]: the 256-way
    # one-hot build is compare-bound; two 16-way one-hots do ~2x fewer
    # compares for the same exact select
    pair_tab_x = pair_tab.reshape(16, 16 * 4)                  # (16, 64)
    quad_pack = (hlen[32, 0, :16] | (hlen[33, 0, :16] << 8))   # (16,)
    # hide mode: pair h_len channels for EVERY table a transform can emit.
    # Pre-transform choices are restricted to {13, 15} (the reference's
    # descending no-linbits scan always lands on 13, alternate 15) plus the
    # ESC rows 16..31; IDX_TO_TRANSFORM_HUF maps within that same set, so 18
    # channels cover all emitted tables. Packed 4-per-int32 like pair_pack.
    emit_tables = [13, 15] + list(range(16, 32))               # 18
    packs = []
    for p in range(0, 18, 4):
        grp = emit_tables[p:p + 4]
        w = np.zeros(256, np.int32)
        for s, t in enumerate(grp):
            w |= hlen[t].reshape(-1) << (8 * s)
        packs.append(w)
    # unpacked twin for the matmul path: (256, 18) h_len per emitted table
    hide_tab = np.stack([hlen[t].reshape(-1) for t in emit_tables], axis=1)
    # per-emitted-table linbits (0 for 13/15)
    emit_linbits = np.array([0, 0] + [int(T.HUFF_LINBITS[t])
                                      for t in range(16, 32)], np.int32)
    # table index -> channel slot (13->0, 15->1, 16+k->2+k; others unused)
    emit_slot = np.zeros(32, np.int32)
    emit_slot[13] = 0
    emit_slot[15] = 1
    for t in range(16, 32):
        emit_slot[t] = 2 + (t - 16)
    return dict(
        steptabi=steptabi.astype(np.int64),
        steptab_f32=steptab.astype(np.float32),
        th=th, th_blocks=th_blocks, th_coarse=th_coarse,
        pair_pack=pair_pack, pair_tab=pair_tab, pair_tab_x=pair_tab_x,
        quad_pack=quad_pack,
        hide_packs=np.stack(packs),                            # (5, 256)
        hide_tab=hide_tab,                                     # (256, 18)
        emit_linbits=emit_linbits, emit_slot=emit_slot,
        transform=T.TRANSFORM_HUF.astype(np.int32),            # (32, 2)
        linmax=T.HUFF_LINMAX.astype(np.int32),
        linbits=T.HUFF_LINBITS.astype(np.int32),
        subdv=T.SUBDV_TABLE.astype(np.int32),
    )


def _quantize(labs64, xrabs_f32, xrmax64, s, c):
    """Vector quantize at per-lane steps ``s``. Exact in the LUT region;
    float32 (flagged) in the reference's float64-fallback region."""
    with jax.named_scope("quant_scale"):
        sidx = jnp.clip(s + 127, 0, 127)
        oob = (s + 127) != sidx
        scalei = jnp.asarray(c["steptabi"])[sidx]              # (C,) i64
        mr = (xrmax64 * scalei + 2147483648) >> 32
        bail = mr > _BAIL
        ln = ((labs64 * scalei[:, None] + 2147483648) >> 32).astype(jnp.int32)
        approx = jnp.any(ln >= 10000, axis=1)
        lnc = jnp.minimum(ln, 9999)
    # exact int2idx[lnc] as a TWO-LEVEL threshold rank: a coarse rank over
    # one threshold per 32-block picks the block, an exact one-hot matmul
    # selects that block's 32 thresholds (values <= 10000, exact in f32),
    # and a fine rank counts within it. ~64 compares + one matmul per
    # element versus the old flat rank's ~1000 compares. Sentinel padding
    # keeps the
    # coarse rank < n_blk, so the one-hot row always exists.
    with jax.named_scope("quant_rank"):
        coarse = jnp.asarray(c["th_coarse"])
        b = jnp.sum((lnc[..., None] >= coarse[None, None, :])
                    .astype(jnp.int32), axis=-1)               # block index
        th_sel = _onehot_rows(b, jnp.asarray(c["th_blocks"], jnp.float32),
                              jnp.float32)                     # (C,576,32)
        ixl = 32 * b + jnp.sum(
            (lnc[..., None].astype(jnp.float32) >= th_sel).astype(jnp.int32),
            axis=-1)
    with jax.named_scope("quant_float"):
        d = (xrabs_f32 * jnp.asarray(c["steptab_f32"])[sidx][:, None]
             * jnp.float32(4.656612875e-10))
        ixa = jnp.floor(jnp.exp2(0.75 * jnp.log2(
            jnp.maximum(d, jnp.float32(1e-30))))).astype(jnp.int32)
        ix = jnp.where(ln < 10000, ixl, ixa)
        ixmax = jnp.max(ix, axis=1)
        ixmax_eff = jnp.where(bail, 16384, ixmax)
    return ix, ixmax_eff, approx, oob


def _cost(ix, addr_in, band, c, hide=None):
    """The shared search-evaluation body: run lengths -> count1 -> subdivide
    (stale addresses kept when big_values==0) -> table select -> bit count.
    Mirrors ops/quant.py / MP3_Encoder.py:266-291,171-211,998-1036,1147-1264.

    ``hide`` = (bits_u8 (L,), cursor (C,), hide_len scalar) enables the stego
    pair transform (MP3_Encoder.py:1257-1263) INSIDE the device search: each
    region's optimal table is mapped through IDX_TO_TRANSFORM_HUF by the
    message bit at its cursor position, and the region's counted cost becomes
    the cost under the EMITTED table (that is what feeds part2_3_length in
    the reference). The cursor is the granule's pinned embedded-bit offset —
    constant for all evaluations of one granule's search, exactly like the
    sequential engine's ``hide_off`` (native/src/rate_search.cpp)."""
    n = ix.shape[0]
    pos = jnp.arange(576, dtype=jnp.int32)
    with jax.named_scope("cost_runlen"):
        nz = ix != 0
        any_nz = jnp.any(nz, axis=1)
        last = jnp.max(jnp.where(nz, pos, -1), axis=1)
        i0 = jnp.where(any_nz, ((last + 2) >> 1) << 1, 0)
        lim = jnp.max(jnp.where(ix > 1, pos + 1, 0), axis=1)
        k = jnp.maximum(0, jnp.minimum((i0 - lim) // 4, i0 // 4))
        c1 = k
        bvr = i0 - 4 * k
        bv = bvr >> 1
        has_bv = bv > 0

    # count1 quad costs in both alignments (the region starts at 2bv mod 4).
    # The 16-way where-sum select stays: a two-stage one-hot here measured
    # 2.4x SLOWER on-chip (the domain is already tiny; the split's div/mod
    # and extra matmul cost more than 16 compares).
    quad_pack = jnp.asarray(c["quad_pack"])

    qvals = jnp.arange(16, dtype=jnp.int32)

    def quad_costs(vals):
        sb = jnp.sum((vals != 0).astype(jnp.int32), axis=-1)
        p = jnp.clip(vals[..., 0] + (vals[..., 1] << 1)
                     + (vals[..., 2] << 2) + (vals[..., 3] << 3), 0, 15)
        q = jnp.sum(jnp.where(p[..., None] == qvals[None, None, :],
                              quad_pack[None, None, :], 0), axis=-1)
        return (q & 255) + sb, (q >> 8) + sb

    with jax.named_scope("cost_count1"):
        qe0, qe1 = quad_costs(ix.reshape(n, 144, 4))
        qo0, qo1 = quad_costs(ix[:, 2:574].reshape(n, 143, 4))
        qidx_e = jnp.arange(144, dtype=jnp.int32)
        qidx_o = jnp.arange(143, dtype=jnp.int32)
        first_e = bvr >> 2
        first_o = (bvr - 2) >> 2
        me = ((qidx_e[None, :] >= first_e[:, None])
              & (qidx_e[None, :] < first_e[:, None] + c1[:, None]))
        mo = ((qidx_o[None, :] >= first_o[:, None])
              & (qidx_o[None, :] < first_o[:, None] + c1[:, None]))
        even = (bvr & 3) == 0
        sum0 = jnp.where(even, jnp.sum(jnp.where(me, qe0, 0), axis=1),
                         jnp.sum(jnp.where(mo, qo0, 0), axis=1))
        sum1 = jnp.where(even, jnp.sum(jnp.where(me, qe1, 0), axis=1),
                         jnp.sum(jnp.where(mo, qo1, 0), axis=1))
        cts = jnp.where(sum0 < sum1, 0, 1).astype(jnp.int32)

    with jax.named_scope("cost_subdivide"):
        # subdivide; addresses stay stale when big_values == 0
        bandj = jnp.asarray(band)                              # (23,)
        scfb_anz = jnp.sum(bandj[None, :] < bvr[:, None], axis=1,
                           dtype=jnp.int32)
        kmax = jnp.sum(bandj[None, :] <= bvr[:, None], axis=1,
                       dtype=jnp.int32) - 1
        sd = jnp.asarray(c["subdv"])[jnp.clip(scfb_anz, 0, 22)]
        tc0 = jnp.maximum(0, jnp.minimum(sd[:, 0], kmax - 1))
        a1n = bandj[tc0 + 1]
        kmax2 = kmax - (tc0 + 1)
        tc1 = jnp.maximum(0, jnp.minimum(sd[:, 1], kmax2 - 1))
        a2n = bandj[jnp.clip(tc0 + 1 + tc1 + 1, 0, 22)]
        a1 = jnp.where(has_bv, a1n, addr_in[:, 0])
        a2 = jnp.where(has_bv, a2n, addr_in[:, 1])
        a3 = jnp.where(has_bv, bvr, addr_in[:, 2])
        r0c = jnp.where(has_bv, tc0, 0)
        r1c = jnp.where(has_bv, tc1, 0)

    with jax.named_scope("cost_pair"):
        # per-pair cost channels under the 4 representative tables
        x = ix[:, 0::2]
        y = ix[:, 1::2]
        xc = jnp.minimum(x, 15)
        yc = jnp.minimum(y, 15)
        signs = (x != 0).astype(jnp.int32) + (y != 0).astype(jnp.int32)
        nesc = (x > 14).astype(jnp.int32) + (y > 14).astype(jnp.int32)
        pidx = xc * 16 + yc
        # h_len of the 4 representative tables per pair, as an exact
        # TWO-STAGE one-hot select: onehot(x) picks the (16, y*4+t) row by
        # matmul, onehot(y) folds the y axis elementwise. Building two
        # 16-way one-hots costs ~2x fewer compares than the flat
        # 256-way one-hot (which itself replaced a packed compare+reduce
        # sweeping 256 int words per pair); exact because every product has
        # a 0/1 factor and each sum has one nonzero term
        ohx = (xc[..., None] == jnp.arange(16, dtype=jnp.int32)
               ).astype(jnp.float32)                           # (C,288,16)
        tmp = jnp.einsum("cpx,xz->cpz", ohx,
                         jnp.asarray(c["pair_tab_x"], jnp.float32),
                         preferred_element_type=jnp.float32,
                         precision=_HIGHEST).reshape(n, 288, 16, 4)
        ohy = (yc[..., None] == jnp.arange(16, dtype=jnp.int32)
               ).astype(jnp.float32)
        pk4 = jnp.sum(tmp * ohy[..., None], axis=2
                      ).astype(jnp.int32)                      # (C,288,4)
        ch13 = pk4[..., 0] + signs
        ch15 = pk4[..., 1] + signs
        ch16 = pk4[..., 2] + signs
        ch24 = pk4[..., 3] + signs

        ppos = pos[0::2]
        starts = jnp.stack([jnp.zeros_like(a1), a1, a2], axis=-1)  # (C,3)
        ends = jnp.stack([a1, a2, bvr], axis=-1)
        pm = ((ppos[None, None, :] >= starts[..., None])
              & (ppos[None, None, :] < ends[..., None]))       # (C,3,288)

    def rsum(chan):
        return jnp.sum(jnp.where(pm, chan[:, None, :], 0), axis=-1)

    with jax.named_scope("cost_regions"):
        rc13 = rsum(ch13)
        rc15 = rsum(ch15)
        rc16 = rsum(ch16)
        rc24 = rsum(ch24)
        rnesc = rsum(nesc)

        sm = ((pos[None, None, :] >= starts[..., None])
              & (pos[None, None, :] < ends[..., None]))        # (C,3,576)
        m = jnp.max(jnp.where(sm, ix[:, None, :], 0), axis=-1)  # (C,3)

    with jax.named_scope("cost_select"):
        linmax = jnp.asarray(c["linmax"])
        linbits = jnp.asarray(c["linbits"])
        nl_choice = jnp.where(rc15 <= rc13, 15, 13)
        nl_cost = jnp.where(rc15 <= rc13, rc15, rc13)
        ixm = m - 15
        t16 = 15 + jnp.sum(linmax[None, None, 15:24] < ixm[..., None],
                           axis=-1, dtype=jnp.int32)
        t24 = 24 + jnp.sum(linmax[None, None, 24:32] < ixm[..., None],
                           axis=-1, dtype=jnp.int32)
        cost16 = jnp.where(t16 == 15, rc15,
                           rc16 + linbits[jnp.clip(t16, 0, 31)] * rnesc)
        cost24 = rc24 + linbits[jnp.clip(t24, 24, 31)] * rnesc
        esc_choice = jnp.where(cost24 < cost16, t24, t16)
        esc_cost = jnp.where(cost24 < cost16, cost24, cost16)

        choice = jnp.where(m == 0, 0,
                           jnp.where(m < 15, nl_choice, esc_choice))
        rcost = jnp.where(m == 0, 0, jnp.where(m < 15, nl_cost, esc_cost))
        active = jnp.stack([a1 > 0, a2 > a1, bvr > a2], axis=-1)
        choice = jnp.where(active, choice, 0)

    if hide is not None:
        with jax.named_scope("cost_hide"):
            hide_bits, hide_cur, hide_len = hide
            # cursor index per region: advances over nonzero choices within
            # the granule (transform preserves nonzero-ness, so pre-transform
            # counts)
            nz = choice > 0
            inc0 = nz[:, 0].astype(jnp.int32)
            inc1 = inc0 + nz[:, 1].astype(jnp.int32)
            idx = jnp.stack([hide_cur, hide_cur + inc0, hide_cur + inc1],
                            axis=-1)                           # (C,3)
            inb = idx < hide_len
            bit = jnp.take(hide_bits,
                           jnp.clip(idx, 0, hide_bits.shape[0] - 1)
                           ).astype(jnp.int32)
            tr = jnp.asarray(c["transform"])
            t_new = tr[jnp.clip(choice, 0, 31), jnp.clip(bit, 0, 1)]
            choice = jnp.where(nz & inb, t_new, choice)
            # re-cost every region under its EMITTED table: the 18
            # emitted-table h_len channels per pair come from one exact
            # one-hot matmul (C,288,256)@(256,18); the per-pair channel
            # select is a small compare+reduce (no take_along_axis)
            emit_slot = jnp.asarray(c["emit_slot"])
            t_pp = jnp.sum(jnp.where(pm, choice[..., None], 0),
                           axis=1)                             # (C,288)
            oht = (t_pp[..., None] == jnp.arange(32, dtype=jnp.int32))
            slot_pp = jnp.sum(oht * emit_slot[None, None, :], axis=-1)
            hl18 = _onehot_rows(pidx, jnp.asarray(c["hide_tab"], jnp.float32),
                                jnp.float32).astype(jnp.int32)  # (C,288,18)
            ohs = (slot_pp[..., None] == jnp.arange(18, dtype=jnp.int32))
            h_pp = jnp.sum(jnp.where(ohs, hl18, 0), axis=-1)
            rc_t = rsum(h_pp + signs)                          # (C,3)
            slot_r = emit_slot[jnp.clip(choice, 0, 31)]
            cost_t = rc_t + jnp.asarray(c["emit_linbits"])[slot_r] * rnesc
            rcost = cost_t

    rcost = jnp.where(active & (choice != 0), rcost, 0)

    bits = jnp.sum(rcost, axis=-1) + jnp.minimum(sum0, sum1)

    # float-fallback risk: approx samples carry +-1-ish float32 error, which
    # can only change the consumed bits through the ESC table choice — i.e.
    # when an active region's max sits near a linmax threshold (the pair
    # costs themselves are invariant: approx values clip to (15,15) and stay
    # > 14 for the linbits count). Evals without risk need no host check.
    near = jnp.any(jnp.abs((m - 15)[..., None]
                           - linmax[None, None, 15:32]) <= 4, axis=-1)
    risk = jnp.any((m >= 15) & near & active, axis=-1)
    return dict(bits=bits, bv=bv, c1=c1, a1=a1, a2=a2, a3=a3,
                r0c=r0c, r1c=r1c, choice=choice, cts=cts, has_bv=has_bv,
                risk=risk)


_FIN_ROWS = ("step", "bits", "bv", "c1", "a1", "a2", "a3", "r0c", "r1c",
             "ch0", "ch1", "ch2", "cts", "flags", "nlog", "xrmax0", "iters")


def _search_body(xr, max_bits, sr_idx, hide_bits=None, hide_cur=None,
                 hide_len=None):
    """(C,576) i32 spectra + (C,) i32 bit budgets -> packed search results.
    Pure traced body — jitted directly for single-file chunks and vmapped
    over a file axis for the sharded batch mode (parallel/batch_encode).
    ``hide_bits``/``hide_cur``/``hide_len`` enable the stego transform with a
    pinned per-lane cursor (see _cost); the parallel-hide orchestration in
    models/encoder.py pins cursors by prefix-summing region counts."""
    c = _sconsts()
    hide = None if hide_bits is None else (hide_bits, hide_cur, hide_len)
    band = T.BAND_ALL[sr_idx].astype(np.int32)
    n = xr.shape[0]
    labs64 = jnp.abs(xr.astype(jnp.int64))
    xrabs32 = jnp.abs(xr)
    xrabs_f32 = xrabs32.astype(jnp.float32)
    xrmax = jnp.max(jnp.maximum(xrabs32, 0), axis=1)
    xrmax64 = xrmax.astype(jnp.int64)
    need = xrmax > 0
    i32z = jnp.zeros(n, jnp.int32)

    def log_push(st, do_log, s, bits):
        lane_slot = (jnp.arange(S_MAXLOG, dtype=jnp.int32)[None, :]
                     == st["nlog"][:, None]) & do_log[:, None]
        st["log_steps"] = jnp.where(lane_slot, s[:, None], st["log_steps"])
        st["log_bits"] = jnp.where(lane_slot, bits[:, None], st["log_bits"])
        st["flags"] |= jnp.where(do_log & (st["nlog"] >= S_MAXLOG),
                                 jnp.int32(FLAG_LOGOVF), jnp.int32(0))
        st["nlog"] = st["nlog"] + do_log.astype(jnp.int32)
        return st

    def evaluate(st, s, live):
        """One search evaluation at per-lane steps ``s`` for ``live`` lanes.
        Returns (bits_for_comparison, cost-dict, gate) and updates carried
        address/virgin/flag/log state exactly like the reference's _eval."""
        ix, ixmax_eff, approx, oob = _quantize(labs64, xrabs_f32, xrmax64, s, c)
        st["flags"] |= jnp.where(live & oob, jnp.int32(FLAG_OOB), jnp.int32(0))
        st["flags"] |= jnp.where(
            live & approx & (jnp.abs(ixmax_eff - MAX_STEP) <= 8),
            jnp.int32(FLAG_IXBAND), jnp.int32(0))
        co = _cost(ix, st["addr"], band, c, hide)
        gate = live & (ixmax_eff <= MAX_STEP)
        bits = jnp.where(ixmax_eff > MAX_STEP, jnp.int32(100000),
                         co["bits"].astype(jnp.int32))
        new_addr = jnp.stack([co["a1"], co["a2"], co["a3"]], axis=-1)
        st["flags"] |= jnp.where(
            gate & (~co["has_bv"]) & (co["c1"] > 0) & st["virgin"],
            jnp.int32(FLAG_ADDR), jnp.int32(0))
        st["addr"] = jnp.where(gate[:, None], new_addr, st["addr"])
        st["virgin"] = st["virgin"] & ~(gate & co["has_bv"])
        st = log_push(st, gate & approx & co["risk"], s, bits)
        return st, bits, co, ix, approx, gate

    state = dict(
        nxt=jnp.full(n, -120, jnp.int32), count=jnp.full(n, 120, jnp.int32),
        running=need, addr=jnp.zeros((n, 3), jnp.int32),
        virgin=jnp.ones(n, bool), flags=i32z, nlog=i32z,
        log_steps=jnp.zeros((n, S_MAXLOG), jnp.int32),
        log_bits=jnp.zeros((n, S_MAXLOG), jnp.int32),
    )

    # ---- bisection: 8 masked rounds (count: 120->60->30->15->8->4->2->1)
    def bis_body(_, st):
        live = st["running"]
        half = st["count"] // 2
        s = st["nxt"] + half
        st, bits, _, _, _, _ = evaluate(st, s, live)
        cond = bits < max_bits
        st["count"] = jnp.where(live, jnp.where(cond, half, st["count"] - half),
                                st["count"])
        st["nxt"] = jnp.where(live & ~cond, st["nxt"] + half, st["nxt"])
        st["running"] = live & (st["count"] > 1)
        return st

    # 8 static rounds. Measured on-chip: Python-unrolling these is perf-
    # neutral (XLA re-rolls the repeated body), so the rolled form is kept
    # for its smaller HLO and faster compiles.
    state = jax.lax.fori_loop(0, 8, bis_body, state)
    step0 = state["nxt"]
    huff_bits = max_bits  # part2_length is identically 0 (slen[0] == 0)

    inner = dict(
        step=step0, done=~need, it=jnp.int32(0),
        f_step=i32z, f_bits=i32z, f_bv=i32z, f_c1=i32z,
        f_a1=i32z, f_a2=i32z, f_a3=i32z, f_r0c=i32z, f_r1c=i32z,
        f_ch=jnp.zeros((n, 3), jnp.int32), f_cts=i32z,
        f_ix=jnp.zeros((n, 576), jnp.int16),
        addr=state["addr"], virgin=state["virgin"], flags=state["flags"],
        nlog=state["nlog"], log_steps=state["log_steps"],
        log_bits=state["log_bits"],
    )

    def inner_cond(st):
        return jnp.any(~st["done"]) & (st["it"] < 160)

    def inner_body(st):
        pend = ~st["done"]
        s1 = st["step"] + 1
        sub = dict(addr=st["addr"], virgin=st["virgin"], flags=st["flags"],
                   nlog=st["nlog"], log_steps=st["log_steps"],
                   log_bits=st["log_bits"])
        ix, ixmax_eff, approx, oob = _quantize(labs64, xrabs_f32, xrmax64,
                                               s1, c)
        sub["flags"] |= jnp.where(pend & oob, jnp.int32(FLAG_OOB),
                                  jnp.int32(0))
        sub["flags"] |= jnp.where(
            pend & approx & (jnp.abs(ixmax_eff - MAX_STEP) <= 8),
            jnp.int32(FLAG_IXBAND), jnp.int32(0))
        skip = ixmax_eff > MAX_STEP
        ev = pend & ~skip
        co = _cost(ix, sub["addr"], band, c, hide)
        bits = co["bits"].astype(jnp.int32)
        new_addr = jnp.stack([co["a1"], co["a2"], co["a3"]], axis=-1)
        sub["flags"] |= jnp.where(
            ev & (~co["has_bv"]) & (co["c1"] > 0) & sub["virgin"],
            jnp.int32(FLAG_ADDR), jnp.int32(0))
        sub["addr"] = jnp.where(ev[:, None], new_addr, sub["addr"])
        sub["virgin"] = sub["virgin"] & ~(ev & co["has_bv"])
        sub = log_push(sub, ev & approx & co["risk"], s1, bits)

        fin = ev & (bits <= huff_bits)
        sub["flags"] |= jnp.where(fin & approx, jnp.int32(FLAG_FINAL_APPROX),
                                  jnp.int32(0))
        ix_signed = jnp.where(xr < 0, -ix, ix).astype(jnp.int16)
        out = dict(st)
        out.update(sub)
        out["step"] = jnp.where(pend, s1, st["step"])
        out["done"] = st["done"] | fin
        out["it"] = st["it"] + 1
        out["f_step"] = jnp.where(fin, s1, st["f_step"])
        out["f_bits"] = jnp.where(fin, bits, st["f_bits"])
        out["f_bv"] = jnp.where(fin, co["bv"], st["f_bv"])
        out["f_c1"] = jnp.where(fin, co["c1"], st["f_c1"])
        out["f_a1"] = jnp.where(fin, co["a1"], st["f_a1"])
        out["f_a2"] = jnp.where(fin, co["a2"], st["f_a2"])
        out["f_a3"] = jnp.where(fin, co["a3"], st["f_a3"])
        out["f_r0c"] = jnp.where(fin, co["r0c"], st["f_r0c"])
        out["f_r1c"] = jnp.where(fin, co["r1c"], st["f_r1c"])
        out["f_ch"] = jnp.where(fin[:, None], co["choice"], st["f_ch"])
        out["f_cts"] = jnp.where(fin, co["cts"], st["f_cts"])
        out["f_ix"] = jnp.where(fin[:, None], ix_signed, st["f_ix"])
        return out

    st = jax.lax.while_loop(inner_cond, inner_body, inner)
    flags = st["flags"] | jnp.where(~st["done"], jnp.int32(FLAG_ITER),
                                    jnp.int32(0))

    # int16 wire format: every row fits comfortably (step <= ~200, bits <=
    # ~11k even for a worst-case all-escape spectrum, addresses <= 576,
    # nlog/iters <= 168) — fetch layers widen to int32 right after the
    # transfer so consumers never do int16 arithmetic
    fin = jnp.stack([
        st["f_step"], st["f_bits"], st["f_bv"], st["f_c1"],
        st["f_a1"], st["f_a2"], st["f_a3"], st["f_r0c"], st["f_r1c"],
        st["f_ch"][:, 0], st["f_ch"][:, 1], st["f_ch"][:, 2], st["f_cts"],
        flags, st["nlog"], (~need).astype(jnp.int32),
        jnp.broadcast_to(st["it"], st["f_step"].shape),
    ]).astype(jnp.int16)                                       # (ROWS, C)
    return fin, st["f_ix"], st["log_steps"], st["log_bits"]


_search_chunk_jit = jax.jit(_search_body, static_argnames=("sr_idx",))


def _search_body_packed(xs, mb, sr_idx, hide_bits=None, hide_cur=None,
                        hide_len=None):
    """_search_body with the ix plane packed for the fetch: almost all
    quantized values are tiny, so ship int8 + a per-lane wide flag and let
    the host re-gather the rare wide lanes (linbits-scale values) at full
    width from the resident int16 plane. Halves the dominant d2h transfer."""
    fin, ix, lsteps, lbits = _search_body(xs, mb, sr_idx, hide_bits,
                                          hide_cur, hide_len)
    ix8 = jnp.clip(ix, -128, 127).astype(jnp.int8)
    wide = jnp.any(jnp.abs(ix.astype(jnp.int32)) > 127, axis=1)
    return fin, ix8, wide, ix, lsteps, lbits


_search_chunk_packed = jax.jit(_search_body_packed,
                               static_argnames=("sr_idx",))


@functools.partial(jax.jit, static_argnames=("sr_idx", "want_scfsi"))
def _search_batch_jit(xr, max_bits, sr_idx, want_scfsi=False):
    """Vmapped search over a leading file axis: (F, N, 576) + (F, N) ->
    stacked packed results. With the file axis laid out on a mesh's ``files``
    axis (NamedSharding), XLA partitions this with zero collectives.
    ``want_scfsi`` folds the scfsi energy sums into the same program
    (vmapped over files — stays collective-free on the mesh)."""
    out = jax.vmap(lambda a, b: _search_body_packed(a, b, sr_idx))(xr,
                                                                   max_bits)
    if want_scfsi:
        tot, en = jax.vmap(lambda a: _scfsi_sums(a, sr_idx))(xr)
        return out + (tot, en)
    return out


@functools.partial(jax.jit, static_argnames=("sr_idx",))
def _search_batch_hide_jit(xr, max_bits, hide_bits, hide_cur, hide_len,
                           sr_idx):
    """_search_batch_jit with per-file stego state: (F, L) message bits,
    (F, N) pinned cursors, (F,) bit lengths. Shards over ``files`` exactly
    like the plain batch search."""
    return jax.vmap(
        lambda a, b, hb, hc, hl: _search_body_packed(a, b, sr_idx, hb, hc, hl)
    )(xr, max_bits, hide_bits, hide_cur, hide_len)


_gather_rows2 = jax.jit(lambda a, f, l: a[f, l])


def _fetch_logs(nlog_h: np.ndarray, ls_dev, lb_dev):
    """Lazy log fetch: the (N, S_MAXLOG) approx-evaluation logs are consumed
    only for lanes with nlog > 0 (models/encoder._plane_redo), which are
    rare — gather just those rows instead of draining both planes."""
    shape = ls_dev.shape
    ls = np.zeros(shape, np.int32)
    lb = np.zeros(shape, np.int32)
    if len(shape) == 2:
        lanes = np.flatnonzero(nlog_h > 0)
        if len(lanes):
            li = jnp.asarray(lanes, jnp.int32)
            ls[lanes] = np.asarray(_gather_rows(ls_dev, li))
            lb[lanes] = np.asarray(_gather_rows(lb_dev, li))
    else:
        wf, wl = np.nonzero(nlog_h > 0)
        if len(wf):
            fi = jnp.asarray(wf, jnp.int32)
            li = jnp.asarray(wl, jnp.int32)
            ls[wf, wl] = np.asarray(_gather_rows2(ls_dev, fi, li))
            lb[wf, wl] = np.asarray(_gather_rows2(lb_dev, fi, li))
    return ls, lb


def search_batch(xr_dev, max_bits: np.ndarray, sr_idx: int,
                 hide_bits: np.ndarray = None, hide_cur: np.ndarray = None,
                 hide_len: np.ndarray = None,
                 want_scfsi: bool = False) -> dict:
    """Sharded multi-file search: resident (F, N, 576) spectra (file axis
    optionally sharded over a mesh) -> dict of stacked (F, ...) numpy arrays
    with the same keys as :func:`search_all`. The ix plane crosses the link
    as int8 + re-gathered wide lanes (see _search_body_packed). The optional
    per-file stego state ((F, L) bits / (F, N) pinned cursors / (F,) bit
    lengths) runs the hide transform inside the sharded search.
    ``want_scfsi`` folds the scfsi energy sums into the same device program
    and fetch round; they come back under ``out["scfsi"]`` as a
    ((F, N) total, (F, N, 21) per-band) pair."""
    tot = en = None
    if hide_bits is not None:
        fin, ix8, wide, ix_dev, lsteps, lbits = _search_batch_hide_jit(
            xr_dev, jnp.asarray(np.asarray(max_bits, np.int32)),
            jnp.asarray(np.asarray(hide_bits, np.uint8)),
            jnp.asarray(np.asarray(hide_cur, np.int32)),
            jnp.asarray(np.asarray(hide_len, np.int32)), sr_idx)
    elif want_scfsi:
        fin, ix8, wide, ix_dev, lsteps, lbits, tot, en = _search_batch_jit(
            xr_dev, jnp.asarray(np.asarray(max_bits, np.int32)), sr_idx,
            want_scfsi=True)
    else:
        fin, ix8, wide, ix_dev, lsteps, lbits = _search_batch_jit(
            xr_dev, jnp.asarray(np.asarray(max_bits, np.int32)), sr_idx)
    pieces = [fin, ix8, wide]
    if tot is not None:
        pieces += [tot, en]
    got = _fetch_pieces(pieces)
    fin_h = got[0].astype(np.int32)        # int16 wire -> int32 for consumers
    ix8_h, wide_h = got[1], got[2]
    out = {k: fin_h[:, r] for r, k in enumerate(_FIN_ROWS)}
    if tot is not None:
        out["scfsi"] = (got[3], got[4])
    out["ix"] = ix8_h                      # int8; wide lanes in out["ixw"]
    ixw = {}
    wf, wl = np.nonzero(wide_h)
    if len(wf):
        rows = np.asarray(_gather_rows2(ix_dev, jnp.asarray(wf, jnp.int32),
                                        jnp.asarray(wl, jnp.int32)))
        for k in range(len(wf)):
            ixw[(int(wf[k]), int(wl[k]))] = rows[k]
    out["ixw"] = ixw
    out["log_steps"], out["log_bits"] = _fetch_logs(out["nlog"], lsteps,
                                                    lbits)
    return out


@functools.partial(jax.jit, static_argnames=("sr_idx",))
def _scfsi_sums(xr, sr_idx):
    """Per-granule scfsi energy sums (MP3_Encoder.py:817-850): int32-wrapping
    sums of mulsr(xr,xr)>>10 over each long scalefactor band + the total.
    int32 wraparound is modular, so band sums via cumulative-sum differences
    equal the reference's in-order wrapped partial sums exactly."""
    band = T.BAND_ALL[sr_idx].astype(np.int32)
    xr64 = xr.astype(jnp.int64)
    terms = (((xr64 * xr64) + 1073741824) >> 31).astype(jnp.int32) >> 10
    total = jnp.sum(terms, axis=1, dtype=jnp.int32)
    csum = jnp.cumsum(terms, axis=1, dtype=jnp.int32)
    csz = jnp.concatenate(
        [jnp.zeros((xr.shape[0], 1), jnp.int32), csum], axis=1)
    lo = jnp.asarray(band[:21].astype(np.int32))
    hi = jnp.asarray(band[1:22].astype(np.int32))
    en = csz[:, hi] - csz[:, lo]
    return total, en


def scfsi_sums(xr_dev, sr_idx: int):
    """Resident (N,576) spectra -> ((N,) total, (N,21) per-band) int32 sums."""
    total, en = _scfsi_sums(xr_dev, sr_idx)
    tot, en_h = _fetch_pieces([total, en])
    return tot, en_h


_gather_rows = jax.jit(lambda a, i: a[i])
_gather_rows3 = jax.jit(lambda a, b, c, i: (a[i], b[i], c[i]))


def fetch_rows(xr_dev, idx: np.ndarray) -> np.ndarray:
    """Gather (M,576) spectra rows on device, fetch to host."""
    if len(idx) == 0:
        return np.zeros((0, 576), np.int32)
    rows = _gather_rows(xr_dev, jnp.asarray(idx, jnp.int32))
    return np.asarray(rows)


def fetch_rows_logs(xr_dev, ls_dev, lb_dev, idx: np.ndarray):
    """One-device-round-trip gather of spectra rows AND the approx-eval logs
    for the ``idx`` lanes (the verify/redo set). On a high-latency link each
    extra device call costs its full dispatch+sync latency, so the three
    gathers ship as one program and one fetch."""
    if len(idx) == 0:
        z = np.zeros((0, S_MAXLOG), np.int32)
        return np.zeros((0, 576), np.int32), z, z
    rows, ls, lb = _gather_rows3(xr_dev, ls_dev, lb_dev,
                                 jnp.asarray(idx, jnp.int32))
    got = _fetch_pieces([rows, ls, lb])
    return got[0], got[1].astype(np.int32), got[2].astype(np.int32)




def search_all(xr_dev, max_bits: np.ndarray, sr_idx: int,
               hide_bits: np.ndarray = None,
               hide_cur: np.ndarray = None) -> dict:
    """Run the device search for all lanes.

    :param xr_dev: resident (N, 576) int32 spectra (device array).
    :param max_bits: (N,) int32 per-lane bit budgets.
    :param sr_idx: samplerate index (selects scalefactor band row).
    :param hide_bits: optional (L,) uint8 0/1 message bits — enables the
        stego pair transform inside the search (see _cost).
    :param hide_cur: (N,) int32 pinned embedded-bit cursor per lane
        (required with hide_bits; models/encoder pins it by prefix sum).
    :return: dict of (N,) numpy arrays (keys _FIN_ROWS) plus ``ix`` (N,576)
        int16 signed quantized samples and ``log_steps``/``log_bits``
        (N, S_MAXLOG) for approx-cell verification.
    """
    n = xr_dev.shape[0]
    chunk = CHUNK if n <= 4 * CHUNK else CHUNK_BIG
    pad = (-n) % chunk
    mb = np.asarray(max_bits, np.int32)
    if pad:
        mb = np.concatenate([mb, np.zeros(pad, np.int32)])
    hb = hl = None
    if hide_bits is not None:
        # pad the bits to a whole 4096 bucket so message length doesn't
        # recompile (L=0 pads to 4096, not a stray 4095-element bucket)
        L = len(hide_bits)
        lpad = max(4096, -(-L // 4096) * 4096) - L
        hb = jnp.asarray(np.concatenate(
            [np.asarray(hide_bits, np.uint8), np.zeros(lpad, np.uint8)]))
        hl = jnp.int32(L)
        hc = np.asarray(hide_cur, np.int32)
        if pad:
            # padded lanes: cursor past the end -> transform disabled
            hc = np.concatenate([hc, np.full(pad, 1 << 30, np.int32)])
    pending = []
    for i in range(0, n + pad, chunk):
        xs = jax.lax.dynamic_slice_in_dim(xr_dev, i, chunk, axis=0) \
            if i + chunk <= n else \
            jnp.pad(xr_dev[i:], ((0, i + chunk - n), (0, 0)))
        if hide_bits is not None:
            pending.append(_search_chunk_packed(
                xs, jnp.asarray(mb[i:i + chunk]), sr_idx, hb,
                jnp.asarray(hc[i:i + chunk]), hl))
        else:
            pending.append(_search_chunk_packed(
                xs, jnp.asarray(mb[i:i + chunk]), sr_idx))
    # fetch only fin/ix8/wide: the full-width ix plane stays device-resident
    # (rare wide lanes come back at int16 width) and the approx logs are
    # gathered lazily per chunk (rare nlog>0 lanes only)
    flat = [b for tup in pending for b in (tup[0], tup[1], tup[2])]
    got = _fetch_pieces(flat)
    fins = [got[i].astype(np.int32) for i in range(0, len(got), 3)]
    ix8s = [got[i] for i in range(1, len(got), 3)]
    wides = [got[i] for i in range(2, len(got), 3)]
    fin = np.concatenate(fins, axis=1)[:, :n]
    out = {k: fin[r] for r, k in enumerate(_FIN_ROWS)}
    # ix stays int8 (the wire format): widening the full plane on the page-
    # fault-bound host costs more than the whole fetch. Wide (linbits-scale)
    # lanes live in out["ixw"]; consumers patch them in (see dense_ix).
    out["ix"] = np.concatenate(ix8s, axis=0)[:n]
    ixw = {}
    wide = np.concatenate(wides, axis=0)[:n]
    if wide.any():
        for ci, tup in enumerate(pending):
            lo = ci * chunk
            lanes = np.flatnonzero(wide[lo:lo + chunk])
            if len(lanes):
                rows = np.asarray(_gather_rows(
                    tup[3], jnp.asarray(lanes, jnp.int32)))
                for k, l in enumerate(lanes):
                    ixw[lo + int(l)] = rows[k]
    out["ixw"] = ixw
    nlog_row = _FIN_ROWS.index("nlog")
    ls_parts = []
    lb_parts = []
    for ci, tup in enumerate(pending):
        ls_c, lb_c = _fetch_logs(fins[ci][nlog_row], tup[4], tup[5])
        ls_parts.append(ls_c)
        lb_parts.append(lb_c)
    out["log_steps"] = np.concatenate(ls_parts, axis=0)[:n]
    out["log_bits"] = np.concatenate(lb_parts, axis=0)[:n]
    return out


@functools.partial(jax.jit, static_argnames=("sr_idx", "want_scfsi"))
def _hide_fused_jit(xr, mb, hide_bits, hide_len, order, off0, sr_idx,
                    want_scfsi):
    """Whole-file hide as ONE device program (VERDICT r3 item 4): pass A
    (transform-free search, only its region counts are consumed), the
    embedded-bit cursor pinning (permute to reference f▸ch▸gr order +
    prefix sum, models/encoder pin()'s device twin), pass B (the search WITH
    the pair transform at the pinned cursors) and the scfsi energy sums.
    Fuses what used to be 2 chunked search dispatches + a host round trip +
    a scfsi dispatch; pass A's fin/ix planes never cross the link."""
    finA, _, _, _ = _search_body(xr, mb, sr_idx)
    counts = ((finA[9] > 0).astype(jnp.int32) + (finA[10] > 0)
              + (finA[11] > 0))
    co = counts[order]
    cur_o = off0 + jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(co[:-1], dtype=jnp.int32)])
    cursors = jnp.zeros_like(counts).at[order].set(cur_o)
    fin, ix8, wide, ix, ls, lb = _search_body_packed(
        xr, mb, sr_idx, hide_bits, cursors, hide_len)
    if want_scfsi:
        tot, en = _scfsi_sums(xr, sr_idx)
    else:
        tot = en = jnp.zeros((), jnp.int32)
    return fin, ix8, wide, ix, ls, lb, cursors, tot, en


def search_hide_fused(xr_dev, max_bits: np.ndarray, sr_idx: int,
                      hide_bits: np.ndarray, order: np.ndarray, off0: int,
                      want_scfsi: bool):
    """One-dispatch hide: pass A + on-device cursor pinning + pass B
    (+ scfsi sums) over resident (N, 576) spectra.

    :param order: (N,) permutation mapping rank-in-reference-cursor-order to
        lane index; padded lanes (zero spectra, zero budget) must rank last.
    :param off0: initial embedded-bit cursor (``hide_str_offset``).
    :return: (search_all-shaped result dict, (N,) pinned int32 cursors,
        scfsi (total, en) pair or None). The caller slices padded lanes off.
    """
    L = len(hide_bits)
    # whole 4096 bucket so message length doesn't recompile (L=0 -> 4096)
    lpad = max(4096, -(-L // 4096) * 4096) - L
    hb = jnp.asarray(np.concatenate(
        [np.asarray(hide_bits, np.uint8), np.zeros(lpad, np.uint8)]))
    fin, ix8, wide, ix_dev, ls, lb, cursors, tot, en = _hide_fused_jit(
        xr_dev, jnp.asarray(np.asarray(max_bits, np.int32)), hb,
        jnp.int32(L), jnp.asarray(np.asarray(order, np.int32)),
        jnp.int32(off0), sr_idx, want_scfsi)
    pieces = [fin, ix8, wide, cursors]
    if want_scfsi:
        pieces += [tot, en]
    got = _fetch_pieces(pieces)
    out = _unpack_single(got[0], got[1], got[2], ix_dev, ls, lb)
    scf = (got[4], got[5]) if want_scfsi else None
    return out, got[3], scf


def _unpack_single(fin_h, ix8_h, wide_h, ix_dev, ls_dev, lb_dev) -> dict:
    """Fetched single-dispatch packed results -> the search_all result dict
    (rare wide lanes re-gathered at full width from the resident plane).

    The approx logs are NOT materialized here: ``_log_dev`` carries the
    resident device planes, and models/encoder._plane_redo gathers the
    needed rows together with its spectra gather (fetch_rows_logs) — one
    device round trip instead of three."""
    out = {k: fin_h.astype(np.int32)[r] for r, k in enumerate(_FIN_ROWS)}
    out["ix"] = ix8_h
    ixw = {}
    lanes = np.flatnonzero(wide_h)
    if len(lanes):
        rows = np.asarray(_gather_rows(ix_dev,
                                       jnp.asarray(lanes, jnp.int32)))
        for k, l in enumerate(lanes):
            ixw[int(l)] = rows[k]
    out["ixw"] = ixw
    out["log_steps"] = out["log_bits"] = None
    out["_log_dev"] = (ls_dev, lb_dev)
    return out


@functools.partial(jax.jit, static_argnames=("sr_idx", "want_scfsi"))
def _search_scfsi_jit(xr, mb, sr_idx, want_scfsi):
    """Whole-file clear-encode as one program: the packed search plus the
    scfsi energy sums (both read the same resident spectra), replacing a
    chunked multi-dispatch search_all + a separate scfsi dispatch."""
    fin, ix8, wide, ix, ls, lb = _search_body_packed(xr, mb, sr_idx)
    if want_scfsi:
        tot, en = _scfsi_sums(xr, sr_idx)
    else:
        tot = en = jnp.zeros((), jnp.int32)
    return fin, ix8, wide, ix, ls, lb, tot, en


def search_single_fused(xr_dev, max_bits: np.ndarray, sr_idx: int,
                        want_scfsi: bool):
    """One-dispatch whole-file search (+ scfsi sums) over resident (N, 576)
    spectra; the single-stream twin of the batch/hide fused programs.
    Returns (search_all-shaped dict, scfsi (total, en) pair or None)."""
    fin, ix8, wide, ix_dev, ls, lb, tot, en = _search_scfsi_jit(
        xr_dev, jnp.asarray(np.asarray(max_bits, np.int32)), sr_idx,
        want_scfsi)
    pieces = [fin, ix8, wide]
    if want_scfsi:
        pieces += [tot, en]
    got = _fetch_pieces(pieces)
    out = _unpack_single(got[0], got[1], got[2], ix_dev, ls, lb)
    scf = (got[3], got[4]) if want_scfsi else None
    return out, scf


def dense_ix(res: dict) -> np.ndarray:
    """Widen a search result's int8 ix plane to int32 with the wide-lane
    patches applied (testing/debug helper; production consumers patch the
    serializer's int32 staging buffer directly instead)."""
    ix = res["ix"].astype(np.int32)
    for key, row in res.get("ixw", {}).items():
        ix[key] = row
    return ix
