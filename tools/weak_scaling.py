#!/usr/bin/env python
"""Multi-chip scaling shape check on the 8-virtual-device CPU mesh
: this records what can be validated without several cards — that the data-parallel
decode and encode-search programs stay COLLECTIVE-FREE at every mesh width
(they shard a file axis; XLA must not insert any cross-device traffic), that
the frame-sharded decode's halo exchange stays O(boundary) (exactly two
``collective-permute`` ops regardless of width), and the relative wall-clock
of the same total work at widths 1/2/4/8.

CPU-sim wall-clock is a smoke signal, not a perf claim: all N virtual
devices share the same host cores, so ideal scaling shows up as FLAT wall
time with width (same total work, more parallel shards over the same
silicon) rather than a speedup. The collective counts are exact, though —
they are read from the compiled HLO, which is what real hardware would run.

Run via bench.py (subprocess with JAX_PLATFORMS=cpu and 8 virtual devices)
or standalone:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/weak_scaling.py
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all")


def _count_collectives(compiled) -> dict:
    txt = compiled.as_text()
    counts = {c: txt.count(f" {c}(") + txt.count(f" {c}-start(")
              for c in COLLECTIVES}
    return {k: v for k, v in counts.items() if v}


def main():
    # jax may already be imported with its platform chosen, so env vars
    # alone can be too late — set the config directly (same as
    # tests/conftest.py)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mp3stego_tpu.bitstream import decoder_host as dh
    from mp3stego_tpu.ops import decode_plane as dp
    from mp3stego_tpu.ops import search_plane as SP
    from mp3stego_tpu.parallel.batch_decode import (_decode_batch,
                                                    prepare_batch)
    from mp3stego_tpu.parallel.frame_shard import decode_granules_sharded

    devs = jax.devices()
    assert len(devs) >= 8, f"need 8 virtual devices, got {len(devs)}"

    data = np.load(os.path.join(REPO, "tests", "golden",
                                "encode_golden.npz"))["mp3_bytes"].tobytes()
    # 8 distinct-enough files: the fixture stream tiled to ~2s each
    parsed = dh.parse_mp3(data * 2, 0)
    preps = [dp.host_prepare(parsed) for _ in range(8)]
    batch = prepare_batch(preps)
    total_g = parsed.num_frames * 2 * 8

    out = {"total_granules": total_g, "widths": {}}
    for n in (1, 2, 4, 8):
        mesh = Mesh(np.array(devs[:n]), ("files",))
        spec = NamedSharding(mesh, P("files"))
        args = {k: jax.device_put(batch[k], spec) for k in dp.ALL_KEYS}
        lowered = jax.jit(
            lambda a: _decode_batch(a, dtype_name="float32")).lower(args)
        compiled = lowered.compile()
        o = compiled(args)
        jax.block_until_ready(o)
        best = None
        for _ in range(3):
            t0 = time.time()
            o = compiled(args)
            jax.block_until_ready(o)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        dec_coll = _count_collectives(compiled)

        # sharded batch search: (F, N, 576) spectra over the same file axis
        rng = np.random.default_rng(0)
        xr = rng.integers(-(1 << 14), 1 << 14,
                          size=(8, 256, 576)).astype(np.int32)
        mb = np.full((8, 256), 1631, np.int32)
        xr_d = jax.device_put(xr, spec)
        mb_d = jax.device_put(mb, spec)
        low_s = jax.jit(lambda a, b: SP._search_batch_jit(a, b, 0)[0]).lower(
            xr_d, mb_d)
        comp_s = low_s.compile()
        o = comp_s(xr_d, mb_d)
        jax.block_until_ready(o)
        best_s = None
        for _ in range(3):
            t0 = time.time()
            o = comp_s(xr_d, mb_d)
            jax.block_until_ready(o)
            dt = time.time() - t0
            best_s = dt if best_s is None else min(best_s, dt)
        srch_coll = _count_collectives(comp_s)

        # frame-sharded single-stream decode: halo exchange must stay
        # O(boundary) — two ppermutes total, independent of width
        fmesh = Mesh(np.array(devs[:n]), ("frames",))
        t0 = time.time()
        decode_granules_sharded(preps[0], fmesh)
        fs_wall = time.time() - t0
        from mp3stego_tpu.parallel.frame_shard import _decode_sharded, _specs
        in_specs, _ = _specs(fmesh)
        host = dict(preps[0])
        host["raw_dense"] = dp.dense_raw(preps[0]).astype(np.int16)
        t = host["raw_dense"].shape[1]
        pad = (-t) % n
        fargs = {}
        for k, sp_ in in_specs.items():
            a = host[k]
            axis = 1 if (k in dp.T_AXIS1_KEYS or k == "raw_dense") else \
                (0 if k in dp.T_AXIS0_KEYS else None)
            if axis is not None and pad:
                width = [(0, 0)] * a.ndim
                width[axis] = (0, pad)
                a = np.pad(a, width)
            fargs[k] = jax.device_put(a, NamedSharding(fmesh, sp_))
        comp_f = jax.jit(
            lambda a: _decode_sharded(a, mesh=fmesh,
                                      dtype_name="float32")).lower(
            fargs).compile()
        halo_coll = _count_collectives(comp_f)

        out["widths"][n] = {
            "dp_decode_wall_ms": round(best * 1e3, 1),
            "dp_decode_collectives": dec_coll or "none",
            "dp_search_wall_ms": round(best_s * 1e3, 1),
            "dp_search_collectives": srch_coll or "none",
            "frame_shard_collectives": halo_coll or "none",
            "frame_shard_wall_ms": round(fs_wall * 1e3, 1),
        }
        assert not dec_coll, f"dp decode grew collectives at width {n}"
        # the search's inner while_loop termination must agree across
        # shards: GSPMD inserts ONE scalar pred[] all-reduce for the loop
        # condition — O(1) control traffic, not data. Nothing else allowed.
        assert set(srch_coll) <= {"all-reduce"}, srch_coll
        if n > 1:
            assert "all-reduce(%and_reduce" in comp_s.as_text() \
                or "all-reduce" in str(srch_coll), srch_coll
            assert srch_coll.get("all-reduce", 0) <= 2, srch_coll
            assert halo_coll.get("collective-permute", 0) == 2, halo_coll

    print(json.dumps(out))


if __name__ == "__main__":
    main()
