"""The trace reduction (utils/profiling.py): from a profiler trace to device
time per named scope and the device-busy share of the window."""

import os

import numpy as np

import jax
import jax.numpy as jnp
import pytest

from mp3stego_tpu.utils import profiling as prof

# a GPU trace as jax.profiler writes it, compiled without command buffers:
# one device plane, one CUDA stream with two fusions and a cuBLAS kernel each
# reporting its HLO instruction, and a copy on another stream
_GPU_XSPACE = """
planes {
  id: 1 name: "/device:GPU:0"
  lines {
    id: 1 name: "Stream #13(MemcpyD2D,Compute)" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000
      stats { metadata_id: 10 str_value: "loop_add_fusion.2" }
      stats { metadata_id: 11 str_value: "jit_f" } }
    events { metadata_id: 2 offset_ps: 3000000 duration_ps: 1000000
      stats { metadata_id: 10 str_value: "%(reduce_op)s" }
      stats { metadata_id: 11 str_value: "jit_f" } }
    events { metadata_id: 3 offset_ps: 4000000 duration_ps: 4000000
      stats { metadata_id: 10 str_value: "custom-call.1" }
      stats { metadata_id: 11 str_value: "jit_f" } }
  }
  lines {
    id: 2 name: "Stream #14(MemcpyH2D)" timestamp_ns: 1000
    events { metadata_id: 4 offset_ps: 1000000 duration_ps: 2000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "loop_add_fusion_2" } }
  event_metadata { key: 2 value { id: 2 name: "input_reduce_fusion_1" } }
  event_metadata { key: 3 value { id: 3 name: "sm80_xmma_gemm_f32f32_cublas" } }
  event_metadata { key: 4 value { id: 4 name: "MemcpyH2D" } }
  stat_metadata { key: 10 value { id: 10 name: "hlo_op" } }
  stat_metadata { key: 11 value { id: 11 name: "hlo_module" } }
}
planes {
  id: 2 name: "Task Environment"
  stats { metadata_id: 1 uint64_value: 100 }
  stats { metadata_id: 2 uint64_value: 20100 }
  stat_metadata { key: 1 value { id: 1 name: "profile_start_time" } }
  stat_metadata { key: 2 value { id: 2 name: "profile_stop_time" } }
}
"""

# the same run with no device plane: what a GPU trace looks like when the
# profiler attached no device tracer
_HOST_ONLY_XSPACE = """
planes {
  id: 1 name: "/host:CPU"
  lines {
    id: 1 name: "python" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000
      stats { metadata_id: 10 str_value: "loop_add_fusion.2" }
      stats { metadata_id: 11 str_value: "jit_f" } }
  }
  event_metadata { key: 1 value { id: 1 name: "loop_add_fusion.2" } }
  stat_metadata { key: 10 value { id: 10 name: "hlo_op" } }
  stat_metadata { key: 11 value { id: 11 name: "hlo_module" } }
}
"""

_HLO = """
%fused_computation.1 (param_0.1: f32[8]) -> f32[8] {
  %param_0.1 = f32[8]{0} parameter(0)
  %mul.1 = f32[8]{0} multiply(%param_0.1, %param_0.1), metadata={op_name="jit(f)/synth_fir/mul"}
  %add.1 = f32[8]{0} add(%mul.1, %param_0.1), metadata={op_name="jit(f)/synth_fir/add"}
  ROOT %convert.1 = f32[8]{0} convert(%add.1), metadata={op_name="jit(f)/convert_element_type"}
}

ENTRY %main.1 (x.1: f32[8]) -> f32[8] {
  %loop_add_fusion.2 = f32[8]{0} fusion(%x.1), kind=kLoop, metadata={op_name="jit(f)/vmap(requantize)/add" stack_frame_id=2}
  %input_reduce_fusion.1 = f32[8]{0} fusion(%x.1), kind=kInput, calls=%fused_computation.1, metadata={op_name="jit(f)/convert_element_type"}
  ROOT %custom-call.1 = f32[8]{0} custom-call(%input_reduce_fusion.1), custom_call_target="__cublas$gemm", metadata={op_name="jit(f)/imdct/dot_general"}
}
"""


def _write_trace(tmp_path, text):
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    raw = jax.profiler.ProfileData.text_proto_to_serialized_xspace(text)
    (d / "host.xplane.pb").write_bytes(raw)
    return str(tmp_path)


def test_gpu_layout_scopes_and_busy_share(tmp_path):
    tr = prof.parse_device_trace(
        _write_trace(tmp_path, _GPU_XSPACE % {
            "reduce_op": "input_reduce_fusion.1"}), _HLO, backend="gpu")
    by_kernel = {op["kernel"]: op for op in tr["ops"]}
    assert set(by_kernel) == {"loop_add_fusion_2", "input_reduce_fusion_1",
                              "sm80_xmma_gemm_f32f32_cublas"}
    assert by_kernel["loop_add_fusion_2"]["scope"] == ["requantize"]
    # the fusion's root has no scope; the instructions fused into it do
    assert by_kernel["input_reduce_fusion_1"]["scope"] == ["synth_fir"]
    assert by_kernel["input_reduce_fusion_1"]["name"] == "input_reduce_fusion.1"
    # a cuBLAS kernel launched on its own is attributed to its instruction
    gemm = by_kernel["sm80_xmma_gemm_f32f32_cublas"]
    assert gemm["name"] == "custom-call.1" and gemm["scope"] == ["imdct"]
    assert gemm["category"] == "gemm"
    # busy = union of [0,2] [1,3] [3,4] [4,8] us = 8 us of a 20 us window
    assert np.isclose(tr["busy_ms"], 0.008)
    assert np.isclose(tr["window_ms"], 0.020)
    assert np.isclose(tr["busy_share"], 0.4)
    table = prof.stage_utilization(tr["ops"], ["requantize", "synth_fir"])
    assert table["requantize"]["n_ops"] == 1
    assert np.isclose(table["synth_fir"]["ms"], 0.001)
    assert np.isclose(table["other"]["ms"], 0.004)
    assert table["other"]["dominant"] == "gemm"


@pytest.mark.parametrize("trace, match", [
    (_GPU_XSPACE % {"reduce_op": "command_buffer"}, "command buffer"),
    (_HOST_ONLY_XSPACE, "no /device:GPU: plane"),
], ids=["command_buffer", "no_device_plane"])
def test_unattributable_gpu_trace_is_an_error(tmp_path, trace, match):
    """A GPU trace is read from its device plane alone, kernel by kernel:
    host events never stand in for device time."""
    with pytest.raises(ValueError, match=match):
        prof.parse_device_trace(_write_trace(tmp_path, trace), _HLO,
                                backend="gpu")


def test_union_of_intervals():
    assert prof._union_ns([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert prof._union_ns([]) == 0


def test_profile_compiled_attributes_decode_stages(tmp_path, fixture_mp3):
    """End to end on this backend: the decode plane compiled without
    command buffers, traced, reduced per named scope."""
    from mp3stego_tpu.bitstream import decoder_host as dh
    from mp3stego_tpu.ops import decode_plane as dp
    with open(fixture_mp3, "rb") as f:
        prep = dp.host_prepare(dh.parse_mp3(f.read(), 0))
    args = ({k: jnp.asarray(prep[k]) for k in dp.ALL_KEYS},)
    tr, untraced_s = prof.profile_compiled(
        dp._decode_granules_i16.lower(*args, wrap=False), args,
        str(tmp_path))
    assert untraced_s > 0 and 0 < tr["busy_share"] <= 1
    table = prof.stage_utilization(tr["ops"], [
        "requantize", "stereo", "reorder_alias", "imdct", "synth_v",
        "synth_fir"])
    for stage in ("requantize", "imdct", "synth_v", "synth_fir"):
        assert table[stage]["n_ops"] > 0, stage
    assert os.listdir(tmp_path)
