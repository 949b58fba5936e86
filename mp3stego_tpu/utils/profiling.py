"""Tracing / profiling utilities.

The reference's only instrumentation is a wall-clock print of the parse loop
(decoder/decoder.py:76-80) and tqdm progress bars (MP3_Parser.py:67,
MP3_Encoder.py:607). The equivalents here:

* ``StageTimer`` — per-stage wall-clock accounting for the codec pipelines
  (host parse, host prepare, device dispatch, device fetch, serialization),
  printed when ``quiet=False`` or collected programmatically.
* ``trace()`` — context manager around ``jax.profiler.trace``: dumps a
  TensorBoard/perfetto trace of the device work under a directory
  (set MP3STEGO_TPU_TRACE=<dir> to trace any pipeline without code changes).
* ``progress()`` — tqdm iterator when available/enabled, plain iterator
  otherwise.
"""

import contextlib
import os
import re
import time
from collections import OrderedDict


class StageTimer:
    """Accumulates wall-clock per named stage.

    >>> t = StageTimer()
    >>> with t.stage("host_parse"):
    ...     pass
    >>> _ = t.report()
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times = OrderedDict()
        self.counts = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'stage':<24}{'time':>10}  {'calls':>6}  {'share':>6}"]
        for name, t in self.times.items():
            share = (t / total * 100.0) if total else 0.0
            lines.append(f"{name:<24}{t * 1e3:>8.1f}ms  {self.counts[name]:>6}"
                         f"  {share:>5.1f}%")
        lines.append(f"{'total':<24}{total * 1e3:>8.1f}ms")
        return "\n".join(lines)

    def print_report(self):
        print(self.report())


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Wrap a block in a JAX profiler trace (TensorBoard / perfetto viewable).
    No-op when no directory is given and MP3STEGO_TPU_TRACE is unset."""
    log_dir = log_dir or os.environ.get("MP3STEGO_TPU_TRACE")
    if not log_dir:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield


_HLO_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s(.*)$")
_HLO_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_HLO_OP_NAME = re.compile(r'\bop_name="([^"]*)"')
_HLO_CALLS = re.compile(r"\bcalls=%?([\w.\-]+)")


def hlo_op_names(hlo_text: str) -> dict:
    """{HLO instruction name: [its ``op_name``, then the op_names of the
    instructions in the computation it calls]} from a compiled module's text
    (``jax.stages.Compiled.as_text()``). An op_name carries the
    ``jax.named_scope`` path, and a fusion's own op_name is only its root's,
    so the called computation's op_names say which scopes it also ran."""
    comps, own, calls = {}, {}, {}
    cur = None
    for line in hlo_text.splitlines():
        m = _HLO_INSTR.match(line)
        if m and cur is not None:
            name, rest = m.groups()
            on = _HLO_OP_NAME.search(rest)
            own[name] = on.group(1) if on else ""
            if on:
                comps[cur].append(on.group(1))
            c = _HLO_CALLS.search(rest)
            if c:
                calls[name] = c.group(1)
            continue
        m = _HLO_COMP.match(line)
        if m:
            cur = m.group(1)
            comps.setdefault(cur, [])
    return {n: [own[n]] + comps.get(calls.get(n), []) for n in own}


def _scope_path(op_name: str) -> list:
    """'jit(f)/vmap(scope_a)/.../op' -> ['scope_a', ...]: the jit prefix and
    the op itself dropped, transform wrappers around a component stripped
    so named_scope labels survive batching."""
    parts = [_unwrap(p) for p in op_name.rstrip(":").split("/") if p]
    return parts[1:-1] if len(parts) > 2 else []


def _scopes(primary: str, fused: list) -> list:
    """Scope segments of a kernel: its own op_name's first, then those of
    the instructions fused into it, most frequent first."""
    out = _scope_path(primary)
    counts = {}
    for path in fused:
        for seg in _scope_path(path):
            counts[seg] = counts.get(seg, 0) + 1
    out += [k for k in sorted(counts, key=counts.get, reverse=True)
            if k not in out]
    return out


def _kernel_category(kernel: str) -> str:
    """Coarse class of a GPU kernel from its name: XLA fusion kind, cuBLAS
    or CUTLASS matrix product, copy, or the name itself."""
    k = kernel.lower()
    if "gemm" in k or "cublas" in k or "cutlass" in k:
        return "gemm"
    if k.startswith("memcpy") or k.startswith("memset"):
        return "copy"
    m = re.match(r"(loop|input|wrapped|triton)_", k)
    return f"{m.group(1)} fusion" if m else k.split("_")[0]


# XLA compile options that launch every thunk on its own instead of inside
# a command buffer (CUDA graph), so a trace attributes each kernel, cuBLAS
# ones included, to its HLO instruction.
NO_COMMAND_BUFFERS = {"xla_gpu_enable_command_buffer": "",
                      "xla_gpu_graph_min_graph_size": 1 << 30}


def profile_compiled(lowered, args, log_dir: str, dispatches: int = 1):
    """Compile ``lowered`` (a ``jax.stages.Lowered``) with
    ``NO_COMMAND_BUFFERS``, warm it, trace ``dispatches`` steady calls under
    ``log_dir`` and return (``parse_device_trace`` result, untraced seconds
    per dispatch)."""
    import jax
    compiled = lowered.compile(compiler_options=NO_COMMAND_BUFFERS)
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(dispatches):
        out = compiled(*args)
    jax.block_until_ready(out)
    untraced_s = (time.perf_counter() - t0) / dispatches
    with jax.profiler.trace(log_dir):
        for _ in range(dispatches):
            out = compiled(*args)
        jax.block_until_ready(out)
    return parse_device_trace(log_dir, compiled.as_text()), untraced_s


def parse_device_trace(log_dir: str, hlo_text: str = "",
                       backend: str = None) -> dict:
    """Parse the newest ``jax.profiler`` trace under ``log_dir`` into per-op
    records from the device timeline.

    Reads the ``.xplane.pb`` with ``jax.profiler.ProfileData``. ``backend``
    (default ``jax.default_backend()``) picks the timeline: on ``gpu`` the
    ``/device:GPU:<n>`` planes, one line per CUDA stream, each kernel event
    carrying ``hlo_module`` and ``hlo_op`` stats; a GPU trace without such a
    plane is an error. On ``cpu`` the XLA thunk events of ``/host:CPU`` are
    the timeline (the test backend). Kernels launched from a command buffer
    (CUDA graph) report ``hlo_op == "command_buffer"`` and cannot be
    attributed: that is an error too, so compile the traced program through
    :func:`profile_compiled`. The ``jax.named_scope`` path of an instruction
    comes from its ``op_name`` metadata in ``hlo_text`` (the compiled
    module's ``as_text()``).

    Returns ``{"ops": [...], "window_ms", "busy_ms", "busy_share"}``. Each
    op record has ``name`` (HLO instruction, else kernel), ``kernel``,
    ``module``, ``scope`` (named-scope segments: the kernel's own op_name
    first, then those of the instructions fused into it), ``start_us``,
    ``dur_us`` and ``category`` (kernel class). ``busy_ms`` is the union of
    all device intervals (kernels and copies) and ``busy_share`` its
    fraction of the profiling window.
    """
    import glob

    import jax

    backend = backend or jax.default_backend()
    dev = {"gpu": "/device:GPU:", "cpu": "/host:CPU"}.get(backend)
    if dev is None:
        raise ValueError(f"no trace layout for backend {backend!r}")
    runs = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile", "*")))
    if not runs:
        raise FileNotFoundError(f"no profile under {log_dir}")
    pbs = glob.glob(os.path.join(runs[-1], "*.xplane.pb"))
    if not pbs:
        raise FileNotFoundError(f"no .xplane.pb under {runs[-1]}")
    data = jax.profiler.ProfileData.from_file(pbs[0])
    op_names = hlo_op_names(hlo_text)
    ops, spans = [], []
    window_ns = None
    planes = list(data.planes)
    if not any(p.name.startswith(dev) for p in planes):
        raise ValueError(f"{backend} trace under {log_dir} has no {dev} "
                         f"plane (planes: {[p.name for p in planes]})")
    for plane in planes:
        if plane.name == "Task Environment":
            st = dict(plane.stats)
            if "profile_start_time" in st and "profile_stop_time" in st:
                window_ns = (int(st["profile_stop_time"])
                             - int(st["profile_start_time"]))
        if not plane.name.startswith(dev):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                if backend == "cpu" and "hlo_module" not in st:
                    continue                       # host work, not a thunk
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if "hlo_module" not in st:
                    continue                       # copies, not XLA ops
                hlo = st.get("hlo_op") or ev.name
                if hlo == "command_buffer":
                    raise ValueError(
                        f"kernel {ev.name} ran inside a command buffer and "
                        "cannot be attributed; compile through "
                        "profile_compiled")
                paths = op_names.get(hlo, [""])
                tf_op = st.get("tf_op", "")
                if tf_op and not tf_op.startswith("XlaModule"):
                    paths = [tf_op] + paths[1:]
                ops.append(dict(
                    name=hlo if hlo in op_names else ev.name,
                    kernel=ev.name,
                    module=st.get("hlo_module", ""),
                    scope=_scopes(paths[0], paths[1:]),
                    start_us=ev.start_ns / 1e3,
                    dur_us=ev.duration_ns / 1e3,
                    category=_kernel_category(ev.name),
                ))
    busy_ns = _union_ns(spans)
    if window_ns is None:
        window_ns = (max(e for _, e in spans) - min(s for s, _ in spans)
                     if spans else 0)
    return {"ops": ops, "window_ms": window_ns / 1e6, "busy_ms": busy_ns / 1e6,
            "busy_share": busy_ns / window_ns if window_ns else 0.0}


def _union_ns(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _unwrap(part: str) -> str:
    """'vmap(requantize)' / 'jit(clip)' -> 'requantize' / 'clip'."""
    while "(" in part and part.endswith(")"):
        part = part[part.index("(") + 1:-1]
    return part


def stage_utilization(ops: list, stage_names: list, runs: int = 1) -> dict:
    """Aggregate device-op records per pipeline stage.

    ``stage_names`` are the ``jax.named_scope`` labels; an op whose scope
    path contains one of them is attributed to the FIRST match (fusions that
    span scope boundaries carry one representative op's scope — attribution
    at fusion granularity). Everything else lands in ``"other"``. Returns
    per-stage: device ms per dispatch, time share, op count, the distinct
    kernels attributed to it, ``in_kernels`` (every kernel that ran any of
    its ops, fused into another stage's kernel or not) and the dominant (by
    time) op category.
    """
    agg = {}
    for op in ops:
        stage = "other"
        for s in op["scope"]:
            if s in stage_names:
                stage = s
                break
        a = agg.setdefault(stage, dict(us=0.0, cats={}, n=0, kernels={}))
        a["us"] += op["dur_us"]
        a["n"] += 1
        k = op.get("name", "")
        a["kernels"][k] = a["kernels"].get(k, 0.0) + op["dur_us"]
        a["cats"][op["category"]] = (a["cats"].get(op["category"], 0.0)
                                     + op["dur_us"])
    within = {}          # stage -> kernels that ran any of its ops
    for op in ops:
        for stage in set(op["scope"]) & set(stage_names):
            within.setdefault(stage, set()).add(op.get("name", ""))
    for stage in within:
        agg.setdefault(stage, dict(us=0.0, cats={}, n=0, kernels={}))
    total_us = sum(a["us"] for a in agg.values()) or 1e-9
    out = {}
    for stage, a in sorted(agg.items(), key=lambda kv: -kv[1]["us"]):
        out[stage] = dict(
            ms=round(a["us"] / 1e3 / max(runs, 1), 3),
            share=round(a["us"] / total_us, 3),
            n_ops=a["n"],
            n_kernels=len(a["kernels"]),
            kernels=sorted(a["kernels"], key=a["kernels"].get, reverse=True),
            in_kernels=sorted(within.get(stage, ())),
            dominant=max(a["cats"], key=a["cats"].get) if a["cats"] else "",
        )
    return out


def progress(iterable, desc: str = "", enabled: bool = True):
    """tqdm-wrapped iterable (the reference's progress observability,
    MP3_Encoder.py:607), degrading to the plain iterable."""
    if not enabled:
        return iterable
    try:
        from tqdm import tqdm
        return tqdm(iterable, desc=desc)
    except Exception:
        return iterable


class _NullBar:
    def update(self, n=0):
        pass

    def close(self):
        pass


def byte_bar(total: int, enabled: bool = True, desc: str = "decoding"):
    """Byte-progress bar (the reference's per-byte decode tqdm,
    MP3_Parser.py:67); a no-op object when disabled or tqdm is missing."""
    if not enabled:
        return _NullBar()
    try:
        from tqdm import tqdm
    except ImportError:
        return _NullBar()
    return tqdm(total=total, unit="B", unit_scale=True, desc=desc)
