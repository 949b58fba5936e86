"""Device numeric plane: batched JAX/XLA kernels for the MP3 codec.

Decode: requantize -> MS stereo -> reorder/alias -> IMDCT -> frequency inversion ->
polyphase synthesis. Encode: polyphase analysis -> MDCT -> alias butterflies ->
quantization rate loop -> Huffman bit costs. All kernels are batched over
granules (and files); the only sequential structures in the MP3 format — the
IMDCT overlap-add and the synthesis FIFO — are reformulated as shifted adds and
a 16-tap FIR over V-vectors, so nothing needs a `lax.scan`.

Importing this package enables jax x64 mode: the bit-exact decode path is
float64 and the fixed-point encode path needs int64 intermediates.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the codec kernels have a handful of static
# shapes per file length, so cross-process cache hits are the common case.
# JAX_COMPILATION_CACHE_DIR, when set, is honoured as JAX reads it, and no
# other directory is set here. Otherwise the cache lives at a fixed path in
# the checkout, <repo>/.jax_cache/<host tag>: the path is part of what makes
# an entry found again, so it never depends on a temporary name, a PID or the
# time. The per-host subdirectory exists because XLA's CPU AOT entries are
# compiled for the writing machine's microarchitecture; loading them on a
# different CPU logs machine-type-mismatch errors and can SIGILL.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _host_cache_tag() -> str:
    import hashlib
    import platform
    bits = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    bits.append(line.strip())
                    break
    except OSError:
        bits.append(platform.processor() or "")
    return hashlib.sha256("|".join(bits).encode()).hexdigest()[:12]


def default_cache_dir() -> str:
    """The compile-cache directory used when JAX_COMPILATION_CACHE_DIR is
    unset: fixed inside the checkout (listed in .gitignore)."""
    return os.path.join(REPO_ROOT, ".jax_cache", _host_cache_tag())


def _enable_compile_cache() -> None:
    try:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(default_cache_dir(), exist_ok=True)
            jax.config.update("jax_compilation_cache_dir",
                              default_cache_dir())
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except Exception:  # the cache is an optimization only
        pass


_enable_compile_cache()
