"""mp3stego_tpu — MP3 steganography framework on JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of
tomershay100/mp3-steganography-lib (mp3stego-lib): a complete MPEG-1 Layer III
decoder and Shine-style fixed-point encoder with a Huffman-pair steganographic
channel, batched over granules/files on an accelerator (one GPU, or a
mesh of them), plus the five-operation
``Steganography`` façade.

Public API mirrors the reference package (__init__.py:1-4):
    from mp3stego_tpu import Steganography, Decoder, Encoder
"""

def _tune_host_allocator():
    """Keep glibc from munmapping large buffers on free.

    By default glibc serves >128 KB allocations with mmap and returns them to
    the kernel on free, so every large NumPy temp / device-fetch destination
    re-faults its pages. On virtualized hosts with slow page faults (measured
    here: ~10 MB/s faulting vs ~9 GB/s into warm pages) that dominates the
    whole pipeline. Raising M_MMAP_THRESHOLD / M_TRIM_THRESHOLD keeps the
    heap warm — repeated large allocations run at memory speed. Trade-off:
    peak RSS stays allocated; disable with MP3STEGO_TPU_MALLOC_TUNE=0.
    """
    import ctypes
    import os
    if os.environ.get("MP3STEGO_TPU_MALLOC_TUNE", "1") != "1":
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
    except Exception:  # noqa: BLE001 - non-glibc platforms: default malloc
        pass


_tune_host_allocator()

from mp3stego_tpu.models.decoder import Decoder                    # noqa: E402
from mp3stego_tpu.models.encoder import Encoder                    # noqa: E402
from mp3stego_tpu.steganography import Steganography, str_to_binary_str  # noqa: E402

__version__ = "0.1.0"

__all__ = ["Steganography", "Decoder", "Encoder", "str_to_binary_str"]
