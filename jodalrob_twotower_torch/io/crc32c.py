"""CRC32C (Castagnoli) for the TFRecord framing (port of the checksum in
``jodalrob_twotower_tpu/native/``).

As in the JAX package, the native library is taken when it builds, else the
pure-Python version: ``csrc/crc32c.cpp`` is compiled with g++ at first use
(``ops/_build.build_host``) and loaded through ctypes. The pure-Python
version takes one table lookup a byte, so a table of 768-float text
embeddings (about 3 KB a record) spends tens of seconds per 100,000 rows in
it; ``backend()`` says which one is in use.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

from jodalrob_twotower_torch.ops import _build

_lock = threading.Lock()
_lib: ctypes.CDLL | None | bool = False  # False: not attempted yet


def native_library() -> ctypes.CDLL | None:
    """The native CRC library, or None where it cannot be built or loaded."""
    global _lib
    if _lib is False:
        with _lock:
            if _lib is False:
                try:
                    lib = _build.load_host("crc32c")
                    lib.crc32c.restype = ctypes.c_uint32
                    lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
                    _lib = lib
                except (OSError, RuntimeError, subprocess.SubprocessError):
                    _lib = None
    return _lib


def backend() -> str:
    """"native" or "python": the CRC ``crc32c`` computes with."""
    return "python" if native_library() is None else "native"


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data`` continuing from ``crc``: native, else pure Python."""
    lib = native_library()
    if lib is not None:
        return int(lib.crc32c(data, len(data), crc))
    return _crc32c_py(data, crc)


_PY_TABLE: list[int] | None = None


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """The plain version: one table lookup a byte."""
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
            tbl.append(c)
        _PY_TABLE = tbl
    crc = ~crc & 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ _PY_TABLE[(crc ^ byte) & 0xFF]
    return ~crc & 0xFFFFFFFF
