"""Buffer compression through native codecs (ctypes).

reference: include/lama/buffer_compressor.h:43-80 — compress, decompress
and bound with LZ4 and ZSTD implementations (src/buffer_compressor.cpp:49
LZ4_compress_fast level 1, :96 ZSTD_compress level 1).

* LZ4: the block format of ``native/lama_codec.cpp`` (the repository's
  own implementation, wire-compatible with the reference's lz4), compiled
  with ``g++`` at first use into ``build/native/`` at the repository root;
  the library's name carries a hash of the source, so an edited source is
  rebuilt. Without a compiler, constructing an lz4 compressor raises.
* ZSTD: standard zstd frames through the system libzstd (the same
  level-1 ``ZSTD_compress``/``ZSTD_decompress`` calls the reference
  makes); without it, construction raises rather than write another wire
  format.

Both packages' compressors give the same bytes for the same input and
read each other's output.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import pathlib
import subprocess
import threading

_REPO = pathlib.Path(__file__).resolve().parents[2]
SRC_PATH = _REPO / "native" / "lama_codec.cpp"
BUILD_DIR = _REPO / "build" / "native"

_lock = threading.Lock()
_lz4 = None
_zstd = None
_zstd_tried = False


def _lz4_lib():
    """The native lz4 library, built at first use; raises RuntimeError
    when it cannot be built or loaded."""
    global _lz4
    with _lock:
        if _lz4 is not None:
            return _lz4
        digest = hashlib.sha256(SRC_PATH.read_bytes()).hexdigest()[:12]
        so = BUILD_DIR / f"lama_codec-{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", "-O3", "-shared", "-fPIC",
                                "-std=c++17", str(SRC_PATH), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"building {SRC_PATH.name} with g++ "
                                   f"failed: {e}") from e
            os.replace(tmp, so)      # atomic: concurrent builders agree
        lib = ctypes.CDLL(str(so))
        for name in ("lama_lz4_compress", "lama_lz4_decompress"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                           ctypes.c_char_p, ctypes.c_int64]
        lib.lama_lz4_compress_bound.restype = ctypes.c_int64
        lib.lama_lz4_compress_bound.argtypes = [ctypes.c_int64]
        _lz4 = lib
        return lib


def _zstd_lib():
    """The system libzstd through ctypes, or None."""
    global _zstd, _zstd_tried
    with _lock:
        if _zstd_tried:
            return _zstd
        _zstd_tried = True
        for name in ("libzstd.so.1", "libzstd.so",
                     ctypes.util.find_library("zstd")):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            lib.ZSTD_compress.restype = ctypes.c_size_t
            lib.ZSTD_compress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t]
            lib.ZSTD_compressBound.restype = ctypes.c_size_t
            lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            _zstd = lib
            break
        return _zstd


class BufferCompressor:
    """compress / decompress / bound (buffer_compressor.h:43-80) for
    ``algorithm`` ``"lz4"`` or ``"zstd"``."""

    def __init__(self, algorithm: str = "lz4"):
        if algorithm not in ("lz4", "zstd"):
            raise ValueError(f"unknown compression algorithm {algorithm!r}")
        self.algorithm = algorithm
        self._lz4 = _lz4_lib() if algorithm == "lz4" else None
        self._zstd = _zstd_lib() if algorithm == "zstd" else None
        if algorithm == "zstd" and self._zstd is None:
            raise RuntimeError(
                "algorithm 'zstd': libzstd is not available on this host "
                "(the reference writes real zstd frames, "
                "src/buffer_compressor.cpp:96); use 'lz4'")

    def compress_bound(self, n: int) -> int:
        if self._zstd is not None:
            return int(self._zstd.ZSTD_compressBound(n))
        return int(self._lz4.lama_lz4_compress_bound(n))

    def compress(self, data: bytes) -> bytes:
        data = bytes(data)
        cap = self.compress_bound(len(data))
        out = ctypes.create_string_buffer(cap)
        if self._zstd is not None:
            # level 1, as ZSTDBufferCompressor (src/buffer_compressor.cpp:96)
            n = self._zstd.ZSTD_compress(out, cap, data, len(data), 1)
            if self._zstd.ZSTD_isError(n):
                raise RuntimeError("ZSTD_compress failed")
            return out.raw[:n]
        n = self._lz4.lama_lz4_compress(data, len(data), out, cap)
        if n < 0:
            raise RuntimeError("lz4 compression failed")
        return out.raw[:n]

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        data = bytes(data)
        out = ctypes.create_string_buffer(expected_size)
        if self._zstd is not None:
            n = self._zstd.ZSTD_decompress(out, expected_size, data,
                                           len(data))
            if self._zstd.ZSTD_isError(n):
                raise RuntimeError("ZSTD_decompress failed (corrupt frame?)")
            return out.raw[:n]
        n = self._lz4.lama_lz4_decompress(data, len(data), out,
                                          expected_size)
        if n < 0:
            raise RuntimeError("lz4 decompression failed (corrupt block?)")
        return out.raw[:n]
