"""ctypes bindings for the port's native host data layer.

  batcher.cpp — mmap batch assembler + async prefetcher (NativeBatcher)
  decoder.cpp — libjpeg decode + PIL-parity resize pool (decode_files,
                decode_mem; the pack builder of data/histo.py)

The port's own copy of moma_tpu/data/native (same C ABI, same Python
names).  Each library is built with g++ at its first use into
`build/moma_tpu_torch/host/` at the repository root, never next to the
source, under a name keyed by a hash of the source, the flags and the
host's CPU (a `-march=native` library copied to another CPU dies with
SIGILL).  A failed build of the batcher raises with g++'s message; the
decoder needs libjpeg's headers, and where they are missing
`decoder_unavailable()` says why and the pack builder decodes with PIL.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import platform
from pathlib import Path
from typing import Optional

import numpy as np

from moma_tpu_torch.ops import _build

HERE = Path(__file__).resolve().parent
HOST_BUILD_DIR = _build.BUILD_DIR / "host"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
LIBS = {"batcher": (), "decoder": ("-ljpeg",)}


def _host_fingerprint() -> str:
    """The CPU's identity: its machine name and feature flags."""
    parts = [platform.machine()]
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith(("flags", "Features")):
                parts.append(line.strip())
                break
    return "|".join(parts)


def lib_path(name: str) -> Path:
    """Where the library built from this exact source, these flags and
    this host's CPU lives."""
    h = hashlib.sha256((HERE / f"{name}.cpp").read_bytes())
    h.update(" ".join(FLAGS + LIBS[name]).encode())
    h.update(_host_fingerprint().encode())
    return HOST_BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def _load(name: str):
    """(library, None) once built and loaded, or (None, g++'s message)."""
    path = lib_path(name)
    if not path.exists():
        proc = _build.compile_library(
            ["g++", *FLAGS], [str(HERE / f"{name}.cpp"), *LIBS[name]], path)
        if proc.returncode != 0:
            return None, (proc.stderr or proc.stdout).strip()
    return ctypes.CDLL(str(path)), None


@functools.lru_cache(maxsize=None)
def get_lib():
    """The batcher library; raises RuntimeError with g++'s message when it
    does not build."""
    lib, err = _load("batcher")
    if lib is None:
        raise RuntimeError(f"g++ failed to build batcher.cpp:\n{err}")
    u8p, i64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(
        ctypes.c_int64)
    lib.bt_open.restype = ctypes.c_void_p
    lib.bt_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                            ctypes.c_int64]
    lib.bt_gather.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64, u8p,
                              ctypes.c_int]
    lib.bt_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
    lib.bt_prefetch_submit.argtypes = [ctypes.c_void_p, i64p,
                                       ctypes.c_int64]
    lib.bt_prefetch_submit_into.argtypes = [ctypes.c_void_p, i64p,
                                            ctypes.c_int64,
                                            ctypes.c_void_p]
    lib.bt_prefetch_get.restype = ctypes.c_int64
    lib.bt_prefetch_get.argtypes = [ctypes.c_void_p, u8p]
    lib.bt_prefetch_get_ref.restype = ctypes.c_void_p
    lib.bt_prefetch_get_ref.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(u8p), i64p]
    lib.bt_prefetch_release.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.bt_close.argtypes = [ctypes.c_void_p]
    return lib


def decoder_unavailable() -> Optional[str]:
    """None when the native decoder builds on this host, else the first
    line of g++'s error (e.g. libjpeg's headers are missing)."""
    _, err = _load("decoder")
    return None if err is None else (err.splitlines() or ["g++ failed"])[0]


@functools.lru_cache(maxsize=None)
def get_decoder_lib():
    """The decoder library, or None where it does not build
    (decoder_unavailable() says why)."""
    lib, _ = _load("decoder")
    if lib is not None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.dec_decode_mem.restype = ctypes.c_int
        lib.dec_decode_mem.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int, u8p]
        lib.dec_decode_file.restype = ctypes.c_int
        lib.dec_decode_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int, u8p]
        lib.dec_decode_files.restype = ctypes.c_int64
        lib.dec_decode_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, u8p, u8p, ctypes.c_int]
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_files(paths, size: int, fast: bool = False, threads: int = 8,
                 out: Optional[np.ndarray] = None):
    """Decode+resize JPEG files natively -> (images (n,size,size,3) uint8,
    fail (n,) bool).  Rows with fail=True (non-JPEG, corrupt, missing) are
    zeroed; the caller decodes those with PIL.  None when the native
    decoder is unavailable.  `out` ((n,size,size,3) uint8, C-contiguous,
    e.g. a slice of the pack memmap) receives the rows in place: decoding
    straight into the destination avoids a staging copy and its page
    faults."""
    lib = get_decoder_lib()
    if lib is None:
        return None
    n = len(paths)
    if out is None:
        out = np.empty((n, size, size, 3), dtype=np.uint8)
    elif (out.dtype != np.uint8 or out.shape != (n, size, size, 3)
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be C-contiguous uint8 {(n, size, size, 3)}"
                         f", got {out.dtype} {out.shape}")
    failed = np.zeros((n,), dtype=np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.dec_decode_files(c_paths, n, size, int(fast), _u8(out), _u8(failed),
                         threads)
    return out, failed.astype(bool)


def decode_mem(blob: bytes, size: int, fast: bool = False):
    """Decode one in-memory JPEG -> (size,size,3) uint8, or None on
    failure / native decoder unavailable."""
    lib = get_decoder_lib()
    if lib is None:
        return None
    buf = np.frombuffer(blob, dtype=np.uint8)
    out = np.empty((size, size, 3), dtype=np.uint8)
    rc = lib.dec_decode_mem(_u8(buf), buf.size, size, int(fast), _u8(out))
    return out if rc == 0 else None


class NativeBatcher:
    """Multi-threaded gather + async prefetch over a packed uint8 file.

    Usage:
        b = NativeBatcher(path, n, row_shape)
        b.start(batch_size, depth=4, threads=8)
        b.submit(indices)           # one call per upcoming batch
        arr = b.get()               # (batch, *row_shape) uint8, FIFO

    `submit_into(indices, dst)` has the batch assembled straight into the
    caller's buffer `dst` (a pinned host tensor's memory, for one); `dst`
    must stay valid and untouched until that batch is dequeued.
    """

    def __init__(self, path: str, n_rows: int, row_shape):
        self.row_shape = tuple(row_shape)
        self.row_bytes = int(np.prod(row_shape))
        self.n_rows = n_rows
        self._lib = get_lib()
        self._h = self._lib.bt_open(path.encode(), n_rows, self.row_bytes)
        if not self._h:
            raise OSError(f"bt_open failed for {path}")
        self._batch = 0

    def start(self, batch_size: int, depth: int = 3, threads: int = 8):
        self._batch = batch_size
        self._lib.bt_prefetch_start(self._h, batch_size, depth, threads)

    @staticmethod
    def _idx(indices):
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        return idx, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def submit(self, indices: np.ndarray):
        idx, p = self._idx(indices)
        self._lib.bt_prefetch_submit(self._h, p, idx.shape[0])

    def submit_into(self, indices: np.ndarray, dst_ptr: int):
        idx, p = self._idx(indices)
        self._lib.bt_prefetch_submit_into(self._h, p, idx.shape[0], dst_ptr)

    def get(self) -> np.ndarray:
        out = np.empty((self._batch, *self.row_shape), dtype=np.uint8)
        n = self._lib.bt_prefetch_get(self._h, _u8(out))
        return out[:n]

    def get_view(self):
        """Zero-copy dequeue: (view, token).  `view` aliases the batcher's
        buffer (or the caller's, for a batch of submit_into); it is valid
        ONLY until release(token), so consume it before releasing, and
        release before close()."""
        data = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_int64()
        token = self._lib.bt_prefetch_get_ref(self._h, ctypes.byref(data),
                                              ctypes.byref(n))
        arr = np.ctypeslib.as_array(data, shape=(n.value, *self.row_shape))
        return arr, token

    def release(self, token) -> None:
        self._lib.bt_prefetch_release(self._h, token)

    def gather(self, indices: np.ndarray, threads: int = 8) -> np.ndarray:
        idx, p = self._idx(indices)
        out = np.empty((idx.shape[0], *self.row_shape), dtype=np.uint8)
        self._lib.bt_gather(self._h, p, idx.shape[0], _u8(out), threads)
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.bt_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
