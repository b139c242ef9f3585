"""The native roaring codec: build and ctypes bindings.

The port's own copy of ``pilosa_tpu/native`` (JAX ``native/__init__.py``):
``roaring_native.cpp`` beside this file compiles with ``g++`` at first
use into ``build/torch_native/`` at the root of the checkout
(git-ignored), keyed by a hash of the source and the flags as the CUDA
kernels are (``ops/_build.py``): a changed source or flag builds anew,
an unchanged one loads the library already there.  The port never loads
the JAX package's library.

Every wrapper returns None when the library is unavailable (no ``g++``,
a failed build, or ``PILOSA_TPU_DISABLE_NATIVE`` set), and the caller
runs the pure-Python path of ``ops/roaring.py``, which stays the plain
version and the parity oracle: the bytes are the same either way.

Nothing here builds at import: the first call does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "roaring_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

# -mpopcnt (not -march=native): the hot loops are __builtin_popcountll
# sweeps, and a host-tuned build would fault on a machine the checkout
# moves to (JAX native/__init__.py:31-35).
CFLAGS = ("-O3", "-mpopcnt", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False
_path: Path | None = None

_U64P = ctypes.POINTER(ctypes.c_uint64)


class NativeCorruptError(ValueError):
    """A file the native decoder refuses; ``ops/roaring.py`` raises it
    again as its ``CorruptError`` with the same message."""


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpilosa_native-{digest}.so"


def _build(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    # A per-process temporary: concurrent builds (a server and a CLI
    # on a fresh checkout) must not interleave writes before the rename.
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *CFLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass


def _bind(l: ctypes.CDLL) -> None:
    sigs = {
        "ptpu_decode": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64]),
        "ptpu_error": (ctypes.c_char_p, [ctypes.c_void_p]),
        "ptpu_nkeys": (ctypes.c_int64, [ctypes.c_void_p]),
        "ptpu_ops": (ctypes.c_int64, [ctypes.c_void_p]),
        "ptpu_extract": (None, [ctypes.c_void_p, _U64P, _U64P]),
        "ptpu_free": (None, [ctypes.c_void_p]),
        "ptpu_encode_size": (ctypes.c_int64, [_U64P, _U64P, ctypes.c_int64]),
        "ptpu_encode": (ctypes.c_int64, [_U64P, _U64P, ctypes.c_int64, ctypes.c_char_p,
                                         ctypes.c_int64]),
        "ptpu_encode_op": (None, [ctypes.c_uint8, ctypes.c_uint64, ctypes.c_char_p]),
        "ptpu_parse_csv": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64, _U64P, _U64P,
                                            ctypes.c_int64]),
        "ptpu_format_csv": (ctypes.c_int64, [_U64P, _U64P, ctypes.c_int64,
                                             ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]),
        "ptpu_decode_tiered": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64]),
        "ptpu_t_error": (ctypes.c_char_p, [ctypes.c_void_p]),
        "ptpu_t_ops": (ctypes.c_int64, [ctypes.c_void_p]),
        "ptpu_t_counts": (None, [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)] * 3),
        "ptpu_t_extract": (None, [ctypes.c_void_p, _U64P, _U64P, _U64P,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_uint32)]),
        "ptpu_t_free": (None, [ctypes.c_void_p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(l, name)
        fn.restype = res
        fn.argtypes = args


def lib() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None when disabled or
    when it cannot be built or loaded (the Python paths then run)."""
    global _lib, _failed, _path
    if _lib is not None:
        return _lib
    if _failed or os.environ.get("PILOSA_TPU_DISABLE_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            path = library_path()
            if not path.exists() and not _build(path):
                _failed = True
                return None
            l = ctypes.CDLL(str(path))
            _bind(l)
        except OSError:
            _failed = True
            return None
        _path = path
        _lib = l
        return _lib


def available() -> bool:
    return lib() is not None


def loaded_path() -> Path | None:
    """The file of the loaded library, or None while none is loaded."""
    return _path


def _ptr(a: np.ndarray, ctype=ctypes.c_uint64):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode(data: bytes):
    """A roaring file -> ``({key: uint64[1024]}, op_count)``, or None."""
    l = lib()
    if l is None:
        return None
    h = l.ptpu_decode(data, len(data))
    try:
        err = l.ptpu_error(h)
        if err is not None:
            raise NativeCorruptError(err.decode())
        nkeys = l.ptpu_nkeys(h)
        ops = l.ptpu_ops(h)
        keys = np.zeros(nkeys, dtype=np.uint64)
        words = np.zeros(nkeys * 1024, dtype=np.uint64)
        if nkeys:
            l.ptpu_extract(h, _ptr(keys), _ptr(words))
        return {int(keys[i]): words[i * 1024 : (i + 1) * 1024] for i in range(nkeys)}, int(ops)
    finally:
        l.ptpu_free(h)


def decode_tiered(data):
    """A roaring file (bytes, or any buffer, read in place) ->
    ``({key: uint64[1024]}, {key: sorted uint32 values}, op_count)``, or
    None.  Array containers never become words."""
    l = lib()
    if l is None:
        return None
    if isinstance(data, (bytes, bytearray)):
        buf, buf_len = bytes(data), len(data)
    else:
        # A pointer into the buffer; ``arr`` pins it for the call.
        arr = np.frombuffer(data, dtype=np.uint8)
        buf, buf_len = ctypes.c_char_p(arr.ctypes.data), len(arr)
    h = l.ptpu_decode_tiered(buf, buf_len)
    try:
        err = l.ptpu_t_error(h)
        if err is not None:
            raise NativeCorruptError(err.decode())
        nw, na, tv = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        l.ptpu_t_counts(h, ctypes.byref(nw), ctypes.byref(na), ctypes.byref(tv))
        nw, na, tv = nw.value, na.value, tv.value
        ops = l.ptpu_t_ops(h)
        wkeys = np.zeros(nw, dtype=np.uint64)
        wwords = np.zeros(nw * 1024, dtype=np.uint64)
        akeys = np.zeros(na, dtype=np.uint64)
        alens = np.zeros(na, dtype=np.int64)
        avals = np.zeros(tv, dtype=np.uint32)
        if nw or na:
            l.ptpu_t_extract(h, _ptr(wkeys), _ptr(wwords), _ptr(akeys),
                             _ptr(alens, ctypes.c_int64), _ptr(avals, ctypes.c_uint32))
        words = {int(wkeys[i]): wwords[i * 1024 : (i + 1) * 1024] for i in range(nw)}
        bounds = np.concatenate(([0], np.cumsum(alens))).astype(np.int64)
        arrays = {int(akeys[i]): avals[bounds[i] : bounds[i + 1]] for i in range(na)}
        return words, arrays, int(ops)
    finally:
        l.ptpu_t_free(h)


def encode(containers: dict[int, np.ndarray]) -> bytes | None:
    """``{key: uint64[1024]}`` -> the roaring file, or None."""
    l = lib()
    if l is None:
        return None
    keys = np.array(sorted(containers), dtype=np.uint64)
    if len(keys):
        payloads = [np.asarray(containers[int(k)], dtype=np.uint64) for k in keys]
        # Each container checked: a total-length check alone would let
        # one short container shift every later payload.
        if any(p.shape != (1024,) for p in payloads):
            raise ValueError("container payloads must be 1024 words each")
        words = np.concatenate(payloads)
    else:
        words = np.zeros(0, dtype=np.uint64)
    return _encode_raw(l, keys, words)


def encode_packed(keys: np.ndarray, words2d: np.ndarray) -> bytes | None:
    """A packed dense tier — ``keys`` ascending, ``words2d[i]`` the 1024
    words of ``keys[i]`` — to the roaring file, or None."""
    l = lib()
    if l is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    words2d = np.ascontiguousarray(words2d, dtype=np.uint64)
    if words2d.ndim != 2 or words2d.shape != (len(keys), 1024):
        raise ValueError("words2d must have shape (len(keys), 1024)")
    return _encode_raw(l, keys, words2d.reshape(-1))


def _encode_raw(l, keys: np.ndarray, words: np.ndarray) -> bytes | None:
    kp, wp = _ptr(keys), _ptr(words)
    size = l.ptpu_encode_size(kp, wp, len(keys))
    out = ctypes.create_string_buffer(max(size, 1))
    n = l.ptpu_encode(kp, wp, len(keys), out, size)
    if n < 0:
        return None
    return out.raw[:n]


def encode_op(typ: int, value: int) -> bytes | None:
    """One 13-byte op-log record, or None."""
    l = lib()
    if l is None:
        return None
    out = ctypes.create_string_buffer(13)
    l.ptpu_encode_op(typ, value, out)
    return out.raw


def parse_csv(data: bytes):
    """Two-column ``row,col`` CSV -> ``(rows u64[], cols u64[])``, or
    None (unavailable, a timestamp column, anything malformed: the
    caller reads it with Python's csv)."""
    l = lib()
    if l is None:
        return None
    cap = data.count(b"\n") + 2
    rows = np.zeros(cap, dtype=np.uint64)
    cols = np.zeros(cap, dtype=np.uint64)
    n = l.ptpu_parse_csv(data, len(data), _ptr(rows), _ptr(cols), cap)
    if n < 0:
        return None
    return rows[:n], cols[:n]


def format_csv(rows: np.ndarray, cols: np.ndarray) -> bytes | None:
    """Parallel row/col arrays as ``row,col\\n`` records, or None when
    the library is unavailable (the caller formats with numpy)."""
    l = lib()
    if l is None or len(rows) == 0:
        return b"" if l is not None else None
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    cols = np.ascontiguousarray(cols, dtype=np.uint64)
    # Each record's width bounded by the widest values present; +43: the
    # C side checks one worst-case record of headroom before each write.
    cap = len(rows) * (len(str(int(rows.max()))) + len(str(int(cols.max()))) + 2) + 43
    out = np.empty(cap, dtype=np.uint8)
    n = l.ptpu_format_csv(_ptr(rows), _ptr(cols), len(rows), _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        return None
    return out[:n].tobytes()
