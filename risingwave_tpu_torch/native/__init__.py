"""The checkpoint row codec: native C++ bound with ctypes (host code).

Counterpart of ``risingwave_tpu/native/``: ``rowcodec.cpp`` encodes whole
dirty batches of columnar buffers into the byte formats of
``common/row.py`` (memcomparable keys, value rows) in one call. The library
is built with ``g++`` at first use into ``build/native/`` beside the package,
its file name keyed by a hash of the source, so an edited source is rebuilt
and a stale library is never loaded. Nothing is compiled at import. Where
there is no compiler, ``codec()`` is None and callers use the Python
encoders, which give the same bytes. JSONB and BYTEA go through the string
code, as VARCHAR does; LIST and STRUCT have no native code, so
``codec(types)`` is None for a row that holds one, and such rows take the
Python encoders (the reference's codec raises on them, ROADMAP C3).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..common.types import GLOBAL_STRING_DICT

SRC = Path(__file__).resolve().parent / "rowcodec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: TypeKind name -> native type code (rowcodec.cpp's header comment)
_CODE_BY_KIND = {"BOOL": 0, "INT16": 1, "INT32": 2, "DATE": 2, "INT64": 3,
                 "TIME": 3, "TIMESTAMP": 3, "INTERVAL": 3, "SERIAL": 3,
                 "DECIMAL": 3, "FLOAT32": 4, "FLOAT64": 5, "VARCHAR": 6,
                 "BYTEA": 6, "JSONB": 6}
#: native type code -> the numpy dtype the C side reads
_NP_BY_CODE = {0: np.uint8, 1: np.int16, 2: np.int32, 3: np.int64,
               4: np.float32, 5: np.float64}

_lib: Optional["RowCodec"] = None
_tried = False
_build_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"rowcodec-{h.hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
        try:
            subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    lib = ctypes.CDLL(str(so_path))
    lib.rw_encode.restype = ctypes.c_longlong
    lib.rw_encode.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.rw_abi_version.argtypes = []
    lib.rw_abi_version.restype = ctypes.c_int
    if lib.rw_abi_version() != 1:
        return None
    return lib


def codec(types=None) -> Optional["RowCodec"]:
    """The process-wide codec, built at the first call, or None when no
    compiler is available or when one of ``types`` (the row's column
    types, if given) has no native code."""
    global _lib, _tried
    if types is not None and any(t.kind.name not in _CODE_BY_KIND
                                 for t in types):
        return None
    with _build_lock:
        if not _tried:
            _tried = True
            lib = _build()
            if lib is not None:
                _lib = RowCodec(lib)
    return _lib


class RowCodec:
    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def _prep_columns(self, datas: Sequence[np.ndarray],
                      masks: Sequence[np.ndarray], types) -> tuple:
        """-> (codes, data_ptrs, mask_ptrs, blob_ptrs, off_ptrs, keepalive,
        longest string in bytes)"""
        n = len(types)
        codes = (ctypes.c_int * n)()
        data_ptrs = (ctypes.c_void_p * n)()
        mask_ptrs = (ctypes.c_void_p * n)()
        blob_ptrs = (ctypes.c_void_p * n)()
        off_ptrs = (ctypes.c_void_p * n)()
        keep = []
        blob_bytes = 0
        for i, t in enumerate(types):
            code = _CODE_BY_KIND[t.kind.name]
            codes[i] = code
            mask = np.ascontiguousarray(masks[i], np.uint8)
            keep.append(mask)
            mask_ptrs[i] = mask.ctypes.data_as(ctypes.c_void_p).value
            if code == 6:
                # the delta's distinct strings as one blob, each row an
                # index into it
                ids = np.ascontiguousarray(datas[i]).astype(np.int64)
                uniq, inv = np.unique(ids, return_inverse=True)
                parts = [GLOBAL_STRING_DICT.lookup(int(u)).encode("utf-8")
                         for u in uniq]
                offs = np.zeros(len(parts) + 1, np.int64)
                np.cumsum([len(p) for p in parts], out=offs[1:])
                blob = np.frombuffer(b"".join(parts) or b"\x00", np.uint8)
                blob_bytes += max((len(p) for p in parts), default=0)
                inv64 = np.ascontiguousarray(inv.reshape(-1), np.int64)
                keep.extend((blob, offs, inv64))
                data_ptrs[i] = inv64.ctypes.data_as(ctypes.c_void_p).value
                blob_ptrs[i] = blob.ctypes.data_as(ctypes.c_void_p).value
                off_ptrs[i] = offs.ctypes.data_as(ctypes.c_void_p).value
            else:
                arr = np.ascontiguousarray(datas[i], _NP_BY_CODE[code])
                keep.append(arr)
                data_ptrs[i] = arr.ctypes.data_as(ctypes.c_void_p).value
        return codes, data_ptrs, mask_ptrs, blob_ptrs, off_ptrs, keep, \
            blob_bytes

    def _encode(self, key_mode: int, datas, masks, types,
                indices: np.ndarray) -> list:
        n = len(types)
        sel = np.ascontiguousarray(indices, np.int64)
        n_sel = len(sel)
        if n_sel == 0:
            return []
        # gather the delta first: all per-column preparation scales with
        # the selected rows, not with the state's capacity
        datas = [np.asarray(d).reshape(-1)[sel] for d in datas]
        masks = [np.asarray(m).reshape(-1)[sel] for m in masks]
        (codes, data_ptrs, mask_ptrs, blob_ptrs, off_ptrs, keep,
         blob_bytes) = self._prep_columns(datas, masks, types)
        idx = np.arange(n_sel, dtype=np.int64)
        out_offsets = np.zeros(n_sel + 1, np.int64)
        # at most 9 bytes per fixed column per row; a string column at most
        # twice its longest string (escapes) plus framing
        cap = n_sel * (9 * n + 8 + 2 * blob_bytes + 6) + 64
        for _ in range(3):
            out = np.zeros(cap, np.uint8)
            written = self.lib.rw_encode(
                key_mode, n, codes, data_ptrs, mask_ptrs, blob_ptrs,
                off_ptrs, idx.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_longlong)),
                n_sel,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                cap,
                out_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
            if written >= 0:
                buf = out.tobytes()
                return [buf[out_offsets[r]:out_offsets[r + 1]]
                        for r in range(n_sel)]
            cap *= 4
        raise RuntimeError("native row encode: buffer growth failed")

    def encode_value_rows(self, datas, masks, types, indices) -> list:
        """Columnar buffers -> value-encoded bytes per selected row (the
        bytes of ``common/row.py``'s ``encode_value_row``)."""
        return self._encode(0, datas, masks, types, indices)

    def encode_keys(self, datas, masks, types, indices) -> list:
        """Columnar buffers -> memcomparable key bytes per selected row (the
        bytes of ``common/row.py``'s ``encode_key``)."""
        return self._encode(1, datas, masks, types, indices)
