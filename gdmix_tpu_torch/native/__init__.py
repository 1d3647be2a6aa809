"""Native (C++) acceleration for the host-side data path.

Loads libgdmix_io.so (built from tfrecord_io.cc) via ctypes; builds it with g++
on first use if missing. Falls back to the pure-Python codecs transparently —
`available()` reports which path is active.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# The C++ sources are this package's own copies of the JAX package's,
# beside this file; the libraries build into the checkout's build/ tree.
_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_SRC_DIR))
_DIR = os.path.join(_ROOT, "build", "gdmix_tpu_torch", "native")
_SO = os.path.join(_DIR, "libgdmix_io.so")
_SRC = os.path.join(_SRC_DIR, "tfrecord_io.cc")

_lib = None
_tried = False


def _gxx(args: List[str], so: str) -> None:
    """g++ into a per-process name, then an atomic rename: processes that
    share the build directory never load a half-written library."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++"] + args + ["-o", tmp],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)


def _build() -> bool:
    try:
        _gxx(["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC], _SO)
        return True
    except Exception as e:  # pragma: no cover - toolchain-dependent
        logger.info("native build failed (%s); using pure-python IO", e)
        return False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or \
            os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as e:  # pragma: no cover
        logger.info("native load failed (%s); using pure-python IO", e)
        return None
    lib.gdx_parse.restype = ctypes.c_void_p
    lib.gdx_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                              ctypes.c_char_p, ctypes.c_char_p]
    lib.gdx_num_records.restype = ctypes.c_int64
    lib.gdx_num_records.argtypes = [ctypes.c_void_p]
    lib.gdx_max_nnz.restype = ctypes.c_int32
    lib.gdx_max_nnz.argtypes = [ctypes.c_void_p]
    lib.gdx_fill_dense.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.gdx_fill_dense_i64.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.gdx_fill_sparse.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    lib.gdx_free.argtypes = [ctypes.c_void_p]
    lib.gdx_seq_parse.restype = ctypes.c_void_p
    lib.gdx_seq_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    for fn in ("gdx_seq_num_entities", "gdx_seq_total_records",
               "gdx_seq_id_bytes"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("gdx_seq_max_nnz", "gdx_seq_has_unknown_context"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.gdx_seq_fill_meta.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    lib.gdx_seq_fill_ctx.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.gdx_seq_fill_ctx_i64.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.gdx_seq_fill_sparse.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    lib.gdx_seq_free.argtypes = [ctypes.c_void_p]
    _PU8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.gdx_seq_write.restype = ctypes.c_int64
    lib.gdx_seq_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,  # ids i/b/off
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,   # entity, counts, E
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_char_p, ctypes.c_char_p,                   # idx/val names
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # sp idx/val/nnz
        ctypes.c_int32, _PU8, ctypes.c_int64]
    lib.gdx_rec_write.restype = ctypes.c_int64
    lib.gdx_rec_write.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int64, _PU8, ctypes.c_int64]
    _lib = lib
    return _lib


def _col_pointers(col_names, col_arrays):
    """(names_arr, types, fptrs, iptrs, kept_arrays) for the native writers."""
    ncols = len(col_names)
    names_arr = (ctypes.c_char_p * max(ncols, 1))(
        *[n.encode() for n in col_names] or [b""])
    types = bytearray()
    fptrs = (ctypes.POINTER(ctypes.c_double) * max(ncols, 1))()
    iptrs = (ctypes.POINTER(ctypes.c_int64) * max(ncols, 1))()
    kept = []
    for i, arr in enumerate(col_arrays):
        if arr.dtype.kind in "iu":
            a = np.ascontiguousarray(arr, np.int64)
            iptrs[i] = a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            types.append(ord("i"))
        else:
            a = np.ascontiguousarray(arr, np.float64)
            fptrs[i] = a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            types.append(ord("f"))
        kept.append(a)
    return names_arr, bytes(types), fptrs, iptrs, kept


def encode_grouped_records(entity_ids, entity_as_bytes: bool,
                           entity_name: str, counts, col_names, col_arrays,
                           idx_name, val_name, sp_idx, sp_val, rec_nnz):
    """Encode grouped SequenceExample TFRecords (framed, crc'd) from columnar
    arrays; returns the file bytes or None → python fallback."""
    lib = _load()
    if lib is None:
        return None
    E = len(counts)
    counts = np.ascontiguousarray(counts, np.int64)
    N = int(counts.sum())
    if entity_as_bytes:
        blobs = [str(e).encode("utf-8") for e in entity_ids]
        id_off = np.zeros(E + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=id_off[1:])
        id_bytes = b"".join(blobs)
        ids_i = None
        id_extra = len(id_bytes)
    else:
        ids_i = np.ascontiguousarray(
            [int(e) for e in entity_ids], np.int64) if E else \
            np.zeros(0, np.int64)
        id_bytes = id_off = None
        id_extra = 11 * E
    names_arr, types, fptrs, iptrs, kept = _col_pointers(col_names, col_arrays)
    if any(len(a) != N for a in kept):
        return None
    K = 0
    M = 0
    sp_i = sp_v = nnz = None
    if sp_idx is not None:
        sp_i = np.ascontiguousarray(sp_idx, np.int64)
        sp_v = np.ascontiguousarray(sp_val, np.float64)
        nnz = np.ascontiguousarray(rec_nnz, np.int32)
        K = sp_i.shape[1] if sp_i.ndim == 2 else 0
        # the C encoder trusts these invariants; violations (e.g. fewer
        # ragged rows than records) must fall back, not read out of bounds
        if (sp_i.shape != (N, K) or sp_v.shape != (N, K) or nnz.shape != (N,)
                or (N and (nnz.min() < 0 or nnz.max() > K))):
            return None
        M = int(nnz.sum())
    per_col = sum(len(c) + 48 for c in col_names)
    cap = (E * (128 + len(entity_name)
                + per_col + 2 * (len(idx_name or "") + len(val_name or "") + 64))
           + id_extra
           + N * (sum(11 if t == ord("i") else 5 for t in types) + 32)
           + M * 15 + 4096)
    out = np.empty(cap, np.uint8)
    written = lib.gdx_seq_write(
        None if ids_i is None else ids_i.ctypes.data_as(ctypes.c_void_p),
        id_bytes, None if id_off is None else
        id_off.ctypes.data_as(ctypes.c_void_p),
        entity_name.encode(), counts.ctypes.data_as(ctypes.c_void_p), E,
        names_arr, types, len(col_names), fptrs, iptrs,
        (idx_name or "").encode() or None, (val_name or "").encode() or None,
        None if sp_i is None else sp_i.ctypes.data_as(ctypes.c_void_p),
        None if sp_v is None else sp_v.ctypes.data_as(ctypes.c_void_p),
        None if nnz is None else nnz.ctypes.data_as(ctypes.c_void_p),
        K, out, cap)
    if written < 0:
        logger.info("native grouped encode overflow; python fallback")
        return None
    return out[:written].tobytes()


def encode_per_record(col_names, col_arrays, idx_name, val_name,
                      sp_idx, sp_val, rec_nnz, n_records: int):
    """Encode per-record Example TFRecords from columnar arrays; returns file
    bytes or None → python fallback."""
    lib = _load()
    if lib is None:
        return None
    names_arr, types, fptrs, iptrs, kept = _col_pointers(col_names, col_arrays)
    N = n_records
    if any(len(a) != N for a in kept):
        return None
    K = 0
    M = 0
    sp_i = sp_v = nnz = None
    if sp_idx is not None:
        sp_i = np.ascontiguousarray(sp_idx, np.int64)
        sp_v = np.ascontiguousarray(sp_val, np.float64)
        nnz = np.ascontiguousarray(rec_nnz, np.int32)
        K = sp_i.shape[1] if sp_i.ndim == 2 else 0
        if (sp_i.shape != (N, K) or sp_v.shape != (N, K) or nnz.shape != (N,)
                or (N and (nnz.min() < 0 or nnz.max() > K))):
            return None
        M = int(nnz.sum())
    per_col = sum(len(c) + 48 for c in col_names)
    cap = (N * (64 + per_col
                + sum(11 if t == ord("i") else 5 for t in types)
                + 2 * (len(idx_name or "") + len(val_name or "") + 64))
           + M * 15 + 4096)
    out = np.empty(cap, np.uint8)
    written = lib.gdx_rec_write(
        None, names_arr, types, len(col_names), fptrs, iptrs,
        (idx_name or "").encode() or None, (val_name or "").encode() or None,
        None if sp_i is None else sp_i.ctypes.data_as(ctypes.c_void_p),
        None if sp_v is None else sp_v.ctypes.data_as(ctypes.c_void_p),
        None if nnz is None else nnz.ctypes.data_as(ctypes.c_void_p),
        K, N, out, cap)
    if written < 0:
        logger.info("native per-record encode overflow; python fallback")
        return None
    return out[:written].tobytes()


def available() -> bool:
    return _load() is not None


def parse_per_record(buf: bytes, dense_names: List[str],
                     feature_bag: Optional[str], align: int = 8,
                     int_names: Optional[List[str]] = None
                     ) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                                         Optional[np.ndarray], Optional[np.ndarray],
                                         Optional[np.ndarray]]]:
    """Decode an in-memory TFRecord buffer.

    Returns (dense_columns, present_flags, indices[N,K], values[N,K], nnz[N]) or
    None if the native path is unavailable/failed. Columns named in int_names
    come back as exact int64; the rest as float64.
    """
    int_names = set(int_names or ())
    lib = _load()
    if lib is None:
        return None
    names_arr = (ctypes.c_char_p * len(dense_names))(
        *[n.encode() for n in dense_names])
    idx_name = f"{feature_bag}_indices".encode() if feature_bag else b""
    val_name = f"{feature_bag}_values".encode() if feature_bag else b""
    h = lib.gdx_parse(buf, len(buf), names_arr, len(dense_names),
                      idx_name, val_name)
    if not h:
        return None
    try:
        n = lib.gdx_num_records(h)
        dense: Dict[str, np.ndarray] = {}
        present: Dict[str, np.ndarray] = {}
        for i, name in enumerate(dense_names):
            flags = np.zeros(n, np.uint8)
            if name in int_names:
                out = np.zeros(n, np.int64)
                if n:
                    lib.gdx_fill_dense_i64(h, i, out, flags)
            else:
                out = np.zeros(n, np.float64)
                if n:
                    lib.gdx_fill_dense(h, i, out, flags)
            dense[name] = out
            present[name] = flags
        indices = values = nnz = None
        if feature_bag:
            k = max(int(lib.gdx_max_nnz(h)), 1)
            k = ((k + align - 1) // align) * align
            indices = np.zeros((n, k), np.int64)
            values = np.zeros((n, k), np.float64)
            nnz = np.zeros(n, np.int32)
            if n:
                lib.gdx_fill_sparse(h, k, indices, values, nnz)
        return dense, present, indices, values, nnz
    finally:
        lib.gdx_free(h)


def parse_per_entity_grouped(buf: bytes, ctx_names: List[str],
                             entity_name: str, feature_bag: Optional[str],
                             int_names: Optional[List[str]] = None,
                             align: int = 8):
    """Decode an in-memory TFRecord buffer of grouped SequenceExamples into
    COLUMNAR arrays (≡ TF's C++ parse_sequence_example kernel for the schema
    the framework uses, reference input_data_pipeline.py:223-332).

    Returns (entity_ids, counts[E], ctx {name: flat [total]}, ctx_present
    {name: [E]}, indices [total,K], values [total,K], nnz [total]) or None if
    the native path is unavailable, parse failed, or the record carries context
    columns outside `ctx_names` (caller falls back to the python codec so no
    column is silently dropped).
    """
    int_names = set(int_names or ())
    lib = _load()
    if lib is None:
        return None
    names_arr = (ctypes.c_char_p * max(len(ctx_names), 1))(
        *[n.encode() for n in ctx_names] or [b""])
    idx_name = f"{feature_bag}_indices".encode() if feature_bag else b""
    val_name = f"{feature_bag}_values".encode() if feature_bag else b""
    h = lib.gdx_seq_parse(buf, len(buf), names_arr, len(ctx_names),
                          entity_name.encode(), idx_name, val_name)
    if not h:
        return None
    try:
        if lib.gdx_seq_has_unknown_context(h):
            return None
        e = lib.gdx_seq_num_entities(h)
        total = lib.gdx_seq_total_records(h)
        counts = np.zeros(e, np.int32)
        id_buf = ctypes.create_string_buffer(int(lib.gdx_seq_id_bytes(h)) + 1)
        id_offs = np.zeros(e + 1, np.int64)
        if e:
            lib.gdx_seq_fill_meta(h, counts, id_buf, id_offs)
        raw = id_buf.raw
        try:
            entity_ids = [raw[id_offs[i]:id_offs[i + 1]].decode("utf-8")
                          for i in range(e)]
        except UnicodeDecodeError:  # corrupt ids → python path's own error
            return None
        ctx: Dict[str, np.ndarray] = {}
        ctx_present: Dict[str, np.ndarray] = {}
        for i, name in enumerate(ctx_names):
            flags = np.zeros(e, np.uint8)
            if name in int_names:
                out = np.zeros(total, np.int64)
                if e:
                    lib.gdx_seq_fill_ctx_i64(h, i, out, flags)
            else:
                out = np.zeros(total, np.float64)
                if e:
                    lib.gdx_seq_fill_ctx(h, i, out, flags)
            ctx[name] = out
            ctx_present[name] = flags
        indices = values = nnz = None
        if feature_bag:
            k = max(int(lib.gdx_seq_max_nnz(h)), 1)
            k = ((k + align - 1) // align) * align
            indices = np.zeros((total, k), np.int64)
            values = np.zeros((total, k), np.float64)
            nnz = np.zeros(total, np.int32)
            if e:
                lib.gdx_seq_fill_sparse(h, k, indices, values, nnz)
        return entity_ids, counts, ctx, ctx_present, indices, values, nnz
    finally:
        lib.gdx_seq_free(h)


# ---------------------------------------------------------------------------
# Native Avro flat-record decoder (score files)
# ---------------------------------------------------------------------------

_AVRO_SO = os.path.join(_DIR, "libgdmix_avro.so")
_AVRO_SRC = os.path.join(_SRC_DIR, "avro_io.cc")
_avro_lib = None
_avro_tried = False

_PRIM_CODE = {"long": "L", "int": "I", "float": "F", "double": "D",
              "boolean": "B", "string": "S", "bytes": "S"}


def _load_avro():
    global _avro_lib, _avro_tried
    if _avro_lib is not None or _avro_tried:
        return _avro_lib
    _avro_tried = True
    if not os.path.exists(_AVRO_SO) or \
            os.path.getmtime(_AVRO_SO) < os.path.getmtime(_AVRO_SRC):
        try:
            _gxx(["-O3", "-shared", "-fPIC", "-std=c++17", _AVRO_SRC, "-lz"],
                 _AVRO_SO)
        except Exception as e:  # pragma: no cover
            logger.info("native avro build failed (%s)", e)
            return None
    try:
        lib = ctypes.CDLL(_AVRO_SO)
    except OSError as e:  # pragma: no cover
        logger.info("native avro load failed (%s)", e)
        return None
    lib.gdx_avro_parse.restype = ctypes.c_void_p
    lib.gdx_avro_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_char_p, ctypes.c_char_p]
    lib.gdx_avro_num_records.restype = ctypes.c_int64
    lib.gdx_avro_num_records.argtypes = [ctypes.c_void_p]
    lib.gdx_avro_fill_f64.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.gdx_avro_fill_i64.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.gdx_avro_free.argtypes = [ctypes.c_void_p]
    lib.gdx_avro_encode.restype = ctypes.c_int64
    lib.gdx_avro_encode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64]
    _I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    _F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    _U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.gdx_model_encode.restype = ctypes.c_int64
    lib.gdx_model_encode.argtypes = [
        ctypes.c_char_p, _I64,                       # id bytes/offs
        ctypes.c_char_p, _I64,                       # ntv table/offs
        ctypes.c_char_p, ctypes.c_int64,             # intercept blob
        ctypes.c_char_p, ctypes.c_int64,             # modelClass blob
        ctypes.c_char_p, ctypes.c_int64,             # lossFunction blob
        ctypes.c_void_p, ctypes.c_void_p,            # coef ids / vals
        ctypes.c_void_p, ctypes.c_void_p,            # coef vars / model offs
        ctypes.c_void_p, ctypes.c_void_p,            # icpt vals / vars
        ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
        _U8, ctypes.c_int64]
    lib.gdx_model_parse.restype = ctypes.c_void_p
    lib.gdx_model_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, _I64,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    for fn in ("gdx_model_num", "gdx_model_total_means",
               "gdx_model_id_bytes_len"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.gdx_model_fill.argtypes = [ctypes.c_void_p, _U8, _I64, _I64, _I64,
                                   _F64, _F64, _U8]
    lib.gdx_model_free.argtypes = [ctypes.c_void_p]
    _avro_lib = lib
    return _avro_lib


def _field_codes(schema: dict):
    """(codes, union_subs, returned field names + dtypes) or None if the
    schema is not a flat primitive record the native decoder handles."""
    if not isinstance(schema, dict) or schema.get("type") != "record":
        return None
    codes = []
    subs = []
    names = []
    fields = schema.get("fields", [])
    if not isinstance(fields, list):
        return None
    for f in fields:
        if not isinstance(f, dict) or "type" not in f or "name" not in f:
            return None
        t = f["type"]
        if isinstance(t, str) and t in _PRIM_CODE:
            codes.append(_PRIM_CODE[t])
            subs.append("-")
            if _PRIM_CODE[t] != "S":
                names.append((f["name"], _PRIM_CODE[t]))
        elif (isinstance(t, list) and len(t) == 2 and t[0] == "null"
              and isinstance(t[1], str) and t[1] in _PRIM_CODE
              and _PRIM_CODE[t[1]] != "S"):
            codes.append("U")
            subs.append(_PRIM_CODE[t[1]])
            names.append((f["name"], _PRIM_CODE[t[1]]))
        else:
            return None
    return "".join(codes), "".join(subs), names


_MAX_FIELD_BYTES = {"L": 11, "I": 11, "D": 9, "F": 5, "B": 2}  # incl. branch


def encode_avro_column_blocks(schema: dict, columns: Dict[str, np.ndarray],
                              present: Optional[Dict[str, np.ndarray]] = None,
                              block_records: int = 65536):
    """Encode parallel column arrays into Avro block payloads.

    Yields (record_count, payload_bytes) per OCF block; the caller frames them
    into a container (avro.write_encoded_blocks). Returns None if the native
    library is unavailable or the schema isn't flat primitives — callers fall
    back to the per-record Python datum writer. `present` maps nullable-union
    field names to uint8 masks (0 → null branch); omitted names write the
    value branch for every row.
    """
    lib = _load_avro()
    if lib is None:
        return None
    fc = _field_codes(schema)
    if fc is None or "S" in fc[0]:
        return None
    codes, subs, names = fc
    if len(names) != len(codes):  # a skipped field can't be re-encoded
        return None
    cols = []
    for (name, code), top in zip(names, codes):
        arr = np.ascontiguousarray(
            columns[name],
            dtype=np.int64 if code in "LIB" else np.float64)
        mask = (present or {}).get(name)
        if mask is not None:
            mask = np.ascontiguousarray(mask, dtype=np.uint8)
        cols.append((code, top == "U", arr, mask))
    n = len(cols[0][2])
    if any(len(a) != n for _, _, a, _ in cols):
        raise ValueError("score columns must have equal length")

    ncols = len(cols)
    code_str = "".join(c for c, _, _, _ in cols).encode()
    nullable = (ctypes.c_uint8 * ncols)(*[int(u) for _, u, _, _ in cols])
    ip = (ctypes.POINTER(ctypes.c_int64) * ncols)()
    dp = (ctypes.POINTER(ctypes.c_double) * ncols)()
    pp = (ctypes.POINTER(ctypes.c_uint8) * ncols)()
    for i, (code, _, arr, mask) in enumerate(cols):
        if code in "LIB":
            ip[i] = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        else:
            dp[i] = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if mask is not None:
            pp[i] = mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rec_bytes = sum(_MAX_FIELD_BYTES[c] for c, _, _, _ in cols)

    def gen(cols=cols):
        # ip/dp/pp point into cols' arrays, some of them converted copies:
        # the generator holds them until its last block is encoded
        out = np.empty(block_records * rec_bytes, np.uint8)
        for start in range(0, n, block_records):
            count = min(block_records, n - start)
            written = lib.gdx_avro_encode(
                code_str, nullable, ncols, ip, dp, pp, start, count, out,
                out.nbytes)
            if written < 0:  # pragma: no cover - sizing bug guard
                raise RuntimeError("native avro encode overflow")
            yield count, out[:written].tobytes()

    return gen() if n else iter(())


# ---------------------------------------------------------------------------
# photon-ml Bayesian linear model codec (columnar fast paths for
# io/model_avro.py; reference pays per-record fastavro costs here,
# io_utils.py:45-213)
# ---------------------------------------------------------------------------

def _enc_str(s: str) -> bytes:
    b = s.encode("utf-8")
    out = bytearray()
    z = (len(b) << 1)
    while z >= 0x80:
        out.append((z & 0x7F) | 0x80)
        z >>= 7
    out.append(z)
    return bytes(out) + b


def _ntv_table(feature_list) -> Tuple[bytes, np.ndarray]:
    """Pre-encode every (name, term) pair once: varint(len)+name+varint(len)+term."""
    blocks = [_enc_str(name) + _enc_str(term) for name, term in feature_list]
    offs = np.zeros(len(blocks) + 1, np.int64)
    np.cumsum([len(b) for b in blocks], out=offs[1:])
    return b"".join(blocks), offs


_INTERCEPT_BLOB = _enc_str("(INTERCEPT)") + _enc_str("")


def encode_model_blocks(model_ids, feature_list, coef_ids, coef_vals,
                        coef_vars, model_offs, icpt_vals, icpt_vars,
                        model_class, threshold, block_models: int = 4096):
    """Encode photon-ml model records into OCF block payloads.

    Flat columnar inputs: coef_ids/coef_vals[/coef_vars] with model_offs [E+1]
    ranges (all None for intercept-only models); icpt_vals/icpt_vars [E] or
    None. Yields (count, payload) blocks. Returns None when the native lib is
    missing — callers fall back to the per-record writer.
    """
    lib = _load_avro()
    if lib is None:
        return None
    table, table_offs = _ntv_table(feature_list or [])
    id_blobs = [str(m).encode("utf-8") for m in model_ids]
    id_offs = np.zeros(len(id_blobs) + 1, np.int64)
    np.cumsum([len(b) for b in id_blobs], out=id_offs[1:])
    id_bytes = b"".join(id_blobs)
    mclass = (b"\x02" + _enc_str(model_class)
              if model_class is not None else b"\x00")
    loss = b"\x02" + _enc_str("")  # lossFunction = "" (gen_one_avro_model)
    E = len(id_blobs)

    def _ptr(arr, dt):
        if arr is None:
            return None
        a = np.ascontiguousarray(arr, dtype=dt)
        return a, a.ctypes.data_as(ctypes.c_void_p)

    ids_k = _ptr(coef_ids, np.int64)
    vals_k = _ptr(coef_vals, np.float64)
    vars_k = _ptr(coef_vars, np.float64)
    offs_k = _ptr(model_offs, np.int64)
    iv_k = _ptr(icpt_vals, np.float64)
    ivar_k = _ptr(icpt_vars, np.float64)

    def gen():
        for start in range(0, E, block_models):
            count = min(block_models, E - start)
            # exact-enough capacity: ids + fixed blobs + per-coef worst case
            lo = int(offs_k[0][start]) if offs_k else 0
            hi = int(offs_k[0][start + count]) if offs_k else 0
            max_blk = int(np.max(np.diff(table_offs))) + 9 if len(table_offs) > 1 else 9
            cap = (int(id_offs[start + count] - id_offs[start])
                   + count * (64 + len(mclass) + len(loss)
                              + 2 * (len(_INTERCEPT_BLOB) + 9 + 12))
                   + 2 * (hi - lo) * max_blk)
            out = np.empty(cap, np.uint8)
            written = lib.gdx_model_encode(
                id_bytes, id_offs, table, table_offs,
                _INTERCEPT_BLOB, len(_INTERCEPT_BLOB),
                mclass, len(mclass), loss, len(loss),
                ids_k[1] if ids_k else None, vals_k[1] if vals_k else None,
                vars_k[1] if vars_k else None, offs_k[1] if offs_k else None,
                iv_k[1] if iv_k else None, ivar_k[1] if ivar_k else None,
                float(threshold), start, count, out, cap)
            if written < 0:  # pragma: no cover - sizing bug guard
                raise RuntimeError("native model encode overflow")
            yield count, out[:written].tobytes()

    return gen() if E else iter(())


def parse_model_file(path: str, feature_list):
    """Decode a photon-ml model OCF into columnar arrays.

    Returns (model_ids, mean_offs [E+1], mean_ids, mean_vals, var_vals,
    var_present [E]) where mean_ids indexes feature_list, -1 = intercept,
    -2 = (name, term) not in feature_list. None → caller falls back (native
    lib missing, malformed/unsupported file, or variances misaligned with
    means — the python path raises the reference's assertion instead).
    """
    lib = _load_avro()
    if lib is None:
        return None
    table, table_offs = _ntv_table(feature_list or [])
    with open(path, "rb") as f:
        buf = f.read()
    h = lib.gdx_model_parse(buf, len(buf), table, table_offs,
                            len(feature_list or []), _INTERCEPT_BLOB,
                            len(_INTERCEPT_BLOB))
    if not h:
        return None
    try:
        e = lib.gdx_model_num(h)
        total = lib.gdx_model_total_means(h)
        id_bytes = np.zeros(max(lib.gdx_model_id_bytes_len(h), 1), np.uint8)
        id_offs = np.zeros(e + 1, np.int64)
        mean_offs = np.zeros(e + 1, np.int64)
        mean_ids = np.zeros(total, np.int64)
        mean_vals = np.zeros(total, np.float64)
        var_vals = np.zeros(total, np.float64)
        var_present = np.zeros(e, np.uint8)
        if e:
            lib.gdx_model_fill(h, id_bytes, id_offs, mean_offs, mean_ids,
                               mean_vals, var_vals, var_present)
        raw = id_bytes.tobytes()
        try:
            model_ids = [raw[id_offs[i]:id_offs[i + 1]].decode("utf-8")
                         for i in range(e)]
        except UnicodeDecodeError:  # corrupt file → per-record fallback
            return None
        return model_ids, mean_offs, mean_ids, mean_vals, var_vals, var_present
    finally:
        lib.gdx_model_free(h)


def read_avro_columns(path: str):
    """Decode a flat-primitive-record OCF into {name: array} (nullable fields
    carry NaN where absent). Returns None if unsupported → caller falls back."""
    lib = _load_avro()
    if lib is None:
        return None
    from gdmix_tpu_torch.io import avro as avro_py
    try:
        schema = avro_py.read_schema(path)
    except Exception:
        return None
    fc = _field_codes(schema)
    if fc is None:
        return None
    codes, subs, names = fc
    with open(path, "rb") as f:
        buf = f.read()
    h = lib.gdx_avro_parse(buf, len(buf), codes.encode(), subs.encode())
    if not h:
        return None
    try:
        n = lib.gdx_avro_num_records(h)
        out = {}
        for col, (name, code) in enumerate(names):
            present = np.zeros(n, np.uint8)
            if code in ("L", "I", "B"):
                arr = np.zeros(n, np.int64)
                if n:
                    lib.gdx_avro_fill_i64(h, col, arr, present)
                out[name] = arr
            else:
                arr = np.zeros(n, np.float64)
                if n:
                    lib.gdx_avro_fill_f64(h, col, arr, present)
                arr[present == 0] = np.nan
                out[name] = arr
        return out
    finally:
        lib.gdx_avro_free(h)


# ---------------------------------------------------------------------------
# Bucketize marshal kernels (bucketize_ops.cc): per-entity support extraction
# + local-index remap and per-tier solver-block scatter, multicore — the two
# loops that dominate the random-effect host marshal.
# ---------------------------------------------------------------------------

_BKT_SO = os.path.join(_DIR, "libgdmix_bucketize.so")
_BKT_SRC = os.path.join(_SRC_DIR, "bucketize_ops.cc")
_bkt_lib = None
_bkt_tried = False

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _load_bkt():
    global _bkt_lib, _bkt_tried
    if _bkt_lib is not None or _bkt_tried:
        return _bkt_lib
    _bkt_tried = True
    if not os.path.exists(_BKT_SO) or \
            os.path.getmtime(_BKT_SO) < os.path.getmtime(_BKT_SRC):
        try:
            _gxx(["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                  _BKT_SRC], _BKT_SO)
        except Exception as e:  # pragma: no cover
            logger.info("native bucketize build failed (%s)", e)
            return None
    try:
        lib = ctypes.CDLL(_BKT_SO)
    except OSError as e:  # pragma: no cover
        logger.info("native bucketize load failed (%s)", e)
        return None
    lib.gdx_entry_local.restype = ctypes.c_int64
    lib.gdx_entry_local.argtypes = [
        _i32p, _f64p, ctypes.c_void_p, _i64p, _i64p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        _i32p, _i64p, _i64p, _i64p, ctypes.c_int64]
    lib.gdx_scatter_entries.restype = None
    lib.gdx_scatter_entries.argtypes = [
        _i32p, _f64p, ctypes.c_void_p, _i32p, _i64p, _i64p, _i32p, _i64p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, _i32p, _f64p]
    lib.gdx_gather_column.restype = None
    lib.gdx_gather_column.argtypes = [
        ctypes.c_void_p, _i64p, _i64p, _i32p, _i64p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, _f64p]
    _bkt_lib = lib
    return lib


def bucketize_available() -> bool:
    return _load_bkt() is not None


def _nnz_ptr(nnz):
    if nnz is None:
        return None, None
    arr = np.ascontiguousarray(nnz, np.int32)
    return arr, arr.ctypes.data_as(ctypes.c_void_p)


def entry_local(indices, values, nnz, counts, rec_starts,
                use_value_mask=False):
    """Fused per-entity support extraction + per-entry local feature ids.

    Returns (local [N,K] int32, uniq_fid [U] int64 entity-major sorted,
    u_counts [E] int64, u_offs [E+1] int64), or None when the native library
    is unavailable. Liveness: nnz when given; else value != 0 when
    use_value_mask, else all K entries."""
    lib = _load_bkt()
    if lib is None:
        return None
    indices = np.ascontiguousarray(indices, np.int32)
    values = np.ascontiguousarray(values, np.float64)
    counts = np.ascontiguousarray(counts, np.int64)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    n, k = indices.shape
    e = len(counts)
    nnz_arr, nnz_p = _nnz_ptr(nnz)
    cap_u = max(int(nnz_arr.sum()) if nnz_arr is not None else n * k, 1)
    local = np.zeros((n, k), np.int32)
    uniq = np.empty(cap_u, np.int64)
    u_counts = np.zeros(e, np.int64)
    u_offs = np.zeros(e + 1, np.int64)
    u = lib.gdx_entry_local(indices, values, nnz_p, counts, rec_starts,
                            n, k, e, int(use_value_mask), local, uniq,
                            u_counts, u_offs, cap_u)
    if u < 0:  # pragma: no cover - cap_u is always sufficient
        return None
    return local, uniq[:u].copy(), u_counts, u_offs


def scatter_entries(indices, values, nnz, local, ent_of_rec, rec_starts,
                    tier_of_ent, slot_of_ent, t, out_idx, out_val,
                    use_value_mask=False):
    """Per-tier [b, n_cap, k] block scatter of live entries (out arrays are
    caller-zeroed). Returns False when the native library is unavailable."""
    lib = _load_bkt()
    if lib is None:
        return False
    indices = np.ascontiguousarray(indices, np.int32)
    values = np.ascontiguousarray(values, np.float64)
    n, k_in = indices.shape
    nnz_arr, nnz_p = _nnz_ptr(nnz)
    lib.gdx_scatter_entries(
        indices, values, nnz_p, np.ascontiguousarray(local, np.int32),
        np.ascontiguousarray(ent_of_rec, np.int64),
        np.ascontiguousarray(rec_starts, np.int64),
        np.ascontiguousarray(tier_of_ent, np.int32),
        np.ascontiguousarray(slot_of_ent, np.int64),
        n, k_in, int(use_value_mask), int(t),
        out_idx.shape[1], out_idx.shape[2], out_idx, out_val)
    return True


def gather_column(col, ent_of_rec, rec_starts, tier_of_ent, slot_of_ent, t,
                  out):
    """Per-tier [b, n_cap] scalar-column gather (col=None fills 1.0 at live
    cells). Returns False when the native library is unavailable."""
    lib = _load_bkt()
    if lib is None:
        return False
    col_p = None
    if col is not None:
        col = np.ascontiguousarray(col, np.float64)
        col_p = col.ctypes.data_as(ctypes.c_void_p)
    lib.gdx_gather_column(
        col_p, np.ascontiguousarray(ent_of_rec, np.int64),
        np.ascontiguousarray(rec_starts, np.int64),
        np.ascontiguousarray(tier_of_ent, np.int32),
        np.ascontiguousarray(slot_of_ent, np.int64),
        len(ent_of_rec), int(t), out.shape[1], out)
    return True
