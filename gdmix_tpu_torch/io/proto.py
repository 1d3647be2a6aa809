"""Minimal protobuf wire codec for tf.train.Example / SequenceExample.

Clean-room encoder/decoder for exactly the message shapes the reference's tf.data
pipelines parse (linkedin/gdmix:gdmix-trainer/src/gdmix/io/input_data_pipeline.py:
tf.io.parse_example / parse_sequence_example):

    message BytesList  { repeated bytes value = 1; }
    message FloatList  { repeated float value = 1 [packed = true]; }
    message Int64List  { repeated int64 value = 1 [packed = true]; }
    message Feature    { oneof { BytesList=1; FloatList=2; Int64List=3 } }
    message Features   { map<string, Feature> feature = 1; }
    message FeatureList  { repeated Feature feature = 1; }
    message FeatureLists { map<string, FeatureList> feature_list = 1; }
    message Example         { Features features = 1; }
    message SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }

Decoded form: a Feature is a python list of bytes / float / int. An Example decodes to
{name: list}. A SequenceExample decodes to (context: {name: list},
sequence: {name: list-of-lists}).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------

def _write_varint(n: int, out: bytearray) -> None:
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    shift = 0
    acc = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            return acc, pos
        shift += 7


def _key(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delimited(field: int, payload: bytes, out: bytearray) -> None:
    _write_varint(_key(field, _WIRE_LEN), out)
    _write_varint(len(payload), out)
    out += payload


def _skip(buf, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire == _WIRE_I64:
        return pos + 8
    if wire == _WIRE_LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire == _WIRE_I32:
        return pos + 4
    raise ValueError(f"Unsupported wire type {wire}")


# ---------------------------------------------------------------------------
# Feature encode/decode
# ---------------------------------------------------------------------------

def encode_feature(values: List[Any]) -> bytes:
    """Encode a list of values as a Feature message. Type inferred from elements."""
    out = bytearray()
    if not values:
        return bytes(out)
    v0 = values[0]
    inner = bytearray()
    if isinstance(v0, (bytes, bytearray, str)):
        for v in values:
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            _write_len_delimited(1, b, inner)
        _write_len_delimited(1, bytes(inner), out)  # bytes_list = field 1
    elif isinstance(v0, float):
        packed = struct.pack(f"<{len(values)}f", *values)
        _write_len_delimited(1, packed, inner)
        _write_len_delimited(2, bytes(inner), out)  # float_list = field 2
    elif isinstance(v0, (int,)):
        body = bytearray()
        for v in values:
            _write_varint(int(v), body)
        _write_len_delimited(1, bytes(body), inner)
        _write_len_delimited(3, bytes(inner), out)  # int64_list = field 3
    else:
        raise TypeError(f"Unsupported feature element type {type(v0)}")
    return bytes(out)


def _unsigned_to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def decode_feature(buf, start: int = 0, end: int = None) -> List[Any]:
    """Decode a Feature message into a python list."""
    end = len(buf) if end is None else end
    pos = start
    values: List[Any] = []
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire != _WIRE_LEN:
            pos = _skip(buf, pos, wire)
            continue
        n, pos = _read_varint(buf, pos)
        inner_end = pos + n
        if field == 1:  # BytesList
            p = pos
            while p < inner_end:
                t, p = _read_varint(buf, p)
                if t & 7 == _WIRE_LEN:
                    m, p = _read_varint(buf, p)
                    values.append(bytes(buf[p:p + m]))
                    p += m
                else:
                    p = _skip(buf, p, t & 7)
        elif field == 2:  # FloatList
            p = pos
            while p < inner_end:
                t, p = _read_varint(buf, p)
                if t >> 3 == 1 and t & 7 == _WIRE_LEN:  # packed
                    m, p = _read_varint(buf, p)
                    count = m // 4
                    values.extend(struct.unpack_from(f"<{count}f", buf, p))
                    p += m
                elif t >> 3 == 1 and t & 7 == _WIRE_I32:  # unpacked
                    values.append(struct.unpack_from("<f", buf, p)[0])
                    p += 4
                else:
                    p = _skip(buf, p, t & 7)
        elif field == 3:  # Int64List
            p = pos
            while p < inner_end:
                t, p = _read_varint(buf, p)
                if t >> 3 == 1 and t & 7 == _WIRE_LEN:  # packed
                    m, p = _read_varint(buf, p)
                    stop = p + m
                    while p < stop:
                        v, p = _read_varint(buf, p)
                        values.append(_unsigned_to_signed64(v))
                elif t >> 3 == 1 and t & 7 == _WIRE_VARINT:
                    v, p = _read_varint(buf, p)
                    values.append(_unsigned_to_signed64(v))
                else:
                    p = _skip(buf, p, t & 7)
        pos = inner_end
    return values


# ---------------------------------------------------------------------------
# Features (map<string, Feature>)
# ---------------------------------------------------------------------------

def encode_features(features: Dict[str, List[Any]]) -> bytes:
    out = bytearray()
    for name, values in features.items():
        entry = bytearray()
        _write_len_delimited(1, name.encode("utf-8"), entry)   # key
        _write_len_delimited(2, encode_feature(values), entry)  # value
        _write_len_delimited(1, bytes(entry), out)              # map entry
    return bytes(out)


def decode_features(buf, start: int = 0, end: int = None) -> Dict[str, List[Any]]:
    end = len(buf) if end is None else end
    pos = start
    result: Dict[str, List[Any]] = {}
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        if tag != _key(1, _WIRE_LEN):
            pos = _skip(buf, pos, tag & 7)
            continue
        n, pos = _read_varint(buf, pos)
        entry_end = pos + n
        key = None
        value: List[Any] = []
        p = pos
        while p < entry_end:
            t, p = _read_varint(buf, p)
            m, p = _read_varint(buf, p)
            if t >> 3 == 1:
                key = bytes(buf[p:p + m]).decode("utf-8")
            elif t >> 3 == 2:
                value = decode_feature(buf, p, p + m)
            p += m
        if key is not None:
            result[key] = value
        pos = entry_end
    return result


# ---------------------------------------------------------------------------
# Example
# ---------------------------------------------------------------------------

def encode_example(features: Dict[str, List[Any]]) -> bytes:
    out = bytearray()
    _write_len_delimited(1, encode_features(features), out)
    return bytes(out)


def decode_example(payload: bytes) -> Dict[str, List[Any]]:
    buf = memoryview(payload)
    pos = 0
    result: Dict[str, List[Any]] = {}
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag == _key(1, _WIRE_LEN):
            n, pos = _read_varint(buf, pos)
            result = decode_features(buf, pos, pos + n)
            pos += n
        else:
            pos = _skip(buf, pos, tag & 7)
    return result


# ---------------------------------------------------------------------------
# SequenceExample
# ---------------------------------------------------------------------------

def encode_sequence_example(context: Dict[str, List[Any]],
                            sequence: Dict[str, List[List[Any]]]) -> bytes:
    out = bytearray()
    _write_len_delimited(1, encode_features(context), out)
    lists = bytearray()
    for name, rows in sequence.items():
        fl = bytearray()
        for row in rows:
            _write_len_delimited(1, encode_feature(row), fl)  # FeatureList.feature
        entry = bytearray()
        _write_len_delimited(1, name.encode("utf-8"), entry)
        _write_len_delimited(2, bytes(fl), entry)
        _write_len_delimited(1, bytes(entry), lists)  # map entry
    _write_len_delimited(2, bytes(lists), out)
    return bytes(out)


def _decode_feature_list(buf, start: int, end: int) -> List[List[Any]]:
    rows: List[List[Any]] = []
    pos = start
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        if tag == _key(1, _WIRE_LEN):
            n, pos = _read_varint(buf, pos)
            rows.append(decode_feature(buf, pos, pos + n))
            pos += n
        else:
            pos = _skip(buf, pos, tag & 7)
    return rows


def decode_sequence_example(payload: bytes) -> Tuple[Dict[str, List[Any]],
                                                     Dict[str, List[List[Any]]]]:
    buf = memoryview(payload)
    pos = 0
    context: Dict[str, List[Any]] = {}
    sequence: Dict[str, List[List[Any]]] = {}
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag == _key(1, _WIRE_LEN):
            n, pos = _read_varint(buf, pos)
            context = decode_features(buf, pos, pos + n)
            pos += n
        elif tag == _key(2, _WIRE_LEN):
            n, pos = _read_varint(buf, pos)
            lists_end = pos + n
            p = pos
            while p < lists_end:
                t, p = _read_varint(buf, p)
                if t != _key(1, _WIRE_LEN):
                    p = _skip(buf, p, t & 7)
                    continue
                m, p = _read_varint(buf, p)
                entry_end = p + m
                key = None
                rows: List[List[Any]] = []
                q = p
                while q < entry_end:
                    t2, q = _read_varint(buf, q)
                    m2, q = _read_varint(buf, q)
                    if t2 >> 3 == 1:
                        key = bytes(buf[q:q + m2]).decode("utf-8")
                    elif t2 >> 3 == 2:
                        rows = _decode_feature_list(buf, q, q + m2)
                    q += m2
                if key is not None:
                    sequence[key] = rows
                p = entry_end
            pos = lists_end
        else:
            pos = _skip(buf, pos, tag & 7)
    return context, sequence
