"""Clean-room Avro Object Container File (OCF) codec.

The reference uses fastavro for photon-ml model files and score files
(linkedin/gdmix:gdmix-trainer/src/gdmix/util/io_utils.py:23-43). fastavro is not
available here, and our IO layer should not depend on the JVM or TF, so this module
implements the subset of the Avro 1.x spec the framework needs:

  * primitives: null, boolean, int, long, float, double, bytes, string
  * complex: record, enum, array, map, union, fixed, named-type references
  * container files with "null" and "deflate" codecs

Schemas are plain JSON dicts (same dialect as the reference's
BayesianLinearModelAvro in linkedin/gdmix:gdmix-trainer/src/gdmix/models/schemas.py).
"""
from __future__ import annotations

import json
import os
import struct
import zlib

from gdmix_tpu_torch.io import fs
from typing import Any, Dict, Iterable, Iterator, List, Tuple, Union

MAGIC = b"Obj\x01"
SYNC_SIZE = 16
DEFAULT_SYNC = b"\x9aGDMIX-TPU-sync\x9b"[:16].ljust(16, b"\x00")

SchemaType = Union[str, dict, list]

_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes", "string"}


# ---------------------------------------------------------------------------
# zig-zag varint encoding (Avro "long"/"int")
# ---------------------------------------------------------------------------

def _encode_long(n: int, out: bytearray) -> None:
    # zigzag(n) = (n << 1) ^ (n >> 63) for two's-complement 64-bit n.
    n = ((n << 1) ^ (n >> 63)) & ((1 << 64) - 1)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _decode_long(buf: memoryview, pos: int) -> Tuple[int, int]:
    shift = 0
    acc = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    # un-zigzag
    return (acc >> 1) ^ -(acc & 1), pos


# ---------------------------------------------------------------------------
# Schema resolution
# ---------------------------------------------------------------------------

class _Names:
    """Registry of named types (records/enums/fixed) for reference resolution."""

    def __init__(self):
        self.named: Dict[str, dict] = {}

    def register(self, schema: dict) -> None:
        name = schema.get("name")
        if name:
            ns = schema.get("namespace")
            self.named[name] = schema
            if ns:
                self.named[f"{ns}.{name}"] = schema

    def resolve(self, schema: SchemaType) -> SchemaType:
        if isinstance(schema, str) and schema not in _PRIMITIVES:
            if schema not in self.named:
                raise ValueError(f"Unknown named type {schema!r}")
            return self.named[schema]
        return schema


def parse_schema(schema: Union[str, SchemaType]) -> Tuple[SchemaType, _Names]:
    """Parse a schema (JSON string or dict) and build the named-type registry."""
    if isinstance(schema, str) and (schema.lstrip()[:1] in "{[" or '"' in schema):
        schema = json.loads(schema)
    names = _Names()

    def walk(s: SchemaType) -> None:
        if isinstance(s, dict):
            t = s.get("type")
            if t in ("record", "error"):
                names.register(s)
                for f in s.get("fields", []):
                    walk(f["type"])
            elif t in ("enum", "fixed"):
                names.register(s)
            elif t == "array":
                walk(s["items"])
            elif t == "map":
                walk(s["values"])
            else:
                walk(t)
        elif isinstance(s, list):
            for branch in s:
                walk(branch)

    walk(schema)
    return schema, names


# ---------------------------------------------------------------------------
# Datum writer
# ---------------------------------------------------------------------------

def _write_datum(datum: Any, schema: SchemaType, names: _Names, out: bytearray) -> None:
    schema = names.resolve(schema)
    if isinstance(schema, str):
        t = schema
    elif isinstance(schema, list):
        _write_union(datum, schema, names, out)
        return
    else:
        t = schema["type"]
        if isinstance(t, list):
            _write_union(datum, t, names, out)
            return

    if t == "null":
        return
    if t == "boolean":
        out.append(1 if datum else 0)
    elif t in ("int", "long"):
        _encode_long(int(datum), out)
    elif t == "float":
        out += struct.pack("<f", float(datum))
    elif t == "double":
        out += struct.pack("<d", float(datum))
    elif t == "bytes":
        b = bytes(datum)
        _encode_long(len(b), out)
        out += b
    elif t == "string":
        b = datum.encode("utf-8") if isinstance(datum, str) else bytes(datum)
        _encode_long(len(b), out)
        out += b
    elif t == "fixed":
        out += bytes(datum)
    elif t == "enum":
        _encode_long(schema["symbols"].index(datum), out)
    elif t == "record":
        for f in schema["fields"]:
            name = f["name"]
            if name in datum:
                value = datum[name]
            elif "default" in f:
                value = f["default"]
            else:
                raise ValueError(f"Missing field {name!r} with no default")
            _write_datum(value, f["type"], names, out)
    elif t == "array":
        items = list(datum)
        if items:
            _encode_long(len(items), out)
            for item in items:
                _write_datum(item, schema["items"], names, out)
        _encode_long(0, out)
    elif t == "map":
        entries = dict(datum)
        if entries:
            _encode_long(len(entries), out)
            for k, v in entries.items():
                kb = k.encode("utf-8")
                _encode_long(len(kb), out)
                out += kb
                _write_datum(v, schema["values"], names, out)
        _encode_long(0, out)
    else:
        raise ValueError(f"Unsupported schema type {t!r}")


def _branch_matches(datum: Any, branch: SchemaType, names: _Names) -> bool:
    branch = names.resolve(branch)
    t = branch if isinstance(branch, str) else branch.get("type")
    if t == "null":
        return datum is None
    if datum is None:
        return False
    if t == "boolean":
        return isinstance(datum, bool)
    if t in ("int", "long"):
        return isinstance(datum, int) and not isinstance(datum, bool)
    if t in ("float", "double"):
        return isinstance(datum, (int, float)) and not isinstance(datum, bool)
    if t in ("bytes", "fixed"):
        return isinstance(datum, (bytes, bytearray))
    if t in ("string", "enum"):
        return isinstance(datum, str)
    if t == "record":
        return isinstance(datum, dict)
    if t == "array":
        return isinstance(datum, (list, tuple))
    if t == "map":
        return isinstance(datum, dict)
    return False


def _write_union(datum: Any, branches: list, names: _Names, out: bytearray) -> None:
    for idx, branch in enumerate(branches):
        if _branch_matches(datum, branch, names):
            _encode_long(idx, out)
            _write_datum(datum, branch, names, out)
            return
    raise ValueError(f"Datum {datum!r} does not match any union branch {branches!r}")


# ---------------------------------------------------------------------------
# Datum reader
# ---------------------------------------------------------------------------

def _read_datum(buf: memoryview, pos: int, schema: SchemaType, names: _Names) -> Tuple[Any, int]:
    schema = names.resolve(schema)
    if isinstance(schema, list):
        idx, pos = _decode_long(buf, pos)
        return _read_datum(buf, pos, schema[idx], names)
    if isinstance(schema, str):
        t = schema
    else:
        t = schema["type"]
        if isinstance(t, list):
            idx, pos = _decode_long(buf, pos)
            return _read_datum(buf, pos, t[idx], names)

    if t == "null":
        return None, pos
    if t == "boolean":
        return buf[pos] != 0, pos + 1
    if t in ("int", "long"):
        return _decode_long(buf, pos)
    if t == "float":
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if t == "double":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if t in ("bytes",):
        n, pos = _decode_long(buf, pos)
        if n < 0 or pos + n > len(buf):
            raise ValueError("Corrupt Avro datum (bad bytes length)")
        return bytes(buf[pos:pos + n]), pos + n
    if t == "string":
        n, pos = _decode_long(buf, pos)
        if n < 0 or pos + n > len(buf):
            raise ValueError("Corrupt Avro datum (bad string length)")
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if t == "fixed":
        n = schema["size"]
        return bytes(buf[pos:pos + n]), pos + n
    if t == "enum":
        idx, pos = _decode_long(buf, pos)
        return schema["symbols"][idx], pos
    if t == "record":
        rec = {}
        for f in schema["fields"]:
            rec[f["name"]], pos = _read_datum(buf, pos, f["type"], names)
        return rec, pos
    if t == "array":
        items: List[Any] = []
        while True:
            count, pos = _decode_long(buf, pos)
            if count == 0:
                break
            if count < 0:
                count = -count
                _, pos = _decode_long(buf, pos)  # skip byte size
            for _ in range(count):
                item, pos = _read_datum(buf, pos, schema["items"], names)
                items.append(item)
        return items, pos
    if t == "map":
        entries: Dict[str, Any] = {}
        while True:
            count, pos = _decode_long(buf, pos)
            if count == 0:
                break
            if count < 0:
                count = -count
                _, pos = _decode_long(buf, pos)
            for _ in range(count):
                n, pos = _decode_long(buf, pos)
                key = bytes(buf[pos:pos + n]).decode("utf-8")
                pos += n
                entries[key], pos = _read_datum(buf, pos, schema["values"], names)
        return entries, pos
    raise ValueError(f"Unsupported schema type {t!r}")


# ---------------------------------------------------------------------------
# Container files
# ---------------------------------------------------------------------------

def write_records(path_or_file, schema: Union[str, SchemaType], records: Iterable[dict],
                  codec: str = "null", sync_interval: int = 4000) -> int:
    """Write records to an Avro OCF. Returns the number of records written."""
    parsed, names = parse_schema(schema)
    own = isinstance(path_or_file, (str, os.PathLike))
    f = fs.open(path_or_file, "wb") if own else path_or_file
    try:
        header = bytearray()
        header += MAGIC
        meta = {
            "avro.schema": json.dumps(parsed).encode("utf-8"),
            "avro.codec": codec.encode("utf-8"),
        }
        _encode_long(len(meta), header)
        for k, v in meta.items():
            kb = k.encode("utf-8")
            _encode_long(len(kb), header)
            header += kb
            _encode_long(len(v), header)
            header += v
        _encode_long(0, header)
        header += DEFAULT_SYNC
        f.write(bytes(header))

        total = 0
        block = bytearray()
        count = 0

        def flush():
            nonlocal block, count
            if not count:
                return
            payload = bytes(block)
            if codec == "deflate":
                payload = zlib.compress(payload)[2:-1]  # raw deflate, no zlib wrapper
            head = bytearray()
            _encode_long(count, head)
            _encode_long(len(payload), head)
            f.write(bytes(head))
            f.write(payload)
            f.write(DEFAULT_SYNC)
            block = bytearray()
            count = 0

        for rec in records:
            _write_datum(rec, parsed, names, block)
            count += 1
            total += 1
            if count >= sync_interval:
                flush()
        flush()
        return total
    finally:
        if own:
            f.close()


def write_encoded_blocks(path_or_file, schema: Union[str, SchemaType],
                         blocks: Iterable[Tuple[int, bytes]],
                         codec: str = "null") -> int:
    """Write an OCF from pre-encoded block payloads.

    `blocks` yields (record_count, raw_datum_bytes) — e.g. from the native
    columnar encoder (gdmix_tpu_torch.native.encode_avro_column_blocks). Same
    container framing as write_records; returns total records written.
    """
    parsed, _ = parse_schema(schema)
    own = isinstance(path_or_file, (str, os.PathLike))
    f = fs.open(path_or_file, "wb") if own else path_or_file
    try:
        header = bytearray()
        header += MAGIC
        meta = {
            "avro.schema": json.dumps(parsed).encode("utf-8"),
            "avro.codec": codec.encode("utf-8"),
        }
        _encode_long(len(meta), header)
        for k, v in meta.items():
            kb = k.encode("utf-8")
            _encode_long(len(kb), header)
            header += kb
            _encode_long(len(v), header)
            header += v
        _encode_long(0, header)
        header += DEFAULT_SYNC
        f.write(bytes(header))
        total = 0
        for count, payload in blocks:
            if not count:
                continue
            if codec == "deflate":
                payload = zlib.compress(payload)[2:-1]
            head = bytearray()
            _encode_long(count, head)
            _encode_long(len(payload), head)
            f.write(bytes(head))
            f.write(payload)
            f.write(DEFAULT_SYNC)
            total += count
        return total
    finally:
        if own:
            f.close()


def append_records(path: str, records: Iterable[dict]) -> int:
    """Append records to an existing OCF (schema/codec read from its header)."""
    with fs.open(path, "rb") as f:
        data = f.read()
    schema, codec, _, _ = _read_header(memoryview(data))
    parsed, names = parse_schema(schema)
    block = bytearray()
    count = 0
    for rec in records:
        _write_datum(rec, parsed, names, block)
        count += 1
    if not count:
        return 0
    payload = bytes(block)
    if codec == "deflate":
        payload = zlib.compress(payload)[2:-1]
    head = bytearray()
    _encode_long(count, head)
    _encode_long(len(payload), head)
    with fs.open(path, "ab") as f:
        f.write(bytes(head))
        f.write(payload)
        f.write(DEFAULT_SYNC)
    return count


def _read_header(buf: memoryview) -> Tuple[dict, str, bytes, int]:
    if bytes(buf[:4]) != MAGIC:
        raise ValueError("Not an Avro object container file")
    pos = 4
    meta: Dict[str, bytes] = {}
    while True:
        count, pos = _decode_long(buf, pos)
        if count == 0:
            break
        if count < 0:
            count = -count
            _, pos = _decode_long(buf, pos)
        for _ in range(count):
            n, pos = _decode_long(buf, pos)
            if n < 0 or pos + n > len(buf):  # corrupt length must not rewind
                raise ValueError("Corrupt Avro header (bad metadata length)")
            key = bytes(buf[pos:pos + n]).decode("utf-8")
            pos += n
            n, pos = _decode_long(buf, pos)
            if n < 0 or pos + n > len(buf):
                raise ValueError("Corrupt Avro header (bad metadata length)")
            meta[key] = bytes(buf[pos:pos + n])
            pos += n
    sync = bytes(buf[pos:pos + SYNC_SIZE])
    pos += SYNC_SIZE
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    return schema, codec, sync, pos


def read_records(path_or_file) -> Iterator[dict]:
    """Iterate the records of an Avro OCF."""
    own = isinstance(path_or_file, (str, os.PathLike))
    f = fs.open(path_or_file, "rb") if own else path_or_file
    try:
        data = f.read()
    finally:
        if own:
            f.close()
    buf = memoryview(data)
    schema, codec, sync, pos = _read_header(buf)
    parsed, names = parse_schema(schema)
    while pos < len(buf):
        count, pos = _decode_long(buf, pos)
        size, pos = _decode_long(buf, pos)
        if count < 0 or size < 0 or pos + size > len(buf):
            raise ValueError("Corrupt Avro block header")
        payload = buf[pos:pos + size]
        pos += size
        if bytes(buf[pos:pos + SYNC_SIZE]) != sync:
            raise ValueError("Sync marker mismatch — corrupt Avro file")
        pos += SYNC_SIZE
        if codec == "deflate":
            payload = memoryview(zlib.decompress(bytes(payload), wbits=-15))
        elif codec == "snappy":
            from gdmix_tpu_torch.io.snappy import decompress
            # avro snappy blocks end with a 4-byte big-endian CRC32 of the
            # uncompressed data
            payload = memoryview(decompress(bytes(payload[:-4])))
        elif codec != "null":
            raise ValueError(f"Unsupported codec {codec!r}")
        p = 0
        for _ in range(count):
            rec, p = _read_datum(payload, p, parsed, names)
            yield rec


def read_schema(path: str) -> dict:
    """Return the writer schema of an OCF without decoding records."""
    with fs.open(path, "rb") as f:
        head = f.read(1 << 16)
    schema, _, _, _ = _read_header(memoryview(head))
    return schema
