"""Pure-Python snappy raw-format decompressor.

Spark writes avro with the snappy codec by default, and this environment has no
python-snappy — so the Avro reader needs its own decoder. Only decompression is
implemented (we never write snappy). Raw snappy format: a little-endian varint
preamble with the uncompressed length, then a stream of literal/copy elements
(copies may overlap — byte-wise semantics).
"""
from __future__ import annotations


def decompress(data: bytes) -> bytes:
    buf = memoryview(data)
    # preamble: uncompressed length (LE varint)
    pos = 0
    shift = 0
    total = 0
    while True:
        b = buf[pos]
        pos += 1
        total |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7

    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        elem_type = tag & 0x03
        if elem_type == 0:  # literal
            length = tag >> 2
            if length < 60:
                length += 1
            else:
                extra = length - 59  # 1..4 extra length bytes
                length = int.from_bytes(buf[pos:pos + extra], "little") + 1
                pos += extra
            out += buf[pos:pos + length]
            pos += length
        else:
            if elem_type == 1:  # copy with 1-byte offset
                length = ((tag >> 2) & 0x07) + 4
                offset = ((tag >> 5) << 8) | buf[pos]
                pos += 1
            elif elem_type == 2:  # 2-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos:pos + 2], "little")
                pos += 2
            else:  # 4-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos:pos + 4], "little")
                pos += 4
            if offset == 0:
                raise ValueError("corrupt snappy stream: zero copy offset")
            start = len(out) - offset
            if start < 0:
                raise ValueError("corrupt snappy stream: offset before start")
            if offset >= length:
                out += out[start:start + length]
            else:
                # overlapping copy: byte-wise (run-length expansion)
                for i in range(length):
                    out.append(out[start + i])
    if len(out) != total:
        raise ValueError(f"snappy length mismatch: got {len(out)}, "
                         f"expected {total}")
    return bytes(out)
