"""Minimal protobuf (proto3) wire-format reader/writer (the port's own copy
of ``mgard_tpu/io/protowire.py``, byte for byte the same encoding).

Generic varint/length-delimited codec plus a tiny schema language, used to
emit and parse the reference MGARD header (src/mgard.proto) without a
protoc build step.  Messages are plain dicts keyed by field name.

Schema entries: ``field_name: (field_number, kind)`` where kind is one of
``"varint"``, ``"double"``, ``"message:<SchemaName>"``,
``"repeated_varint"``, ``"repeated_double"``, ``"string"``.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

__all__ = ["encode_message", "decode_message"]


def _write_varint(out: bytearray, value: int):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, off
        shift += 7


def encode_message(schema: Dict, schemas: Dict[str, Dict],
                   msg: Dict) -> bytes:
    out = bytearray()
    # proto3 convention: omit default (zero) scalar values
    for name, (num, kind) in schema.items():
        if name not in msg:
            continue
        val = msg[name]
        if kind == "varint":
            if val == 0:
                continue
            _write_varint(out, num << 3 | 0)
            _write_varint(out, int(val))
        elif kind == "double":
            if val == 0.0:
                continue
            _write_varint(out, num << 3 | 1)
            out += struct.pack("<d", float(val))
        elif kind == "string":
            if not val:
                continue
            data = val.encode() if isinstance(val, str) else bytes(val)
            _write_varint(out, num << 3 | 2)
            _write_varint(out, len(data))
            out += data
        elif kind == "repeated_varint":
            if not len(val):
                continue
            packed = bytearray()
            for v in val:
                _write_varint(packed, int(v))
            _write_varint(out, num << 3 | 2)
            _write_varint(out, len(packed))
            out += packed
        elif kind == "repeated_double":
            if not len(val):
                continue
            _write_varint(out, num << 3 | 2)
            _write_varint(out, 8 * len(val))
            for v in val:
                out += struct.pack("<d", float(v))
        elif kind.startswith("message:"):
            sub = encode_message(schemas[kind[8:]], schemas, val)
            _write_varint(out, num << 3 | 2)
            _write_varint(out, len(sub))
            out += sub
        else:
            raise ValueError(f"unknown kind {kind}")
    return bytes(out)


def decode_message(schema: Dict, schemas: Dict[str, Dict],
                   buf: bytes) -> Dict:
    by_num = {num: (name, kind) for name, (num, kind) in schema.items()}
    msg: Dict = {}
    # populate proto3 defaults
    for name, (num, kind) in schema.items():
        if kind == "varint":
            msg[name] = 0
        elif kind == "double":
            msg[name] = 0.0
        elif kind == "string":
            msg[name] = ""
        elif kind.startswith("repeated"):
            msg[name] = []
        elif kind.startswith("message:"):
            pass  # absent submessage stays absent
    off = 0
    while off < len(buf):
        tag, off = _read_varint(buf, off)
        num, wire = tag >> 3, tag & 7
        if num in by_num:
            name, kind = by_num[num]
        else:
            name, kind = None, None
        if wire == 0:
            val, off = _read_varint(buf, off)
            if name:
                if kind == "repeated_varint":
                    msg[name].append(val)
                else:
                    msg[name] = val
        elif wire == 1:
            (val,) = struct.unpack_from("<d", buf, off)
            off += 8
            if name:
                msg[name] = val
        elif wire == 5:
            off += 4
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            data = buf[off:off + ln]
            off += ln
            if not name:
                continue
            if kind == "repeated_varint":
                p = 0
                while p < len(data):
                    v, p = _read_varint(data, p)
                    msg[name].append(v)
            elif kind == "repeated_double":
                msg[name] = list(
                    struct.unpack(f"<{len(data)//8}d", data))
            elif kind == "string":
                msg[name] = data.decode()
            elif kind.startswith("message:"):
                msg[name] = decode_message(schemas[kind[8:]], schemas, data)
            else:
                msg[name] = data
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return msg
