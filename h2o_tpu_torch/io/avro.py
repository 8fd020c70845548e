"""Pure-Python Avro Object Container File reader for flat records
(``h2o_tpu/io/avro.py``, copied).

Reference: `h2o-parsers/h2o-avro-parser/` — the reference wraps the Avro Java
library and flattens top-level primitive fields into frame columns
(`AvroParser.java`: flat schemas; nested records unsupported there too).
This reader implements the container spec directly (header `Obj\\x01`,
metadata map with schema JSON + codec, sync-marked blocks, zigzag varint
binary encoding) so no avro dependency is needed. Supported field types:
null/boolean/int/long/float/double/string/bytes, nullable unions
(["null", T] either order), and enum (→ categorical).
"""

from __future__ import annotations

import json
import struct
import zlib

MAGIC = b"Obj\x01"


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated avro data")
        self.pos += n
        return b

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)

    # zigzag varint (spec: primitive long/int encoding)
    def long(self) -> int:
        shift, acc = 0, 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def bytes_(self) -> bytes:
        return self.read(self.long())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def float_(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def double(self) -> float:
        return struct.unpack("<d", self.read(8))[0]

    def boolean(self) -> bool:
        return self.read(1) != b"\x00"

    def map_(self) -> dict:
        out = {}
        while True:
            n = self.long()
            if n == 0:
                break
            if n < 0:  # block with byte size prefix
                n = -n
                self.long()
            for _ in range(n):
                k = self.string()
                out[k] = self.bytes_()
        return out


def _decode_value(r: _Reader, ftype):
    """Decode one value of an (already simplified) schema type."""
    if isinstance(ftype, list):  # union — branch index picks the member
        branch = ftype[r.long()]
        return _decode_value(r, branch)
    if isinstance(ftype, dict):
        t = ftype["type"]
        if t == "enum":
            return ftype["symbols"][r.long()]
        if t == "fixed":
            return r.read(int(ftype["size"]))
        if t in ("array", "map", "record"):
            raise NotImplementedError(
                f"avro: nested '{t}' fields are not supported (the reference "
                f"parser flattens only top-level primitives)")
        return _decode_value(r, t)
    if ftype == "null":
        return None
    if ftype == "boolean":
        return r.boolean()
    if ftype in ("int", "long"):
        return r.long()
    if ftype == "float":
        return r.float_()
    if ftype == "double":
        return r.double()
    if ftype == "string":
        return r.string()
    if ftype == "bytes":
        return r.bytes_()
    raise NotImplementedError(f"avro type {ftype!r}")


def read_avro(path: str):
    """→ (column_names, list-of-column value lists, per-column enum domains
    or None, per-column simplified type names). Rows stream block-by-block;
    deflate and null codecs."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ValueError(f"{path}: not an avro object container file")
    meta = r.map_()  # keys decode to str; values stay bytes
    sync = r.read(16)
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    if schema.get("type") != "record":
        raise NotImplementedError("avro: top-level schema must be a record")
    fields = schema["fields"]
    names = [f["name"] for f in fields]
    cols: list[list] = [[] for _ in names]

    while not r.at_end():
        nrows = r.long()
        nbytes = r.long()
        block = r.read(nbytes)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise NotImplementedError(f"avro codec '{codec}' not supported")
        br = _Reader(block)
        for _ in range(nrows):
            for j, fld in enumerate(fields):
                cols[j].append(_decode_value(br, fld["type"]))
        if r.read(16) != sync:
            raise ValueError("avro: sync marker mismatch (corrupt block)")

    domains, types = [], []
    for fld in fields:
        ft = fld["type"]
        members = ft if isinstance(ft, list) else [ft]
        enum = next((m for m in members
                     if isinstance(m, dict) and m.get("type") == "enum"), None)
        domains.append(list(enum["symbols"]) if enum else None)
        prim = next((m if isinstance(m, str) else m.get("type")
                     for m in members
                     if (m if isinstance(m, str) else m.get("type"))
                     != "null"), "null")
        types.append(prim)
    return names, cols, domains, types


def write_avro(path: str, names, cols, schema_types=None,
               codec: str = "null"):
    """Minimal writer (tests + export parity): flat record of
    double/string/nullable-double columns."""
    import numpy as np

    fields = []
    for j, n in enumerate(names):
        t = (schema_types[j] if schema_types else
             ("string" if any(isinstance(v, str) for v in cols[j])
              else "double"))
        fields.append({"name": str(n), "type": ["null", t]})
    schema = {"type": "record", "name": "h2o_frame", "fields": fields}

    def zigzag(v: int) -> bytes:
        v = (v << 1) ^ (v >> 63)
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    def enc_str(s: str) -> bytes:
        b = s.encode()
        return zigzag(len(b)) + b

    body = bytearray()
    nrows = len(cols[0]) if cols else 0
    for i in range(nrows):
        for j, fld in enumerate(fields):
            v = cols[j][i]
            isna = v is None or (isinstance(v, float) and np.isnan(v))
            if isna:
                body += zigzag(0)  # union branch 0 = null
                continue
            body += zigzag(1)
            if fld["type"][1] == "string":
                body += enc_str(str(v))
            else:
                body += struct.pack("<d", float(v))
    payload = bytes(body)
    if codec == "deflate":
        c = zlib.compressobj(wbits=-15)
        payload = c.compress(payload) + c.flush()

    sync = b"0123456789abcdef"
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    out = bytearray(MAGIC)
    out += zigzag(len(meta))
    for k, v in meta.items():
        out += enc_str(k) + zigzag(len(v)) + v
    out += zigzag(0)
    out += sync
    out += zigzag(nrows) + zigzag(len(payload)) + payload + sync
    with open(path, "wb") as f:
        f.write(bytes(out))
