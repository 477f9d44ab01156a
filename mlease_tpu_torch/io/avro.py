"""Self-contained Avro object-container-file codec (reader + writer).

The reference framework (linkedin/ml-ease) speaks Avro everywhere: training
data, prepared partitions, models, lambda->rho maps and loglik outputs are all
Avro container files (reference: src/main/avro/*.avsc, and
src/main/java/com/linkedin/mapred/AvroUtils.java:238 for the streaming reader).
This environment has no avro library installed, so this module implements the
Avro 1.x binary encoding and the object container file format from scratch:

  * primitives: null, boolean, int, long (zigzag varints), float, double,
    bytes, string
  * complex: record, enum, array, map, union, fixed
  * container framing: "Obj\\x01" magic, metadata map (avro.schema /
    avro.codec), 16-byte sync marker, blocked records with per-block count +
    byte size (null and deflate codecs)

A C++ fast path for bulk-decoding training rows lives in
mlease_tpu_torch/native/ (see mlease_tpu_torch.io.fast_decode); this
pure-Python module is the always-available reference implementation and
the only writer.

Copied from mlease_tpu/io/avro.py with its imports renamed; logic unchanged.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterable, Iterator

MAGIC = b"Obj\x01"
SYNC_SIZE = 16
DEFAULT_SYNC = b"\x8f\x6d\x1e\x62\xa1\x09\x5b\xc3\x77\x0a\x4e\x1c\x6a\x4d\x20\x51"

PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes", "string"}

_f32 = struct.Struct("<f")
_f64 = struct.Struct("<d")


class SchemaParseError(ValueError):
    pass


def parse_schema(schema: Any) -> Any:
    """Normalize a schema given as JSON text / dict / list into plain
    python structures (dict/list/str). Named-type references are left as
    strings and resolved lazily during encode/decode."""
    if isinstance(schema, str):
        s = schema.strip()
        if s.startswith("{") or s.startswith("["):
            return json.loads(s)
        return s  # primitive or named reference
    return schema


def _schema_type(schema: Any) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    if isinstance(schema, dict):
        return schema["type"]
    raise SchemaParseError(f"bad schema: {schema!r}")


class _NamedTypes(dict):
    """Registry of named types (records/enums/fixed) seen while walking a
    schema so that references by name resolve."""

    def collect(self, schema: Any) -> None:
        if isinstance(schema, dict):
            t = schema["type"]
            if t in ("record", "enum", "fixed"):
                name = schema.get("name")
                ns = schema.get("namespace")
                if name is not None:
                    self[name] = schema
                    if ns:
                        self[f"{ns}.{name}"] = schema
            if t == "record":
                for f in schema.get("fields", []):
                    self.collect(f["type"])
            elif t == "array":
                self.collect(schema["items"])
            elif t == "map":
                self.collect(schema["values"])
        elif isinstance(schema, list):
            for s in schema:
                self.collect(s)

    def resolve(self, schema: Any) -> Any:
        if isinstance(schema, str) and schema not in PRIMITIVES:
            try:
                return self[schema]
            except KeyError:
                raise SchemaParseError(f"unresolved named type: {schema}")
        return schema


# ---------------------------------------------------------------------------
# Binary decoder
# ---------------------------------------------------------------------------

class BinaryDecoder:
    __slots__ = ("buf", "pos")

    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0

    def read_long(self) -> int:
        buf = self.buf
        pos = self.pos
        b = buf[pos]
        pos += 1
        n = b & 0x7F
        shift = 7
        while b & 0x80:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
        self.pos = pos
        return (n >> 1) ^ -(n & 1)

    read_int = read_long

    def read_null(self) -> None:
        return None

    def read_boolean(self) -> bool:
        v = self.buf[self.pos] != 0
        self.pos += 1
        return v

    def read_float(self) -> float:
        v = _f32.unpack_from(self.buf, self.pos)[0]
        self.pos += 4
        return v

    def read_double(self) -> float:
        v = _f64.unpack_from(self.buf, self.pos)[0]
        self.pos += 8
        return v

    def read_bytes(self) -> bytes:
        n = self.read_long()
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    def read_fixed(self, n: int) -> bytes:
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def skip(self, n: int) -> None:
        self.pos += n


def decode(schema: Any, dec: BinaryDecoder, names: _NamedTypes) -> Any:
    schema = names.resolve(schema)
    t = _schema_type(schema)
    if t == "null":
        return None
    if t == "boolean":
        return dec.read_boolean()
    if t in ("int", "long"):
        return dec.read_long()
    if t == "float":
        return dec.read_float()
    if t == "double":
        return dec.read_double()
    if t == "bytes":
        return dec.read_bytes()
    if t == "string":
        return dec.read_string()
    if t == "union":
        idx = dec.read_long()
        return decode(schema[idx], dec, names)
    if t == "record":
        out = {}
        for f in schema["fields"]:
            out[f["name"]] = decode(f["type"], dec, names)
        return out
    if t == "array":
        items = schema["items"]
        out = []
        while True:
            n = dec.read_long()
            if n == 0:
                break
            if n < 0:
                dec.read_long()  # block byte size, unused
                n = -n
            for _ in range(n):
                out.append(decode(items, dec, names))
        return out
    if t == "map":
        values = schema["values"]
        out = {}
        while True:
            n = dec.read_long()
            if n == 0:
                break
            if n < 0:
                dec.read_long()
                n = -n
            for _ in range(n):
                k = dec.read_string()
                out[k] = decode(values, dec, names)
        return out
    if t == "enum":
        return schema["symbols"][dec.read_long()]
    if t == "fixed":
        return dec.read_fixed(schema["size"])
    raise SchemaParseError(f"unknown schema type: {t}")


# ---------------------------------------------------------------------------
# Writer -> reader schema resolution (Avro spec "Schema Resolution")
#
# The reference's avro-mapred stack resolves the file's writer schema against
# the job's declared reader schema (field reordering, defaults for missing
# fields, numeric promotions, union re-matching) whenever a job sets an
# explicit input schema (reference: AvroUtils.getAvroInputSchema,
# src/main/java/com/linkedin/mapred/AvroUtils.java:197-215, applied via
# AbstractAvroJob.java:283). decode_resolved() implements the same rules for
# this from-scratch codec.
# ---------------------------------------------------------------------------

class SchemaResolutionError(SchemaParseError):
    pass


def skip_datum(schema: Any, dec: BinaryDecoder, names: _NamedTypes) -> None:
    """Skip one datum of `schema` without materializing it (writer-only
    record fields)."""
    schema = names.resolve(schema)
    t = _schema_type(schema)
    if t == "null":
        return
    if t == "boolean":
        dec.skip(1)
    elif t in ("int", "long"):
        dec.read_long()
    elif t == "float":
        dec.skip(4)
    elif t == "double":
        dec.skip(8)
    elif t in ("bytes", "string"):
        dec.skip(dec.read_long())
    elif t == "union":
        skip_datum(schema[dec.read_long()], dec, names)
    elif t == "record":
        for f in schema["fields"]:
            skip_datum(f["type"], dec, names)
    elif t == "array":
        while True:
            n = dec.read_long()
            if n == 0:
                break
            if n < 0:
                dec.skip(dec.read_long())   # block byte size: fast skip
                continue
            for _ in range(n):
                skip_datum(schema["items"], dec, names)
    elif t == "map":
        while True:
            n = dec.read_long()
            if n == 0:
                break
            if n < 0:
                dec.skip(dec.read_long())
                continue
            for _ in range(n):
                dec.skip(dec.read_long())   # key
                skip_datum(schema["values"], dec, names)
    elif t == "enum":
        dec.read_long()
    elif t == "fixed":
        dec.skip(schema["size"])
    else:
        raise SchemaParseError(f"unknown schema type: {t}")


# numeric promotions the spec allows (writer type -> allowed reader types)
_PROMOTIONS = {
    "int": ("long", "float", "double"),
    "long": ("float", "double"),
    "float": ("double",),
    "string": ("bytes",),
    "bytes": ("string",),
}


def _plain_name(schema: Any) -> str | None:
    if isinstance(schema, dict):
        n = schema.get("name")
        return n.rsplit(".", 1)[-1] if n else None
    return None


def _resolvable(w: Any, r: Any, w_names: _NamedTypes,
                r_names: _NamedTypes) -> bool:
    """Can writer schema w resolve against reader schema r? (Used for the
    reader-union branch match; spec: the FIRST matching branch is used.)"""
    w = w_names.resolve(w)
    r = r_names.resolve(r)
    wt, rt = _schema_type(w), _schema_type(r)
    if wt == "union" or rt == "union":
        return True  # defer to the recursive resolution
    if wt == rt:
        if wt in ("record", "enum", "fixed"):
            wn, rn = _plain_name(w), _plain_name(r)
            return wn is None or rn is None or wn == rn
        return True
    return rt in _PROMOTIONS.get(wt, ())


def default_value(schema: Any, default: Any, names: _NamedTypes) -> Any:
    """A reader field's JSON default -> runtime value (spec table: bytes and
    fixed defaults are JSON strings of codepoints 0-255; union defaults
    correspond to the FIRST branch)."""
    schema = names.resolve(schema)
    t = _schema_type(schema)
    if t == "union":
        return default_value(schema[0], default, names)
    if t in ("bytes", "fixed") and isinstance(default, str):
        return default.encode("latin-1")
    if t == "record":
        out = {}
        default = default or {}
        for f in schema["fields"]:
            if f["name"] in default:
                out[f["name"]] = default_value(f["type"], default[f["name"]],
                                               names)
            elif "default" in f:
                out[f["name"]] = default_value(f["type"], f["default"], names)
            else:
                raise SchemaResolutionError(
                    f"no default for nested field {f['name']}")
        return out
    if t == "array":
        return [default_value(schema["items"], d, names)
                for d in (default or [])]
    if t == "map":
        return {k: default_value(schema["values"], v, names)
                for k, v in (default or {}).items()}
    if t in ("float", "double") and default is not None:
        return float(default)
    return default


def decode_resolved(w_schema: Any, r_schema: Any, dec: BinaryDecoder,
                    w_names: _NamedTypes, r_names: _NamedTypes) -> Any:
    """Decode data written with w_schema as r_schema (Avro spec resolution:
    record fields matched by name — writer-only fields skipped, reader-only
    fields take their default — numeric/string promotions, union
    re-matching, enum symbol lookup)."""
    w = w_names.resolve(w_schema)
    r = r_names.resolve(r_schema)
    wt, rt = _schema_type(w), _schema_type(r)
    if wt == "union":
        return decode_resolved(w[dec.read_long()], r, dec, w_names, r_names)
    if rt == "union":
        for branch in r:
            if _resolvable(w, branch, w_names, r_names):
                return decode_resolved(w, branch, dec, w_names, r_names)
        raise SchemaResolutionError(
            f"writer type {wt} matches no reader union branch {r!r}")
    if wt == rt and wt not in ("record", "enum", "fixed", "array", "map"):
        return decode(w, dec, w_names)
    if rt in _PROMOTIONS.get(wt, ()):
        if wt in ("int", "long"):
            v = dec.read_long()
            return float(v) if rt in ("float", "double") else v
        if wt == "float":
            return dec.read_float()
        if wt == "string":            # -> bytes
            return dec.read_bytes()
        if wt == "bytes":             # -> string
            return dec.read_bytes().decode("utf-8")
    if wt != rt:
        raise SchemaResolutionError(
            f"writer type {wt} does not resolve to reader type {rt}")
    if wt == "record":
        wn, rn = _plain_name(w), _plain_name(r)
        if wn and rn and wn != rn:
            raise SchemaResolutionError(f"record name mismatch {wn} != {rn}")
        r_fields = {f["name"]: f for f in r["fields"]}
        out = {}
        seen = set()
        for f in w["fields"]:
            rf = r_fields.get(f["name"])
            if rf is None:
                skip_datum(f["type"], dec, w_names)
            else:
                out[f["name"]] = decode_resolved(f["type"], rf["type"], dec,
                                                 w_names, r_names)
                seen.add(f["name"])
        for f in r["fields"]:
            if f["name"] in seen:
                continue
            if "default" not in f:
                raise SchemaResolutionError(
                    f"reader field {f['name']} missing from writer schema "
                    "and has no default")
            out[f["name"]] = default_value(f["type"], f["default"], r_names)
        # resolved records take the READER schema's field order (the wire is
        # writer-ordered; avro-java's resolved GenericRecord is reader-shaped)
        return {f["name"]: out[f["name"]] for f in r["fields"]}
    if wt == "array":
        out = []
        while True:
            n = dec.read_long()
            if n == 0:
                break
            if n < 0:
                dec.read_long()
                n = -n
            for _ in range(n):
                out.append(decode_resolved(w["items"], r["items"], dec,
                                           w_names, r_names))
        return out
    if wt == "map":
        out = {}
        while True:
            n = dec.read_long()
            if n == 0:
                break
            if n < 0:
                dec.read_long()
                n = -n
            for _ in range(n):
                k = dec.read_string()
                out[k] = decode_resolved(w["values"], r["values"], dec,
                                         w_names, r_names)
        return out
    if wt == "enum":
        sym = w["symbols"][dec.read_long()]
        if sym not in r["symbols"]:
            if "default" in r:       # enum default (Avro >= 1.9)
                return r["default"]
            raise SchemaResolutionError(
                f"writer enum symbol {sym} not in reader symbols")
        return sym
    if wt == "fixed":
        if w["size"] != r["size"]:
            raise SchemaResolutionError(
                f"fixed size mismatch {w['size']} != {r['size']}")
        return dec.read_fixed(w["size"])
    raise SchemaParseError(f"unknown schema type: {wt}")


# ---------------------------------------------------------------------------
# Binary encoder
# ---------------------------------------------------------------------------

class BinaryEncoder:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts: list[bytes] = []

    def write_long(self, v: int) -> None:
        v = (v << 1) ^ (v >> 63) if v < 0 else (v << 1)
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        self.parts.append(bytes(out))

    write_int = write_long

    def write_boolean(self, v: bool) -> None:
        self.parts.append(b"\x01" if v else b"\x00")

    def write_float(self, v: float) -> None:
        self.parts.append(_f32.pack(v))

    def write_double(self, v: float) -> None:
        self.parts.append(_f64.pack(v))

    def write_bytes(self, v: bytes) -> None:
        self.write_long(len(v))
        self.parts.append(v)

    def write_string(self, v: str) -> None:
        self.write_bytes(v.encode("utf-8"))

    def write_raw(self, v: bytes) -> None:
        self.parts.append(v)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def _union_index(schema: list, datum: Any, names: _NamedTypes) -> int:
    """Pick the first union branch the datum fits."""
    for i, branch in enumerate(schema):
        b = names.resolve(branch)
        t = _schema_type(b)
        if datum is None and t == "null":
            return i
        if isinstance(datum, bool):
            if t == "boolean":
                return i
            continue
        if isinstance(datum, int) and t in ("int", "long"):
            return i
        if isinstance(datum, float) and t in ("float", "double"):
            return i
        if isinstance(datum, int) and t in ("float", "double"):
            return i
        if isinstance(datum, str) and t in ("string", "enum"):
            return i
        if isinstance(datum, bytes) and t in ("bytes", "fixed"):
            return i
        if isinstance(datum, dict) and t in ("record", "map"):
            return i
        if isinstance(datum, (list, tuple)) and t == "array":
            return i
    raise SchemaParseError(f"datum {datum!r} does not match union {schema!r}")


def encode(schema: Any, datum: Any, enc: BinaryEncoder, names: _NamedTypes) -> None:
    schema = names.resolve(schema)
    t = _schema_type(schema)
    if t == "null":
        return
    if t == "boolean":
        enc.write_boolean(datum)
    elif t in ("int", "long"):
        enc.write_long(int(datum))
    elif t == "float":
        enc.write_float(float(datum))
    elif t == "double":
        enc.write_double(float(datum))
    elif t == "bytes":
        enc.write_bytes(datum)
    elif t == "string":
        enc.write_string(datum)
    elif t == "union":
        idx = _union_index(schema, datum, names)
        enc.write_long(idx)
        encode(schema[idx], datum, enc, names)
    elif t == "record":
        for f in schema["fields"]:
            name = f["name"]
            if isinstance(datum, dict):
                value = datum.get(name, f.get("default"))
            else:
                value = getattr(datum, name)
            encode(f["type"], value, enc, names)
    elif t == "array":
        if datum:
            enc.write_long(len(datum))
            for item in datum:
                encode(schema["items"], item, enc, names)
        enc.write_long(0)
    elif t == "map":
        if datum:
            enc.write_long(len(datum))
            for k, v in datum.items():
                enc.write_string(k)
                encode(schema["values"], v, enc, names)
        enc.write_long(0)
    elif t == "enum":
        enc.write_long(schema["symbols"].index(datum))
    elif t == "fixed":
        enc.write_raw(datum)
    else:
        raise SchemaParseError(f"unknown schema type: {t}")


# ---------------------------------------------------------------------------
# Container file reader / writer
# ---------------------------------------------------------------------------

_META_SCHEMA = {"type": "map", "values": "bytes"}


class AvroFileReader:
    """Streaming reader over an Avro object container file.

    reader_schema (optional) enables writer->reader schema resolution: data
    is decoded AS the reader schema (field reordering, defaults for fields
    missing from the file, numeric promotions, union re-matching) — the
    behavior the reference gets from avro-mapred when a job declares an
    input schema (AvroUtils.java:197-215)."""

    def __init__(self, fo: BinaryIO | str, reader_schema: Any = None):
        self._own = isinstance(fo, (str, os.PathLike))
        self._fo = open(fo, "rb") if self._own else fo
        magic = self._fo.read(4)
        if magic != MAGIC:
            raise IOError(f"not an Avro container file (magic={magic!r})")
        names = _NamedTypes()
        meta_dec = _StreamDecoder(self._fo)
        meta = decode(_META_SCHEMA, meta_dec, names)
        self.metadata = meta
        self.codec = meta.get("avro.codec", b"null").decode()
        self.schema_json = meta["avro.schema"].decode("utf-8")
        self.schema = parse_schema(self.schema_json)
        self.names = _NamedTypes()
        self.names.collect(self.schema)
        self.reader_schema = (parse_schema(reader_schema)
                              if reader_schema is not None else None)
        self.reader_names = _NamedTypes()
        if self.reader_schema is not None:
            self.reader_names.collect(self.reader_schema)
        self.sync = self._fo.read(SYNC_SIZE)

    def blocks(self) -> Iterator[tuple[int, bytes]]:
        """Yield (record_count, decompressed_payload) per container block."""
        while True:
            head = self._fo.read(1)
            if not head:
                return
            dec = _StreamDecoder(self._fo, first=head)
            count = dec.read_long()
            nbytes = dec.read_long()
            payload = self._fo.read(nbytes)
            sync = self._fo.read(SYNC_SIZE)
            if sync != self.sync:
                raise IOError("bad sync marker in Avro file")
            if self.codec == "deflate":
                payload = zlib.decompress(payload, -15)
            elif self.codec != "null":
                raise IOError(f"unsupported Avro codec: {self.codec}")
            yield count, payload

    def __iter__(self) -> Iterator[Any]:
        if self.reader_schema is not None:
            for count, payload in self.blocks():
                dec = BinaryDecoder(payload)
                for _ in range(count):
                    yield decode_resolved(self.schema, self.reader_schema,
                                          dec, self.names, self.reader_names)
            return
        for count, payload in self.blocks():
            dec = BinaryDecoder(payload)
            for _ in range(count):
                yield decode(self.schema, dec, self.names)

    def close(self) -> None:
        if self._own:
            self._fo.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _StreamDecoder(BinaryDecoder):
    """Decoder over a file object (used only for headers/block framing)."""

    def __init__(self, fo: BinaryIO, first: bytes = b""):
        self._fo = fo
        self._first = first
        super().__init__(b"")

    def _read1(self) -> int:
        if self._first:
            b = self._first[0]
            self._first = b""
            return b
        c = self._fo.read(1)
        if not c:
            raise EOFError("truncated Avro stream")
        return c[0]

    def read_long(self) -> int:
        b = self._read1()
        n = b & 0x7F
        shift = 7
        while b & 0x80:
            b = self._read1()
            n |= (b & 0x7F) << shift
            shift += 7
        return (n >> 1) ^ -(n & 1)

    read_int = read_long

    def read_bytes(self) -> bytes:
        n = self.read_long()
        first = b""
        if self._first:
            first, self._first = self._first, b""
        data = first + self._fo.read(n - len(first))
        return data

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    def read_boolean(self) -> bool:
        return self._read1() != 0

    def read_float(self) -> float:
        return _f32.unpack(self.read_fixed(4))[0]

    def read_double(self) -> float:
        return _f64.unpack(self.read_fixed(8))[0]

    def read_fixed(self, n: int) -> bytes:
        first = b""
        if self._first:
            first, self._first = self._first, b""
        return first + self._fo.read(n - len(first))


class AvroFileWriter:
    """Writer producing Avro object container files (null or deflate codec).

    Mirrors the reference's AvroHdfsFileWriter
    (src/main/java/com/linkedin/mapred/AvroHdfsFileWriter.java:25-44), which
    writes a single schema'd file with deflate level 9.
    """

    def __init__(self, fo: BinaryIO | str, schema: Any, codec: str = "deflate",
                 block_records: int = 4096):
        self._own = isinstance(fo, (str, os.PathLike))
        if self._own:
            os.makedirs(os.path.dirname(os.path.abspath(fo)), exist_ok=True)
        self._fo = open(fo, "wb") if self._own else fo
        self.schema = parse_schema(schema)
        self.names = _NamedTypes()
        self.names.collect(self.schema)
        self.codec = codec
        self.block_records = block_records
        self.sync = DEFAULT_SYNC
        self._buf = BinaryEncoder()
        self._count = 0
        self._write_header()

    def _write_header(self) -> None:
        enc = BinaryEncoder()
        enc.write_raw(MAGIC)
        meta = {
            "avro.schema": json.dumps(self.schema).encode("utf-8"),
            "avro.codec": self.codec.encode(),
        }
        encode(_META_SCHEMA, meta, enc, self.names)
        enc.write_raw(self.sync)
        self._fo.write(enc.getvalue())

    def append(self, datum: Any) -> None:
        encode(self.schema, datum, self._buf, self.names)
        self._count += 1
        if self._count >= self.block_records:
            self.flush_block()

    def extend(self, data: Iterable[Any]) -> None:
        for d in data:
            self.append(d)

    def flush_block(self) -> None:
        if self._count == 0:
            return
        payload = self._buf.getvalue()
        if self.codec == "deflate":
            co = zlib.compressobj(9, zlib.DEFLATED, -15)
            payload = co.compress(payload) + co.flush()
        enc = BinaryEncoder()
        enc.write_long(self._count)
        enc.write_long(len(payload))
        enc.write_raw(payload)
        enc.write_raw(self.sync)
        self._fo.write(enc.getvalue())
        self._buf = BinaryEncoder()
        self._count = 0

    def append_raw_block(self, payload: bytes, count: int) -> None:
        """Write one pre-encoded binary block: `count` records already
        encoded back-to-back with this file's writer schema (e.g. by the
        native encoder, native/avro_encode.cpp). Buffered appends are
        flushed first so record order is preserved; the file's codec applies
        to the raw payload like any other block."""
        if count <= 0:
            return
        self.flush_block()
        if self.codec == "deflate":
            co = zlib.compressobj(9, zlib.DEFLATED, -15)
            payload = co.compress(payload) + co.flush()
        enc = BinaryEncoder()
        enc.write_long(count)
        enc.write_long(len(payload))
        enc.write_raw(payload)
        enc.write_raw(self.sync)
        self._fo.write(enc.getvalue())

    def close(self) -> None:
        self.flush_block()
        if self._own:
            self._fo.close()
        else:
            self._fo.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, reader_schema: Any = None) -> list[Any]:
    """Read all records of one Avro file (or every *.avro under a dir),
    optionally resolved against a reader schema (see AvroFileReader).

    Directory traversal mirrors AvroUtils.enumerateFiles
    (src/main/java/com/linkedin/mapred/AvroUtils.java:89-133): files whose
    basename starts with '_' are ignored.
    """
    out: list[Any] = []
    for p in enumerate_avro_files(path):
        with AvroFileReader(p, reader_schema=reader_schema) as r:
            out.extend(r)
    return out


def enumerate_avro_files(path: str) -> list[str]:
    # comma-separated path lists, as the reference's input.paths accepts
    # (JobConfig values are raw strings; AvroUtils.addAllSubPaths is called
    # per comma-split entry)
    if "," in path:
        out: list[str] = []
        for p in path.split(","):
            p = p.strip()
            if not p:
                continue
            # an explicitly-listed entry that does not exist is an error,
            # as in AvroUtils.addAllSubPaths (a bad HDFS path fails the
            # job) — silently contributing zero files would hide typos
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"input path entry does not exist: {p!r} "
                    f"(from comma-separated list {path!r})")
            out.extend(enumerate_avro_files(p))
        return out
    # same typo-hiding guard for a single path: nonexistent input is an
    # error, not an empty file list
    if not os.path.exists(path):
        raise FileNotFoundError(f"input path does not exist: {path!r}")
    if os.path.isfile(path):
        return [path]
    found: list[str] = []
    for root, dirs, files in os.walk(path):
        # '_'/'.'-prefixed path components are ignored at every level, as in
        # AvroUtils.addAllSubPaths (AvroUtils.java:54-66,126-129)
        dirs[:] = [d for d in dirs
                   if not d.startswith("_") and not d.startswith(".")]
        for f in sorted(files):
            if f.startswith("_") or f.startswith("."):
                continue
            if f.endswith(".avro"):
                found.append(os.path.join(root, f))
    return sorted(found)


def write_records(path: str, schema: Any, records: Iterable[Any],
                  codec: str = "deflate", block_records: int = 4096) -> None:
    with AvroFileWriter(path, schema, codec=codec,
                        block_records=block_records) as w:
        w.extend(records)
