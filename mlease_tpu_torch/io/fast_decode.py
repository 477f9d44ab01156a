"""ctypes binding for the native Avro row decoder (native/avro_decode.cpp).

Port of mlease_tpu/io/fast_decode.py, logic unchanged. Compiles the parsed
Avro schema into the C++ decoder's compact descriptor grammar, streams
container blocks (keeping deflate inflation in C++), and returns columnar
numpy arrays + the interned feature vocabulary. Falls back cleanly when the
shared library is unavailable (`is_available()` is False and callers use
the pure-Python path in mlease_tpu_torch/io/avro.py).

The library is the port's own copy of the codec
(`mlease_tpu_torch/native/`), built at first use by io/_native_build.py;
MLEASE_NO_NATIVE set in the environment disables it.

Role mapping (see native/avro_decode.cpp):
  top-level fields:  response/click/label -> 'r', weight -> 'w',
                     offset -> 'o', features -> 'F', map-key column -> 'K'
  feature items:     name -> 'N', term -> 'T', value -> 'V'
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Any, NamedTuple

import numpy as np

from mlease_tpu_torch.io import _native_build

logger = logging.getLogger(__name__)

_lib = None
_tried = False
_load_lock = threading.Lock()


def _load():
    """The library, built and loaded at the first call (None where it
    cannot be); a call on another thread meanwhile waits for it."""
    with _load_lock:
        return _load_once()


def _load_once():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("MLEASE_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(str(_native_build.build()))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        logger.warning("native Avro codec unavailable: %s", e)
        return None
    lib.mlease_ctx_new.restype = ctypes.c_void_p
    lib.mlease_ctx_new.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.mlease_ctx_free.argtypes = [ctypes.c_void_p]
    lib.mlease_decode_block.restype = ctypes.c_int
    lib.mlease_decode_block.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int]
    lib.mlease_decode_blocks_mt.restype = ctypes.c_int
    lib.mlease_decode_blocks_mt.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    for name in ("mlease_num_rows", "mlease_num_feats", "mlease_vocab_size",
                 "mlease_vocab_arena_size", "mlease_key_arena_size"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.mlease_error.restype = ctypes.c_char_p
    lib.mlease_error.argtypes = [ctypes.c_void_p]
    lib.mlease_copy_rows.argtypes = [ctypes.c_void_p] * 5
    lib.mlease_copy_feats.argtypes = [ctypes.c_void_p] * 3
    lib.mlease_copy_vocab.argtypes = [ctypes.c_void_p] * 4
    lib.mlease_copy_keys.argtypes = [ctypes.c_void_p] * 3
    lib.mlease_encode_ctr_block.restype = ctypes.c_int64
    lib.mlease_encode_ctr_block.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    _lib = lib
    return lib


def is_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# schema -> descriptor compilation
# ---------------------------------------------------------------------------

_PRIM = {"null": "n", "boolean": "b", "int": "i", "long": "l", "float": "f",
         "double": "d", "string": "s", "bytes": "y"}

_FEATURE_ROLES = {"name": "N", "term": "T", "value": "V"}


class DescriptorError(ValueError):
    pass


def compile_descriptor(schema: Any, names, *, map_key: str = "",
                       reader_fields: set[str] | None = None) -> str:
    """Top-level record schema -> C++ descriptor string.

    The descriptor always encodes the WRITER's binary layout (the file's
    schema). reader_fields — the top-level field names of a declared reader
    schema — implements the columnar slice of Avro schema resolution:
    writer fields absent from the reader are demoted to '_' (decoded and
    discarded), and reader-only role columns fall back to the C++ defaults
    (weight 1.0 / offset 0.0). Numeric promotions need no handling: role
    values convert to the column type whatever writer primitive the
    descriptor encodes."""
    schema = names.resolve(schema)
    if not (isinstance(schema, dict) and schema.get("type") == "record"):
        raise DescriptorError("top-level schema must be a record")

    def visible(fname: str) -> bool:
        return reader_fields is None or fname in reader_fields

    # The Python path (records.get_response) applies per-record
    # click -> response -> label precedence with later non-null aliases
    # winning (Util.java:309-320). The native decoder has no per-record null
    # logic, so it only handles the unambiguous case: exactly one alias
    # column in the schema. Zero aliases would silently train all-negative;
    # two or more could disagree with the Python path — both fall back.
    aliases = [f["name"] for f in schema["fields"]
               if f["name"] in ("response", "click", "label")
               and visible(f["name"])]
    if len(aliases) != 1:
        raise DescriptorError(
            "need exactly one of response/click/label in the schema for "
            f"native ingest, found {aliases!r}; use the Python path")
    parts = [f"R{len(schema['fields'])};"]
    for f in schema["fields"]:
        fname = f["name"]
        if not visible(fname):
            role = "_"
        elif fname in ("response", "click", "label"):
            role = "r"
        elif fname == "weight":
            role = "w"
        elif fname == "offset":
            role = "o"
        elif fname == "features":
            role = "F"
        elif map_key and fname == map_key:
            role = "K"
        else:
            role = "_"
        parts.append(role + ":" + _compile_type(f["type"], names,
                                                in_features=(role == "F")))
    return "".join(parts)


def _compile_type(schema: Any, names, in_features: bool = False,
                  in_item: bool = False) -> str:
    schema = names.resolve(schema)
    if isinstance(schema, str):
        if schema in _PRIM:
            return _PRIM[schema]
        raise DescriptorError(f"unsupported type {schema}")
    if isinstance(schema, list):
        return (f"U{len(schema)};"
                + "".join(_compile_type(s, names, in_features, in_item)
                          for s in schema))
    t = schema["type"]
    if t in _PRIM:
        return _PRIM[t]
    if t == "fixed":
        return f"x{schema['size']};"
    if t == "enum":
        return "e;"
    if t == "array":
        return "A" + _compile_type(schema["items"], names,
                                   in_features, in_features)
    if t == "map":
        return "M" + _compile_type(schema["values"], names)
    if t == "record":
        parts = [f"R{len(schema['fields'])};"]
        for f in schema["fields"]:
            role = _FEATURE_ROLES.get(f["name"], "_") if in_item else "_"
            parts.append(role + ":" + _compile_type(f["type"], names))
        return "".join(parts)
    raise DescriptorError(f"unsupported type {t}")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class DecodedRows(NamedTuple):
    """Columnar decode result: CSR rows over an interned vocabulary."""

    response: np.ndarray     # (N,) int32
    weight: np.ndarray       # (N,) float32
    offset: np.ndarray       # (N,) float32
    row_start: np.ndarray    # (N+1,) int64 CSR offsets into feat_*
    feat_id: np.ndarray      # (nnz,) int32 ids into vocab_names
    feat_val: np.ndarray     # (nnz,) float32
    vocab_names: list        # feature keys ("name\x01term"), by id
    keys: list | None = None  # (N,) map-key column per row, when decoded

    @property
    def num_rows(self) -> int:
        return len(self.response)


def decode_file(path: str, *, ignore_value: bool = False,
                map_key: str = "", nthreads: int = 0,
                reader_schema=None) -> DecodedRows:
    """Decode one Avro container file natively. Raises RuntimeError if the
    native library is unavailable (check is_available() first).

    nthreads > 1 decodes container blocks with that many C++ worker threads
    (byte-balanced contiguous block ranges, serially merged — result is
    byte-identical to the sequential decode, including vocabulary id order);
    0 picks an automatic width, 1 forces sequential.

    reader_schema declares the reading job's schema (the reference's
    avro-mapred input-schema resolution, AvroUtils.java:197-215): writer
    columns it omits are skipped, columns it adds fall back to the decoder's
    defaults (weight 1.0, offset 0.0)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")

    from mlease_tpu_torch.io.avro import AvroFileReader, parse_schema

    reader_fields = None
    if reader_schema is not None:
        rs = parse_schema(reader_schema)
        if not (isinstance(rs, dict) and rs.get("type") == "record"):
            raise DescriptorError("reader schema must be a record")
        reader_fields = {f["name"] for f in rs.get("fields", [])}

    with open(path, "rb") as f:
        reader = AvroFileReader(f)
        desc = compile_descriptor(reader.schema, reader.names,
                                  map_key=map_key,
                                  reader_fields=reader_fields)
        ctx = lib.mlease_ctx_new(desc.encode(), 1 if ignore_value else 0)
        if not ctx:
            raise RuntimeError(f"bad descriptor: {desc}")
        try:
            deflated = 1 if reader.codec == "deflate" else 0
            reader.codec = "null"  # keep payload compressed; C++ inflates
            if nthreads != 1:
                blocks = list(reader.blocks())  # [(count, payload bytes)]
                n = len(blocks)
                if nthreads <= 0:
                    nthreads = min(os.cpu_count() or 1, 8, max(n, 1))
                datas = (ctypes.c_char_p * n)(*[p for _, p in blocks])
                sizes = (ctypes.c_int64 * n)(*[len(p) for _, p in blocks])
                counts = (ctypes.c_int64 * n)(*[c for c, _ in blocks])
                rc = lib.mlease_decode_blocks_mt(ctx, datas, sizes, counts,
                                                 n, deflated, nthreads)
                if rc != 0:
                    raise RuntimeError(
                        f"native decode failed ({rc}): "
                        f"{lib.mlease_error(ctx).decode()}")
            else:
                for count, payload in reader.blocks():
                    rc = lib.mlease_decode_block(ctx, payload, len(payload),
                                                 count, deflated)
                    if rc != 0:
                        raise RuntimeError(
                            f"native decode failed ({rc}): "
                            f"{lib.mlease_error(ctx).decode()}")

            n = lib.mlease_num_rows(ctx)
            nf = lib.mlease_num_feats(ctx)
            nv = lib.mlease_vocab_size(ctx)
            arena_sz = lib.mlease_vocab_arena_size(ctx)
            key_sz = lib.mlease_key_arena_size(ctx)

            response = np.empty(n, np.int32)
            weight = np.empty(n, np.float32)
            offset = np.empty(n, np.float32)
            row_start = np.empty(n + 1, np.int64)
            lib.mlease_copy_rows(
                ctx, response.ctypes.data_as(ctypes.c_void_p),
                weight.ctypes.data_as(ctypes.c_void_p),
                offset.ctypes.data_as(ctypes.c_void_p),
                row_start.ctypes.data_as(ctypes.c_void_p))

            feat_id = np.empty(nf, np.int32)
            feat_val = np.empty(nf, np.float32)
            lib.mlease_copy_feats(
                ctx, feat_id.ctypes.data_as(ctypes.c_void_p),
                feat_val.ctypes.data_as(ctypes.c_void_p))

            arena = np.empty(arena_sz, np.uint8)
            offs = np.empty(nv, np.int64)
            lens = np.empty(nv, np.int32)
            lib.mlease_copy_vocab(
                ctx, arena.ctypes.data_as(ctypes.c_void_p),
                offs.ctypes.data_as(ctypes.c_void_p),
                lens.ctypes.data_as(ctypes.c_void_p))
            raw = arena.tobytes()
            vocab_names = [raw[offs[i]:offs[i] + lens[i]].decode("utf-8")
                           for i in range(nv)]

            keys = None
            if map_key:
                karena = np.empty(key_sz, np.uint8)
                kstart = np.empty(n + 1, np.int64)
                lib.mlease_copy_keys(
                    ctx, karena.ctypes.data_as(ctypes.c_void_p),
                    kstart.ctypes.data_as(ctypes.c_void_p))
                kraw = karena.tobytes()
                keys = [kraw[kstart[i]:kstart[i + 1]].decode("utf-8")
                        for i in range(n)]

            return DecodedRows(response, weight, offset, row_start, feat_id,
                               feat_val, vocab_names, keys)
        finally:
            lib.mlease_ctx_free(ctx)
