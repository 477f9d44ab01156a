"""ctypes binding for the native Avro row encoder (native/avro_encode.cpp).

Port of mlease_tpu/io/fast_encode.py, logic unchanged. Encodes vectorized
numpy chunks of reference-schema rows ({response, features[{name,term,
value}], weight, offset} — RegressionPrepare.java:73-192 input contract)
into Avro binary block payloads, about two orders of magnitude faster than
the per-row Python encoder. Files are written through
AvroFileWriter.append_raw_block, so the container framing (and therefore
both decoders) is unchanged. The encoder lives in the same library as the
decoder (mlease_tpu_torch/io/fast_decode.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from mlease_tpu_torch.io.fast_decode import _load


def is_available() -> bool:
    return _load() is not None


def encode_ctr_block(cols: np.ndarray, vals: np.ndarray, y: np.ndarray,
                     weight: np.ndarray | None = None,
                     offset: np.ndarray | None = None) -> bytes:
    """Encode (m, k) rows into one Avro binary block payload.

    cols int32 (m, k) feature ids (rendered as names "f<id>", term "");
    vals float32 (m, k); y int32 (m,) responses; weight/offset float32 (m,)
    or None for the defaults 1.0 / 0.0."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native encoder unavailable")

    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    y = np.ascontiguousarray(y, np.int32)
    m, k = cols.shape
    if vals.shape != (m, k) or y.shape != (m,):
        raise ValueError(f"vals {vals.shape} and y {y.shape} do not match "
                         f"cols {cols.shape}")
    wp = op = None
    if weight is not None:
        weight = np.ascontiguousarray(weight, np.float32)
        if weight.shape != (m,):
            raise ValueError(f"weight {weight.shape} is not ({m},)")
        wp = weight.ctypes.data_as(ctypes.c_void_p)
    if offset is not None:
        offset = np.ascontiguousarray(offset, np.float32)
        if offset.shape != (m,):
            raise ValueError(f"offset {offset.shape} is not ({m},)")
        op = offset.ctypes.data_as(ctypes.c_void_p)

    cap = m * (24 + k * 24) + 64
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = lib.mlease_encode_ctr_block(
            cols.ctypes.data_as(ctypes.c_void_p),
            vals.ctypes.data_as(ctypes.c_void_p),
            y.ctypes.data_as(ctypes.c_void_p), wp, op,
            m, k, ctypes.cast(buf, ctypes.c_void_p), cap)
        if n >= 0:
            return buf.raw[:n]
        cap *= 2
