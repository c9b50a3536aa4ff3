"""Zero-stripping array compression (the reference's U1), pure numpy.

Wire-compatible with ``Utilities::compress_array``/``decompress_array``
(src/utilities/RayUtilities.h:93-207). Three modes:

* 0 -- raw little-endian dump
* 1 -- bitmask-of-nonzeros + dense nonzero values, with two special cases:
       all-zero arrays collapse to the single byte ``7`` and arrays whose
       compressed form would not be smaller are stored dense
* 2 -- downcast float64 -> float32, then mode 1

Plus the bool specialization: plain bit-packing.

Implementation is vectorized numpy rather than the reference's scalar loops.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compress_array", "decompress_array", "compress_bool", "decompress_bool"]


def compress_array(data: np.ndarray, method: int) -> bytes:
    """Compress a 1-D numeric array; returns the wire bytes."""
    data = np.ascontiguousarray(data)
    n = data.size
    if method == 0:
        return data.tobytes()
    if method == 2:
        return compress_array(data.astype(np.float32), 1)
    if method != 1:
        raise ValueError(f"Unknown compression method {method}")
    itemsize = data.dtype.itemsize
    nonzero = data != 0
    n_nonzero = int(np.count_nonzero(nonzero))
    if n_nonzero == 0:
        # Special case: everything is zero (RayUtilities.h:108-112)
        return bytes([7])
    mask_bytes = (n + 7) // 8
    if n_nonzero * itemsize + mask_bytes >= n * itemsize:
        # Dense storage is no worse (RayUtilities.h:113-119)
        return data.tobytes()
    mask = np.packbits(nonzero.view(np.uint8), bitorder="little")
    return mask.tobytes() + data[nonzero].tobytes()


def decompress_array(n: int, payload: bytes, method: int, dtype) -> np.ndarray:
    """Decompress ``payload`` into an array of ``n`` elements of ``dtype``."""
    dtype = np.dtype(dtype)
    if method == 0:
        out = np.frombuffer(payload, dtype=dtype, count=n).copy()
        return out
    if method == 2:
        return decompress_array(n, payload, 1, np.float32).astype(dtype)
    if method != 1:
        raise ValueError(f"Unknown compression method {method}")
    nb = len(payload)
    if nb <= 1:
        # NULL / all-zero array (RayUtilities.h:170-175)
        return np.zeros(n, dtype=dtype)
    if nb == n * dtype.itemsize:
        return np.frombuffer(payload, dtype=dtype, count=n).copy()
    mask_bytes = (n + 7) // 8
    mask = np.unpackbits(
        np.frombuffer(payload[:mask_bytes], dtype=np.uint8), bitorder="little"
    )[:n].astype(bool)
    values = np.frombuffer(payload[mask_bytes:], dtype=dtype)
    out = np.zeros(n, dtype=dtype)
    out[mask] = values[: int(np.count_nonzero(mask))]
    return out


def compress_bool(data: np.ndarray) -> bytes:
    """Bool specialization = bit packing (RayUtilities.h:51-55 decl)."""
    data = np.asarray(data, dtype=bool)
    return np.packbits(data.view(np.uint8), bitorder="little").tobytes()


def decompress_bool(n: int, payload: bytes) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8), bitorder="little")
    return bits[:n].astype(bool)
