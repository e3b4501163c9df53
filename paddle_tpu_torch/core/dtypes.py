"""Dtype registry: paddle's dtype names and torch dtypes.

Port of paddle_tpu/core/dtypes.py. The 64-bit policy is kept: a request
for a 64-bit dtype narrows to its 32-bit counterpart, and 64-bit integer
host data is narrowed with a range check instead of a silent wrap.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "narrow_host_array"]

_ALIASES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "fp32": torch.float32,
    "fp64": torch.float64,
}

_DEVICE_NARROW = {
    torch.int64: torch.int32,
    torch.uint64: torch.uint32,
    torch.float64: torch.float32,
    torch.complex128: torch.complex64,
}


def narrow_host_array(arr):
    """Narrow a 64-bit-integer numpy array to int32/uint32, raising
    OverflowError when values do not fit (instead of wrapping silently)."""
    if arr.dtype == np.int64:
        if arr.size and (int(arr.max()) > 2**31 - 1
                         or int(arr.min()) < -2**31):
            raise OverflowError(
                "int64 value out of int32 range: integer data is stored as "
                "int32 (64-bit dtypes narrow to 32 bits)")
        return arr.astype(np.int32)
    if arr.dtype == np.uint64:
        if arr.size and int(arr.max()) > 2**32 - 1:
            raise OverflowError(
                "uint64 value out of uint32 range: integer data is stored as "
                "uint32 (64-bit dtypes narrow to 32 bits)")
        return arr.astype(np.uint32)
    return arr


def _convert_dtype_raw(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
    else:
        # numpy dtypes and scalar types (ml_dtypes' bfloat16 is named so)
        key = np.dtype(dtype).name
    if key not in _ALIASES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _ALIASES[key]


def convert_dtype(dtype):
    """Normalize a dtype spec (str, numpy dtype, torch dtype) to a torch
    dtype; 64-bit specs narrow to their 32-bit counterparts."""
    dt = _convert_dtype_raw(dtype)
    return _DEVICE_NARROW.get(dt, dt)
