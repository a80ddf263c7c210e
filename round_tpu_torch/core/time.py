"""Wrap-around-safe round / instance arithmetic.

Port of round_tpu/core/time.py.  Round numbers ("Time") are 32-bit and wrap
around; comparisons are correct as long as the two values are less than
2**31 - 1 apart.  Instance numbers are 16-bit with the same trick.
(Reference semantics: psync Time.scala:7-18 and runtime/Instance.scala:6-33.)

All operations work elementwise on torch tensors, numpy arrays and Python
ints; Python ints and numpy values become CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_i32(x):
    if isinstance(x, (int, np.integer)):
        # py int -> wrapped 32-bit two's complement
        return torch.tensor(((int(x) + 2**31) % 2**32) - 2**31,
                            dtype=torch.int32)
    return torch.as_tensor(x).to(torch.int32)


def _as_i16(x):
    if isinstance(x, (int, np.integer)):
        return torch.tensor(((int(x) + 2**15) % 2**16) - 2**15,
                            dtype=torch.int16)
    return torch.as_tensor(x).to(torch.int16)


class Time:
    """Namespace of wrap-around-safe ops on 32-bit round numbers."""

    dtype = torch.int32

    @staticmethod
    def lt(a, b):
        """a < b modulo wrap-around: true iff (a - b) is negative in int32."""
        return (_as_i32(a) - _as_i32(b)) < 0

    @staticmethod
    def leq(a, b):
        return (_as_i32(a) - _as_i32(b)) <= 0

    @staticmethod
    def gt(a, b):
        return (_as_i32(a) - _as_i32(b)) > 0

    @staticmethod
    def geq(a, b):
        return (_as_i32(a) - _as_i32(b)) >= 0

    @staticmethod
    def max(a, b):
        a32, b32 = _as_i32(a), _as_i32(b)
        return torch.where((a32 - b32) >= 0, a32, b32)

    @staticmethod
    def min(a, b):
        a32, b32 = _as_i32(a), _as_i32(b)
        return torch.where((a32 - b32) <= 0, a32, b32)

    @staticmethod
    def add(a, k):
        return _as_i32(a) + _as_i32(k)

    @staticmethod
    def diff(a, b):
        """Signed distance a - b (valid while |a-b| < 2**31)."""
        return _as_i32(a) - _as_i32(b)


class Instance:
    """Same trick on 16-bit instance ids (2**16 concurrent-instance id space)."""

    dtype = torch.int16

    @staticmethod
    def lt(a, b):
        return (_as_i16(a) - _as_i16(b)) < 0

    @staticmethod
    def leq(a, b):
        return (_as_i16(a) - _as_i16(b)) <= 0

    @staticmethod
    def max(a, b):
        a16, b16 = _as_i16(a), _as_i16(b)
        return torch.where((a16 - b16) >= 0, a16, b16)

    @staticmethod
    def add(a, k):
        return _as_i16(a) + _as_i16(k)
