"""The arithmetic the plain reference runs in.

``F64`` is the reference proper. ``TF32`` is its control: the precision
below the float32 that the configurations state (with TF32 off), so the
comparison that decides ``correct`` must fail it. TF32 keeps float32's
range and 10 of its 23 mantissa bits; here every operand the reference
marks with ``rnd`` is rounded to nearest (ties to even) to those bits and
the arithmetic in between runs in float32, as a TF32 tensor-core product
rounds its inputs and accumulates in float32.
"""

from __future__ import annotations

import dataclasses

import torch


def tf32_round(x):
    """x rounded to TF32's 10-bit mantissa, as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _exact(x):
    return x


def _tf32_keep_grad(x):
    """tf32_round in the forward pass, the identity for autograd."""
    return x + (tf32_round(x.detach()) - x.detach())


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype
    rnd: object


F64 = Precision("float64", torch.float64, _exact)
TF32 = Precision("tf32", torch.float32, _tf32_keep_grad)

PRECISIONS = {p.name: p for p in (F64, TF32)}
