"""The arithmetic a reference runs in: 'f64' (float64), 'f32' (float32,
TF32 off) or 'tf32' (float32 with every product's operands rounded to
TF32's 10-bit mantissa and float32 sums: what the tensor cores compute with
TF32 on, on any device; in the backward pass the incoming gradient, an
operand of the backward products, is rounded alike). 'tf32' is the
control: the reference one step below the float32 the configurations
state."""
from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("f64", "f32", "tf32")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest, ties
    to even, on the bit pattern."""
    i = x.detach().to(torch.float32).contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


class _Operand(torch.autograd.Function):
    """An operand rounded to TF32; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Product(torch.autograd.Function):
    """A product's result unchanged; the gradient it receives, an operand
    of the backward products, rounded to TF32."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return tf32(g)


class Arith:
    """Products in one of ``MODES``: ``dtype`` of the states and tables,
    ``mm``, ``linear``, ``conv2d`` and ``conv_transpose2d``."""

    def __init__(self, mode: str):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "f64" else torch.float32

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(x) if self.mode == "tf32" else x

    def _p(self, y: torch.Tensor) -> torch.Tensor:
        return _Product.apply(y) if self.mode == "tf32" else y

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._p(self._r(a) @ self._r(b))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
        """x·wᵀ + b with w stored (out, in), as torch's Linear keeps it."""
        y = self.mm(x, w.t())
        return y if b is None else y + b

    def conv2d(self, x, w, b, stride: int = 1, padding: int = 0):
        return self._p(F.conv2d(self._r(x), self._r(w), b, stride=stride, padding=padding))

    def conv_transpose2d(self, x, w, b, stride: int = 1, padding: int = 0):
        return self._p(F.conv_transpose2d(self._r(x), self._r(w), b, stride=stride,
                                          padding=padding))
