"""Roadmap fused ops: pooling, conv(+ReLU)+pooling and eltwise-sum+ReLU.

The reference lists these as planned (README.md:64-65) and documents their
intended semantics via the MKL-DNN pipeline it builds in
test/test_conv_relu_pooling.cc:313-391 (conv + optional eltwise-sum post-op
+ relu + max/avg pooling over VGG/ResNet layer shapes).

Pooling is ``lax.reduce_window`` and the eltwise sum one elementwise loop:
both are bandwidth-bound, and XLA fuses them with their neighbours.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ConvConfig, PoolConfig
from ..types import dtype, round_mode
from ..utils.logger import check_eq
from ..utils.mathutil import conv_output_size
from .requant import round_f32, saturate_to


# ---------------------------------------------------------------- pooling

def _max_identity(dt: dtype):
    return {dtype.u8: 0, dtype.s8: -128, dtype.s32: -(2 ** 31),
            dtype.f32: -np.inf}[dt]


def _avg_exc_counts(pc: PoolConfig) -> np.ndarray:
    """Per-output count of window taps inside the image, (oh, ow) f32."""
    ones = np.zeros((pc.ih + pc.ph + pc.pb, pc.iw + pc.pw + pc.pr),
                    np.int32)
    ones[pc.ph:pc.ph + pc.ih, pc.pw:pc.pw + pc.iw] = 1
    cnt = np.zeros((pc.oh, pc.ow), np.int32)
    for ki in range(pc.kh):
        for kj in range(pc.kw):
            hs = slice(ki, ki + (pc.oh - 1) * pc.sh + 1, pc.sh)
            ws = slice(kj, kj + (pc.ow - 1) * pc.sw + 1, pc.sw)
            cnt += ones[hs, ws]
    return cnt.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("pc", "dt"))
def _pool_call(pc: PoolConfig, dt: dtype, x):
    window = (1, pc.kh, pc.kw, 1)
    strides = (1, pc.sh, pc.sw, 1)
    pads = ((0, 0), (pc.ph, pc.pb), (pc.pw, pc.pr), (0, 0))
    if pc.kind == "max":
        init = np.asarray(_max_identity(dt), dtype=dt.np)
        return jax.lax.reduce_window(x, init, jax.lax.max, window, strides,
                                     pads)
    is_int = dt != dtype.f32
    xs = x.astype(jnp.int32) if is_int else x
    sums = jax.lax.reduce_window(xs, np.zeros((), xs.dtype), jax.lax.add,
                                 window, strides, pads)
    if pc.kind == "avg_inc":
        denom = np.float32(pc.kh * pc.kw)
    else:
        denom = _avg_exc_counts(pc)[None, :, :, None]
    val = sums.astype(jnp.float32) / denom
    if is_int:
        return saturate_to(round_f32(val, pc.round), dt)
    return val


def pool(x, kind: str, kernel, stride, padding,
         round=round_mode.nearest):
    """Standalone max/avg pooling over NHWC (any supported dtype)."""
    x = jnp.asarray(x)
    dt = dtype.from_any(x.dtype)
    pc = PoolConfig.make(kind, (x.shape[1], x.shape[2]), kernel, stride,
                         padding, round)
    return _pool_call(pc, dt, x)


# ------------------------------------------- fused conv(+relu)+pool

def conv_relu_pool(src, wei, bia, stride, padding, *, dst_dtype,
                   conv_scales=(1.0,), conv_relu=True,
                   conv_round_mode=round_mode.nearest,
                   pool_kind="max", pool_kernel=(2, 2), pool_stride=(2, 2),
                   pool_padding=(0, 0), pool_round_mode=round_mode.nearest):
    """Conv+ReLU+pooling (the planned op at
    test/test_conv_relu_pooling.cc:264-281): the conv path followed by the
    pooling window under one jit (ops/convpool.py)."""
    from .convpool import ConvPoolOp

    src = np.asarray(src) if not hasattr(src, "dtype") else src
    wei = np.asarray(wei)
    n, ih, iw, ic = src.shape
    oc, _, kh, kw = wei.shape
    oh = conv_output_size(ih, kh, stride[0], padding[0])
    ow = conv_output_size(iw, kw, stride[1], padding[1])
    cfg = ConvConfig.make(
        (n, ih, iw, ic), tuple(wei.shape),
        None if bia is None else np.asarray(bia).dtype,
        stride, padding, (n, oh, ow, oc), dst_dtype,
        conv0_relu=conv_relu, conv0_scales=conv_scales,
        conv0_round=conv_round_mode)
    pc = PoolConfig.make(pool_kind, (oh, ow), pool_kernel, pool_stride,
                         pool_padding, pool_round_mode)
    return ConvPoolOp(cfg, pc, wei, bia)(src)


# ------------------------------------------- eltwise sum + relu

@functools.partial(jax.jit, static_argnames=("dt", "with_relu"))
def _sum_relu_call(dt: dtype, with_relu: bool, a, b):
    if dt == dtype.f32:
        s = a + b
        return jnp.maximum(s, 0.0) if with_relu else s
    if dt == dtype.s32:
        # s32 + s32 can exceed int32; the oracle saturates. Overflow iff
        # the operands share a sign and the wrapped sum's sign differs.
        s = a + b
        ovf = ((~(a ^ b)) & (a ^ s)) < 0
        s = jnp.where(ovf, jnp.where(a >= 0, jnp.int32(2 ** 31 - 1),
                                     jnp.int32(-2 ** 31)), s)
        return jnp.maximum(s, 0) if with_relu else s
    s = a.astype(jnp.int32) + b.astype(jnp.int32)
    if with_relu:
        s = jnp.maximum(s, 0)
    lo, hi = (-128, 127) if dt == dtype.s8 else (0, 255)
    return jnp.clip(s, lo, hi).astype(dt.np)


def eltwise_sum_relu(a, b, with_relu: bool = True):
    """Fused elementwise sum + ReLU (roadmap op, README.md:64-65).

    Integer dtypes accumulate in s32 and saturate back; f32 adds in f32.
    """
    a, b = jnp.asarray(a), jnp.asarray(b)
    check_eq(a.shape, b.shape, "eltwise operand shapes")
    check_eq(a.dtype, b.dtype, "eltwise operand dtypes")
    return _sum_relu_call(dtype.from_any(a.dtype), with_relu, a, b)
