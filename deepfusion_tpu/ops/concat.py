"""Concat(+ReLU).

Re-design of the reference's JIT concat (``src/jit_concat_kernel.cc:30-128``
+ ``src/op_concat.cc:22-72``). The op is pure bandwidth: XLA fuses the
channel concat and the ReLU into one loop that reads every input once and
writes the output once, which is the HBM roofline for this op.

ReLU semantics: true ReLU per dtype. The reference has two out-of-range
quirks (s32 via 16-bit-lane max, u8 via signed-byte max,
``src/jit_concat_kernel.cc:43-51``) that only diverge outside its tested
value range; see ops/ref.py docstring.
"""
from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp

from ..config import ConcatConfig


def _relu(x):
    if x.dtype == jnp.uint8:
        return x  # true ReLU is the identity on unsigned values
    return jnp.maximum(x, jnp.zeros((), dtype=x.dtype))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _concat_call(cfg: ConcatConfig, *srcs):
    out = jnp.concatenate(srcs, axis=-1)
    return _relu(out) if cfg.with_relu else out


def concat(srcs: Sequence, post_relu: bool = False):
    """Concatenate NHWC tensors along channels, optionally fused with ReLU.

    Functional analogue of ``deepfusion::concat`` + ``op->submit()``
    (``include/deepfusion.h:116-118``). All inputs must share dtype and
    batch/spatial dims; channel counts must satisfy the reference's
    block-divisibility rule (see ConcatConfig.make).
    """
    arrs = [jnp.asarray(s) for s in srcs]
    cfg = ConcatConfig.make([tuple(a.shape) for a in arrs],
                            arrs[0].dtype, post_relu)
    for a in arrs:
        if a.dtype != arrs[0].dtype:
            raise ValueError("concat inputs must share dtype "
                             "(src/jit_concat_kernel.cc:183-185)")
    return _concat_call(cfg, *arrs)
