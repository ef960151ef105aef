"""Requantization epilogue (traced jnp; runs inside the conv kernel and in
plain XLA code alike).

Implements the reference's store_output chain exactly
(``src/jit_conv_kernel.cc:218-315``; contract in SURVEY.md §4):
s32 acc -> f32 -> +bias -> *scale -> ReLU -> round -> saturating convert.
Integer converts of rounded values go f32 -> int32 -> 8-bit (the x86
sequence vcvtps2dq + vpmov[us]db is the same two-step dance).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import dtype, round_mode


def round_f32(x, mode: round_mode):
    if mode == round_mode.nearest:
        return jax.lax.round(x, jax.lax.RoundingMethod.TO_NEAREST_EVEN)
    return jnp.floor(x)


def saturate_to(x_f32, dst: dtype):
    """Post-round convert with saturation; input must hold integral f32."""
    if dst == dtype.f32:
        return x_f32
    if dst == dtype.s32:
        # vcvtps2dq saturates at the int32 range
        x = jnp.clip(x_f32, -2147483648.0, 2147483647.0)
        return x.astype(jnp.int32)
    lo, hi = (-128.0, 127.0) if dst == dtype.s8 else (0.0, 255.0)
    return jnp.clip(x_f32, lo, hi).astype(jnp.int32).astype(dst.np)


def requant(acc_s32, bias_f32, scale_f32, with_relu: bool,
            mode: round_mode, dst: dtype, sum_term=None,
            round_fn=round_f32):
    """Full epilogue. bias_f32 may be None; bias/scale broadcast over rows.

    ReLU is forced for u8 destinations (``src/jit_conv_kernel.cc:264``).

    sum_term (optional, f32): eltwise-sum post-op operand. Spec note: the
    reference never implemented its sum post-op (README.md:64-65 roadmap);
    ours joins AFTER rounding, in the exact integer domain:

        out = saturate(relu?(round((acc+bias)*scale) + round(sum*sscale)))

    MKL-DNN adds the sum in f32 *before* rounding, but that order is not
    bit-reproducible on XLA: the compiler legally keeps excess precision
    (fma-contracts mul+add, --xla_allow_excess_precision defaults on),
    flipping values at rounding
    boundaries. Integer-domain joins are exact on every backend. For f32
    destinations the sum stays an f32 add (no rounding step exists) and
    comparisons are tolerance-based anyway.

    round_fn(x, mode): the rounding primitive (inside a Triton kernel,
    where no round primitive exists, ``ops.conv._kround``).
    """
    x = acc_s32.astype(jnp.float32)
    if bias_f32 is not None:
        x = x + bias_f32
    x = x * scale_f32
    relu = with_relu or dst == dtype.u8
    if sum_term is None:
        if relu:
            x = jnp.maximum(x, 0.0)
        if dst == dtype.f32:
            return x
        return saturate_to(round_fn(x, mode), dst)
    if dst == dtype.f32:
        x = x + sum_term
        if relu:
            x = jnp.maximum(x, 0.0)
        return x
    # integer dst: round both addends, join exactly, then relu/saturate
    # (relu commutes with the monotone round; round(0) == 0)
    x = round_fn(x, mode) + round_fn(sum_term, mode)
    if relu:
        x = jnp.maximum(x, 0.0)
    return saturate_to(x, dst)


def requant_to_u8_centered(acc_s32, bias_f32, scale_f32, mode: round_mode,
                           zero_mask=None, sum_rounded=None,
                           round_fn=round_f32):
    """Fused-path epilogue: requantize to u8 then shift to s8 (x - 128) for
    the next int8 product. ReLU is always applied (``:275-277`` — the fused
    intermediate is always u8). Returns int8 values in [-128, 127].

    zero_mask (optional, f32 of 0.0/1.0, broadcastable): slots multiplied
    by 0.0 come out as exactly -128 (packed-domain padding).

    sum_rounded (optional, f32 holding integral values): pre-rounded
    eltwise-sum operand, joined in the exact integer domain after this
    stage's own round — the same order as ``requant``'s sum path, so the
    packed-domain sum post-op is bit-identical to the dense one.
    """
    x = acc_s32.astype(jnp.float32)
    if bias_f32 is not None:
        x = x + bias_f32
    x = x * scale_f32
    if zero_mask is not None:
        x = x * zero_mask
    x = round_fn(x, mode)
    if sum_rounded is not None:
        # relu commutes with the monotone round and round(0) == 0
        x = x + sum_rounded
    x = jnp.clip(x, 0.0, 255.0) - 128.0
    return x.astype(jnp.int32).astype(jnp.int8)
