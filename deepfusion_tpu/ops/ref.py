"""Pure-numpy oracle implementations with the reference's exact numerics.

These play the role MKL-DNN plays in the reference test suite
(``test/test_concat.cc:31-87``): an independent implementation each kernel is
compared against element-wise — bit-exact for integer dtypes, 1e-4 relative
for f32 (``test/test_utils.h:73-85``).

Numerical contract (from the reference JIT kernels, see SURVEY.md §4):
 1. conv accumulates u8 x s8 -> s32 (``src/jit_conv_kernel.cc:341`` vpdpbusd)
 2. requant = f32(acc) [+ bias_f32] * scale_f32
    (``src/jit_conv_kernel.cc:259-263``); bias of u8/s8/s32 widened to f32
    (``:238-254``)
 3. ReLU in f32 before rounding; forced when dst is u8 or when feeding the
    fused 1x1 (``:264``, ``:102``)
 4. round nearest = ties-to-even (vcvtps2dq {rn-sae}), down = floor
    (``:267-274``); f32 dst skips rounding (``:267``)
 5. saturate: s32->s8 clamps [-128,127], s32->u8 clamps [0,255]
    (``:287-293``); s32 dst is the rounded value (vcvtps2dq saturates at
    int32 range)
 6. scales: scalar or per-output-channel (``src/op_conv.cc:320,342-344``)
 7. the fused 3x3 intermediate is always requantized to u8 (``:275-277``)

Divergence note: the reference concat applies ReLU with lane-width quirks for
s32 (vpmaxsw, 16-bit lanes — ``src/jit_concat_kernel.cc:45``) and u8
(vpmaxsb signed-byte — ``:49``). Those are bugs outside the tested value
range (|x| <= 16); this oracle and the ops implement *true* ReLU,
which is bit-identical over the reference's own test ranges.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..config import ConvConfig, PoolConfig
from ..types import dtype, round_mode
from ..utils.mathutil import conv_output_size


def round_f32(x: np.ndarray, mode: round_mode) -> np.ndarray:
    """f32 rounding with the reference instruction semantics (contract #4)."""
    x = np.asarray(x, dtype=np.float32)
    if mode == round_mode.nearest:
        return np.rint(x).astype(np.float32)  # ties to even, like {rn-sae}
    return np.floor(x).astype(np.float32)     # toward -inf, like {rd-sae}


def saturate_cast(x_f32: np.ndarray, dst: dtype) -> np.ndarray:
    """Post-round saturating convert (contract #5). Input must be integral."""
    if dst == dtype.f32:
        return x_f32.astype(np.float32)
    lo, hi = {
        dtype.s32: (-2147483648.0, 2147483647.0),
        dtype.s8: (-128.0, 127.0),
        dtype.u8: (0.0, 255.0),
    }[dst]
    return np.clip(x_f32, lo, hi).astype(np.float64).astype(dst.np)


def requant_ref(acc_s32: np.ndarray,
                bias: Optional[np.ndarray],
                scales: Sequence[float],
                with_relu: bool,
                mode: round_mode,
                dst: dtype,
                sum_src: Optional[np.ndarray] = None,
                sum_scale: float = 1.0) -> np.ndarray:
    """The full requantization epilogue (contracts #2-#5).

    acc_s32: (..., oc) int32; bias: (oc,) any supported dtype or None;
    scales: length 1 or oc. sum_src: optional eltwise-sum post-op operand
    added (x sum_scale, in f32) after scaling, before ReLU (MKL-DNN sum
    post-op semantics, the documented intent of the ResNet case in
    test/test_conv_relu_pooling.cc:336-338).
    """
    x = acc_s32.astype(np.float32)
    if bias is not None:
        x = x + np.asarray(bias).astype(np.float32)
    sc = np.asarray(scales, dtype=np.float32).reshape(-1)
    x = x * (sc if sc.size > 1 else sc[0])
    relu = with_relu or dst == dtype.u8
    if sum_src is None:
        if relu:
            x = np.maximum(x, np.float32(0))
        if dst != dtype.f32:
            x = round_f32(x, mode)
        return saturate_cast(x, dst)
    # sum post-op: integer-domain join (see ops/requant.py docstring for
    # why this diverges from MKL-DNN's pre-round f32 add)
    sum_term = (np.float32(sum_scale)
                * np.asarray(sum_src).astype(np.float32))
    if dst == dtype.f32:
        x = x + sum_term
        if relu:
            x = np.maximum(x, np.float32(0))
        return x.astype(np.float32)
    x = round_f32(x, mode) + round_f32(sum_term, mode)
    if relu:
        x = np.maximum(x, np.float32(0))
    return saturate_cast(x, dst)


def concat_relu_ref(srcs: Sequence[np.ndarray], with_relu: bool) -> np.ndarray:
    """Concat along channels (NHWC) + optional true ReLU.

    Oracle for the concat op (reference op: ``src/op_concat.cc:22-72``).
    """
    out = np.concatenate([np.asarray(s) for s in srcs], axis=-1)
    if with_relu:
        if out.dtype == np.uint8:
            pass  # true ReLU is identity on u8
        else:
            out = np.maximum(out, np.zeros((), dtype=out.dtype))
    return out


def conv_acc_ref(src_u8: np.ndarray, wei_s8: np.ndarray,
                 stride, padding) -> np.ndarray:
    """Direct u8 x s8 -> s32 convolution accumulator (contract #1).

    src: (N,H,W,IC) u8; wei: (OC,IC,KH,KW) s8; returns (N,OH,OW,OC) s32.
    Zero padding contributes zero (x86 kernel clips padded taps,
    ``src/op_conv.cc:102-104`` — numerically identical to zero-pad).
    """
    src = np.asarray(src_u8)
    wei = np.asarray(wei_s8)
    n, ih, iw, ic = src.shape
    oc, wic, kh, kw = wei.shape
    assert ic == wic
    sh, sw = stride
    ph, pw = padding
    oh = conv_output_size(ih, kh, sh, ph)
    ow = conv_output_size(iw, kw, sw, pw)
    # accumulate via float64 BLAS matmuls: exact while |acc| < 2^53 (here
    # bounded by kh*kw*ic*255*127 < 2^53 for any ic < 2^31), and orders of
    # magnitude faster than numpy's non-BLAS integer einsum.
    assert kh * kw * ic * 255 * 127 < 2 ** 53
    srcp = np.zeros((n, ih + 2 * ph, iw + 2 * pw, ic), dtype=np.float64)
    srcp[:, ph:ph + ih, pw:pw + iw, :] = src.astype(np.float64)
    w64 = wei.astype(np.float64)  # (oc, ic, kh, kw)
    acc = np.zeros((n, oh, ow, oc), dtype=np.float64)
    for ki in range(kh):
        for kj in range(kw):
            # patch (n, oh, ow, ic)
            patch = srcp[:, ki:ki + (oh - 1) * sh + 1:sh,
                         kj:kj + (ow - 1) * sw + 1:sw, :]
            acc += patch @ w64[:, :, ki, kj].T
    return acc.astype(np.int32)


def conv_ref(cfg: ConvConfig, src_u8, wei_s8, bias=None,
             wei1x1_s8=None, bias1x1=None, sum_src=None) -> np.ndarray:
    """Full conv3x3(+relu)(+conv1x1+relu)(+sum) oracle matching the fused
    JIT kernel's dataflow (``src/jit_conv_kernel.cc:218-315`` + ``:27-191``);
    the optional sum post-op applies to the final stage."""
    acc = conv_acc_ref(src_u8, wei_s8, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw))
    if not cfg.fuse_conv1x1:
        return requant_ref(acc, bias, cfg.conv0_scales, cfg.conv0_relu,
                           cfg.conv0_round, cfg.dst_dt,
                           sum_src=sum_src, sum_scale=cfg.sum_scale)
    # fused: 3x3 result always requantized to u8 (relu forced, contract #7)
    inter_u8 = requant_ref(acc, bias, cfg.conv0_scales, True,
                           cfg.conv0_round, dtype.u8)
    # 1x1 stage: u8 x s8 -> s32 over oc
    w1 = np.asarray(wei1x1_s8).astype(np.float64)  # (oc1x1, oc, 1, 1)
    w1 = w1.reshape(w1.shape[0], w1.shape[1])
    assert w1.shape[1] * 255 * 127 < 2 ** 53  # f64 matmul exactness bound
    acc1 = (inter_u8.astype(np.float64) @ w1.T).astype(np.int32)
    return requant_ref(acc1, bias1x1, cfg.conv1_scales, cfg.conv1_relu,
                       cfg.conv1_round, cfg.dst_dt,
                       sum_src=sum_src, sum_scale=cfg.sum_scale)


def pool_ref(x: np.ndarray, pc: PoolConfig) -> np.ndarray:
    """Max / avg pooling oracle (MKL-DNN semantics, the documented spec in
    ``test/test_conv_relu_pooling.cc:313-391``).

    Integer average pooling accumulates in s32, divides in f32, rounds with
    ``pc.round`` and saturates back to the input dtype.
    """
    x = np.asarray(x)
    n, ih, iw, c = x.shape
    assert (ih, iw) == (pc.ih, pc.iw)
    out_dt = dtype.from_any(x.dtype)
    is_int = out_dt != dtype.f32

    if pc.kind == "max":
        if out_dt == dtype.u8:
            pad_val = 0
        elif out_dt == dtype.s8:
            pad_val = -(2 ** 7)
        elif out_dt == dtype.s32:
            pad_val = -(2 ** 31)
        else:
            pad_val = -np.inf
        xp = np.full((n, ih + pc.ph + pc.pb, iw + pc.pw + pc.pr, c),
                     pad_val, dtype=np.float64 if not is_int else np.int64)
        xp[:, pc.ph:pc.ph + ih, pc.pw:pc.pw + iw, :] = x
        out = np.full((n, pc.oh, pc.ow, c), pad_val,
                      dtype=xp.dtype)
        for ki in range(pc.kh):
            for kj in range(pc.kw):
                hs = slice(ki, ki + (pc.oh - 1) * pc.sh + 1, pc.sh)
                ws = slice(kj, kj + (pc.ow - 1) * pc.sw + 1, pc.sw)
                out = np.maximum(out, xp[:, hs, ws, :])
        return out.astype(x.dtype)

    # average pooling
    xp = np.zeros((n, ih + pc.ph + pc.pb, iw + pc.pw + pc.pr, c),
                  dtype=np.int64 if is_int else np.float64)
    xp[:, pc.ph:pc.ph + ih, pc.pw:pc.pw + iw, :] = x
    ones = np.zeros((ih + pc.ph + pc.pb, iw + pc.pw + pc.pr),
                    dtype=np.int64)
    ones[pc.ph:pc.ph + ih, pc.pw:pc.pw + iw] = 1
    acc = np.zeros((n, pc.oh, pc.ow, c), dtype=xp.dtype)
    cnt = np.zeros((pc.oh, pc.ow), dtype=np.int64)
    for ki in range(pc.kh):
        for kj in range(pc.kw):
            hs = slice(ki, ki + (pc.oh - 1) * pc.sh + 1, pc.sh)
            ws = slice(kj, kj + (pc.ow - 1) * pc.sw + 1, pc.sw)
            acc += xp[:, hs, ws, :]
            cnt += ones[hs, ws]
    denom = (np.float32(pc.kh * pc.kw) if pc.kind == "avg_inc"
             else cnt[None, :, :, None].astype(np.float32))
    val = acc.astype(np.float32) / denom
    if is_int:
        val = round_f32(val, pc.round)
        return saturate_cast(val, out_dt)
    return val.astype(np.float32)


def eltwise_sum_relu_ref(a: np.ndarray, b: np.ndarray,
                         with_relu: bool = True) -> np.ndarray:
    """Eltwise sum + ReLU oracle (roadmap op, README.md:64-65).

    Integer inputs accumulate in s32 then saturate back to the input dtype;
    f32 adds in f32.
    """
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    dt = dtype.from_any(a.dtype)
    if dt == dtype.f32:
        out = a + b
        return np.maximum(out, 0.0).astype(np.float32) if with_relu else out
    s = a.astype(np.int64) + b.astype(np.int64)
    if with_relu:
        s = np.maximum(s, 0)
    lo, hi = {dtype.s32: (-2**31, 2**31 - 1), dtype.s8: (-128, 127),
              dtype.u8: (0, 255)}[dt]
    return np.clip(s, lo, hi).astype(dt.np)
