"""Layout transforms: weight packing and activation prep.

Reference parity: the ``OIhw4i16o4i`` weight pre-pack that lets x86 load
4 input channels x 16 output channels as one zmm for ``vpdpbusd``
(``src/jit_conv_kernel.cc:512-564``). The int8 tensor-core products take a
plain 2-D int8 operand, so the pack here is: OIHW -> (KH*KW*ICP, OCP) with
channels zero-padded to multiples of 32 (config.CHANNEL_ALIGN).

u8 activation handling: int8 tensor-core products are s8 x s8, so u8
activations are
shifted to s8 (x - 128) and the exact correction term
``128 * sum_{taps,ic} w`` is folded in as a per-oc int32 vector:

    conv_u8s8(x, w) = conv_s8s8(pad(x) - 128, w) + 128 * colsum(w)

This identity is exact in int32 *because the shifted padding value (-128)
participates in every tap*: the per-pixel difference is always
``128 * sum over ALL taps`` regardless of how many taps fall inside the
image. The same trick feeds the fused 1x1 stage its u8 intermediate.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import ConvConfig
from ..types import dtype


def pack_conv_weights(wei_oihw: np.ndarray, icp: int, ocp: int) -> np.ndarray:
    """OIHW s8 -> (KW*KH*ICP, OCP) s8, zero-padded channels.

    The row order is (kw, kh, ic): tap (ki, kj) owns the ICP rows starting
    at (kj*KH + ki)*ICP, the order in which the conv kernel's K loop and
    the plain XLA twin's im2col patch walk the taps.
    """
    w = np.asarray(wei_oihw)
    oc, ic, kh, kw = w.shape
    out = np.zeros((kw, kh, icp, ocp), dtype=np.int8)
    # (oc,ic,kh,kw) -> (kw,kh,ic,oc)
    out[:, :, :ic, :oc] = np.transpose(w, (3, 2, 1, 0))
    return out.reshape(kw * kh * icp, ocp)


def pack_1x1_weights(wei_oihw: np.ndarray, icp: int, ocp: int) -> np.ndarray:
    """(OC1,IC,1,1) s8 -> (ICP, OCP) s8 for the fused 1x1 matmul."""
    w = np.asarray(wei_oihw)
    oc1, ic = w.shape[0], w.shape[1]
    out = np.zeros((icp, ocp), dtype=np.int8)
    out[:ic, :oc1] = w.reshape(oc1, ic).T
    return out


def u8_shift_correction(packed_wei: np.ndarray) -> np.ndarray:
    """Per-output-channel exact correction: 128 * column-sum of the packed
    weight matrix, int32. Add to the s8-matmul accumulator to recover the
    u8-activation accumulator."""
    return 128 * packed_wei.astype(np.int32).sum(axis=0)


def widen_bias(bias, bia_dt, ocp: int) -> np.ndarray:
    """Bias widened to f32 and zero-padded to ocp.

    Reference widens u8/s8/s32 bias to f32 in-kernel
    (``src/jit_conv_kernel.cc:238-254``); doing it at pack time is
    numerically identical (all int bias values are exactly representable).
    """
    out = np.zeros((ocp,), dtype=np.float32)
    if bias is not None:
        b = np.asarray(bias).reshape(-1).astype(np.float32)
        out[:b.size] = b
    return out


def widen_scales(scales, oc: int, ocp: int) -> np.ndarray:
    """Scales broadcast to per-channel f32, padded to ocp (pad value 1.0).

    In-kernel the x86 code indexes the scale vector per 16-channel block
    (``src/jit_conv_kernel.cc:232-233``); a dense per-channel vector is the
    equivalent and is bit-identical under f32 multiply.
    """
    sc = np.asarray(scales, dtype=np.float32).reshape(-1)
    out = np.ones((ocp,), dtype=np.float32)
    out[:oc] = sc if sc.size > 1 else np.full((oc,), sc[0], np.float32)
    return out


def prep_src(cfg: ConvConfig, src_u8, xp=np):
    """Activation prep: NHWC u8 -> spatially padded, channel-padded,
    shifted-to-s8 tensor of shape (N, IHP, IWP8, ICP), where IWP8 rounds
    the padded width up to a multiple of 8 (the flat layout of
    ops/conv.py).

    Works with numpy (host) or jax.numpy (traced, one fused XLA pass). Channel-pad and width-pad slots hold -128 after the shift,
    matching the spatial padding, so the single constant correction term
    stays exact (their weights are zero) and the extra columns only feed
    discarded out-of-row outputs.
    """
    from ..utils.mathutil import round_up

    src = xp.asarray(src_u8)
    n, ih, iw, ic = src.shape
    iwp8 = round_up(iw + 2 * cfg.pw, 8)
    pad = ((0, 0), (cfg.ph, cfg.ph),
           (cfg.pw, iwp8 - iw - cfg.pw), (0, cfg.icp - ic))
    padded = xp.pad(src, pad)  # zero-pad in u8 domain
    return (padded.astype(xp.int16) - 128).astype(xp.int8)


# --------------------------------------------------------------- strided
# Space-to-depth lowering (the packed domain's strided convs): a
# stride-(sh,sw) conv is exactly a stride-1 conv over the (sh*sw*ic)-channel
# s2d grid with remapped weights. Original tap (ki,kj) reading input row
# oi*sh+ki lands at s2d tap (ki//sh, kj//sw) in channel group
# (ki%sh)*sw + (kj%sw); s2d slots with no original tap get zero weights, so
# the result is bit-identical (the u8-shift correction only sums weight
# columns, and zero rows contribute nothing).


def _s2d_regroup(x, ih2: int, iw2: int, sh: int, sw: int, ic: int, xp):
    """(N, ih2*sh, iw2*sw, IC) -> (N, ih2, iw2, sh*sw*IC) with channel group
    g = (row%sh)*sw + (col%sw), i.e. channel index g*ic + c.

    Equivalent to reshape(n,ih2,sh,iw2,sw,ic) + transpose(0,1,3,2,4,5),
    but expressed as sh strided ROW slices + a pure reshape + one channel
    concat: the W-direction regroup is a no-op relayout (cols are already
    contiguous as (iw2, sw*ic)), so the only data movement XLA sees is
    row-strided copies of full rows, each contiguous in memory."""
    n = x.shape[0]
    slabs = [x[:, a::sh].reshape(n, ih2, iw2, sw * ic) for a in range(sh)]
    return slabs[0] if sh == 1 else xp.concatenate(slabs, axis=-1)


def s2d_taps(cfg: ConvConfig) -> Tuple[int, int]:
    """Kernel extent of the stride-1 equivalent on the s2d grid."""
    return (cfg.kh - 1) // cfg.sh + 1, (cfg.kw - 1) // cfg.sw + 1


def s2d_cfg(cfg: ConvConfig) -> ConvConfig:
    """The stride-1 ConvConfig equivalent to a strided `cfg` on the s2d
    grid. Output geometry, dtypes, scales, fusion and post-ops carry over
    unchanged; only the input-side geometry is re-expressed."""
    kh2, kw2 = s2d_taps(cfg)
    ic2 = cfg.sh * cfg.sw * cfg.ic
    ih2 = cfg.oh + kh2 - 1
    iw2 = cfg.ow + kw2 - 1
    out_oc = cfg.oc1x1 if cfg.fuse_conv1x1 else cfg.oc
    return ConvConfig.make(
        (cfg.bs, ih2, iw2, ic2), (cfg.oc, ic2, kh2, kw2), cfg.bia_dt,
        (1, 1), (0, 0), (cfg.bs, cfg.oh, cfg.ow, out_oc), cfg.dst_dt,
        conv0_relu=cfg.conv0_relu, conv0_scales=cfg.conv0_scales,
        conv0_round=cfg.conv0_round,
        wei1x1_shape=(cfg.oc1x1, cfg.oc, 1, 1) if cfg.fuse_conv1x1 else None,
        bia1x1_dt=cfg.bia1x1_dt, conv1_relu=cfg.conv1_relu,
        conv1_scales=cfg.conv1_scales, conv1_round=cfg.conv1_round,
        groups=cfg.gp, sum_dt=cfg.sum_dt if cfg.with_sum else None,
        sum_scale=cfg.sum_scale)


def s2d_weights(cfg: ConvConfig, wei_oihw: np.ndarray) -> np.ndarray:
    """OIHW weights of the strided conv -> OIHW weights of the s2d conv."""
    w = np.asarray(wei_oihw)
    oc, ic, kh, kw = w.shape
    kh2, kw2 = s2d_taps(cfg)
    out = np.zeros((oc, cfg.sh * cfg.sw * ic, kh2, kw2), w.dtype)
    for ki in range(kh):
        qi, a = divmod(ki, cfg.sh)
        for kj in range(kw):
            qj, b = divmod(kj, cfg.sw)
            g = a * cfg.sw + b
            out[:, g * ic:(g + 1) * ic, qi, qj] = w[:, :, ki, kj]
    return out


def s2d_image_u8(cfg: ConvConfig, src_u8, xp=np):
    """NHWC u8 -> the s2d-grid NHWC u8 image of the strided conv `cfg`
    (conv padding baked in as u8 zeros; no channel/width padding, no -128
    shift). ``pack_image(s2d_image_u8(src, cfg), spec)`` yields the packed s2d
    input for a strided ``PackedConvOp``."""
    cfg2 = s2d_cfg(cfg)
    src = xp.asarray(src_u8)
    n, ih, iw, ic = src.shape
    sh, sw = cfg.sh, cfg.sw
    hp, wp = cfg2.ih * sh, cfg2.iw * sw
    take_h = min(ih, hp - cfg.ph)
    take_w = min(iw, wp - cfg.pw)
    x = src[:, :take_h, :take_w, :]
    x = xp.pad(x, ((0, 0), (cfg.ph, hp - cfg.ph - take_h),
                   (cfg.pw, wp - cfg.pw - take_w), (0, 0)))
    if xp is np:
        # host path: the native C++ regroup when the runtime is built
        # (native/dfruntime.cc df_s2d_regroup; numpy fallback inside)
        from ..native import runtime
        return runtime.s2d_regroup(x, cfg2.ih, cfg2.iw, sh, sw, ic)
    return _s2d_regroup(x, cfg2.ih, cfg2.iw, sh, sw, ic, xp)


def pack_all(cfg: ConvConfig, wei, bias=None, wei1x1=None, bias1x1=None
             ) -> dict:
    """One-stop host-side pack for a ConvConfig. Returns the kernel operand
    dict: packed weights, int32 corrections (bias-folded), f32 bias/scales."""
    w3 = pack_conv_weights(np.asarray(wei, dtype=np.int8), cfg.icp, cfg.ocp)
    out = {
        "w3": w3,
        "corr0": u8_shift_correction(w3),
        "bias0": widen_bias(bias, cfg.bia_dt, cfg.ocp),
        "scale0": widen_scales(cfg.conv0_scales, cfg.oc, cfg.ocp),
    }
    if cfg.fuse_conv1x1:
        w1 = pack_1x1_weights(np.asarray(wei1x1, dtype=np.int8),
                              cfg.ocp, cfg.oc1x1p)
        out.update({
            "w1": w1,
            "corr1": u8_shift_correction(w1),
            "bias1": widen_bias(bias1x1, cfg.bia1x1_dt, cfg.oc1x1p),
            "scale1": widen_scales(cfg.conv1_scales, cfg.oc1x1, cfg.oc1x1p),
        })
    return out
