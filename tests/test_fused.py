"""Deep-fused conv3x3+ReLU+conv1x1+ReLU differential tests.

The flagship op (call stack 3.3 in SURVEY.md). The oracle composes the
standalone conv3x3 oracle -> u8 requant -> 1x1 oracle, checking the fused
kernel's register-resident intermediate is bit-identical to the composed path
(the reference's key dataflow invariant, src/jit_conv_kernel.cc:176-184).
"""
import numpy as np
import pytest

from deepfusion_tpu.config import ConvConfig
from deepfusion_tpu.ops.conv import conv
from deepfusion_tpu.ops.ref import conv_ref, requant_ref, conv_acc_ref
from deepfusion_tpu.types import dtype, round_mode
from deepfusion_tpu.utils.logger import CheckError
from deepfusion_tpu.utils.mathutil import conv_output_size

from helpers import compare, fill_data

# (mb, ic, ih, iw, oc, ph, sh, oc1x1) for 3x3 conv0 — adapted from
# test/test_conv.cc:86-92 with consistent geometry
FUSED_SHAPES = [
    (2, 32, 13, 13, 32, 0, 1, 64),
    (2, 32, 13, 13, 32, 1, 1, 32),
    (1, 16, 10, 12, 32, 1, 2, 16),
]


def build(shape, bia_dt, bia1_dt, dst_dt, rng, scales="scalar",
          conv1_relu=True, rnd0=round_mode.nearest, rnd1=round_mode.nearest):
    mb, ic, ih, iw, oc, ph, sh, oc1 = shape
    kh = kw = 3
    src = fill_data((mb, ih, iw, ic), "u8", rng)
    wei = fill_data((oc, ic, kh, kw), "s8", rng)
    wei1 = fill_data((oc1, oc, 1, 1), "s8", rng)
    bia = None if bia_dt is None else fill_data((oc,), bia_dt, rng)
    bia1 = None if bia1_dt is None else fill_data((oc1,), bia1_dt, rng)
    if scales == "scalar":
        sc0, sc1 = (0.02,), (0.4,)
    else:
        sc0 = rng.uniform(0.005, 0.03, oc).astype(np.float32)
        sc1 = rng.uniform(0.1, 0.9, oc1).astype(np.float32)
    oh = conv_output_size(ih, kh, sh, ph)
    ow = conv_output_size(iw, kw, sh, ph)
    cfg = ConvConfig.make(
        (mb, ih, iw, ic), (oc, ic, kh, kw),
        None if bia is None else bia.dtype,
        (sh, sh), (ph, ph), (mb, oh, ow, oc1), dst_dt,
        conv0_scales=sc0, conv0_round=rnd0,
        wei1x1_shape=(oc1, oc, 1, 1),
        bia1x1_dt=None if bia1 is None else bia1.dtype,
        conv1_relu=conv1_relu, conv1_scales=sc1, conv1_round=rnd1)
    return cfg, src, wei, bia, wei1, bia1, sc0, sc1


def run(cfg, src, wei, bia, wei1, bia1, sc0, sc1, dst_dt):
    return conv(src, wei, bia, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw),
                dst_dtype=dst_dt, conv0_scales=sc0,
                conv0_round_mode=cfg.conv0_round,
                wei1x1=wei1, bia1x1=bia1, conv1_relu=cfg.conv1_relu,
                conv1_scales=sc1, conv1_round_mode=cfg.conv1_round)


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("dst_dt", ["u8", "s8", "s32", "f32"])
def test_fused_shapes_dtypes(shape, dst_dt, rng):
    cfg, *rest = build(shape, "s32", "s32", dst_dt, rng)
    out = run(cfg, *rest, dst_dt)
    compare(out, conv_ref(cfg, rest[0], rest[1], rest[2], rest[3], rest[4]),
            f"fused {shape} -> {dst_dt}")


@pytest.mark.parametrize("bia_dt,bia1_dt", [("s8", "s8"), ("s8", None),
                                            (None, "s32"), (None, None),
                                            ("u8", "f32"), ("f32", "u8")])
def test_fused_bias_combos(bia_dt, bia1_dt, rng):
    cfg, *rest = build(FUSED_SHAPES[1], bia_dt, bia1_dt, "u8", rng)
    out = run(cfg, *rest, "u8")
    compare(out, conv_ref(cfg, rest[0], rest[1], rest[2], rest[3], rest[4]),
            f"fused bias {bia_dt}/{bia1_dt}")


def test_fused_per_channel_scales(rng):
    cfg, *rest = build(FUSED_SHAPES[0], "s32", "s32", "s8", rng,
                       scales="per_oc")
    out = run(cfg, *rest, "s8")
    compare(out, conv_ref(cfg, rest[0], rest[1], rest[2], rest[3], rest[4]),
            "fused per-oc scales")


@pytest.mark.parametrize("rnd0,rnd1", [(round_mode.down, round_mode.nearest),
                                       (round_mode.nearest, round_mode.down)])
def test_fused_round_modes(rnd0, rnd1, rng):
    cfg, *rest = build(FUSED_SHAPES[1], "s32", "s32", "s8", rng,
                       rnd0=rnd0, rnd1=rnd1)
    out = run(cfg, *rest, "s8")
    compare(out, conv_ref(cfg, rest[0], rest[1], rest[2], rest[3], rest[4]),
            f"fused round {rnd0}/{rnd1}")


def test_fused_equals_composed_pipeline(rng):
    """The dataflow invariant: fused == conv0->u8 then conv1, composed from
    *independent* oracle stages (not the fused oracle)."""
    cfg, src, wei, bia, wei1, bia1, sc0, sc1 = build(
        FUSED_SHAPES[1], "s32", "s32", "u8", rng)
    out = run(cfg, src, wei, bia, wei1, bia1, sc0, sc1, "u8")
    acc = conv_acc_ref(src, wei, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw))
    inter = requant_ref(acc, bia, sc0, True, cfg.conv0_round, dtype.u8)
    w1 = wei1.reshape(wei1.shape[0], wei1.shape[1]).astype(np.int32)
    acc1 = np.einsum("nhwc,oc->nhwo", inter.astype(np.int32), w1)
    ref = requant_ref(acc1, bia1, sc1, cfg.conv1_relu, cfg.conv1_round,
                      dtype.u8)
    compare(out, ref, "fused vs composed")


@pytest.mark.slow
def test_fused_large_shape(rng):
    # the reference's big case: mb2 ic32 @120x360 -> oc64 -> oc1x1 32
    shape = (1, 32, 60, 90, 64, 1, 1, 32)  # scaled spatial for CPU interpret
    cfg, *rest = build(shape, "s32", "s32", "u8", rng)
    out = run(cfg, *rest, "u8")
    compare(out, conv_ref(cfg, rest[0], rest[1], rest[2], rest[3], rest[4]),
            "fused large")


def test_fused_rejects_bad_1x1_channels():
    with pytest.raises(CheckError):
        ConvConfig.make((2, 13, 13, 32), (32, 32, 3, 3), None, (1, 1), (1, 1),
                        (2, 13, 13, 64), "u8",
                        wei1x1_shape=(64, 48, 1, 1))  # ic1x1 != oc


def test_fused_rejects_non_1x1():
    with pytest.raises(CheckError):
        ConvConfig.make((2, 13, 13, 32), (32, 32, 3, 3), None, (1, 1), (1, 1),
                        (2, 13, 13, 64), "u8",
                        wei1x1_shape=(64, 32, 3, 3))
