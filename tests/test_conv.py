"""Conv3x3(+ReLU) differential tests vs the numpy oracle.

Covers what the reference *declared* but left stubbed
(test/test_conv.cc:64-75): 8 dtype-combo suites (src u8 x wei s8 x bias
{s8,s32} x dst {u8,s8,s32,f32}) over the reference shapes, with geometry
corrected to satisfy conv_output_size (the stub cases at
test/test_conv.cc:86-92 are internally inconsistent and never ran).
Adds scale/round-mode/stride/pad coverage the reference's kernel supports
(src/jit_conv_kernel.cc:218-315).
"""
import numpy as np
import pytest

from deepfusion_tpu.config import ConvConfig
from deepfusion_tpu.ops.conv import conv
from deepfusion_tpu.ops.ref import conv_ref
from deepfusion_tpu.types import dtype, round_mode
from deepfusion_tpu.utils.logger import CheckError
from deepfusion_tpu.utils.mathutil import conv_output_size

from helpers import compare, fill_data

# (mb, ic, ih, iw, oc, kh, kw, ph, pw, sh, sw) — geometry-consistent
# adaptations of test/test_conv.cc:86-92
SHAPES = [
    (2, 32, 13, 13, 32, 3, 3, 0, 0, 1, 1),
    (2, 32, 13, 13, 32, 3, 3, 1, 1, 1, 1),
    (1, 16, 8, 10, 48, 3, 3, 1, 1, 2, 2),   # stride-2 coverage
    (1, 8, 6, 6, 16, 1, 1, 0, 0, 1, 1),     # 1x1 as conv0
    (1, 4, 9, 9, 8, 5, 5, 2, 2, 1, 1),      # 5x5 kernel
]


def make_case(shape, bia_dt, dst_dt, rng, scales="scalar",
              relu=False, rnd=round_mode.nearest):
    mb, ic, ih, iw, oc, kh, kw, ph, pw, sh, sw = shape
    src = fill_data((mb, ih, iw, ic), "u8", rng)
    wei = fill_data((oc, ic, kh, kw), "s8", rng)
    bia = None if bia_dt is None else fill_data((oc,), bia_dt, rng)
    if scales == "scalar":
        sc = (0.35,)
    else:
        sc = rng.uniform(0.1, 0.9, oc).astype(np.float32)
    oh = conv_output_size(ih, kh, sh, ph)
    ow = conv_output_size(iw, kw, sw, pw)
    cfg = ConvConfig.make(
        (mb, ih, iw, ic), (oc, ic, kh, kw),
        None if bia is None else bia.dtype,
        (sh, sw), (ph, pw), (mb, oh, ow, oc), dst_dt,
        conv0_relu=relu, conv0_scales=sc, conv0_round=rnd)
    return cfg, src, wei, bia, sc


@pytest.mark.parametrize("bia_dt", ["u8", "s8", "s32", "f32"])
@pytest.mark.parametrize("dst_dt", ["u8", "s8", "s32", "f32"])
def test_conv_dtype_combos(bia_dt, dst_dt, rng):
    # the reference's 8 dtype suites (test/test_conv.cc:95-102), widened to
    # the full 4x4 bias/dst grid the kernel supports: bias may be any of
    # u8/s8/s32/f32, widened to f32 (src/jit_conv_kernel.cc:238-254)
    shape = SHAPES[1]
    cfg, src, wei, bia, sc = make_case(shape, bia_dt, dst_dt, rng)
    out = conv(src, wei, bia, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw),
               dst_dtype=dst_dt, conv0_scales=sc)
    compare(out, conv_ref(cfg, src, wei, bia), f"conv {bia_dt}->{dst_dt}")


@pytest.mark.parametrize("shape", SHAPES)
def test_conv_shapes(shape, rng):
    cfg, src, wei, bia, sc = make_case(shape, "s32", "s8", rng)
    out = conv(src, wei, bia, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw),
               dst_dtype="s8", conv0_scales=sc)
    compare(out, conv_ref(cfg, src, wei, bia), f"conv shape={shape}")


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("rnd", [round_mode.nearest, round_mode.down])
def test_conv_relu_round_modes(relu, rnd, rng):
    shape = SHAPES[0]
    cfg, src, wei, bia, sc = make_case(shape, "s32", "s8", rng,
                                       relu=relu, rnd=rnd)
    out = conv(src, wei, bia, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw),
               dst_dtype="s8", conv0_relu=relu, conv0_scales=sc,
               conv0_round_mode=rnd)
    compare(out, conv_ref(cfg, src, wei, bia), f"relu={relu} rnd={rnd}")


def test_conv_per_channel_scales(rng):
    shape = SHAPES[1]
    cfg, src, wei, bia, sc = make_case(shape, "s32", "u8", rng,
                                       scales="per_oc")
    out = conv(src, wei, bia, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw),
               dst_dtype="u8", conv0_scales=sc)
    compare(out, conv_ref(cfg, src, wei, bia), "per-oc scales")


def test_conv_no_bias(rng):
    shape = SHAPES[0]
    cfg, src, wei, _, sc = make_case(shape, None, "s32", rng)
    out = conv(src, wei, None, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw),
               dst_dtype="s32", conv0_scales=sc)
    compare(out, conv_ref(cfg, src, wei, None), "no bias")


def test_conv_f32_dst_no_rounding(rng):
    # f32 dst skips the round step entirely (src/jit_conv_kernel.cc:267)
    shape = SHAPES[0]
    cfg, src, wei, bia, sc = make_case(shape, "s32", "f32", rng)
    out = conv(src, wei, bia, (1, 1), (0, 0), dst_dtype="f32",
               conv0_scales=sc)
    ref = conv_ref(cfg, src, wei, bia)
    assert ref.dtype == np.float32
    compare(out, ref, "f32 dst")


def test_round_semantics_ties_to_even():
    # the heart of contract #4: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    from deepfusion_tpu.ops.ref import round_f32
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5], np.float32)
    assert round_f32(x, round_mode.nearest).tolist() == [0, 2, 2, -0, -2, 4]
    assert round_f32(x, round_mode.down).tolist() == [0, 1, 2, -1, -2, 3]


# ----- strided convs -----
# Reference handles stride in-kernel (src/jit_conv_kernel.cc:512-673);
# here strided dense convs run as plain XLA (strided taps + int8 GEMM).

STRIDED_SHAPES = [
    (1, 16, 8, 10, 48, 3, 3, 1, 1, 2, 2),
    (2, 32, 13, 13, 32, 3, 3, 1, 1, 2, 1),   # mixed stride h
    (2, 32, 13, 13, 32, 3, 3, 0, 0, 1, 2),   # mixed stride w, no pad
    (1, 8, 11, 11, 16, 3, 3, 1, 1, 3, 3),    # stride 3 (stride == kernel)
    (1, 8, 10, 10, 16, 5, 5, 2, 2, 2, 2),    # 5x5 kernel, stride 2
    (1, 8, 9, 9, 16, 3, 3, 0, 0, 4, 4),      # stride > kernel (crop path)
    # ResNet-stem geometry, spatially scaled: 7x7/s2 p3, 3 input chans
    (2, 3, 28, 28, 16, 7, 7, 3, 3, 2, 2),
]


@pytest.mark.parametrize("shape", STRIDED_SHAPES)
def test_strided_conv_runs_pallas(shape, rng, monkeypatch):
    # the XLA composition must never be reachable from the op (it survives
    # only as bench.py's --compare-xla baseline)
    import importlib
    C = importlib.import_module("deepfusion_tpu.ops.conv")

    def boom(*a, **k):  # pragma: no cover
        raise AssertionError("strided conv fell back to the XLA path")

    monkeypatch.setattr(C, "_conv_xla", boom)
    cfg, src, wei, bia, sc = make_case(shape, "s32", "u8", rng)
    out = conv(src, wei, bia, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw),
               dst_dtype="u8", conv0_scales=sc)
    compare(out, conv_ref(cfg, src, wei, bia), f"strided pallas {shape}")


def test_strided_conv_per_channel_scales_round_down(rng):
    shape = STRIDED_SHAPES[0]
    cfg, src, wei, bia, sc = make_case(shape, "s8", "s8", rng,
                                       scales="per_oc", rnd=round_mode.down)
    out = conv(src, wei, bia, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw),
               dst_dtype="s8", conv0_scales=sc, conv0_round_mode=round_mode.down)
    compare(out, conv_ref(cfg, src, wei, bia), "strided per-oc round-down")


def test_strided_conv_with_sum_postop(rng):
    from helpers import fill_data as fd
    shape = STRIDED_SHAPES[1]
    cfg0, src, wei, bia, sc = make_case(shape, "s32", "u8", rng)
    sum_src = fd((cfg0.bs, cfg0.oh, cfg0.ow, cfg0.oc), "u8", rng)
    cfg = ConvConfig.make(
        (cfg0.bs, cfg0.ih, cfg0.iw, cfg0.ic), (cfg0.oc, cfg0.ic, 3, 3),
        bia.dtype, (cfg0.sh, cfg0.sw), (cfg0.ph, cfg0.pw),
        (cfg0.bs, cfg0.oh, cfg0.ow, cfg0.oc), "u8", conv0_scales=sc,
        sum_dt="u8", sum_scale=0.5)
    out = conv(src, wei, bia, (cfg.sh, cfg.sw), (cfg.ph, cfg.pw),
               dst_dtype="u8", conv0_scales=sc, sum_src=sum_src,
               sum_scale=0.5)
    compare(out, conv_ref(cfg, src, wei, bia, sum_src=sum_src),
            "strided conv + sum post-op")


# ----- validation / fail-fast (src/op_conv.cc:263-365) -----

def test_conv_rejects_bad_geometry():
    with pytest.raises(CheckError):
        ConvConfig.make((2, 13, 13, 32), (32, 32, 3, 3), None, (1, 1), (0, 0),
                        (2, 12, 12, 32), "u8")  # 13-3+1 = 11, not 12


def test_conv_rejects_ic_mismatch():
    with pytest.raises(CheckError):
        ConvConfig.make((2, 13, 13, 16), (32, 32, 3, 3), None, (1, 1), (0, 0),
                        (2, 11, 11, 32), "u8")


def test_conv_rejects_bad_scales():
    with pytest.raises(CheckError):
        ConvConfig.make((2, 13, 13, 32), (32, 32, 3, 3), None, (1, 1), (0, 0),
                        (2, 11, 11, 32), "u8", conv0_scales=np.ones(7))


def test_conv_rejects_src_dtype():
    with pytest.raises(CheckError):
        ConvConfig.make((2, 13, 13, 32), (32, 32, 3, 3), None, (1, 1), (0, 0),
                        (2, 11, 11, 32), "u8", src_dt="s8")


def test_conv_rejects_groups():
    with pytest.raises(CheckError):
        ConvConfig.make((2, 13, 13, 32), (32, 32, 3, 3), None, (1, 1), (0, 0),
                        (2, 11, 11, 32), "u8", groups=2)


# ----- channel-blocked K loop: ic = 256 spans several channel blocks of
# the kernel's K loop (the reference's nb_ic_blocking,
# src/jit_conv_kernel.cc:643-646) -----

def _wide_ic_cfg(rng, oc=128, fused=False, with_sum=False):
    n, ic, hw = 1, 256, 12
    src = fill_data((n, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    kw = {}
    wei1 = bia1 = None
    if fused:
        wei1 = fill_data((64, oc, 1, 1), "s8", rng)
        bia1 = fill_data((64,), "s32", rng)
        kw = dict(wei1x1_shape=(64, oc, 1, 1), bia1x1_dt=bia1.dtype,
                  conv1_relu=True, conv1_scales=(0.2,))
    if with_sum:
        kw.update(sum_dt="u8", sum_scale=0.5)
    cfg = ConvConfig.make(
        (n, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (1, 1), (1, 1),
        (n, hw, hw, 64 if fused else oc), "u8", conv0_scales=(0.02,), **kw)
    return cfg, src, wei, bia, wei1, bia1


def test_conv_channel_blocked_exact(rng):
    from deepfusion_tpu.ops.conv import ConvOp
    cfg, src, wei, bia, _, _ = _wide_ic_cfg(rng)
    out = ConvOp(cfg, wei, bia)(src)
    compare(out, conv_ref(cfg, src, wei, bia), "channel-blocked conv")


def test_conv_channel_blocked_fused_with_sum(rng):
    from deepfusion_tpu.ops.conv import ConvOp
    cfg, src, wei, bia, wei1, bia1 = _wide_ic_cfg(rng, fused=True,
                                                  with_sum=True)
    sum_src = fill_data((cfg.bs, cfg.oh, cfg.ow, 64), "u8", rng)
    out = ConvOp(cfg, wei, bia, wei1, bia1)(src, sum_src=sum_src)
    compare(out, conv_ref(cfg, src, wei, bia, wei1, bia1, sum_src=sum_src),
            "channel-blocked fused conv + sum")


@pytest.mark.slow
def test_conv_reference_large_shape(rng):
    # the reference's declared big case (test/test_conv.cc:86-92):
    # mb2 ic32 @120x360 -> oc64; runs the Pallas path within budget
    n, ic, ih, iw, oc = 2, 32, 120, 360, 64
    src = fill_data((n, ih, iw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    cfg = ConvConfig.make((n, ih, iw, ic), (oc, ic, 3, 3), bia.dtype,
                          (1, 1), (1, 1), (n, ih, iw, oc), "u8",
                          conv0_scales=(0.02,))
    out = conv(src, wei, bia, (1, 1), (1, 1), dst_dtype="u8",
               conv0_scales=(0.02,))
    compare(out, conv_ref(cfg, src, wei, bia), "reference 120x360 case")
