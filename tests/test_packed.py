"""Layout-persistent (packed-domain) conv path differential tests.

The packed path must be bit-identical to the dense path / numpy oracle:
pack -> packed conv(s) -> unpack == conv_ref composition. Also checks that
the emitted packed array is itself a *valid* packed image (halo rows,
margin columns, and pad lanes all hold -128) so it can feed the next conv
with no glue.
"""
import numpy as np
import pytest

from deepfusion_tpu.config import ConvConfig
from deepfusion_tpu.ops.packed import (PackedConvOp, PackedSpec, pack_image,
                                       unpack_image, validate_packed_conv)
from deepfusion_tpu.ops.ref import conv_ref
from deepfusion_tpu.types import round_mode
from deepfusion_tpu.utils.logger import CheckError
from deepfusion_tpu.utils.mathutil import conv_output_size

from helpers import compare, fill_data


def build_cfg(mb, ic, hw, oc, ph, oc1=None, bia="s32", rng=None,
              scales0=(0.02,), scales1=(0.4,)):
    kh = kw = 3
    oh = conv_output_size(hw, kh, 1, ph)
    src = fill_data((mb, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, kh, kw), "s8", rng)
    bia0 = None if bia is None else fill_data((oc,), bia, rng)
    wei1 = bia1 = None
    if oc1 is not None:
        wei1 = fill_data((oc1, oc, 1, 1), "s8", rng)
        bia1 = fill_data((oc1,), "s32", rng)
    cfg = ConvConfig.make(
        (mb, hw, hw, ic), (oc, ic, kh, kw),
        None if bia0 is None else bia0.dtype, (1, 1), (ph, ph),
        (mb, oh, oh, oc1 if oc1 is not None else oc), "u8",
        conv0_scales=scales0,
        wei1x1_shape=None if oc1 is None else (oc1, oc, 1, 1),
        bia1x1_dt=None if bia1 is None else bia1.dtype,
        conv1_relu=True, conv1_scales=scales1)
    return cfg, src, wei, bia0, wei1, bia1


def test_pack_unpack_roundtrip(rng):
    spec = PackedSpec.make(13, 13, 32, halo=3, col_off=1)
    src = fill_data((2, 13, 13, 32), "u8", rng)
    arr = pack_image(src, spec)
    assert arr.shape == spec.array_shape(2)
    np.testing.assert_array_equal(unpack_image(arr, spec), src)
    # non-image slots are -128
    img = arr.reshape(2, spec.rows, spec.iwp, spec.cp)
    assert (img[:, :spec.halo] == -128).all()
    assert (img[:, spec.halo + 13:] == -128).all()
    assert (img[:, :, :spec.col_off] == -128).all()
    assert (img[:, :, spec.col_off + 13:] == -128).all()


@pytest.mark.parametrize("hw,ph", [(13, 1), (13, 0), (12, 1)])
def test_packed_conv_single(hw, ph, rng):
    cfg, src, wei, bia, _, _ = build_cfg(2, 32, hw, 32, ph, rng=rng)
    pop = PackedConvOp(cfg, wei, bia)
    out = unpack_image(pop(pack_image(src, pop.sin)), pop.sout)
    compare(out, conv_ref(cfg, src, wei, bia), f"packed hw={hw} ph={ph}")


def test_packed_conv_fused(rng):
    cfg, src, wei, bia, wei1, bia1 = build_cfg(2, 32, 13, 32, 1, oc1=64,
                                               rng=rng)
    pop = PackedConvOp(cfg, wei, bia, wei1, bia1)
    ref = conv_ref(cfg, src, wei, bia, wei1x1_s8=wei1, bias1x1=bia1)
    out = unpack_image(pop(pack_image(src, pop.sin)), pop.sout)
    compare(out, ref, "packed fused")


def test_packed_conv_per_oc_scales(rng):
    sc0 = rng.uniform(0.005, 0.05, 32).astype(np.float32)
    sc1 = rng.uniform(0.1, 0.9, 32).astype(np.float32)
    cfg, src, wei, bia, wei1, bia1 = build_cfg(
        1, 32, 13, 32, 1, oc1=32, rng=rng, scales0=sc0, scales1=sc1)
    pop = PackedConvOp(cfg, wei, bia, wei1, bia1)
    ref = conv_ref(cfg, src, wei, bia, wei1x1_s8=wei1, bias1x1=bia1)
    out = unpack_image(pop(pack_image(src, pop.sin)), pop.sout)
    compare(out, ref, "packed per-oc")


def test_packed_output_is_valid_packed_image(rng):
    """The kernel's own halo/margin/lane pads must all be -128."""
    cfg, src, wei, bia, wei1, bia1 = build_cfg(1, 32, 13, 32, 1, oc1=32,
                                               rng=rng)
    pop = PackedConvOp(cfg, wei, bia, wei1, bia1)
    out = np.asarray(pop(pack_image(src, pop.sin)))
    s = pop.sout
    img = out.reshape(1, s.rows, s.iwp, s.cp)
    assert (img[:, :s.halo] == -128).all(), "top halo"
    assert (img[:, s.halo + s.h:] == -128).all(), "bottom halo"
    assert (img[:, s.halo:s.halo + s.h, :s.col_off] == -128).all(), "left"
    assert (img[:, s.halo:s.halo + s.h, s.col_off + s.w:] == -128).all(), \
        "right"
    assert (img[..., s.c:] == -128).all(), "pad lanes"


def test_packed_chain_two_convs(rng):
    """Back-to-back packed convs with NO glue between them: the first op's
    output array feeds the second directly; result matches the composed
    dense oracle."""
    mb, c, hw = 2, 32, 13
    cfg, src, wei, bia, wei1, bia1 = build_cfg(mb, c, hw, 64, 1, oc1=c,
                                               rng=rng)
    pop = PackedConvOp(cfg, wei, bia, wei1, bia1)
    # same geometry in and out -> the op chains with itself
    assert pop.sout.array_shape(mb) == pop.sin.array_shape(mb)
    assert pop.sout.halo == pop.sin.halo and pop.sout.iwp == pop.sin.iwp

    y1 = pop(pack_image(src, pop.sin))
    y2 = unpack_image(pop(y1), pop.sout)

    mid = conv_ref(cfg, src, wei, bia, wei1x1_s8=wei1, bias1x1=bia1)
    ref = conv_ref(cfg, mid, wei, bia, wei1x1_s8=wei1, bias1x1=bia1)
    compare(y2, ref, "packed chain")


def test_packed_validation_fail_fast(rng):
    cfg, src, wei, bia, _, _ = build_cfg(1, 32, 13, 32, 1, rng=rng)
    bad = PackedSpec.make(13, 13, 32, halo=0, col_off=1)  # halo < ph
    with pytest.raises(CheckError):
        PackedConvOp(cfg, wei, bia, sin=bad)
    # stride-2 is s2d-lowered, not rejected
    cfg2 = ConvConfig.make((1, 13, 13, 32), (32, 32, 3, 3), None, (2, 2),
                           (1, 1), (1, 7, 7, 32), "u8")
    assert PackedConvOp(cfg2, wei).cfg_orig is not None
    # s8 dst rejected
    cfg3 = ConvConfig.make((1, 13, 13, 32), (32, 32, 3, 3), None, (1, 1),
                           (1, 1), (1, 13, 13, 32), "s8")
    with pytest.raises(CheckError):
        PackedConvOp(cfg3, wei)


# ------------------------------------------------ packed-domain glue ops

def _rand_packed(rng, spec, n=2):
    """A random u8 image packed to spec, plus the dense original."""
    src = fill_data((n, spec.h, spec.w, spec.c), "u8", rng)
    return src, pack_image(src, spec)


def test_packed_concat_matches_oracle(rng):
    from deepfusion_tpu.ops.packed import packed_concat
    from deepfusion_tpu.ops.ref import concat_relu_ref
    spec = PackedSpec.make(8, 12, 32, halo=2, col_off=2)
    a, pa = _rand_packed(rng, spec)
    b, pb = _rand_packed(rng, spec)
    out, ospec = packed_concat([pa, pb], [spec, spec], post_relu=True)
    assert (ospec.c, ospec.cp) == (64, 64)
    compare(unpack_image(np.asarray(out), ospec),
            concat_relu_ref([a, b], True), "packed concat")


def test_packed_concat_rejects_mid_pad_lanes(rng):
    from deepfusion_tpu.ops.packed import packed_concat
    s_pad = PackedSpec.make(8, 12, 20, halo=2, col_off=2)  # cp=32 > c=20
    _, pa = _rand_packed(rng, s_pad)
    with pytest.raises(CheckError):
        packed_concat([pa, pa], [s_pad, s_pad])


def test_packed_sum_relu_matches_oracle(rng):
    from deepfusion_tpu.ops.packed import packed_sum_relu
    from deepfusion_tpu.ops.ref import eltwise_sum_relu_ref
    spec = PackedSpec.make(6, 10, 32, halo=2, col_off=2)
    # saturating range: use full-range u8 values
    a = rng.integers(0, 256, (2, 6, 10, 32), np.uint8)
    b = rng.integers(0, 256, (2, 6, 10, 32), np.uint8)
    out = np.asarray(packed_sum_relu(pack_image(a, spec),
                                     pack_image(b, spec), spec))
    compare(unpack_image(out, spec), eltwise_sum_relu_ref(a, b, True),
            "packed sum")
    # halo/margins still valid
    img = out.reshape(2, spec.rows, spec.iwp, spec.cp)
    assert (img[:, :spec.halo] == -128).all()
    assert (img[:, :, :spec.col_off] == -128).all()
    assert (img[:, :, spec.col_off + spec.w:] == -128).all()


def test_packed_maxpool2_matches_oracle(rng):
    from deepfusion_tpu.ops.packed import packed_maxpool2
    from deepfusion_tpu.config import PoolConfig
    from deepfusion_tpu.ops.ref import pool_ref
    spec = PackedSpec.make(8, 12, 32, halo=2, col_off=2, iwp=16)
    src = rng.integers(0, 256, (2, 8, 12, 32), np.uint8)
    out, ospec = packed_maxpool2(pack_image(src, spec), spec)
    assert (ospec.h, ospec.w, ospec.halo, ospec.col_off, ospec.iwp) == \
        (4, 6, 1, 1, 8)
    pc = PoolConfig.make("max", (8, 12), (2, 2), (2, 2), (0, 0))
    compare(unpack_image(np.asarray(out), ospec), pool_ref(src, pc),
            "packed maxpool2")
    img = np.asarray(out).reshape(2, ospec.rows, ospec.iwp, ospec.cp)
    assert (img[:, :ospec.halo] == -128).all()
    assert (img[:, :, :ospec.col_off] == -128).all()


def test_packed_maxpool2_validation(rng):
    from deepfusion_tpu.ops.packed import packed_maxpool2
    spec = PackedSpec.make(7, 12, 32, halo=2, col_off=2, iwp=16)  # odd h
    _, pa = _rand_packed(rng, spec)
    with pytest.raises(CheckError):
        packed_maxpool2(pa, spec)
    spec2 = PackedSpec.make(8, 12, 32, halo=2, col_off=1, iwp=16)  # odd off
    _, pb = _rand_packed(rng, spec2)
    with pytest.raises(CheckError):
        packed_maxpool2(pb, spec2)


def test_repack(rng):
    from deepfusion_tpu.ops.packed import repack
    s1 = PackedSpec.make(5, 9, 24, halo=1, col_off=1)
    s2 = PackedSpec.make(5, 9, 24, cp=64, halo=3, col_off=4, iwp=24)
    src, pa = _rand_packed(rng, s1)
    out = np.asarray(repack(pa, s1, s2))
    assert out.shape == s2.array_shape(2)
    np.testing.assert_array_equal(unpack_image(out, s2), src)


def test_packed_multi_input_conv(rng):
    """Concat-free branch merge: a conv reading two lane-segments must
    equal the dense conv over the concatenated image."""
    from deepfusion_tpu.ops.packed import PackedConvOp
    mb, hw, ca, cb, oc = 2, 12, 32, 32, 64
    a = fill_data((mb, hw, hw, ca), "u8", rng)
    b = fill_data((mb, hw, hw, cb), "u8", rng)
    wei = fill_data((oc, ca + cb, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    cfg = ConvConfig.make((mb, hw, hw, ca + cb), (oc, ca + cb, 3, 3),
                          bia.dtype, (1, 1), (1, 1), (mb, hw, hw, oc), "u8",
                          conv0_scales=(0.02,))
    sa = PackedSpec.make(hw, hw, ca, halo=2, col_off=1)
    sb = PackedSpec.make(hw, hw, cb, halo=2, col_off=1)
    pop = PackedConvOp(cfg, wei, bia, sin=(sa, sb), halo_out=1)
    out = pop((pack_image(a, sa), pack_image(b, sb)))
    ref = conv_ref(cfg, np.concatenate([a, b], axis=-1), wei, bia)
    compare(unpack_image(np.asarray(out), pop.sout), ref,
            "multi-input packed conv")


def test_packed_sum_relu_maxpool2(rng):
    from deepfusion_tpu.config import PoolConfig
    from deepfusion_tpu.ops.packed import packed_sum_relu_maxpool2
    from deepfusion_tpu.ops.ref import eltwise_sum_relu_ref, pool_ref
    spec = PackedSpec.make(8, 12, 32, halo=2, col_off=2, iwp=16)
    rspec = PackedSpec.make(8, 12, 64, halo=2, col_off=2, iwp=16)
    a = rng.integers(0, 256, (2, 8, 12, 32), np.uint8)
    b = rng.integers(0, 256, (2, 8, 12, 32), np.uint8)
    r = rng.integers(0, 256, (2, 8, 12, 64), np.uint8)
    out, ospec = packed_sum_relu_maxpool2(
        (pack_image(a, spec), pack_image(b, spec)),
        pack_image(r, rspec), (spec, spec), rspec)
    y = np.concatenate([a, b], axis=-1)
    pc = PoolConfig.make("max", (8, 12), (2, 2), (2, 2), (0, 0))
    expect = pool_ref(eltwise_sum_relu_ref(y, r, True), pc)
    compare(unpack_image(np.asarray(out), ospec), expect, "fused sum-pool")
    # output must itself be a valid packed image
    np.testing.assert_array_equal(np.asarray(out), pack_image(expect, ospec))


def test_packed_global_avgpool(rng):
    from deepfusion_tpu.ops.packed import packed_global_avgpool
    from deepfusion_tpu.ops.pool import pool
    # odd geometry + pad lanes: cp > c exercises the lane slice; values
    # span the full u8 range so the round/saturate chain is exercised
    spec = PackedSpec.make(9, 13, 40, halo=3, col_off=2)
    x = rng.integers(0, 256, (3, 9, 13, 40), np.uint8)
    out = np.asarray(packed_global_avgpool(pack_image(x, spec), spec))
    expect = np.asarray(pool(x, "avg_exc", (9, 13), (9, 13), (0, 0)))
    compare(out, expect, "packed global avg pool")
    assert out.shape == (3, 1, 1, 40) and out.dtype == np.uint8


# ----- sum post-op in the packed domain -----

def _sum_cfg(mb, hw, ic, oc, oc1, rng):
    cfg, src, wei, bia0, wei1, bia1 = build_cfg(
        mb, ic, hw, oc, 1, oc1=oc1, rng=rng)
    import dataclasses
    from deepfusion_tpu.types import dtype
    cfg = dataclasses.replace(cfg, with_sum=True, sum_dt=dtype.u8,
                              sum_scale=0.7)
    return cfg, src, wei, bia0, wei1, bia1


@pytest.mark.parametrize("fused", [False, True])
def test_packed_sum_postop(fused, rng):
    """Packed conv with an eltwise-sum post-op == dense ConvOp with_sum
    (exact integer-domain join), including a DEEPER sum-operand halo than
    the output's (halo erosion re-base)."""
    from deepfusion_tpu.ops.conv import ConvOp
    mb, hw, ic, oc = 2, 12, 32, 32
    oc1 = 32 if fused else None
    cfg, src, wei, bia0, wei1, bia1 = _sum_cfg(mb, hw, ic, oc, oc1, rng)
    # full-range sum operand exercises the round/saturate join
    sum_u8 = rng.integers(0, 256, (mb, hw, hw, oc1 or oc), np.uint8)

    dense = ConvOp(cfg, wei, bia0, wei1, bia1)
    expect = np.asarray(dense(src, sum_src=sum_u8))

    sin = PackedSpec.make(hw, hw, ic, halo=3, col_off=1)
    pop = PackedConvOp(cfg, wei, bia0, wei1, bia1, sin=sin,
                       col_off_out=1, halo_out=2,
                       sum_spec=PackedSpec.make(hw, hw, oc1 or oc,
                                                halo=3, col_off=1,
                                                iwp=sin.iwp))
    out = pop(pack_image(src, pop.sin),
              sum_arr=pack_image(sum_u8, pop.ssum))
    compare(unpack_image(np.asarray(out), pop.sout), expect,
            f"packed sum post-op fused={fused}")
    # the output is itself a valid packed image
    np.testing.assert_array_equal(np.asarray(out),
                                  pack_image(expect, pop.sout))


def test_packed_sum_validation(rng):
    cfg, src, wei, bia0, wei1, bia1 = _sum_cfg(1, 12, 32, 32, None, rng)
    sin = PackedSpec.make(12, 12, 32, halo=2, col_off=1)
    bad = PackedSpec.make(12, 12, 32, halo=1, col_off=1, iwp=sin.iwp)
    with pytest.raises(CheckError):   # sum halo shallower than output's
        PackedConvOp(cfg, wei, bia0, sin=sin, col_off_out=1, halo_out=2,
                     sum_spec=bad)
    with pytest.raises(CheckError):   # cfg has sum but no spec given
        PackedConvOp(cfg, wei, bia0, sin=sin, col_off_out=1, halo_out=1)


# ----- strided (s2d-lowered) packed conv -----

@pytest.mark.parametrize("k,stride,pad", [(3, 2, 1), (2, 2, 0), (5, 2, 2)])
def test_packed_strided_conv(k, stride, pad, rng):
    """A strided PackedConvOp runs the stride-1 packed kernel on the s2d
    grid and must equal the dense strided ConvOp bit-for-bit."""
    from deepfusion_tpu.ops import layout
    from deepfusion_tpu.ops.conv import ConvOp
    mb, hw, ic, oc = 2, 14, 16, 32
    oh = conv_output_size(hw, k, stride, pad)
    src = fill_data((mb, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, k, k), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    cfg = ConvConfig.make((mb, hw, hw, ic), (oc, ic, k, k), bia.dtype,
                          (stride, stride), (pad, pad), (mb, oh, oh, oc),
                          "u8", conv0_relu=True, conv0_scales=(0.02,))
    expect = np.asarray(ConvOp(cfg, wei, bia)(src))

    cfg2 = layout.s2d_cfg(cfg)
    kh2 = (k - 1) // stride + 1
    sin = PackedSpec(h=cfg2.ih, w=cfg2.iw, c=cfg2.ic, cp=cfg2.icp,
                     halo=2, col_off=1,
                     iwp=((cfg2.iw + 1 + (kh2 - 1) + 7) // 8) * 8)
    pop = PackedConvOp(cfg, wei, bia, sin=sin, col_off_out=1, halo_out=2)
    assert pop.cfg_orig is not None
    out = pop(pop.pack_input(src))
    compare(unpack_image(np.asarray(out), pop.sout), expect,
            f"packed strided conv k={k} s={stride} p={pad}")


def test_packed_strided_save_load(tmp_path, rng):
    """cfg_orig (the pre-s2d config) must survive save/load so pack_input
    keeps working on a restored op."""
    from deepfusion_tpu.ops.conv import ConvOp
    mb, hw, ic, oc = 1, 10, 16, 32
    oh = conv_output_size(hw, 3, 2, 1)
    src = fill_data((mb, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    cfg = ConvConfig.make((mb, hw, hw, ic), (oc, ic, 3, 3), bia.dtype,
                          (2, 2), (1, 1), (mb, oh, oh, oc), "u8",
                          conv0_relu=True, conv0_scales=(0.02,))
    pop = PackedConvOp(cfg, wei, bia)
    path = str(tmp_path / "s2d.npz")
    pop.save(path)
    pop2 = PackedConvOp.load(path)
    assert pop2.cfg_orig == pop.cfg_orig and pop2.ssum is None
    a = np.asarray(pop(pop.pack_input(src)))
    b = np.asarray(pop2(pop2.pack_input(src)))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("off_in,off_out", [(3, 1), (1, 3), (4, 1)])
def test_packed_conv_large_tap_shifts(off_in, off_out, rng):
    """Asymmetric col_offs drive the tap shifts d = off_in - off_out + kj
    - pw beyond the flagship's {-1,0,1} — exercising _shifted_patch at
    |d| in {2,3} (and the roll fallback beyond 4 via the dense oracle)."""
    from deepfusion_tpu.ops.conv import ConvOp
    mb, hw, ic, oc = 1, 12, 32, 32
    cfg, src, wei, bia0, _, _ = build_cfg(mb, ic, hw, oc, 1, rng=rng)
    expect = np.asarray(ConvOp(cfg, wei, bia0)(src))
    iwp = ((hw + off_in + off_out + 6) // 8 + 1) * 8
    sin = PackedSpec.make(hw, hw, ic, halo=3, col_off=off_in, iwp=iwp)
    pop = PackedConvOp(cfg, wei, bia0, sin=sin, col_off_out=off_out,
                       halo_out=2)
    ds = [sin.col_off - pop.sout.col_off + kj - cfg.pw
          for kj in range(cfg.kw)]
    assert any(abs(d) >= 2 for d in ds), ds
    out = pop(pack_image(src, pop.sin))
    compare(unpack_image(np.asarray(out), pop.sout), expect,
            f"packed conv tap shifts {ds}")


@pytest.mark.parametrize("fused,halo_out", [(False, 2), (True, 2),
                                            (False, 0)])
def test_packed_conv_pool2_epilogue(fused, halo_out, rng):
    """Fused 2x2/s2 max pool in the packed conv epilogue == the separate
    packed_maxpool2 kernel on the conv output (itself oracle-tested), for
    deep and ZERO output halos (halo_out=0 is the dense-M-parity config
    used by the reference-scale VGG rows)."""
    from deepfusion_tpu.ops.packed import packed_maxpool2
    hw = 12
    cfg, src, wei, bia0, wei1, bia1 = build_cfg(
        2, 32, hw, 32, 1, oc1=32 if fused else None, rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=max(halo_out + 1, 1),
                          col_off=2, iwp=16)
    op_ref = PackedConvOp(cfg, wei, bia0, wei1, bia1, sin=sin,
                          col_off_out=2, halo_out=halo_out)
    op_fused = PackedConvOp(cfg, wei, bia0, wei1, bia1, sin=sin,
                            col_off_out=2, halo_out=halo_out, pool2=True)
    x = pack_image(src, sin)
    want, want_spec = packed_maxpool2(op_ref(x), op_ref.sout)
    got = np.asarray(op_fused(x))
    assert op_fused.sout_pooled == want_spec
    np.testing.assert_array_equal(got, np.asarray(want))
    # the pooled output is itself a valid packed image
    s = want_spec
    img = got.reshape(2, s.rows, s.iwp, s.cp)
    assert (img[:, :s.halo] == -128).all()
    assert (img[:, :, :s.col_off] == -128).all()
    assert (img[:, :, s.col_off + s.w:] == -128).all()


def test_packed_conv_pool2_with_sum(rng):
    from deepfusion_tpu.ops.packed import packed_maxpool2
    mb, hw, ic, oc = 2, 12, 32, 32
    cfg, src, wei, bia0, wei1, bia1 = _sum_cfg(mb, hw, ic, oc, None, rng)
    sin = PackedSpec.make(hw, hw, ic, halo=2, col_off=2, iwp=16)
    ssum = PackedSpec.make(hw, hw, oc, halo=2, col_off=2, iwp=16)
    sum_img = fill_data((mb, hw, hw, oc), "u8", rng)
    sum_arr = pack_image(sum_img, ssum)
    op_ref = PackedConvOp(cfg, wei, bia0, sin=sin, col_off_out=2,
                          halo_out=2, sum_spec=ssum)
    op_fused = PackedConvOp(cfg, wei, bia0, sin=sin, col_off_out=2,
                            halo_out=2, sum_spec=ssum, pool2=True)
    x = pack_image(src, sin)
    want, _ = packed_maxpool2(op_ref(x, sum_arr), op_ref.sout)
    np.testing.assert_array_equal(np.asarray(op_fused(x, sum_arr)),
                                  np.asarray(want))


def test_packed_conv_pool2_save_load(tmp_path, rng):
    cfg, src, wei, bia0, wei1, bia1 = build_cfg(1, 32, 12, 32, 1, oc1=32,
                                                rng=rng)
    sin = PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16)
    op = PackedConvOp(cfg, wei, bia0, wei1, bia1, sin=sin, col_off_out=2,
                      halo_out=2, pool2=True)
    x = pack_image(src, sin)
    want = np.asarray(op(x))
    path = str(tmp_path / "pp.npz")
    op.save(path)
    reloaded = PackedConvOp.load(path)
    assert reloaded.pool2
    np.testing.assert_array_equal(np.asarray(reloaded(x)), want)


@pytest.mark.parametrize("k,stride,pad,fused", [(3, 2, 1, False),
                                                (3, 2, 1, True),
                                                (5, 2, 2, False),
                                                (3, 3, 1, False)])
def test_packed_strided_sparse_phase(k, stride, pad, fused, rng):
    """A wide (ic = 128) strided packed op on the space-to-depth grid
    must equal the dense strided ConvOp bit-for-bit, incl. fused 1x1."""
    from deepfusion_tpu.ops.conv import ConvOp
    mb, hw, ic, oc = 1, 10, 128, 32
    oh = conv_output_size(hw, k, stride, pad)
    src = fill_data((mb, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, k, k), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    oc1 = 32 if fused else None
    wei1 = fill_data((oc1, oc, 1, 1), "s8", rng) if fused else None
    bia1 = fill_data((oc1,), "s32", rng) if fused else None
    cfg = ConvConfig.make(
        (mb, hw, hw, ic), (oc, ic, k, k), bia.dtype,
        (stride, stride), (pad, pad),
        (mb, oh, oh, oc1 if fused else oc), "u8",
        conv0_relu=True, conv0_scales=(0.02,),
        wei1x1_shape=(oc1, oc, 1, 1) if fused else None,
        bia1x1_dt=bia1.dtype if fused else None,
        conv1_relu=fused, conv1_scales=(0.4,) if fused else (1.0,))
    expect = np.asarray(ConvOp(cfg, wei, bia, wei1, bia1)(src))
    pop = PackedConvOp(cfg, wei, bia, wei1, bia1)
    assert pop.cfg_orig == cfg and pop.cfg.sh == 1
    out = pop(pop.pack_input(src))
    compare(unpack_image(np.asarray(out), pop.sout), expect,
            f"sparse-phase strided k={k} s={stride} p={pad} fused={fused}")


def test_packed_strided_sparse_save_load(tmp_path, rng):
    mb, hw, ic, oc = 1, 10, 128, 32
    oh = conv_output_size(hw, 3, 2, 1)
    src = fill_data((mb, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    cfg = ConvConfig.make((mb, hw, hw, ic), (oc, ic, 3, 3), bia.dtype,
                          (2, 2), (1, 1), (mb, oh, oh, oc), "u8",
                          conv0_relu=True, conv0_scales=(0.02,))
    pop = PackedConvOp(cfg, wei, bia)
    path = str(tmp_path / "sparse.npz")
    pop.save(path)
    pop2 = PackedConvOp.load(path)
    assert (pop2.cfg, pop2.cfg_orig) == (pop.cfg, pop.cfg_orig)
    np.testing.assert_array_equal(np.asarray(pop(pop.pack_input(src))),
                                  np.asarray(pop2(pop2.pack_input(src))))


def test_packed_strided_sparse_falls_back_on_wide_taps(rng):
    """A wide input margin (col_off 5 -> column taps shifted by 4-5 flat
    positions) on the strided packed path."""
    from deepfusion_tpu.ops.conv import ConvOp
    from deepfusion_tpu.ops import layout
    mb, hw, ic, oc = 1, 10, 128, 32
    oh = conv_output_size(hw, 3, 2, 1)
    src = fill_data((mb, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    cfg = ConvConfig.make((mb, hw, hw, ic), (oc, ic, 3, 3), bia.dtype,
                          (2, 2), (1, 1), (mb, oh, oh, oc), "u8",
                          conv0_relu=True, conv0_scales=(0.02,))
    cfg2 = layout.s2d_cfg(cfg)
    sin = PackedSpec.make(cfg2.ih, cfg2.iw, cfg2.ic, halo=1, col_off=5,
                          iwp=((cfg2.iw + 5 + 1 + 7) // 8) * 8)
    pop = PackedConvOp(cfg, wei, bia, sin=sin, col_off_out=1, halo_out=1)
    expect = np.asarray(ConvOp(cfg, wei, bia)(src))
    compare(unpack_image(np.asarray(pop(pop.pack_input(src))), pop.sout),
            expect, "sparse fallback wide taps")
