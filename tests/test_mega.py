"""Conv pair (PackedConvPairOp) differential tests.

The pair must be bit-identical to running the two fused convs as
sequential PackedConvOps with the pair's intermediate spec, and to the
numpy oracle composition of the two convs.
"""
import numpy as np
import pytest

from deepfusion_tpu.config import ConvConfig
from deepfusion_tpu.ops.mega import PackedConvPairOp
from deepfusion_tpu.ops.packed import (PackedConvOp, PackedSpec, pack_image,
                                       unpack_image)
from deepfusion_tpu.ops.ref import conv_ref
from deepfusion_tpu.utils.logger import CheckError

from helpers import fill_data
from test_packed import build_cfg


def _pair_and_seq(cfg_a, wts_a, cfg_b, wts_b, **kw):
    pair = PackedConvPairOp(cfg_a, wts_a, cfg_b, wts_b, **kw)
    op_a = PackedConvOp(cfg_a, *wts_a, sin=pair.sin,
                        halo_out=pair.smid.halo,
                        col_off_out=pair.smid.col_off)
    assert op_a.sout == pair.smid
    op_b = PackedConvOp(cfg_b, *wts_b, sin=pair.smid,
                        halo_out=pair.sout.halo,
                        col_off_out=pair.sout.col_off)
    assert op_b.sout == pair.sout
    return pair, op_a, op_b


def _check_match(pair, op_a, op_b, src):
    x = pack_image(src, pair.sin)
    got = np.asarray(pair(x))
    want = np.asarray(op_b(op_a(x)))
    np.testing.assert_array_equal(got, want)
    # and the output is a valid packed image: non-image slots all -128
    s = pair.sout
    img = got.reshape(got.shape[0], s.rows, s.iwp, s.cp)
    assert (img[:, :s.halo] == -128).all()
    assert (img[:, s.halo + s.h:] == -128).all()
    assert (img[:, :, :s.col_off] == -128).all()
    assert (img[:, :, s.col_off + s.w:] == -128).all()


@pytest.mark.parametrize("via_oracle", [False, True])
@pytest.mark.parametrize("fused_a,fused_b", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_pair_matches_sequential(fused_a, fused_b, via_oracle, rng):
    hw = 12
    cfg_a, src, wa, ba, wa1, ba1 = build_cfg(
        2, 32, hw, 32, 1, oc1=32 if fused_a else None, rng=rng)
    cfg_b, _, wb, bb, wb1, bb1 = build_cfg(
        2, 32, hw, 32, 1, oc1=32 if fused_b else None, rng=rng)
    pair, op_a, op_b = _pair_and_seq(
        cfg_a, (wa, ba, wa1, ba1), cfg_b, (wb, bb, wb1, bb1))
    if not via_oracle:
        _check_match(pair, op_a, op_b, src)
        return
    mid = conv_ref(cfg_a, src, wa, ba, wa1, ba1)
    want = conv_ref(cfg_b, mid, wb, bb, wb1, bb1)
    got = unpack_image(np.asarray(pair(pack_image(src, pair.sin))),
                       pair.sout)
    np.testing.assert_array_equal(got, want)


def test_pair_channel_change(rng):
    """a: 32 -> 3x3:48 -> 1x1:64; b: 64 -> 3x3:32 -> 1x1:32."""
    hw = 10
    cfg_a, src, wa, ba, wa1, ba1 = build_cfg(1, 32, hw, 48, 1, oc1=64,
                                             rng=rng)
    cfg_b, _, wb, bb, wb1, bb1 = build_cfg(1, 64, hw, 32, 1, oc1=32,
                                           rng=rng)
    pair, op_a, op_b = _pair_and_seq(
        cfg_a, (wa, ba, wa1, ba1), cfg_b, (wb, bb, wb1, bb1))
    _check_match(pair, op_a, op_b, src)


def test_pair_round_modes_and_per_oc_scales(rng):
    from deepfusion_tpu.types import round_mode
    import dataclasses
    hw = 12
    sc0 = tuple(float(s) for s in 0.01 + 0.001 * np.arange(32))
    cfg_a, src, wa, ba, wa1, ba1 = build_cfg(2, 32, hw, 32, 1, oc1=32,
                                             rng=rng, scales0=sc0)
    cfg_a = dataclasses.replace(cfg_a, conv0_round=round_mode.down)
    cfg_b, _, wb, bb, wb1, bb1 = build_cfg(2, 32, hw, 32, 1, oc1=32,
                                           rng=rng)
    cfg_b = dataclasses.replace(cfg_b, conv1_round=round_mode.down)
    pair, op_a, op_b = _pair_and_seq(
        cfg_a, (wa, ba, wa1, ba1), cfg_b, (wb, bb, wb1, bb1))
    _check_match(pair, op_a, op_b, src)


def test_pair_deep_input_halo(rng):
    """halo-erosion style chaining: deeper input halo, shallower output."""
    hw = 12
    cfg_a, src, wa, ba, wa1, ba1 = build_cfg(1, 32, hw, 32, 1, oc1=32,
                                             rng=rng)
    cfg_b, _, wb, bb, wb1, bb1 = build_cfg(1, 32, hw, 32, 1, oc1=32,
                                           rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=3, col_off=1)
    pair, op_a, op_b = _pair_and_seq(
        cfg_a, (wa, ba, wa1, ba1), cfg_b, (wb, bb, wb1, bb1),
        sin=sin, halo_out=1)
    _check_match(pair, op_a, op_b, src)


def test_pair_self_chain(rng):
    """sin == sout geometry: the op chains with itself (the bench shape)."""
    hw = 12
    cfg, src, w, b, w1, b1 = build_cfg(1, 32, hw, 32, 1, oc1=32, rng=rng)
    cfg2, _, w2, b2, w21, b21 = build_cfg(1, 32, hw, 32, 1, oc1=32, rng=rng)
    pair, op_a, op_b = _pair_and_seq(
        cfg, (w, b, w1, b1), cfg2, (w2, b2, w21, b21))
    assert (pair.sin.h, pair.sin.w, pair.sin.c, pair.sin.cp, pair.sin.halo,
            pair.sin.col_off, pair.sin.iwp) == \
           (pair.sout.h, pair.sout.w, pair.sout.c, pair.sout.cp,
            pair.sout.halo, pair.sout.col_off, pair.sout.iwp)
    x = pack_image(src, pair.sin)
    y = pair(pair(x))          # two pairs = four convs
    want = op_b(op_a(op_b(op_a(x))))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(want))


def test_pair_validation_fail_fast(rng):
    cfg_a, _, wa, ba, wa1, ba1 = build_cfg(1, 32, 12, 32, 1, oc1=32,
                                           rng=rng)
    # channel mismatch: b expects 64 input channels
    cfg_b, _, wb, bb, wb1, bb1 = build_cfg(1, 64, 12, 32, 1, oc1=32,
                                           rng=rng)
    with pytest.raises(CheckError):
        PackedConvPairOp(cfg_a, (wa, ba, wa1, ba1),
                         cfg_b, (wb, bb, wb1, bb1))
    # strided cfg rejected
    cfg_s = ConvConfig.make((1, 12, 12, 32), (32, 32, 3, 3), None, (2, 2),
                            (1, 1), (1, 6, 6, 32), "u8",
                            conv0_scales=(0.02,))
    with pytest.raises(CheckError):
        PackedConvPairOp(cfg_s, (wa, None), cfg_s, (wa, None))


@pytest.mark.parametrize("fused_b", [False, True])
def test_pair_save_load_roundtrip(tmp_path, fused_b, rng):
    hw = 12
    cfg_a, src, wa, ba, wa1, ba1 = build_cfg(1, 32, hw, 32, 1, oc1=32,
                                             rng=rng)
    cfg_b, _, wb, bb, wb1, bb1 = build_cfg(1, 32, hw, 32, 1, rng=rng,
                                           oc1=32 if fused_b else None)
    pair = PackedConvPairOp(cfg_a, (wa, ba, wa1, ba1),
                            cfg_b, (wb, bb, wb1, bb1))
    x = pack_image(src, pair.sin)
    want = np.asarray(pair(x))
    path = str(tmp_path / "pair.npz")
    pair.save(path)
    reloaded = PackedConvPairOp.load(path)
    assert (reloaded.cfg_a, reloaded.cfg_b) == (pair.cfg_a, pair.cfg_b)
    assert (reloaded.sin, reloaded.smid, reloaded.sout) == \
           (pair.sin, pair.smid, pair.sout)
    np.testing.assert_array_equal(np.asarray(reloaded(x)), want)


@pytest.mark.parametrize("fused", [False, True])
def test_pair_pool2_epilogue(fused, rng):
    """Pair with the 2x2/s2 max pool on layer b's output ==
    packed_maxpool2 of the plain pair's output (a VGG block:
    conv3x3 -> conv3x3 -> pool)."""
    from deepfusion_tpu.ops.packed import packed_maxpool2
    hw = 12
    oc1 = 32 if fused else None
    cfg_a, src, wa, ba, wa1, ba1 = build_cfg(2, 32, hw, 32, 1, oc1=oc1,
                                             rng=rng)
    cfg_b, _, wb, bb, wb1, bb1 = build_cfg(2, 32, hw, 32, 1, oc1=oc1,
                                           rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=2, col_off=2, iwp=16)
    wts_a, wts_b = (wa, ba, wa1, ba1), (wb, bb, wb1, bb1)
    plain = PackedConvPairOp(cfg_a, wts_a, cfg_b, wts_b, sin=sin,
                             halo_out=2, col_off_out=2)
    pooled = PackedConvPairOp(cfg_a, wts_a, cfg_b, wts_b, sin=sin,
                              halo_out=2, col_off_out=2, pool2=True)
    x = pack_image(src, sin)
    want, want_spec = packed_maxpool2(plain(x), plain.sout)
    got = np.asarray(pooled(x))
    assert pooled.sout_pooled == want_spec
    np.testing.assert_array_equal(got, np.asarray(want))


def test_pair_pool2_save_load(tmp_path, rng):
    hw = 12
    cfg_a, src, wa, ba, wa1, ba1 = build_cfg(1, 32, hw, 32, 1, oc1=32,
                                             rng=rng)
    cfg_b, _, wb, bb, wb1, bb1 = build_cfg(1, 32, hw, 32, 1, oc1=32,
                                           rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=2, col_off=2, iwp=16)
    op = PackedConvPairOp(cfg_a, (wa, ba, wa1, ba1),
                          cfg_b, (wb, bb, wb1, bb1), sin=sin,
                          halo_out=2, col_off_out=2, pool2=True)
    x = pack_image(src, sin)
    want = np.asarray(op(x))
    path = str(tmp_path / "pairpool.npz")
    op.save(path)
    reloaded = PackedConvPairOp.load(path)
    assert reloaded.pool2
    np.testing.assert_array_equal(np.asarray(reloaded(x)), want)


def test_pair_deep_halo_roll_free(rng):
    """halo_in = halo_out + ph_a + ph_b makes every input window
    in-bounds (the erosion geometry). Must stay bit-identical to the
    sequential composition."""
    hw = 12
    cfg_a, src, wa, ba, *_ = build_cfg(2, 32, hw, 32, 1, rng=rng)
    cfg_b, _, wb, bb, *_ = build_cfg(2, 32, hw, 32, 1, rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=3, col_off=1, iwp=16)
    pair, op_a, op_b = _pair_and_seq(
        cfg_a, (wa, ba), cfg_b, (wb, bb), sin=sin, halo_out=1,
        col_off_out=1)
    _check_match(pair, op_a, op_b, src)


def test_pair_pool2_load_rejects_tampered_geometry(tmp_path, rng):
    """A stale/hand-edited pool2 checkpoint with pool-illegal output
    geometry (odd col_off) must fail fast at load, exactly like the
    constructor does."""
    import json

    hw = 12
    cfg_a, src, wa, ba, wa1, ba1 = build_cfg(1, 32, hw, 32, 1, oc1=32,
                                             rng=rng)
    cfg_b, _, wb, bb, wb1, bb1 = build_cfg(1, 32, hw, 32, 1, oc1=32,
                                           rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=2, col_off=2, iwp=16)
    op = PackedConvPairOp(cfg_a, (wa, ba, wa1, ba1),
                          cfg_b, (wb, bb, wb1, bb1), sin=sin,
                          halo_out=2, col_off_out=2, pool2=True)
    path = str(tmp_path / "pairpool.npz")
    op.save(path)
    data = dict(np.load(path, allow_pickle=False))
    cfgs = json.loads(str(data["__cfg__"]))
    cfgs["sout"]["col_off"] = 3          # pair-legal but pool-illegal
    data["__cfg__"] = np.str_(json.dumps(cfgs))
    np.savez(path, **data)
    with pytest.raises(CheckError):
        PackedConvPairOp.load(path)


def test_pair_tight_geometry_shallow_to_deep_halo(rng):
    """halo_in < halo_out on a tiny image: the first taps read before the
    input's first row and the last past its end; those reads feed only
    masked pad rows (VGGFusion block 3's geometry)."""
    hw = 4
    cfg_a, src, wa, ba, *_ = build_cfg(1, 32, hw, 32, 1, rng=rng)
    cfg_b, _, wb, bb, *_ = build_cfg(1, 32, hw, 32, 1, rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=1, col_off=1, iwp=16)
    try:
        pair = PackedConvPairOp(cfg_a, (wa, ba), cfg_b, (wb, bb),
                                sin=sin, halo_out=2, col_off_out=2)
    except CheckError:
        return          # clean rejection is acceptable
    op_a = PackedConvOp(cfg_a, wa, ba, sin=pair.sin,
                        halo_out=pair.smid.halo,
                        col_off_out=pair.smid.col_off)
    op_b = PackedConvOp(cfg_b, wb, bb, sin=pair.smid,
                        halo_out=pair.sout.halo,
                        col_off_out=pair.sout.col_off)
    x = pack_image(src, pair.sin)
    np.testing.assert_array_equal(np.asarray(pair(x)),
                                  np.asarray(op_b(op_a(x))))
