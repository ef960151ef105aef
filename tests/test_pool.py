"""Pooling + eltwise-sum+relu differential tests.

Spec source: the reference's roadmap ops (README.md:64-65) with MKL-DNN
semantics documented in test/test_conv_relu_pooling.cc:313-391 — max pool,
avg include/exclude padding, over VGG/ResNet layer shapes (spatially scaled
down for CPU interpret mode; channel structure preserved).
"""
import numpy as np
import pytest

from deepfusion_tpu.config import ConvConfig, PoolConfig
from deepfusion_tpu.ops.pool import conv_relu_pool, eltwise_sum_relu, pool
from deepfusion_tpu.ops.ref import (conv_ref, eltwise_sum_relu_ref, pool_ref)
from deepfusion_tpu.types import round_mode
from deepfusion_tpu.utils.mathutil import conv_output_size

from helpers import compare, fill_data

# (n, c, ih, iw, pool_kernel, pool_stride, pool_pad) — VGG/ResNet-shaped
POOL_CASES = [
    (1, 16, 4, 4, (2, 2), (2, 2), (0, 0)),     # VGG micro case (exact ref)
    (2, 32, 14, 14, (2, 2), (2, 2), (0, 0)),   # VGG-style 2x2/s2
    (2, 16, 7, 7, (7, 7), (7, 7), (0, 0)),     # ResNet global pool
    (1, 16, 9, 9, (3, 3), (2, 2), (1, 1)),     # padded window
]


@pytest.mark.parametrize("dt", ["u8", "s8", "s32", "f32"])
@pytest.mark.parametrize("kind", ["max", "avg_inc", "avg_exc"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_pool(case, kind, dt, rng):
    n, c, ih, iw, k, s, p = case
    x = fill_data((n, ih, iw, c), dt, rng)
    pc = PoolConfig.make(kind, (ih, iw), k, s, p)
    out = pool(x, kind, k, s, p)
    compare(out, pool_ref(x, pc), f"pool {kind} {dt} {case}")


def test_pool_negative_values_max(rng):
    # max pooling must respect the dtype's identity at padded taps
    x = (rng.integers(-120, -1, (1, 6, 6, 16))).astype(np.int8)
    pc = PoolConfig.make("max", (6, 6), (3, 3), (2, 2), (1, 1))
    out = pool(x, "max", (3, 3), (2, 2), (1, 1))
    compare(out, pool_ref(x, pc), "all-negative max pool")


@pytest.mark.parametrize("pool_kind", ["max", "avg_exc"])
def test_conv_relu_pool_fused(pool_kind, rng):
    # conv3x3+relu -> pool, VGG-ish block scaled down
    n, ic, ih, iw, oc = 1, 16, 8, 8, 32
    src = fill_data((n, ih, iw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    sc = (0.05,)
    oh = conv_output_size(ih, 3, 1, 1)
    cfg = ConvConfig.make((n, ih, iw, ic), (oc, ic, 3, 3), bia.dtype,
                          (1, 1), (1, 1), (n, oh, oh, oc), "u8",
                          conv0_relu=True, conv0_scales=sc)
    out = conv_relu_pool(src, wei, bia, (1, 1), (1, 1), dst_dtype="u8",
                         conv_scales=sc, conv_relu=True,
                         pool_kind=pool_kind, pool_kernel=(2, 2),
                         pool_stride=(2, 2))
    conv_out = conv_ref(cfg, src, wei, bia)
    pc = PoolConfig.make(pool_kind, (oh, oh), (2, 2), (2, 2), (0, 0))
    compare(out, pool_ref(conv_out, pc), f"conv_relu_pool {pool_kind}")


# ----- conv+pool (ops/convpool.py) -----

def _cp_case(rng, dst_dt="u8", kind="max", oc=32, relu=True, sum_dt=None):
    n, ic, ih, iw = 2, 16, 12, 12
    src = fill_data((n, ih, iw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    oh = conv_output_size(ih, 3, 1, 1)
    cfg = ConvConfig.make((n, ih, iw, ic), (oc, ic, 3, 3), bia.dtype,
                          (1, 1), (1, 1), (n, oh, oh, oc), dst_dt,
                          conv0_relu=relu, conv0_scales=(0.05,),
                          sum_dt=sum_dt, sum_scale=0.5)
    pc = PoolConfig.make(kind, (oh, oh), (2, 2), (2, 2), (0, 0))
    return cfg, pc, src, wei, bia


@pytest.mark.parametrize("dst_dt", ["u8", "s8", "s32", "f32"])
@pytest.mark.parametrize("kind", ["max", "avg_inc"])
def test_convpool_single_kernel(dst_dt, kind, rng):
    from deepfusion_tpu.ops.convpool import ConvPoolOp
    cfg, pc, src, wei, bia = _cp_case(rng, dst_dt, kind)
    out = ConvPoolOp(cfg, pc, wei, bia)(src)
    compare(out, pool_ref(conv_ref(cfg, src, wei, bia), pc),
            f"convpool {kind}->{dst_dt}")


def test_convpool_with_sum_postop(rng):
    from deepfusion_tpu.ops.convpool import ConvPoolOp
    cfg, pc, src, wei, bia = _cp_case(rng, "u8", "max", sum_dt="u8")
    sum_src = fill_data((cfg.bs, cfg.oh, cfg.ow, cfg.oc), "u8", rng)
    out = ConvPoolOp(cfg, pc, wei, bia)(src, sum_src=sum_src)
    compare(out, pool_ref(conv_ref(cfg, src, wei, bia, sum_src=sum_src), pc),
            "convpool + sum post-op")


def test_conv_relu_pool_routes_single_kernel(rng):
    # the functional entry point runs the ConvPoolOp path
    cfg, pc, src, wei, bia = _cp_case(rng)
    out = conv_relu_pool(src, wei, bia, (1, 1), (1, 1), dst_dtype="u8",
                         conv_scales=(0.05,), conv_relu=True,
                         pool_kind="max", pool_kernel=(2, 2),
                         pool_stride=(2, 2))
    compare(out, pool_ref(conv_ref(cfg, src, wei, bia), pc),
            "routed single-kernel conv+pool")


def test_convpool_round_down_avg(rng):
    from deepfusion_tpu.ops.convpool import ConvPoolOp
    cfg, pc, src, wei, bia = _cp_case(rng, "s8", "avg_inc")
    import dataclasses
    pc = dataclasses.replace(pc, round=round_mode.down)
    out = ConvPoolOp(cfg, pc, wei, bia)(src)
    compare(out, pool_ref(conv_ref(cfg, src, wei, bia), pc),
            "convpool avg round-down")


@pytest.mark.parametrize("dt", ["u8", "s8", "s32", "f32"])
@pytest.mark.parametrize("relu", [True, False])
def test_eltwise_sum_relu(dt, relu, rng):
    a = fill_data((2, 7, 7, 32), dt, rng)
    b = fill_data((2, 7, 7, 32), dt, rng)
    out = eltwise_sum_relu(a, b, with_relu=relu)
    compare(out, eltwise_sum_relu_ref(a, b, relu), f"sum_relu {dt}")


def test_eltwise_sum_saturates(rng):
    a = np.full((1, 2, 2, 16), 100, np.int8)
    b = np.full((1, 2, 2, 16), 100, np.int8)
    out = eltwise_sum_relu(a, b)
    assert (np.asarray(out) == 127).all()
    au = np.full((1, 2, 2, 16), 200, np.uint8)
    assert (np.asarray(eltwise_sum_relu(au, au)) == 255).all()


@pytest.mark.parametrize("relu", [True, False])
def test_eltwise_sum_s32_overflow_saturates(relu, rng):
    """Round 1 bug: the s32 kernel stored the wrapped int32 sum while the
    oracle saturates through int64. Exercise true
    overflow in both directions plus non-overflow extremes."""
    big = 2**31 - 5
    a = np.array([[big, -big, big, -big, 7, -7, 0, big]] * 2,
                 np.int32).reshape(2, 1, 2, 4)
    b = np.array([[big, -big, -3, 3, big, -big, 0, -1]] * 2,
                 np.int32).reshape(2, 1, 2, 4)
    out = eltwise_sum_relu(a, b, with_relu=relu)
    compare(out, eltwise_sum_relu_ref(a, b, relu), f"s32 overflow relu={relu}")
    rnd_a = rng.integers(-2**31, 2**31, (2, 8, 8, 32), np.int64).astype(np.int32)
    rnd_b = rng.integers(-2**31, 2**31, (2, 8, 8, 32), np.int64).astype(np.int32)
    out = eltwise_sum_relu(rnd_a, rnd_b, with_relu=relu)
    compare(out, eltwise_sum_relu_ref(rnd_a, rnd_b, relu),
            f"s32 random-range relu={relu}")


def test_eltwise_rejects_mismatch(rng):
    from deepfusion_tpu.utils.logger import CheckError
    a = fill_data((1, 2, 2, 16), "s8", rng)
    b = fill_data((1, 2, 2, 32), "s8", rng)
    with pytest.raises(CheckError):
        eltwise_sum_relu(a, b)


# ----- strided conv + pool -----

STRIDED_CP_SHAPES = [
    # (n, ic, ih, oc, kh, ph, sh): conv k/s/p square, + maxpool2x2/s2
    (2, 3, 28, 16, 7, 3, 2),    # ResNet-stem geometry, spatially scaled
    (1, 16, 24, 32, 3, 1, 2),   # 3x3/s2 downsampling block
    (1, 8, 24, 16, 5, 2, 3),    # 5x5/s3
]


@pytest.mark.parametrize("shape", STRIDED_CP_SHAPES)
def test_convpool_strided_single_kernel(shape, rng):
    from deepfusion_tpu.ops.convpool import ConvPoolOp
    n, ic, ih, oc, kh, ph, sh = shape
    src = fill_data((n, ih, ih, ic), "u8", rng)
    wei = fill_data((oc, ic, kh, kh), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    oh = conv_output_size(ih, kh, sh, ph)
    assert oh % 2 == 0
    cfg = ConvConfig.make((n, ih, ih, ic), (oc, ic, kh, kh), bia.dtype,
                          (sh, sh), (ph, ph), (n, oh, oh, oc), "u8",
                          conv0_relu=True, conv0_scales=(0.05,))
    pc = PoolConfig.make("max", (oh, oh), (2, 2), (2, 2), (0, 0))
    out = ConvPoolOp(cfg, pc, wei, bia)(src)
    compare(out, pool_ref(conv_ref(cfg, src, wei, bia), pc),
            f"strided convpool {shape}")


def test_convpool_strided_with_sum_and_save_load(tmp_path, rng):
    """Strided convpool with the sum post-op and a save/load round-trip."""
    from deepfusion_tpu.ops.convpool import ConvPoolOp
    n, ic, ih, oc, kh, ph, sh = 1, 16, 24, 32, 3, 1, 2
    src = fill_data((n, ih, ih, ic), "u8", rng)
    wei = fill_data((oc, ic, kh, kh), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    oh = conv_output_size(ih, kh, sh, ph)
    cfg = ConvConfig.make((n, ih, ih, ic), (oc, ic, kh, kh), bia.dtype,
                          (sh, sh), (ph, ph), (n, oh, oh, oc), "u8",
                          conv0_relu=True, conv0_scales=(0.05,),
                          sum_dt="u8", sum_scale=0.5)
    pc = PoolConfig.make("max", (oh, oh), (2, 2), (2, 2), (0, 0))
    sum_src = fill_data((n, oh, oh, oc), "u8", rng)
    op = ConvPoolOp(cfg, pc, wei, bia)
    want = pool_ref(conv_ref(cfg, src, wei, bia, sum_src=sum_src), pc)
    compare(op(src, sum_src=sum_src), want, "strided convpool + sum")
    path = str(tmp_path / "cp_strided.npz")
    op.save(path)
    reloaded = ConvPoolOp.load(path)
    assert reloaded.cfg == op.cfg and reloaded.pc == op.pc
    compare(reloaded(src, sum_src=sum_src), want,
            "strided convpool + sum after load")
