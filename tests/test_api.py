"""Object-API parity tests: memory containers + factories + submit().

Mirrors the reference's user-facing call shapes
(include/deepfusion.h:105-145): build memories, construct op via factory,
op.submit() writes the dst memory.
"""
import numpy as np
import pytest

import deepfusion_tpu as df
from deepfusion_tpu.config import PoolConfig
from deepfusion_tpu.ops import ref

from helpers import compare


def test_concat_object_api(rng):
    a = df.memory([2, 64, 4, 4], df.format.nhwc, df.s8).fill_random(rng)
    b = df.memory([2, 32, 4, 4], df.format.nhwc, df.s8).fill_random(rng)
    dst = df.memory([2, 96, 4, 4], df.format.nhwc, df.s8)
    op = df.concat([a, b], dst, post_relu=True)
    op.submit()
    compare(dst.data, ref.concat_relu_ref([a.data, b.data], True), "concat")


def test_conv_object_api_standalone(rng):
    src = df.memory([2, 16, 9, 9], df.format.nhwc, df.u8).fill_random(rng)
    wei = df.memory([32, 16, 3, 3], df.format.OIhw4i16o4i, df.s8)
    wei.data = rng.integers(-10, 11, (32, 16, 3, 3)).astype(np.int8)
    bia = df.memory([32], df.format.x, df.s32).fill_random(rng)
    dst = df.memory([2, 32, 9, 9], df.format.nhwc, df.s8)
    op = df.conv(src, wei, bia, (1, 1), (1, 1), dst,
                 conv0_relu=True, conv0_scales=(0.1,))
    op.submit()
    from deepfusion_tpu.config import ConvConfig
    cfg = ConvConfig.make((2, 9, 9, 16), (32, 16, 3, 3), df.s32, (1, 1),
                          (1, 1), (2, 9, 9, 32), df.s8, conv0_relu=True,
                          conv0_scales=(0.1,))
    compare(dst.data, ref.conv_ref(cfg, src.data, wei.data, bia.data),
            "conv object api")


def test_conv_object_api_fused(rng):
    src = df.memory([1, 16, 8, 8], df.format.nhwc, df.u8).fill_random(rng)
    wei = df.memory([32, 16, 3, 3], df.format.OIhw4i16o4i, df.s8)
    wei.data = rng.integers(-10, 11, (32, 16, 3, 3)).astype(np.int8)
    wei1 = df.memory([16, 32, 1, 1], df.format.OIhw4i16o4i, df.s8)
    wei1.data = rng.integers(-10, 11, (16, 32, 1, 1)).astype(np.int8)
    dst = df.memory([1, 16, 8, 8], df.format.nhwc, df.u8)
    # positional style: conv(src, wei, bia, stride, pad, wei1x1, bia1x1,
    # dst, ...) like the 13-arg reference overload
    op = df.conv(src, wei, None, (1, 1), (1, 1), wei1, None, dst,
                 False, (0.02,), df.round_mode.nearest, True, (0.3,))
    op.submit()
    from deepfusion_tpu.config import ConvConfig
    cfg = ConvConfig.make((1, 8, 8, 16), (32, 16, 3, 3), None, (1, 1),
                          (1, 1), (1, 8, 8, 16), df.u8,
                          conv0_scales=(0.02,),
                          wei1x1_shape=(16, 32, 1, 1), conv1_relu=True,
                          conv1_scales=(0.3,))
    compare(dst.data, ref.conv_ref(cfg, src.data, wei.data, None,
                                   wei1.data, None), "fused object api")


def test_pool_object_api(rng):
    src = df.memory([1, 32, 8, 8], df.format.nhwc, df.u8).fill_random(rng)
    dst = df.memory([1, 32, 4, 4], df.format.nhwc, df.u8)
    op = df.pool(src, dst, "max", (2, 2), (2, 2), (0, 0))
    op.submit()
    pc = PoolConfig.make("max", (8, 8), (2, 2), (2, 2), (0, 0))
    compare(dst.data, ref.pool_ref(src.data, pc), "pool object api")


def test_eltwise_object_api(rng):
    a = df.memory([1, 16, 4, 4], df.format.nhwc, df.s8).fill_random(rng)
    b = df.memory([1, 16, 4, 4], df.format.nhwc, df.s8).fill_random(rng)
    dst = df.memory([1, 16, 4, 4], df.format.nhwc, df.s8)
    df.eltwise_sum_relu(a, b, dst).submit()
    compare(dst.data, ref.eltwise_sum_relu_ref(a.data, b.data, True),
            "eltwise object api")


def test_factory_rejects_dtype_mismatch(rng):
    a = df.memory([2, 16, 4, 4], df.format.nhwc, df.s8).fill_random(rng)
    dst = df.memory([2, 16, 4, 4], df.format.nhwc, df.u8)
    with pytest.raises(df.utils.CheckError):
        df.concat([a], dst)


def test_conv_dispatch_rejects_malformed_calls(rng):
    """The conv factory resolves its two reference overloads by operand
    type at each position; anything else must raise, never mis-dispatch."""
    from deepfusion_tpu.utils.logger import CheckError
    src = df.memory([2, 16, 9, 9], df.format.nhwc, df.u8).fill_random(rng)
    wei = df.memory([32, 16, 3, 3], df.format.OIhw4i16o4i, df.s8)
    wei.data = rng.integers(-10, 11, (32, 16, 3, 3)).astype(np.int8)
    bia = df.memory([32], df.format.x, df.s32).fill_random(rng)
    wei1 = df.memory([16, 32, 1, 1], df.format.OIhw4i16o4i, df.s8)
    wei1.data = rng.integers(-10, 11, (16, 32, 1, 1)).astype(np.int8)
    dst = df.memory([2, 16, 9, 9], df.format.nhwc, df.u8)
    # fused shape with dst as keyword still resolves to the fused overload
    op = df.conv(src, wei, bia, (1, 1), (1, 1), wei1, None, dst=dst,
                 conv0_scales=(0.1,), conv1_relu=True,
                 conv1_scales=(0.2,))
    op.submit()
    # plain shape with a trailing stray memory must raise, not mis-dispatch
    with pytest.raises(CheckError):
        df.conv(src, wei, bia, (1, 1), (1, 1), dst, wei1)
    # dst must be a memory
    with pytest.raises(CheckError):
        df.conv(src, wei, bia, (1, 1), (1, 1), "dst")


def test_object_api_results_stay_on_device(rng):
    """Chained object-API ops must not bounce through the host between
    submits; memory.numpy() is the explicit host copy."""
    import jax
    a = df.memory([2, 64, 4, 4], df.format.nhwc, df.s8).fill_random(rng)
    b = df.memory([2, 64, 4, 4], df.format.nhwc, df.s8).fill_random(rng)
    mid = df.memory([2, 128, 4, 4], df.format.nhwc, df.s8)
    dst = df.memory([2, 128, 4, 4], df.format.nhwc, df.s8)
    df.concat([a, b], mid, post_relu=True).submit()
    assert isinstance(mid.data, jax.Array), type(mid.data)
    df.eltwise_sum_relu(mid, mid, dst).submit()
    assert isinstance(dst.data, jax.Array)
    expect = ref.eltwise_sum_relu_ref(
        ref.concat_relu_ref([a.data, b.data], True),
        ref.concat_relu_ref([a.data, b.data], True), True)
    compare(dst.numpy(), expect, "chained on-device object api")
