"""ConvOp packed-weight save/load round-trip tests."""
import numpy as np

from deepfusion_tpu.config import ConvConfig
from deepfusion_tpu.ops.conv import ConvOp

from helpers import compare, fill_data


def test_fused_save_load_roundtrip(tmp_path, rng):
    src = fill_data((2, 9, 9, 16), "u8", rng)
    wei = fill_data((32, 16, 3, 3), "s8", rng)
    bia = fill_data((32,), "s32", rng)
    wei1 = fill_data((16, 32, 1, 1), "s8", rng)
    cfg = ConvConfig.make(
        (2, 9, 9, 16), (32, 16, 3, 3), bia.dtype, (1, 1), (1, 1),
        (2, 9, 9, 16), "u8", conv0_scales=(0.02,),
        wei1x1_shape=(16, 32, 1, 1), conv1_relu=True, conv1_scales=(0.4,))
    op = ConvOp(cfg, wei, bia, wei1)
    path = str(tmp_path / "op.npz")
    op.save(path)
    op2 = ConvOp.load(path)
    assert op2.cfg == op.cfg
    compare(np.asarray(op2(src)), np.asarray(op(src)), "save/load")


def test_sum_postop_save_load(tmp_path, rng):
    """Round 1 bug: `sum_dt` was never serialized, so save() raised
    TypeError on any with_sum config."""
    src = fill_data((2, 9, 9, 16), "u8", rng)
    wei = fill_data((32, 16, 3, 3), "s8", rng)
    bia = fill_data((32,), "s32", rng)
    sum_src = fill_data((2, 9, 9, 32), "u8", rng)
    cfg = ConvConfig.make(
        (2, 9, 9, 16), (32, 16, 3, 3), bia.dtype, (1, 1), (1, 1),
        (2, 9, 9, 32), "u8", conv0_scales=(0.05,),
        sum_dt="u8", sum_scale=0.5)
    op = ConvOp(cfg, wei, bia)
    path = str(tmp_path / "op_sum.npz")
    op.save(path)
    op2 = ConvOp.load(path)
    assert op2.cfg == op.cfg
    compare(np.asarray(op2(src, sum_src=sum_src)),
            np.asarray(op(src, sum_src=sum_src)), "sum save/load")


def test_standalone_save_load(tmp_path, rng):
    src = fill_data((1, 7, 7, 16), "u8", rng)
    wei = fill_data((16, 16, 3, 3), "s8", rng)
    cfg = ConvConfig.make((1, 7, 7, 16), (16, 16, 3, 3), None, (1, 1),
                          (1, 1), (1, 7, 7, 16), "s8",
                          conv0_scales=np.full(16, 0.1, np.float32))
    op = ConvOp(cfg, wei)
    path = str(tmp_path / "op2.npz")
    op.save(path)
    op2 = ConvOp.load(path)
    compare(np.asarray(op2(src)), np.asarray(op(src)), "standalone")


def test_convpool_save_load(tmp_path, rng):
    """Persistence parity for ConvPoolOp."""
    from deepfusion_tpu.config import PoolConfig
    from deepfusion_tpu.ops.convpool import ConvPoolOp

    src = fill_data((2, 8, 8, 16), "u8", rng)
    wei = fill_data((32, 16, 3, 3), "s8", rng)
    bia = fill_data((32,), "s32", rng)
    cfg = ConvConfig.make((2, 8, 8, 16), (32, 16, 3, 3), bia.dtype,
                          (1, 1), (1, 1), (2, 8, 8, 32), "u8",
                          conv0_scales=(0.03,))
    pc = PoolConfig.make("max", (8, 8), (2, 2), (2, 2), (0, 0))
    op = ConvPoolOp(cfg, pc, wei, bia)
    path = str(tmp_path / "cp.npz")
    op.save(path)
    op2 = ConvPoolOp.load(path)
    assert (op2.cfg, op2.pc) == (op.cfg, op.pc)
    compare(np.asarray(op2(src)), np.asarray(op(src)), "convpool save/load")


def test_packed_save_load(tmp_path, rng):
    """Persistence parity for PackedConvOp: the
    input/output PackedSpecs must round-trip with the config."""
    from deepfusion_tpu.ops.packed import (PackedConvOp, pack_image,
                                           unpack_image)

    src = fill_data((2, 8, 8, 32), "u8", rng)
    wei = fill_data((32, 32, 3, 3), "s8", rng)
    bia = fill_data((32,), "s32", rng)
    wei1 = fill_data((32, 32, 1, 1), "s8", rng)
    cfg = ConvConfig.make(
        (2, 8, 8, 32), (32, 32, 3, 3), bia.dtype, (1, 1), (1, 1),
        (2, 8, 8, 32), "u8", conv0_scales=(0.02,),
        wei1x1_shape=(32, 32, 1, 1), conv1_relu=True, conv1_scales=(0.4,))
    op = PackedConvOp(cfg, wei, bia, wei1)
    path = str(tmp_path / "pk.npz")
    op.save(path)
    op2 = PackedConvOp.load(path)
    assert (op2.cfg, op2.sins, op2.sout) == (op.cfg, op.sins, op.sout)
    x = pack_image(src, op.sin)
    compare(unpack_image(np.asarray(op2(x)), op2.sout),
            unpack_image(np.asarray(op(x)), op.sout), "packed save/load")
