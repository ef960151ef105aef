"""The flat conv core (ops/conv.py): the Triton-route kernel (interpret
mode on the CPU) and its plain XLA twin against the numpy oracle, the
tile/lane-chunk choices, the rounding helper, the peak table and the
compile-cache choice. ``gpu``-marked tests run the compiled kernel."""
import importlib

import numpy as np
import pytest

from deepfusion_tpu.config import ConvConfig
from deepfusion_tpu.ops.ref import conv_ref

from helpers import fill_data

C = importlib.import_module("deepfusion_tpu.ops.conv")


def _case(rng, n=1, hw=9, ic=64, oc=64, oc1=None, stride=1, dst="u8",
          sum_dt=None):
    from deepfusion_tpu.utils.mathutil import conv_output_size
    oh = conv_output_size(hw, 3, stride, 1)
    src = fill_data((n, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    w1 = fill_data((oc1, oc, 1, 1), "s8", rng) if oc1 else None
    b1 = fill_data((oc1,), "s32", rng) if oc1 else None
    kw = {}
    if oc1:
        kw = dict(wei1x1_shape=w1.shape, bia1x1_dt=b1.dtype,
                  conv1_relu=True, conv1_scales=(0.3,))
    cfg = ConvConfig.make((n, hw, hw, ic), wei.shape, bia.dtype,
                          (stride, stride), (1, 1),
                          (n, oh, oh, oc1 or oc), dst, conv0_relu=True,
                          conv0_scales=(0.02,), sum_dt=sum_dt,
                          sum_scale=0.5, **kw)
    return cfg, src, wei, bia, w1, b1


@pytest.mark.parametrize("impl", ["triton", "xla"])
@pytest.mark.parametrize("case", [
    dict(),                                  # plain conv3x3
    dict(oc1=32),                            # fused 3x3 -> 1x1
    dict(ic=96, oc=96, oc1=96),              # 3 lane chunks of 32
    dict(dst="s32", oc1=64),                 # rounding into s32
    dict(sum_dt="u8"),                       # sum post-op
])
def test_impls_match_oracle(impl, case, rng):
    import jax.numpy as jnp
    cfg, src, wei, bia, w1, b1 = _case(rng, **case)
    op = C.ConvOp(cfg, wei, bia, w1, b1)
    s = None
    if case.get("sum_dt"):
        s = fill_data((cfg.bs, cfg.oh, cfg.ow, cfg.oc), "u8", rng)
    with C.use_impl(impl):
        got = C._conv_call(cfg, jnp.asarray(src), *op._operands,
                           sum_src=None if s is None else jnp.asarray(s))
    np.testing.assert_array_equal(
        np.asarray(got), conv_ref(cfg, src, wei, bia, w1, b1, sum_src=s))


def test_emit_acc1_is_the_raw_1x1_accumulator(rng):
    import jax.numpy as jnp
    from deepfusion_tpu.ops.ref import conv_acc_ref, requant_ref
    from deepfusion_tpu.types import dtype
    cfg, src, wei, bia, w1, b1 = _case(rng, oc1=32)
    ops = C.ConvOp(cfg, wei, bia, w1, b1)._operands
    got = np.asarray(C.conv_fused_acc1(cfg, jnp.asarray(src), *ops[:6]))
    acc = conv_acc_ref(src, wei, (1, 1), (1, 1))
    mid = requant_ref(acc, bia, cfg.conv0_scales, True, cfg.conv0_round,
                      dtype.u8).astype(np.int64)
    want = mid @ w1.reshape(32, -1).T.astype(np.int64)
    np.testing.assert_array_equal(got[..., :32], want)


def test_negative_first_tap_is_front_padded(rng):
    """A packed geometry whose first tap reads before flat position 0
    (output halo deeper than input halo - ph): the kernel's lead pad."""
    import jax.numpy as jnp
    from deepfusion_tpu.ops.packed import (PackedConvOp, PackedSpec,
                                           pack_image, unpack_image)
    cfg, src, wei, bia, _, _ = _case(rng, hw=8, ic=32, oc=32)
    sin = PackedSpec.make(8, 8, 32, halo=1, col_off=1, iwp=16)
    op = PackedConvOp(cfg, wei, bia, sin=sin, halo_out=3, col_off_out=2)
    y = np.asarray(op(jnp.asarray(pack_image(src, sin))))
    np.testing.assert_array_equal(unpack_image(y, op.sout),
                                  conv_ref(cfg, src, wei, bia))
    img = y.reshape(1, op.sout.rows, op.sout.iwp, -1)
    assert (img[:, :3] == -128).all() and (img[:, :, :2] == -128).all()


def test_rne_matches_numpy_rint():
    import jax
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 266.8, 1e7 + 1,
                  4194304.5, -4194304.5, 8388607.5, 3e9, -0.0, 0.49999997],
                 np.float32)
    got = np.asarray(jax.jit(C._rne)(x))
    np.testing.assert_array_equal(got, np.rint(x))


def test_pow2_divisor():
    assert C._pow2_divisor(256, 128) == 128
    assert C._pow2_divisor(96, 256) == 32
    assert C._pow2_divisor(64, 256) == 64


def test_use_impl_rejects_unknown():
    with pytest.raises(ValueError):
        with C.use_impl("cuda"):
            pass


def test_peak_table_h100():
    import bench
    row = bench.peak_for("NVIDIA H100 80GB HBM3")
    assert row["int8_ops"] == 1979e12 and row["hbm_bytes"] == 3.35e12


def test_peak_table_unknown_device_raises():
    import bench
    with pytest.raises(SystemExit):
        bench.peak_for("cpu")


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from deepfusion_tpu.utils import env
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert env.compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_in_checkout(monkeypatch):
    import os
    from deepfusion_tpu.utils import env
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert env.compile_cache_dir() == os.path.join(root, ".jax_cache")


@pytest.mark.gpu
def test_flagship_compiled_on_gpu(gpu):
    """The flagship fused conv compiled for the card, exact vs oracle."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    cfg, src, wei, bia, w1, b1 = _case(rng, n=2, hw=126, ic=256, oc=256,
                                       oc1=256)
    op = C.ConvOp(cfg, wei, bia, w1, b1)
    got = C._conv_call(cfg, jnp.asarray(src), *op._operands)
    np.testing.assert_array_equal(np.asarray(got),
                                  conv_ref(cfg, src, wei, bia, w1, b1))


@pytest.mark.gpu
def test_chip_smoke_ops_on_gpu(gpu):
    import chip_smoke
    res = chip_smoke.op_phase(np.random.default_rng(0), small=4,
                              log=lambda *_: None)
    assert all(r["max_abs_diff"] == 0 for r in res), res
