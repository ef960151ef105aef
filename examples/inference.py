"""End-to-end deepfusion_tpu usage tour on a GPU.

Covers every user surface the reference's README promises:

  1. functional fused conv (the reference's `conv(...)` factory)
  2. object API (`memory` + `op.submit()`, reference parity)
  3. a layout-persistent packed-domain model chain
  4. the continuous-batching server
  5. sharded execution over a device mesh (when there are >= 2 GPUs)

    python examples/inference.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from deepfusion_tpu.utils import env

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("this tour runs on a GPU "
                         f"(JAX found {jax.devices()[0].platform})")
    env.enable_compile_cache()
    rng = np.random.default_rng(0)

    # ---- 1. functional API: fused conv3x3+ReLU+conv1x1+ReLU ----------
    from deepfusion_tpu.ops.conv import conv

    src = rng.integers(0, 256, (4, 28, 28, 32), dtype=np.uint8)
    wei = rng.integers(-128, 128, (64, 32, 3, 3)).astype(np.int8)
    bia = rng.integers(-100, 100, (64,)).astype(np.int32)
    wei1 = rng.integers(-128, 128, (32, 64, 1, 1)).astype(np.int8)
    out = conv(src, wei, bia, stride=(1, 1), padding=(1, 1),
               dst_dtype="u8", conv0_scales=(0.01,), wei1x1=wei1,
               conv1_relu=True, conv1_scales=(0.1,))
    print(f"1. fused conv: {src.shape} u8 -> {np.asarray(out).shape} "
          f"{np.asarray(out).dtype}")

    # ---- 2. object API (reference parity) ----------------------------
    import deepfusion_tpu as df

    a = df.memory([2, 16, 9, 9], df.format.nhwc, df.s8).fill_random()
    b = df.memory([2, 64, 9, 9], df.format.nhwc, df.s8).fill_random()
    dst = df.memory([2, 80, 9, 9], df.format.nhwc, df.s8)
    df.concat([a, b], dst, post_relu=True).submit()
    print(f"2. object-API concat+relu: -> {dst.data.shape} "
          f"(set DEEPFUSION_PROFILE=1 for per-submit timing)")

    # ---- 3. packed-domain model chain --------------------------------
    from deepfusion_tpu.models import FusionNet, FusionNetConfig

    net = FusionNet(FusionNetConfig(batch=2, hw=28, in_ch=32, width=64,
                                    num_classes=16))
    x = net.example_input()
    logits_dense = np.asarray(net(x))
    logits_packed = np.asarray(net.packed_call(x))
    assert np.array_equal(logits_dense, logits_packed)
    print(f"3. FusionNet: dense and layout-persistent packed forwards "
          f"bitwise identical, logits {logits_dense.shape}")

    # ---- 4. continuous-batching server -------------------------------
    from deepfusion_tpu.serving import BatchServer

    with BatchServer(net.jit_packed(), batch=2,
                     input_shape=net.input_shape[1:]) as server:
        futs = [server.submit(net.example_input(
            np.random.default_rng(i))[0]) for i in range(5)]
        outs = [f.result() for f in futs]
    print(f"4. batch server: 5 requests -> {len(outs)} results of "
          f"shape {outs[0].shape}")

    # ---- 5. sharded execution over a mesh ----------------------------
    import jax

    from deepfusion_tpu.config import ConvConfig
    from deepfusion_tpu.ops.packed import PackedConvOp, pack_image
    from deepfusion_tpu.parallel import (dp_shard, make_mesh,
                                         tp_packed_fused)

    if len(jax.devices()) >= 2:
        cfg = ConvConfig.make(
            (4, 28, 28, 32), (64, 32, 3, 3), bia.dtype, (1, 1), (1, 1),
            (4, 28, 28, 32), "u8", conv0_scales=(0.01,),
            wei1x1_shape=(32, 64, 1, 1), bia1x1_dt=None,
            conv1_relu=True, conv1_scales=(0.1,))
        pop = PackedConvOp(cfg, wei, None, wei1, None)
        xp = pack_image(src, pop.sin)
        mesh = make_mesh(dp=2)
        y_dp = dp_shard(pop, mesh)(xp)
        y_tp = tp_packed_fused(pop, make_mesh(tp=2))(xp)
        assert np.array_equal(np.asarray(y_dp), np.asarray(y_tp))
        print(f"5. dp=2 and tp=2 sharded runs bit-identical: "
              f"{np.asarray(y_dp).shape} over {len(jax.devices())} devices")
    else:
        print("5. (single device: sharded demo skipped)")

    print("ALL EXAMPLES OK")


if __name__ == "__main__":
    main()
