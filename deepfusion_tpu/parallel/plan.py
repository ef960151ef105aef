"""The composed dp x sp x tp execution plan (three sharded stages).

One builder shared by the driver's multi-chip dryrun
(``__graft_entry__.dryrun_multichip``) and the scaling benchmark
(``bench.py --op scaling --mesh dp=..,sp=..,tp=..``), so every mesh the
dryrun proves compiles is also measurable by the throughput harness:

  stage 1 — dp x sp sharded fused conv3x3+1x1 (u8 -> u8): batch over
            ``dp``, H over ``sp`` with the overlap-scheduled ppermute
            halo exchange (``parallel/shard.sp_conv``);
  stage 2 — tp-sharded fused conv: conv0 oc over ``tp``, the 1x1's s32
            contraction completed by ``psum_scatter`` BEFORE the
            nonlinear requant (``parallel/shard.tp_fused_conv``);
  stage 3 — dp x sp sharded conv pair + pool2 (``ops/mega.
            PackedConvPairOp`` under ``sp_packed``: packed-domain ppermute
            halo exchange overlapped with the interior rows, composed with
            dp batch sharding), fed by a
            traced model-boundary ``pack_image_sharded`` and unpacked to
            a dense u8 image at the end so the plan's output is
            mesh-shape-invariant.

The reference has no distributed execution at all (SURVEY.md §2); this
composition is the scale-out demanded by BASELINE.md's north star, with
every stage bit-exact vs its single-device op.
"""
from __future__ import annotations

import numpy as np

from ..config import ConvConfig
from ..ops.conv import ConvOp
from ..ops.mega import PackedConvPairOp
from ..ops.packed import (PackedSpec, pack_image_sharded,
                          unpack_image_sharded)
from ..utils.logger import check
from ..utils.mathutil import round_up
from .shard import sp_conv, sp_packed, tp_fused_conv


def three_stage_plan(mesh, mb: int, hw: int, ic: int, oc: int, oc1: int,
                     rng=None, magnitude: int = 10):
    """Build the composed plan at the given shape.

    Returns ``(step, pair, cfg2)``: ``step(src_u8_nhwc) -> packed pooled
    int8`` jit-ready over ``mesh``; ``pair`` (stage-3 op, for
    ``pair.sout_pooled``) and ``cfg2`` (stage-2 config, for wire-byte
    accounting). Shape legality: ``mb % dp == 0``, ``hw % (2*sp) == 0``,
    ``oc % tp == 0``.
    """
    import jax.numpy as jnp

    rng = rng or np.random.default_rng(0)
    dp, sp, tp = (mesh.shape[a] for a in ("dp", "sp", "tp"))
    check(mb % dp == 0, f"batch {mb} not divisible by dp={dp}")
    check(hw % max(2 * sp, 2) == 0,
          f"hw {hw} must be divisible by 2*sp (sp shards + pool2)")
    check(oc % tp == 0, f"oc {oc} not divisible by tp={tp}")
    m = magnitude

    wei = rng.integers(-m, m + 1, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-m, m + 1, (oc,)).astype(np.int32)
    wei1 = rng.integers(-m, m + 1, (oc1, oc, 1, 1)).astype(np.int8)
    bia1 = rng.integers(-m, m + 1, (oc1,)).astype(np.int32)

    # stage 1: dp x sp sharded fused conv (u8 -> u8), halo exchange on sp
    cfg1 = ConvConfig.make(
        (mb, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (1, 1), (1, 1),
        (mb, hw, hw, oc1), "u8", conv0_scales=(0.02,),
        wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=bia1.dtype,
        conv1_relu=True, conv1_scales=(0.2,))
    op1 = ConvOp(cfg1, wei, bia, wei1, bia1)
    stage1 = sp_conv(op1, mesh, axis="sp", dp_axis="dp")

    # stage 2: tp-sharded fused conv (collective before requant)
    wei2 = rng.integers(-m, m + 1, (oc, oc1, 3, 3)).astype(np.int8)
    wei21 = rng.integers(-m, m + 1, (oc1, oc, 1, 1)).astype(np.int8)
    cfg2 = ConvConfig.make(
        (mb, hw, hw, oc1), (oc, oc1, 3, 3), None, (1, 1), (1, 1),
        (mb, hw, hw, oc1), "u8", conv0_scales=(0.02,),
        wei1x1_shape=(oc1, oc, 1, 1), conv1_relu=True,
        conv1_scales=(0.2,))
    stage2 = tp_fused_conv(cfg2, wei2, None, wei21, None, mesh,
                           wire="reduce_scatter")

    # stage 3: dp x sp sharded conv pair + pool2 (sp_packed halo exchange
    # in the packed domain; erosion sin: halo_out + ph_a + ph_b)
    wei3a = rng.integers(-m, m + 1, (oc1, oc1, 3, 3)).astype(np.int8)
    wei3b = rng.integers(-m, m + 1, (oc1, oc1, 3, 3)).astype(np.int8)
    cfg3 = ConvConfig.make(
        (mb, hw, hw, oc1), (oc1, oc1, 3, 3), None, (1, 1), (1, 1),
        (mb, hw, hw, oc1), "u8", conv0_relu=True, conv0_scales=(0.05,))
    sin3 = PackedSpec.make(hw, hw, oc1, halo=4, col_off=2,
                           iwp=round_up(hw + 4, 16))
    pair = PackedConvPairOp(cfg3, (wei3a, None), cfg3, (wei3b, None),
                            sin=sin3, halo_out=2, col_off_out=2,
                            pool2=True)
    stage3 = sp_packed(pair, mesh, axis="sp", dp_axis="dp")
    sin3_l = stage3.local_spec

    def step(s):
        y = stage2(stage1(s))
        z = stage3(pack_image_sharded(y, sin3_l, sp, xp=jnp))
        # unpack the sharded pooled output to a dense u8 image so the
        # plan's result is identical across mesh shapes
        return unpack_image_sharded(z, stage3.local_out_spec, sp, xp=jnp)

    return step, pair, cfg2
