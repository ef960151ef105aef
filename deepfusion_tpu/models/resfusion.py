"""ResFusionNet — ResNet-style INT8 model exercising the remaining hot
paths FusionNet does not touch: the strided conv, the conv eltwise-sum
post-op (residual fused into the requant epilogue), and the
conv+relu+maxpool downsampler.

The reference ships no models; its VGG/ResNet layer shapes
(test/test_conv_relu_pooling.cc:313-391) and roadmap fusions
(README.md:64-65) are the spec for this composition. Together with
FusionNet, every public op family runs inside a model forward.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from ..config import PoolConfig
from ..ops.convpool import ConvPoolOp
from ..ops.pool import pool
from .fusionnet import _mkconv


@dataclasses.dataclass
class ResFusionNetConfig:
    batch: int = 8
    hw: int = 64          # input resolution (even; stem halves it)
    in_ch: int = 32
    width: int = 128
    num_classes: int = 128
    seed: int = 1


class ResFusionNet:
    """INT8 CNN: strided stem -> residual fused block (sum post-op) ->
    fused conv+relu+maxpool downsample -> fused block -> global avg pool
    -> f32 head."""

    def __init__(self, cfg: ResFusionNetConfig = ResFusionNetConfig()):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n, hw, c, w = cfg.batch, cfg.hw, cfg.in_ch, cfg.width

        # stem: conv3x3 stride 2, u8 out
        p_stem, s = _mkconv(rng, n, hw, hw, c, w, 3, 1, 2, "u8",
                            in_std=74.0)
        self.stem = p_stem.dense()

        # residual block: fused conv3x3+relu+conv1x1 whose epilogue adds
        # the block input via the sum post-op (the reference's roadmap
        # conv+sum+relu chain, fused into one kernel)
        hw1 = s[1]
        p_blk, _ = _mkconv(rng, n, hw1, hw1, w, w, 3, 1, 1, "u8", oc1x1=w)
        p_blk = dataclasses.replace(
            p_blk, cfg=dataclasses.replace(p_blk.cfg, with_sum=True,
                                           sum_scale=1.0,
                                           sum_dt=p_blk.cfg.dst_dt))
        self.block1 = p_blk.dense()

        # downsample: conv3x3+relu+maxpool2x2/s2
        p_dn, _ = _mkconv(rng, n, hw1, hw1, w, w, 3, 1, 1, "u8")
        pc = PoolConfig.make("max", (hw1, hw1), (2, 2), (2, 2), (0, 0))
        self.down = ConvPoolOp(p_dn.cfg, pc, p_dn.wei, p_dn.bia)

        # stage 2: fused block (w -> w -> w)
        hw2 = hw1 // 2
        p_blk2, _ = _mkconv(rng, n, hw2, hw2, w, w, 3, 1, 1, "u8", oc1x1=w)
        self.block2 = p_blk2.dense()

        # head: global avg pool (exclude pad) then 1x1 conv to f32 logits
        p_head, _ = _mkconv(rng, n, 1, 1, w, cfg.num_classes, 1, 0, 1,
                            "f32", relu=False)
        self.head = p_head.dense()
        # raw weights kept for differential testing (oracle composition)
        self.params = dict(stem=p_stem, block1=p_blk, down=p_dn,
                           block2=p_blk2, head=p_head)
        self._in_shape = (n, hw, hw, c)
        self._packed = None

    @property
    def input_shape(self):
        return self._in_shape

    def example_input(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(7)
        return rng.integers(0, 256, self._in_shape, dtype=np.uint8)

    def __call__(self, x_u8):
        x = self.stem(x_u8)                       # strided conv
        y = self.block1(x, sum_src=x)             # residual via sum post-op
        y = self.down(y)                          # conv+pool
        y = self.block2(y)
        y = pool(y, "avg_exc", (y.shape[1], y.shape[2]),
                 (y.shape[1], y.shape[2]), (0, 0))
        logits = self.head(y)
        return logits.reshape(logits.shape[0], -1)

    def jit(self):
        return jax.jit(self.__call__)

    # ------------------------------------------ packed-domain forward path

    def build_packed(self):
        """Layout-persistent pipeline: the strided stem runs the packed
        conv on the s2d grid (its output is already packed for block1),
        the residual joins as a packed sum post-op inside block1's requant
        epilogue, the downsample is a packed conv + packed 2x2 maxpool, and
        the head reduces straight off the packed array — the only dense
        relayout in the model is the boundary pack of the input image.

        Halo budget: iwp=48 (the maxpool needs iwp % 16 == 0); the erosion
        chain stem(4) -> block1(3) -> down(2, even for the pool) -> pool(1)
        -> block2(0) keeps every boundary window in-bounds. block1's sum
        operand is the stem output at halo 4 while block1 emits halo 3 —
        the conv re-bases rows by the static halo difference instead of
        forcing a repack."""
        if self._packed is not None:
            return self._packed
        from ..ops import layout
        from ..ops.packed import PackedSpec
        p = self.params
        cfg2 = layout.s2d_cfg(p["stem"].cfg)
        sin0 = PackedSpec(h=cfg2.ih, w=cfg2.iw, c=cfg2.ic, cp=cfg2.icp,
                          halo=4, col_off=2, iwp=48)
        stem = p["stem"].packed(sin0, 2, 4)
        block1 = p["block1"].packed(stem.sout, 2, 3, sum_spec=stem.sout)
        down = p["down"].packed(block1.sout, 2, 2)
        block2 = p["block2"].packed(
            PackedSpec(h=down.sout.h // 2, w=down.sout.w // 2,
                       c=down.sout.c, cp=down.sout.cp, halo=1, col_off=1,
                       iwp=down.sout.iwp // 2), 1, 0)
        self._packed = dict(stem=stem, block1=block1, down=down,
                            block2=block2)
        return self._packed

    def packed_call(self, x_u8):
        """Forward pass bit-identical to ``__call__`` (the packed sum
        post-op joins in the same exact integer domain as the dense one;
        max pooling commutes with the -128 centering)."""
        import jax.numpy as jnp

        from ..ops.packed import packed_global_avgpool, packed_maxpool2
        P = self.build_packed()
        x = P["stem"].pack_input(x_u8, xp=jnp)
        x = P["stem"](x)                          # packed s2d conv
        y = P["block1"](x, sum_arr=x)             # residual sum post-op
        y = P["down"](y)
        y, _ = packed_maxpool2(y, P["down"].sout)
        y = P["block2"](y)
        y = packed_global_avgpool(y, P["block2"].sout)
        logits = self.head(y)
        return logits.reshape(logits.shape[0], -1)

    def jit_packed(self):
        self.build_packed()
        return jax.jit(self.packed_call)
