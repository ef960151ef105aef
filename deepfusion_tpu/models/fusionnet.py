"""FusionNet — flagship INT8 inference model built from the fused primitives.

The reference ships no models (SURVEY.md §2), but its ops are designed for
exactly this composition (README.md:64-65 roadmap + the VGG/ResNet shapes in
test/test_conv_relu_pooling.cc:313-391). FusionNet exercises every public
op: fused conv3x3+relu+conv1x1+relu blocks, concat+relu branch merge,
eltwise-sum+relu residual, conv+relu+maxpool downsampling, global average
pooling, and an f32 classification head — all INT8 end to end, activations
u8, weights s8, per-channel scales.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ConvConfig
from ..ops.conv import ConvOp
from ..ops.concat import concat
from ..ops.pool import eltwise_sum_relu, pool
from ..utils.mathutil import conv_output_size


@dataclasses.dataclass
class _ConvParams:
    """One conv layer's config + raw weights (kept so the model can build
    both the dense ConvOp and the packed-domain PackedConvOp from them)."""
    cfg: ConvConfig
    wei: np.ndarray
    bia: np.ndarray
    wei1: Optional[np.ndarray] = None
    bia1: Optional[np.ndarray] = None

    def dense(self) -> ConvOp:
        return ConvOp(self.cfg, self.wei, self.bia, self.wei1, self.bia1)

    def packed(self, sin, col_off_out, halo_out, sum_spec=None):
        from ..ops.packed import PackedConvOp
        return PackedConvOp(self.cfg, self.wei, self.bia, self.wei1,
                            self.bia1, sin=sin, col_off_out=col_off_out,
                            halo_out=halo_out, sum_spec=sum_spec)


def _mkconv(rng, n, ih, iw, ic, oc, k, pad, stride, dst_dt, *,
            oc1x1=None, relu=True, in_std=30.0):
    """Build conv params with random int8 weights and analytically
    calibrated scales: scale ~ 48 / std(acc) keeps u8 activations alive
    (neither saturated nor rounded to zero) through arbitrarily deep
    stacks."""
    wei = rng.integers(-16, 17, (oc, ic, k, k)).astype(np.int8)
    wei_std = 16.0 / np.sqrt(3.0)
    acc_std = np.sqrt(k * k * ic) * in_std * wei_std
    bia = rng.integers(-int(acc_std * 0.05) - 1, int(acc_std * 0.05) + 2,
                       (oc,)).astype(np.int32)
    sc0 = (rng.uniform(0.8, 1.2, oc).astype(np.float32)
           * np.float32(48.0 / acc_std))
    oh = conv_output_size(ih, k, stride, pad)
    ow = conv_output_size(iw, k, stride, pad)
    if oc1x1 is None:
        cfg = ConvConfig.make(
            (n, ih, iw, ic), (oc, ic, k, k), bia.dtype, (stride, stride),
            (pad, pad), (n, oh, ow, oc), dst_dt,
            conv0_relu=relu, conv0_scales=sc0)
        return _ConvParams(cfg, wei, bia), (n, oh, ow, oc)
    wei1 = rng.integers(-16, 17, (oc1x1, oc, 1, 1)).astype(np.int8)
    acc1_std = np.sqrt(oc) * 30.0 * wei_std
    bia1 = rng.integers(-int(acc1_std * 0.05) - 1, int(acc1_std * 0.05) + 2,
                        (oc1x1,)).astype(np.int32)
    sc1 = (rng.uniform(0.8, 1.2, oc1x1).astype(np.float32)
           * np.float32(48.0 / acc1_std))
    cfg = ConvConfig.make(
        (n, ih, iw, ic), (oc, ic, k, k), bia.dtype, (stride, stride),
        (pad, pad), (n, oh, ow, oc1x1), dst_dt,
        conv0_relu=True, conv0_scales=sc0,
        wei1x1_shape=(oc1x1, oc, 1, 1), bia1x1_dt=bia1.dtype,
        conv1_relu=relu, conv1_scales=sc1)
    return _ConvParams(cfg, wei, bia, wei1, bia1), (n, oh, ow, oc1x1)


@dataclasses.dataclass
class FusionNetConfig:
    batch: int = 8
    hw: int = 56
    in_ch: int = 32
    width: int = 128
    num_classes: int = 128
    seed: int = 0


class FusionNet:
    """INT8 CNN: stem -> fused block -> branch concat -> residual ->
    downsample -> fused block -> global pool -> f32 head."""

    def __init__(self, cfg: FusionNetConfig = FusionNetConfig()):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n, hw, c, w = cfg.batch, cfg.hw, cfg.in_ch, cfg.width

        # stem: conv3x3 (c -> w) + relu, u8 out; raw u8 input has std ~74
        p_stem, s = _mkconv(rng, n, hw, hw, c, w, 3, 1, 1, "u8",
                            in_std=74.0)
        # block1: deep-fused conv3x3+relu+conv1x1+relu (w -> w -> w)
        p_block1, s = _mkconv(rng, n, s[1], s[2], w, w, 3, 1, 1, "u8",
                              oc1x1=w)
        # branch: 1x1 conv (w -> w) on the same input, concat along channels
        p_branch, _ = _mkconv(rng, n, s[1], s[2], w, w, 1, 0, 1, "u8")
        # fuse branches: concat+relu -> 2w channels
        # residual: 1x1 conv (2w -> 2w) summed with identity via
        # eltwise-sum+relu
        p_res, s2 = _mkconv(rng, n, s[1], s[2], 2 * w, 2 * w, 1, 0, 1,
                            "u8")
        # downsample: maxpool 2x2/s2
        hw2 = s[1] // 2
        # block2: fused (2w -> 2w -> w)
        p_block2, s3 = _mkconv(rng, n, hw2, hw2, 2 * w, 2 * w, 3, 1, 1,
                               "u8", oc1x1=w)
        # head: global avg pool (exclude pad) then 1x1 conv to f32 logits
        p_head, _ = _mkconv(rng, n, 1, 1, w, cfg.num_classes, 1, 0, 1,
                            "f32", relu=False)
        self.params = dict(stem=p_stem, block1=p_block1, branch=p_branch,
                           res=p_res, block2=p_block2, head=p_head)
        self.stem, self.block1, self.branch = (p_stem.dense(),
                                               p_block1.dense(),
                                               p_branch.dense())
        self.res, self.block2, self.head = (p_res.dense(), p_block2.dense(),
                                            p_head.dense())
        self._stem_in_shape = (n, hw, hw, c)
        self._packed = None

    @property
    def input_shape(self):
        return self._stem_in_shape

    def example_input(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(42)
        return rng.integers(0, 256, self._stem_in_shape, dtype=np.uint8)

    def __call__(self, x_u8):
        x = self.stem(x_u8)                        # (n, hw, hw, w) u8
        a = self.block1(x)                          # fused 3x3+1x1
        b = self.branch(x)                          # 1x1 branch
        y = concat([a, b], post_relu=True)          # (n, hw, hw, 2w)
        r = self.res(y)                             # 1x1 on merged
        y = eltwise_sum_relu(y, r)                  # residual + relu
        y = pool(y, "max", (2, 2), (2, 2), (0, 0))  # downsample
        y = self.block2(y)                          # fused 3x3+1x1 -> w
        y = pool(y, "avg_exc",
                 (y.shape[1], y.shape[2]),
                 (y.shape[1], y.shape[2]), (0, 0))  # global avg -> (n,1,1,w)
        logits = self.head(y)                       # (n,1,1,classes) f32
        return logits.reshape(logits.shape[0], -1)

    def jit(self):
        return jax.jit(self.__call__)

    def reference(self, x_u8) -> np.ndarray:
        """The same forward composed from the numpy oracles of ops/ref.py
        (float64 BLAS accumulation, exact): the model-level reference."""
        from ..config import PoolConfig
        from ..ops.ref import (concat_relu_ref, conv_ref,
                               eltwise_sum_relu_ref, pool_ref)

        def run(name, x):
            p = self.params[name]
            return conv_ref(p.cfg, x, p.wei, p.bia, p.wei1, p.bia1)

        x = run("stem", np.asarray(x_u8))
        y = concat_relu_ref([run("block1", x), run("branch", x)], True)
        y = eltwise_sum_relu_ref(y, run("res", y))
        h = y.shape[1]
        y = pool_ref(y, PoolConfig.make("max", (h, h), (2, 2), (2, 2),
                                        (0, 0)))
        y = run("block2", y)
        h = y.shape[1]
        y = pool_ref(y, PoolConfig.make("avg_exc", (h, h), (h, h), (h, h),
                                        (0, 0)))
        logits = run("head", y)
        return logits.reshape(logits.shape[0], -1)

    # ------------------------------------------ packed-domain forward path

    def build_packed(self):
        """Construct the layout-persistent pipeline (ops/packed.py): every
        stride-1 activation stays in the packed domain — conv, concat,
        residual sum, the 2x2 maxpool, and the global avg pool all read
        packed arrays, so the only HBM relayout in the whole model is the
        boundary pack of the input image."""
        if self._packed is not None:
            return self._packed
        from ..ops.packed import PackedSpec
        hw, c, w = self.cfg.hw, self.cfg.in_ch, self.cfg.width
        p = self.params

        # Halo budget (erosion scheme): each 3x3 conv consumes one halo row
        # (halo_out = halo_in - ph), so no output row reads out of
        # bounds. The 2x2
        # maxpool needs its input halo even; the chain 4 -> 3 -> 2(even)
        # -> pool -> 1 -> 0 satisfies every consumer exactly.
        sin0 = PackedSpec.make(hw, hw, c, cp=p["stem"].cfg.icp,
                               halo=4, col_off=2)
        stem = p["stem"].packed(sin0, 2, 3)
        block1 = p["block1"].packed(stem.sout, 2, 2)
        branch = p["branch"].packed(stem.sout, 2, 2)
        # concat-free branch merge: the 1x1 residual conv reads both
        # branches as K-segments, and the fused sum+pool joins them — the
        # 2w-channel concat never exists in memory
        res = p["res"].packed((block1.sout, branch.sout), 2, 2)
        pool_spec = PackedSpec(h=hw // 2, w=hw // 2, c=2 * w, cp=2 * w,
                               halo=1, col_off=1, iwp=sin0.iwp // 2)
        block2 = p["block2"].packed(pool_spec, 1, 0)
        self._packed = dict(stem=stem, block1=block1, branch=branch,
                            res=res, block2=block2)
        return self._packed

    def packed_call(self, x_u8):
        """Forward pass bit-identical to ``__call__`` (u8 ReLU is identity
        through concat; max pooling and the saturating residual sum commute
        exactly with the -128 centering — see ops/packed.py docstrings)."""
        from ..ops.packed import (pack_image, packed_global_avgpool,
                                  packed_sum_relu_maxpool2)
        P = self.build_packed()
        x = pack_image(x_u8, P["stem"].sin, xp=jnp)
        x = P["stem"](x)
        a = P["block1"](x)
        b = P["branch"](x)
        r = P["res"]((a, b))
        y, _ = packed_sum_relu_maxpool2(
            (a, b), r, (P["block1"].sout, P["branch"].sout), P["res"].sout)
        y = P["block2"](y)
        # global avg pool straight off the packed array: the activations
        # never unpack anywhere in the graph (the -128 fill makes non-image
        # slots contribute 0 to the u8 sum)
        y = packed_global_avgpool(y, P["block2"].sout)
        logits = self.head(y)
        return logits.reshape(logits.shape[0], -1)

    def jit_packed(self):
        self.build_packed()
        return jax.jit(self.packed_call)
