"""VGGFusion — a VGG-style INT8 backbone of conv-conv-pool blocks.

The reference's conv+relu+pooling spec pipeline
(test/test_conv_relu_pooling.cc:313-391) is the VGG downsampling block:
conv3x3+relu -> conv3x3+relu -> maxpool2x2/s2. This model stacks three
such blocks. The packed path runs each block as a
``PackedConvPairOp(pool2=True)`` (two packed convs and the pool, with the
activations in the packed layout throughout); the dense twin runs
ConvOp + ConvPoolOp per block; the two forwards are bitwise identical
(tests/test_models.py).

Geometry: every block emits halo_out=2 / col_off_out=2 (even, for pool
legality); pooling halves them to 1/1. The input iwp is a multiple of
8 * 2^n_blocks so every pooled row keeps iwp a multiple of 8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logger import check
from ..utils.mathutil import round_up
from .fusionnet import _mkconv


@dataclasses.dataclass
class VGGFusionConfig:
    batch: int = 8
    hw: int = 56            # divisible by 2^3 (three pooled blocks)
    in_ch: int = 32
    width: int = 64         # block widths: w, 2w, 4w
    num_classes: int = 128
    seed: int = 0


class VGGFusion:
    """INT8 VGG-style CNN: 3 x [conv3x3+relu, conv3x3+relu, maxpool2]
    -> global avg pool -> f32 head."""

    N_BLOCKS = 3

    def __init__(self, cfg: VGGFusionConfig = VGGFusionConfig()):
        check(cfg.hw % (2 ** self.N_BLOCKS) == 0,
              "hw must be divisible by 2^n_blocks")
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n, hw = cfg.batch, cfg.hw
        chans = [cfg.in_ch] + [cfg.width * (1 << b)
                               for b in range(self.N_BLOCKS)]
        self.block_params = []
        h = hw
        for b in range(self.N_BLOCKS):
            c_in, c_out = chans[b], chans[b + 1]
            p1, s = _mkconv(rng, n, h, h, c_in, c_out, 3, 1, 1, "u8",
                            in_std=74.0 if b == 0 else 30.0)
            p2, s = _mkconv(rng, n, s[1], s[2], c_out, c_out, 3, 1, 1,
                            "u8")
            self.block_params.append((p1, p2))
            h //= 2
        p_head, _ = _mkconv(rng, n, 1, 1, chans[-1], cfg.num_classes, 1,
                            0, 1, "f32", relu=False)
        self.head = p_head.dense()
        # dense twin: ConvOp for conv1, ConvPoolOp for conv2 + pool
        from ..config import PoolConfig
        from ..ops.convpool import ConvPoolOp
        self.dense_blocks = []
        for p1, p2 in self.block_params:
            pc = PoolConfig.make("max", (p2.cfg.oh, p2.cfg.ow), (2, 2),
                                 (2, 2), (0, 0))
            self.dense_blocks.append(
                (p1.dense(), ConvPoolOp(p2.cfg, pc, p2.wei, p2.bia)))
        self._stem_in_shape = (n, hw, hw, cfg.in_ch)
        self._packed = None

    @property
    def input_shape(self):
        return self._stem_in_shape

    def example_input(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(42)
        return rng.integers(0, 256, self._stem_in_shape, dtype=np.uint8)

    # ------------------------------------------------------------ dense

    def __call__(self, x_u8):
        from ..ops.pool import pool
        x = jnp.asarray(x_u8)
        for conv1, convpool2 in self.dense_blocks:
            x = convpool2(conv1(x))
        x = pool(x, "avg_exc", (x.shape[1], x.shape[2]),
                 (x.shape[1], x.shape[2]), (0, 0))
        logits = self.head(x)
        return logits.reshape(logits.shape[0], -1)

    def jit(self):
        return jax.jit(self.__call__)

    # ----------------------------------------------------------- packed

    def build_packed(self):
        """One ``PackedConvPairOp(pool2=True)`` per block."""
        if self._packed is not None:
            return self._packed
        from ..ops.mega import PackedConvPairOp
        from ..ops.packed import PackedSpec
        cfg = self.cfg
        # iwp divisible by 8 * 2^n_blocks keeps every pooled iwp % 8 == 0
        iwp0 = round_up(cfg.hw + 4, 8 * 2 ** self.N_BLOCKS)
        spec = PackedSpec.make(cfg.hw, cfg.hw, cfg.in_ch, halo=2,
                               col_off=2, iwp=iwp0)
        pairs = []
        for b, (p1, p2) in enumerate(self.block_params):
            # last block: halo_out=0 (nothing consumes its halo)
            ho = 0 if b == self.N_BLOCKS - 1 else 2
            pair = PackedConvPairOp(
                p1.cfg, (p1.wei, p1.bia), p2.cfg, (p2.wei, p2.bia),
                sin=spec, halo_out=ho, col_off_out=2, pool2=True)
            pairs.append(pair)
            spec = pair.sout_pooled
        self._packed = (pairs, spec)
        return self._packed

    def packed_call(self, x_u8):
        """Bitwise identical to ``__call__``: 3 conv-pair blocks + the
        packed global average pool + the head."""
        from ..ops.packed import pack_image, packed_global_avgpool
        pairs, final_spec = self.build_packed()
        x = pack_image(x_u8, pairs[0].sin, xp=jnp)
        for pair in pairs:
            x = pair(x)
        y = packed_global_avgpool(x, final_spec)
        logits = self.head(y)
        return logits.reshape(logits.shape[0], -1)

    def jit_packed(self):
        self.build_packed()
        return jax.jit(self.packed_call)

    # ------------------------------------------------------------ hybrid

    def hybrid_call(self, x_u8):
        """Mixed schedule: the big-image block runs packed, the shrunken
        late blocks run dense (where packed halo rows/columns are a large
        share of the positions computed). One unpack at the seam is the
        only glue. Bitwise identical to both pure schedules
        (tests/test_models.py)."""
        from ..ops.packed import pack_image, unpack_image
        from ..ops.pool import pool
        pairs, _ = self.build_packed()
        x = pack_image(x_u8, pairs[0].sin, xp=jnp)
        x = pairs[0](x)
        y = unpack_image(x, pairs[0].sout_pooled, xp=jnp)
        for conv1, convpool2 in self.dense_blocks[1:]:
            y = convpool2(conv1(y))
        y = pool(y, "avg_exc", (y.shape[1], y.shape[2]),
                 (y.shape[1], y.shape[2]), (0, 0))
        logits = self.head(y)
        return logits.reshape(logits.shape[0], -1)
