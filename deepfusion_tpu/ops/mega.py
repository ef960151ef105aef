"""Two chained packed convs as one op (``PackedConvPairOp``).

The pair is the composition of two ``PackedConvOp``s: layer a writes the
packed intermediate ``smid`` (halo ``halo_mid``), layer b reads it, and an
optional 2x2/s2 max pool follows. VGGFusion's conv-conv-pool blocks and
``parallel/plan.py``'s third stage use it; ``parallel/shard.py`` shards it
layer by layer.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import ConvConfig
from ..utils.logger import check
from .packed import PackedConvOp, PackedSpec


class PackedConvPairOp:
    """conv_b(conv_a(x)) in the packed domain, optionally 2x2-max-pooled.

    Usage::

        pair = PackedConvPairOp(cfg_a, (wa, ba, wa1, ba1),
                                cfg_b, (wb, bb, wb1, bb1))
        x = pack_image(src_u8, pair.sin)
        y = pair(x)
    """

    def __init__(self, cfg_a: ConvConfig, weights_a, cfg_b: ConvConfig,
                 weights_b, sin: PackedSpec = None, halo_out: int = None,
                 col_off_out: int = None, halo_mid: int = None,
                 pool2: bool = False):
        for cfg, name in ((cfg_a, "cfg_a"), (cfg_b, "cfg_b")):
            check(cfg.sh == 1 and cfg.sw == 1,
                  f"conv pair requires stride 1 ({name})")
            check(not cfg.with_sum,
                  f"conv pair does not take sum post-ops ({name})")
        if halo_mid is None:
            halo_mid = max(cfg_b.ph, 1)
        self.a = PackedConvOp(cfg_a, *self._weights(weights_a), sin=sin,
                              halo_out=halo_mid,
                              col_off_out=(sin.col_off if sin is not None
                                           else None))
        sin = self.a.sin
        self.b = PackedConvOp(cfg_b, *self._weights(weights_b),
                              sin=self.a.sout,
                              halo_out=sin.halo if halo_out is None
                              else halo_out,
                              col_off_out=sin.col_off if col_off_out is None
                              else col_off_out,
                              pool2=pool2)
        self._sync()

    @staticmethod
    def _weights(weights):
        return (tuple(weights) + (None, None, None))[:4]

    def _sync(self):
        self.cfg_a, self.cfg_b = self.a.cfg, self.b.cfg
        self.sin, self.smid, self.sout = self.a.sin, self.a.sout, self.b.sout
        self.pool2 = self.b.pool2

    @property
    def sout_pooled(self) -> PackedSpec:
        return self.b.sout_pooled

    @property
    def _operands(self):
        return list(self.a._operands) + list(self.b._operands)

    def pack_input(self, src_u8, xp=np):
        return self.a.pack_input(src_u8, xp=xp)

    def reheight(self, h: int) -> "PackedConvPairOp":
        """Shallow clone computing an h-row horizontal slab (the per-shard
        op of parallel/shard.sp_packed)."""
        import copy
        clone = copy.copy(self)
        clone.a, clone.b = self.a.reheight(h), self.b.reheight(h)
        clone._sync()
        return clone

    def __call__(self, packed_arr, operands=None):
        """operands: optional override of both layers' packed weights (a's
        then b's) — pass them as jit ARGUMENTS from a traced caller."""
        arr = jnp.asarray(packed_arr)
        check(arr.shape == self.sin.array_shape(arr.shape[0]),
              "input does not match the op's packed spec")
        na = len(self.a._operands)
        ops_a = ops_b = None
        if operands is not None:
            ops_a, ops_b = list(operands[:na]), list(operands[na:])
        return self.b(self.a(arr, operands=ops_a), operands=ops_b)

    # --- packed-weight persistence (mirrors PackedConvOp.save/load) ---

    def save(self, path: str):
        """Save both layers' packed operands + configs + specs to .npz."""
        from ..utils.persist import dump_configs
        arrs = {f"a{j}": np.asarray(v) for j, v in enumerate(self.a._operands)}
        arrs.update({f"b{j}": np.asarray(v)
                     for j, v in enumerate(self.b._operands)})
        np.savez(path, __cfg__=dump_configs(
            cfg_a=self.cfg_a, cfg_b=self.cfg_b, sin=self.sin,
            smid=self.smid, sout=self.sout),
            __pool2__=np.bool_(self.pool2), **arrs)

    @classmethod
    def load(cls, path: str) -> "PackedConvPairOp":
        from ..utils.opcache import OperandCache
        from ..utils.persist import load_configs
        from .packed import validate_packed_conv, validate_packed_maxpool2
        data = np.load(path, allow_pickle=False)
        cfgs = load_configs(data["__cfg__"], cfg_a=ConvConfig,
                            cfg_b=ConvConfig, sin=PackedSpec,
                            smid=PackedSpec, sout=PackedSpec)
        pool2 = bool(data["__pool2__"])
        layers = []
        for name, cfg, si, so, p2 in (("a", cfgs["cfg_a"], cfgs["sin"],
                                       cfgs["smid"], False),
                                      ("b", cfgs["cfg_b"], cfgs["smid"],
                                       cfgs["sout"], pool2)):
            validate_packed_conv(cfg, (si,), so)
            if p2:
                validate_packed_maxpool2(so)
            op = PackedConvOp.__new__(PackedConvOp)
            op.cfg, op.cfg_orig, op.ssum, op.pool2 = cfg, None, None, p2
            op.sins, op.sin, op.sout = (si,), si, so
            nops = 8 if cfg.fuse_conv1x1 else 4
            op._cache = OperandCache([data[f"{name}{j}"]
                                      for j in range(nops)])
            layers.append(op)
        pair = cls.__new__(cls)
        pair.a, pair.b = layers
        pair._sync()
        return pair

