"""Conv3x3(+ReLU)(+sum)+pool — the reference's roadmap op (README.md:64-65;
spec pipeline in test/test_conv_relu_pooling.cc:264-281 and :313-391): the
conv path (ops/conv.py) followed by the pooling window (ops/pool.py) under
one jit. Bit-identical to ``pool_ref(conv_ref(...))``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ConvConfig, PoolConfig
from ..utils.opcache import OperandCache
from . import layout
from .conv import _conv_call
from .pool import _pool_call


@functools.partial(jax.jit, static_argnames=("cfg", "pc"))
def _convpool_call(cfg: ConvConfig, pc: PoolConfig, src_u8, *operands,
                   sum_src=None):
    y = _conv_call(cfg, src_u8, *operands, sum_src=sum_src)
    return _pool_call(pc, cfg.dst_dt, y)


class ConvPoolOp:
    """Pre-packed conv(+relu)(+sum)+pool op for repeated submission."""

    def __init__(self, cfg: ConvConfig, pc: PoolConfig, wei, bia=None):
        from ..utils.logger import check
        check(not cfg.fuse_conv1x1, "conv+pool takes an unfused conv")
        check((pc.ih, pc.iw) == (cfg.oh, cfg.ow),
              "pool input must be the conv output")
        self.cfg, self.pc = cfg, pc
        packed = layout.pack_all(cfg, wei, bia)
        self._cache = OperandCache([packed[k] for k in self._OPERAND_KEYS])

    # host-side packed operands (numpy): safe to close over in traced
    # callers — see utils/opcache.py
    @property
    def _operands(self):
        return self._cache.host

    def __call__(self, src_u8, sum_src=None, operands=None):
        """operands: optional override of the cached packed weights —
        pass them as jit ARGUMENTS from a traced caller to keep the
        compile keyed on shapes instead of weight values."""
        src = jnp.asarray(src_u8)
        if operands is None:
            operands = self._cache.for_call(src)
        return _convpool_call(self.cfg, self.pc, src, *operands,
                              sum_src=None if sum_src is None
                              else jnp.asarray(sum_src))

    # --- packed-weight persistence (mirrors ConvOp.save/load) ---
    _OPERAND_KEYS = ("w3", "corr0", "bias0", "scale0")

    def save(self, path: str):
        """Save the packed operands + conv/pool configs to .npz."""
        from ..utils.persist import dump_configs
        arrs = {k: np.asarray(v) for k, v in
                zip(self._OPERAND_KEYS, self._operands)}
        np.savez(path, __cfg__=dump_configs(cfg=self.cfg, pc=self.pc),
                 **arrs)

    @classmethod
    def load(cls, path: str) -> "ConvPoolOp":
        from ..utils.persist import load_configs
        data = np.load(path, allow_pickle=False)
        cfgs = load_configs(data["__cfg__"], cfg=ConvConfig, pc=PoolConfig)
        op = cls.__new__(cls)
        op.cfg, op.pc = cfgs["cfg"], cfgs["pc"]
        op._cache = OperandCache([data[k] for k in cls._OPERAND_KEYS])
        return op
