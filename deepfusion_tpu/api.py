"""Object-style public API: ``memory`` + ``op`` + factory functions.

Direct parity with the reference's public surface
(``include/deepfusion.h:105-145``): factories validate and build an op
object; ``op.submit()`` runs inference, reading inputs from and writing the
result into ``memory`` containers, with optional wall-clock profiling
(``src/deepfusion.cc:90-103``). The functional API in ``deepfusion_tpu.ops``
is the jax-idiomatic path; this layer exists so reference users find the
same call shapes.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .config import ConvConfig
from .types import dtype, format, memory, round_mode
from .utils.logger import check, check_eq
from .utils.mathutil import conv_output_size
from .utils.profiler import submit_timer


class op:
    """Abstract op with profiled submit (include/deepfusion.h:105-114)."""

    def submit(self):
        with submit_timer(self.name()):
            self.infer()

    def infer(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


class _concat_op(op):
    def __init__(self, srcs: Sequence[memory], dst: memory, post_relu: bool):
        from .ops.concat import concat as concat_fn
        from .config import ConcatConfig
        # validate against dst (factory switch on dst dtype,
        # src/deepfusion.cc:105-121)
        cfg = ConcatConfig.make([tuple(s.actual_dims()) for s in srcs],
                                dst.data_type(), post_relu)
        check_eq(dst.actual_dims()[-1], cfg.oc, "dst channels")
        for s in srcs:
            check_eq(s.data_type(), dst.data_type(),
                     "concat src/dst dtype must match")
        self._srcs, self._dst, self._relu = list(srcs), dst, post_relu
        self._fn = concat_fn

    def infer(self):
        # result stays on device (memory.data holds a jax.Array): chained
        # object-API ops feed each other with zero host round-trips; call
        # memory.numpy() for an explicit host copy
        self._dst.data = self._fn([s.data for s in self._srcs], self._relu)


class _conv_op(op):
    def __init__(self, src, wei, bia, sz_stride, sz_padding, dst,
                 conv0_relu, conv0_scales, conv0_round_mode,
                 wei1x1=None, bia1x1=None, conv1_relu=False,
                 conv1_scales=(1.0,), conv1_round_mode=round_mode.nearest):
        from .ops.conv import ConvOp
        wei_dims = wei.std_dims()  # oihw
        src_dims = src.actual_dims()  # nhwc
        dst_dims = dst.actual_dims()  # nhwc
        cfg = ConvConfig.make(
            tuple(src_dims), tuple(wei_dims),
            None if bia is None else bia.data_type(),
            tuple(sz_stride), tuple(sz_padding), tuple(dst_dims),
            dst.data_type(),
            conv0_relu=conv0_relu, conv0_scales=conv0_scales,
            conv0_round=conv0_round_mode,
            wei1x1_shape=None if wei1x1 is None else tuple(wei1x1.std_dims()),
            bia1x1_dt=None if bia1x1 is None else bia1x1.data_type(),
            conv1_relu=conv1_relu, conv1_scales=conv1_scales,
            conv1_round=conv1_round_mode)
        self._src, self._dst = src, dst
        self._impl = ConvOp(
            cfg, wei.numpy().reshape(wei_dims),
            None if bia is None else bia.numpy(),
            None if wei1x1 is None else wei1x1.numpy().reshape(
                wei1x1.std_dims()),
            None if bia1x1 is None else bia1x1.numpy())

    def infer(self):
        self._dst.data = self._impl(self._src.data)  # stays on device


class _pool_op(op):
    def __init__(self, src, dst, kind, kernel, stride, padding, rnd):
        from .config import PoolConfig
        from .ops.pool import pool as pool_fn
        pc = PoolConfig.make(kind, (src.actual_dims()[1],
                                    src.actual_dims()[2]),
                             kernel, stride, padding, rnd)
        check_eq(tuple(dst.actual_dims()),
                 (src.actual_dims()[0], pc.oh, pc.ow, src.actual_dims()[3]),
                 "pool dst dims")
        check_eq(src.data_type(), dst.data_type(), "pool dtype")
        self._src, self._dst = src, dst
        self._args = (kind, kernel, stride, padding, rnd)
        self._fn = pool_fn

    def infer(self):
        self._dst.data = self._fn(self._src.data, *self._args)


class _eltwise_sum_relu_op(op):
    def __init__(self, a, b, dst, with_relu):
        from .ops.pool import eltwise_sum_relu
        check_eq(a.actual_dims(), b.actual_dims(), "eltwise dims")
        check_eq(a.data_type(), dst.data_type(), "eltwise dtype")
        self._a, self._b, self._dst, self._relu = a, b, dst, with_relu
        self._fn = eltwise_sum_relu

    def infer(self):
        self._dst.data = self._fn(self._a.data, self._b.data, self._relu)


def concat(srcs: Sequence[memory], dst: memory, post_relu: bool = False) -> op:
    """Factory (include/deepfusion.h:116-118)."""
    return _concat_op(srcs, dst, post_relu)


def pool(src: memory, dst: memory, kind: str = "max", kernel=(2, 2),
         stride=(2, 2), padding=(0, 0),
         round_mode_=round_mode.nearest) -> op:
    """Pooling factory (roadmap op; spec test_conv_relu_pooling.cc)."""
    return _pool_op(src, dst, kind, kernel, stride, padding, round_mode_)


def eltwise_sum_relu(a: memory, b: memory, dst: memory,
                     with_relu: bool = True) -> op:
    """Eltwise-sum+ReLU factory (roadmap op, README.md:64-65)."""
    return _eltwise_sum_relu_op(a, b, dst, with_relu)


def conv(src: memory, wei: memory, bia: Optional[memory],
         sz_stride, sz_padding, *args, **kwargs) -> op:
    """Factories (include/deepfusion.h:120-145).

    Two call shapes, like the reference:
      conv(src, wei, bia, stride, pad, dst, conv0_relu, conv0_scales,
           conv0_round_mode)
      conv(src, wei, bia, stride, pad, wei1x1, bia1x1, dst, conv0_relu,
           conv0_scales, conv0_round_mode, conv1_relu, conv1_scales,
           conv1_round_mode)

    The overload is resolved like the C++ compiler resolves the
    reference's two signatures — by the type at each position, checked
    both ways so a malformed call raises instead of mis-dispatching:
    the fused shape has a ``memory`` (dst) at position 2 after a
    ``memory`` wei1x1 and a ``memory``/None bia1x1; the plain shape has
    a ``memory`` dst at position 0 followed only by non-memory extras.
    """
    is_mem = lambda a: isinstance(a, memory)  # noqa: E731

    fused = (len(args) >= 3 and is_mem(args[2])) or \
        (len(args) == 2 and is_mem(args[0]) and "dst" in kwargs) or \
        ("wei1x1" in kwargs)
    if fused:
        wei1x1 = args[0] if args else kwargs.pop("wei1x1")
        bia1x1 = args[1] if len(args) >= 2 else kwargs.pop("bia1x1", None)
        dst = args[2] if len(args) >= 3 else kwargs.pop("dst")
        rest = list(args[3:])
        check(is_mem(wei1x1) and is_mem(dst)
              and (bia1x1 is None or is_mem(bia1x1)),
              "fused conv call shape: (..., wei1x1: memory, "
              "bia1x1: memory|None, dst: memory, ...)")
        check(not any(is_mem(a) for a in rest),
              "unexpected memory operand after dst in fused conv call")
        conv0_relu = rest[0] if len(rest) > 0 else kwargs.get("conv0_relu", False)
        conv0_scales = rest[1] if len(rest) > 1 else kwargs.get("conv0_scales", (1.0,))
        conv0_round = rest[2] if len(rest) > 2 else kwargs.get("conv0_round_mode", round_mode.nearest)
        conv1_relu = rest[3] if len(rest) > 3 else kwargs.get("conv1_relu", False)
        conv1_scales = rest[4] if len(rest) > 4 else kwargs.get("conv1_scales", (1.0,))
        conv1_round = rest[5] if len(rest) > 5 else kwargs.get("conv1_round_mode", round_mode.nearest)
        return _conv_op(src, wei, bia, sz_stride, sz_padding, dst,
                        conv0_relu, conv0_scales, conv0_round,
                        wei1x1, bia1x1, conv1_relu, conv1_scales, conv1_round)
    dst = args[0] if args else kwargs.pop("dst")
    rest = list(args[1:])
    check(is_mem(dst), "conv call shape: dst must be a memory")
    check(not any(is_mem(a) for a in rest),
          "unexpected memory operand after dst in conv call (fused calls "
          "pass wei1x1, bia1x1, dst in that order)")
    conv0_relu = rest[0] if len(rest) > 0 else kwargs.get("conv0_relu", False)
    conv0_scales = rest[1] if len(rest) > 1 else kwargs.get("conv0_scales", (1.0,))
    conv0_round = rest[2] if len(rest) > 2 else kwargs.get("conv0_round_mode", round_mode.nearest)
    return _conv_op(src, wei, bia, sz_stride, sz_padding, dst,
                    conv0_relu, conv0_scales, conv0_round)
