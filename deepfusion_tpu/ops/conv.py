"""Fused INT8 conv3x3(+ReLU)(+conv1x1+ReLU) — the flagship op.

Re-design of the reference's JIT conv (``src/jit_conv_kernel.cc`` +
``src/op_conv.cc``) for a GPU.

**The flat layout.** Every stride-1 conv runs over a *flat* image: the
spatially padded input of shape (N, H', IWP, ICP) viewed as
(N, H' * IWP, ICP), with IWP a multiple of 8 and the u8 values shifted to
s8 (x - 128). Output flat position p reads, for tap (ki, kj), the input
flat position ``p + (row_base + ki) * IWP + col_shift + kj``. One
formulation covers the dense op (``row_base = col_shift = 0``; output
columns >= OW are wrap-around garbage the caller slices away) and the
packed domain of ``ops/packed.py`` (halo re-basing and column offsets; the
epilogue masks every non-image slot to -128).

**Arithmetic.** u8 x s8 products are s8 x s8 after the -128 shift, with the
exact per-channel correction ``128 * colsum(w)`` (``ops/layout.py``); all
products accumulate in int32. The 3x3 result is requantized to u8 (shifted
to s8) and fed to the fused 1x1 product without leaving the kernel — the
reference keeps it in zmm registers (``src/jit_conv_kernel.cc:275-277``).

**Implementation.** ``flat_conv`` is one Pallas kernel on the Triton route:
one program per (image, block of BM flat output positions); the K loop over
kh*kw taps x ICP/BK channel blocks runs inside the program with the int32
accumulator in registers, then requant, the 1x1 ``pl.dot`` on the whole
row, requant and store. Each tap is a plain load at its flat offset. Loads
past the end of the input are masked; an input whose first tap would read
before position 0 is front-padded by the wrapper.

Strided dense convs run as plain XLA (``_conv_strided``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import ConvConfig
from ..types import dtype, round_mode
from ..utils import env
from ..utils.mathutil import round_up
from ..utils.opcache import OperandCache
from . import layout
from .requant import requant, requant_to_u8_centered, round_f32


@dataclasses.dataclass(frozen=True)
class FlatPlan:
    """Output -> input geometry of one flat conv call (module docstring).

    mask: None for a dense output, else ``(row0, halo, h, col_off, w)``:
    output flat row r is absolute row ``row0 + r`` of a packed image whose
    slots outside rows [halo, halo+h) x columns [col_off, col_off+w) are
    forced to -128 (u8 zero)."""

    iwp: int
    rows_out: int
    row_base: int = 0
    col_shift: int = 0
    mask: Optional[Tuple[int, int, int, int, int]] = None

    @property
    def m_out(self) -> int:
        return self.rows_out * self.iwp


def _pow2_divisor(n: int, cap: int) -> int:
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def _rne(x):
    """Round-half-even of f32 from exact steps (floor, subtract, compare):
    the Triton route has no round primitive, and the 2^23 add-subtract
    trick can be folded away by an algebraic simplifier."""
    r = jnp.floor(x)
    f = x - r
    half = r * 0.5
    up = (f > 0.5) | ((f == 0.5) & (half != jnp.floor(half)))
    return jnp.where(up, r + 1.0, r)


def _kround(x, mode):
    return _rne(x) if mode == round_mode.nearest else jnp.floor(x)


# ------------------------------------------------------------ epilogue

def _final(cfg: ConvConfig, plan: FlatPlan, acc, bias, scale, relu: bool,
           mode: round_mode, sum_blk, pos, rnd):
    """Requant of the last stage (acc already u8-shift corrected). Shared
    by the kernel (one block, one lane chunk) and the XLA twin (whole
    arrays). sum_blk: the sum operand at the output positions; pos: the
    flat output positions (packed mask); rnd(x, mode): rounding."""
    if plan.mask is not None:
        row0, halo, h, col_off, w = plan.mask
        col = jax.lax.rem(pos, np.int32(plan.iwp))
        row = row0 + jax.lax.div(pos, np.int32(plan.iwp))
        mask = ((col >= col_off) & (col < col_off + w)
                & (row >= halo) & (row < halo + h)).astype(jnp.float32)
        sum_rounded = None
        if sum_blk is not None:
            # packed sum operand: centered u8; non-image slots hold u8 0
            sv = sum_blk.astype(jnp.int32) + 128
            sum_rounded = rnd(sv.astype(jnp.float32)
                              * np.float32(cfg.sum_scale), mode)
        return requant_to_u8_centered(acc, bias, scale, mode,
                                      zero_mask=mask,
                                      sum_rounded=sum_rounded, round_fn=rnd)
    sum_term = None
    if sum_blk is not None:
        st = sum_blk
        if cfg.sum_dt in (dtype.u8, dtype.s8):
            st = st.astype(jnp.int32)
        sum_term = st.astype(jnp.float32) * np.float32(cfg.sum_scale)
    return requant(acc, bias, scale, relu, mode, cfg.dst_dt,
                   sum_term=sum_term, round_fn=rnd)


def _stage0(cfg: ConvConfig, acc, vec, rnd):
    """3x3 stage of a fused op: corrected acc -> centered u8 intermediate."""
    return requant_to_u8_centered(
        acc + vec("corr0"), vec("bias0") if cfg.conv0_with_bias else None,
        vec("scale0"), cfg.conv0_round, round_fn=rnd)


def _last(cfg: ConvConfig, plan: FlatPlan, acc, vec, sum_blk, pos, rnd,
          emit_acc1: bool):
    """Last stage from its raw int32 accumulator."""
    if cfg.fuse_conv1x1:
        acc = acc + vec("corr1")
        if emit_acc1:
            return acc
        return _final(cfg, plan, acc,
                      vec("bias1") if cfg.conv1_with_bias else None,
                      vec("scale1"), cfg.conv1_relu, cfg.conv1_round,
                      sum_blk, pos, rnd)
    return _final(cfg, plan, acc + vec("corr0"),
                  vec("bias0") if cfg.conv0_with_bias else None,
                  vec("scale0"), cfg.conv0_relu, cfg.conv0_round,
                  sum_blk, pos, rnd)


_VEC_KEYS = ("corr0", "bias0", "scale0", "corr1", "bias1", "scale1")


def _out_lanes_dtype(cfg: ConvConfig, plan: FlatPlan, emit_acc1: bool):
    lanes = cfg.oc1x1p if cfg.fuse_conv1x1 else cfg.ocp
    if emit_acc1:
        return lanes, jnp.int32
    if plan.mask is not None:
        return lanes, jnp.int8
    return lanes, cfg.dst_dt.np


# ------------------------------------------------------ Triton kernel

def _kernel(*refs, cfg: ConvConfig, plan: FlatPlan, cps, r_in: int,
            lead: int, bm: int, bk: int, bn0: int, bn1: int, has_sum: bool,
            sum_off: int, emit_acc1: bool):
    n_src = len(cps)
    x_refs, refs = refs[:n_src], refs[n_src:]
    w3_ref, refs = refs[0], refs[1:]
    vrefs = dict(zip(("corr0", "bias0", "scale0"), refs[:3]))
    refs = refs[3:]
    w1_ref = None
    if cfg.fuse_conv1x1:
        w1_ref, refs = refs[0], refs[1:]
        vrefs.update(zip(("corr1", "bias1", "scale1"), refs[:3]))
        refs = refs[3:]
    sum_ref = None
    if has_sum:
        sum_ref, refs = refs[0], refs[1:]
    (out_ref,) = refs

    b = pl.program_id(0)
    p0 = pl.program_id(1) * bm
    pos = p0 + jnp.arange(bm, dtype=jnp.int32)
    icp = sum(cps)
    ntap = cfg.kh * cfg.kw
    row_ok = (pos < plan.m_out)[:, None]

    def conv0(j0):
        """3x3 accumulator of output lanes [j0*bn0, (j0+1)*bn0): the K
        loop over taps x channel blocks, in registers."""
        acc = jnp.zeros((bm, bn0), jnp.int32)
        lane0 = 0
        for x_ref, cp in zip(x_refs, cps):
            nch = cp // bk

            def body(i, acc, x_ref=x_ref, nch=nch, lane0=lane0):
                div, rem = jax.lax.div, jax.lax.rem
                t, c = (i, 0) if nch == 1 else (div(i, nch), rem(i, nch))
                kj, ki = div(t, cfg.kh), rem(t, cfg.kh)
                off = ((plan.row_base + ki) * plan.iwp + plan.col_shift
                       + kj + lead)
                xt = plgpu.load(
                    x_ref.at[b, pl.ds(p0 + off, bm), pl.ds(c * bk, bk)],
                    mask=((pos + off) < r_in)[:, None], other=0)
                wt = w3_ref[pl.ds(j0 * bn0, bn0),
                            pl.ds(t * icp + lane0 + c * bk, bk)]
                return acc + pl.dot(xt, wt, trans_b=True)

            acc = jax.lax.fori_loop(0, ntap * nch, body, acc)
            lane0 += cp
        return acc

    def vec_at(j, bn):
        return lambda k: vrefs[k][pl.ds(j * bn, bn)][None, :]

    def sum_at(j, bn):
        if not has_sum:
            return None
        return plgpu.load(
            sum_ref.at[b, pl.ds(p0 + sum_off, bm), pl.ds(j * bn, bn)],
            mask=((pos + sum_off) < sum_ref.shape[1])[:, None], other=0)

    def store(j, bn, res):
        plgpu.store(out_ref.at[b, pl.ds(p0, bm), pl.ds(j * bn, bn)],
                    res.astype(out_ref.dtype), mask=row_ok)

    n0 = cfg.ocp // bn0
    if not cfg.fuse_conv1x1:
        for j0 in range(n0):
            store(j0, bn0, _last(cfg, plan, conv0(j0), vec_at(j0, bn0),
                                 sum_at(j0, bn0), pos[:, None], _kround,
                                 emit_acc1))
        return
    n1 = cfg.oc1x1p // bn1
    acc1 = [jnp.zeros((bm, bn1), jnp.int32) for _ in range(n1)]
    for j0 in range(n0):
        x1 = _stage0(cfg, conv0(j0), vec_at(j0, bn0), _kround)
        for j1 in range(n1):
            acc1[j1] = acc1[j1] + pl.dot(
                x1, w1_ref[pl.ds(j1 * bn1, bn1), pl.ds(j0 * bn0, bn0)],
                trans_b=True)
    for j1 in range(n1):
        store(j1, bn1, _last(cfg, plan, acc1[j1], vec_at(j1, bn1),
                             sum_at(j1, bn1), pos[:, None], _kround,
                             emit_acc1))


# Tiles: the fastest of a sweep over the flagship op and the FusionNet
# forward on an H100 (docs/PERF.md): BM output positions per program,
# channel blocks of at most BK, lane chunks of at most BN.
BM, NUM_WARPS, NUM_STAGES, BK, BN = 128, 8, 3, 128, 256


def _conv_triton(cfg: ConvConfig, plan: FlatPlan, xs, ops, sum_arr,
                 sum_off: int, emit_acc1: bool):
    n = xs[0].shape[0]
    cps = tuple(x.shape[-1] for x in xs)
    lead = max(0, -min(plan.row_base * plan.iwp + plan.col_shift, 0))
    if lead:
        xs = [jnp.pad(x, ((0, 0), (lead, 0), (0, 0)),
                      constant_values=np.int8(-128)) for x in xs]
    lanes, out_dt = _out_lanes_dtype(cfg, plan, emit_acc1)
    has_sum = sum_arr is not None
    # weights K-major (N, K): int8 tensor-core products take both operands
    # with K contiguous
    args = list(xs) + [ops[0].T] + [o.reshape(-1) for o in ops[1:4]]
    if cfg.fuse_conv1x1:
        args += [ops[4].T] + [o.reshape(-1) for o in ops[5:8]]
    if has_sum:
        args.append(sum_arr)
    kernel = functools.partial(
        _kernel, cfg=cfg, plan=plan, cps=cps, r_in=xs[0].shape[1],
        lead=lead, bm=BM, bk=min(_pow2_divisor(cp, BK) for cp in cps),
        bn0=_pow2_divisor(cfg.ocp, BN),
        bn1=_pow2_divisor(cfg.oc1x1p, BN) if cfg.fuse_conv1x1 else 0,
        has_sum=has_sum, sum_off=sum_off, emit_acc1=emit_acc1)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n, plan.m_out, lanes), out_dt),
        grid=(n, pl.cdiv(plan.m_out, BM)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=env.interpret_kernels(),
        name="df_flat_conv",
    )(*args)


# --------------------------------------------------------- XLA twin

def _conv_xla(cfg: ConvConfig, plan: FlatPlan, xs, ops, sum_arr,
              sum_off: int, emit_acc1: bool):
    """The same computation as whole-array XLA ops: the kh*kw shifted flat
    slices concatenated into an im2col patch, one int8 GEMM with int32
    accumulation. (XLA has no int8 convolution with an int32 result on
    the GPU: cuDNN's integer convolutions emit s8 or f32 only.)"""
    x = xs[0] if len(xs) == 1 else jnp.concatenate(xs, axis=-1)
    offs = [(plan.row_base + ki) * plan.iwp + plan.col_shift + kj
            for kj in range(cfg.kw) for ki in range(cfg.kh)]
    lead = max(0, -min(offs))
    tail = max(0, max(offs) + plan.m_out - x.shape[1])
    x = jnp.pad(x, ((0, 0), (lead, tail), (0, 0)),
                constant_values=np.int8(-128))
    patch = jnp.concatenate(
        [jax.lax.slice_in_dim(x, o + lead, o + lead + plan.m_out, axis=1)
         for o in offs], axis=-1)
    acc = jax.lax.dot_general(patch, ops[0], (((2,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    sum_blk = None
    if sum_arr is not None:
        sum_blk = jax.lax.slice_in_dim(
            jnp.pad(sum_arr, ((0, 0), (0, max(0, sum_off + plan.m_out
                                              - sum_arr.shape[1])),
                              (0, 0))),
            sum_off, sum_off + plan.m_out, axis=1)
    pos = jnp.arange(plan.m_out, dtype=jnp.int32).reshape(1, -1, 1)
    res = _epilogue_xla(cfg, plan, acc, ops, sum_blk, pos, emit_acc1)
    return res.astype(_out_lanes_dtype(cfg, plan, emit_acc1)[1])


def _epilogue_xla(cfg: ConvConfig, plan: FlatPlan, acc, ops, sum_blk, pos,
                  emit_acc1: bool):
    vecs = dict(zip(_VEC_KEYS, tuple(ops[1:4]) + tuple(ops[5:8])))

    def vec(k):
        return vecs[k].reshape((1,) * (acc.ndim - 1) + (-1,))

    if cfg.fuse_conv1x1:
        x1 = _stage0(cfg, acc, vec, round_f32)
        acc = jax.lax.dot_general(x1, ops[4], (((x1.ndim - 1,), (0,)),
                                               ((), ())),
                                  preferred_element_type=jnp.int32)
    return _last(cfg, plan, acc, vec, sum_blk, pos, round_f32, emit_acc1)


IMPLS = {"triton": _conv_triton, "xla": _conv_xla}
_impl = ["triton"]


@contextlib.contextmanager
def use_impl(name: str):
    """Run every stride-1 conv traced inside the block with ``name``
    (``"triton"``, the kernel, or ``"xla"``, its plain twin) — for timing
    the kernel against what XLA makes of the plain version. Clears JAX's
    trace caches on entry and exit so jitted callers retrace."""
    if name not in IMPLS:
        raise ValueError(f"unknown conv implementation {name!r}")
    prev = _impl[0]
    _impl[0] = name
    jax.clear_caches()
    try:
        yield
    finally:
        _impl[0] = prev
        jax.clear_caches()


def flat_conv(cfg: ConvConfig, plan: FlatPlan, xs, ops, *, sum_arr=None,
              sum_off: int = 0, emit_acc1: bool = False):
    """Stride-1 conv over flat inputs (module docstring).

    xs: tuple of (N, R, cp_i) centered-s8 arrays whose lane concatenation
    is the conv input (cp_i sum to cfg.icp). ops: the packed operands
    (w3, corr0, bias0, scale0[, w1, corr1, bias1, scale1]). sum_arr: the
    eltwise-sum operand, flat, read at output position p + sum_off.
    Returns (N, plan.m_out, ocp_out): the requantized output (centered s8
    when plan.mask is set), or the raw 1x1 int32 accumulator with
    emit_acc1 (tensor-parallel partial sums)."""
    return IMPLS[_impl[0]](cfg, plan, tuple(xs), tuple(ops), sum_arr,
                           sum_off, emit_acc1)


# ------------------------------------------------------- dense entry

def _dense_plan(cfg: ConvConfig) -> FlatPlan:
    return FlatPlan(iwp=round_up(cfg.iw + 2 * cfg.pw, 8), rows_out=cfg.oh)


def _dense_sum_flat(cfg: ConvConfig, plan: FlatPlan, sum_src):
    """(n, oh, ow, oc) -> (n, oh*iwp, ocp_out); padded slots feed only
    discarded outputs."""
    ocp_out = cfg.oc1x1p if cfg.fuse_conv1x1 else cfg.ocp
    out_oc = cfg.oc1x1 if cfg.fuse_conv1x1 else cfg.oc
    s = jnp.pad(sum_src, ((0, 0), (0, 0), (0, plan.iwp - cfg.ow),
                          (0, ocp_out - out_oc)))
    return s.reshape(s.shape[0], plan.m_out, ocp_out)


def _conv_dense(cfg: ConvConfig, src_u8, ops, sum_src=None,
                emit_acc1: bool = False):
    plan = _dense_plan(cfg)
    srcp = layout.prep_src(cfg, src_u8, xp=jnp)    # (n, ihp, iwp, icp) s8
    flat = srcp.reshape(srcp.shape[0], -1, cfg.icp)
    sflat = None if sum_src is None else _dense_sum_flat(cfg, plan, sum_src)
    out = flat_conv(cfg, plan, (flat,), ops, sum_arr=sflat,
                    emit_acc1=emit_acc1)
    lanes = out.shape[-1]
    out = out.reshape(cfg.bs, cfg.oh, plan.iwp, lanes)[:, :, :cfg.ow]
    if emit_acc1:
        return out
    return out[..., :cfg.oc1x1 if cfg.fuse_conv1x1 else cfg.oc]


def _conv_strided(cfg: ConvConfig, src_u8, ops, sum_src=None):
    """Strided conv as plain XLA: strided tap slices, one int8 GEMM with
    int32 accumulation, the same requant epilogue."""
    x = (jnp.asarray(src_u8).astype(jnp.int16) - 128).astype(jnp.int8)
    x = jnp.pad(x, ((0, 0), (cfg.ph, cfg.ph), (cfg.pw, cfg.pw),
                    (0, cfg.icp - cfg.ic)), constant_values=np.int8(-128))
    taps = [x[:, ki:ki + (cfg.oh - 1) * cfg.sh + 1:cfg.sh,
              kj:kj + (cfg.ow - 1) * cfg.sw + 1:cfg.sw]
            for kj in range(cfg.kw) for ki in range(cfg.kh)]
    acc = jax.lax.dot_general(jnp.concatenate(taps, axis=-1), ops[0],
                              (((3,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    sum_blk = None
    if sum_src is not None:
        ocp_out = cfg.oc1x1p if cfg.fuse_conv1x1 else cfg.ocp
        sum_blk = jnp.pad(sum_src, ((0, 0),) * 3
                          + ((0, ocp_out - sum_src.shape[-1]),))
    res = _epilogue_xla(cfg, FlatPlan(iwp=cfg.ow, rows_out=cfg.oh), acc,
                        ops, sum_blk, None, False)
    return res[..., :cfg.oc1x1 if cfg.fuse_conv1x1 else cfg.oc]


@functools.partial(jax.jit, static_argnames=("cfg",))
def _conv_call(cfg: ConvConfig, src_u8, w3, corr0, bias0, scale0,
               w1=None, corr1=None, bias1=None, scale1=None, sum_src=None):
    ops = (w3, corr0, bias0, scale0)
    if cfg.fuse_conv1x1:
        ops += (w1, corr1, bias1, scale1)
    if cfg.sh > 1 or cfg.sw > 1:
        return _conv_strided(cfg, src_u8, ops, sum_src)
    return _conv_dense(cfg, src_u8, ops, sum_src)


@functools.partial(jax.jit, static_argnames=("cfg",))
def conv_fused_acc1(cfg: ConvConfig, src_u8, w3, corr0, bias0, scale0,
                    w1, corr1):
    """Fused stride-1 conv emitting the raw s32 1x1 accumulator
    (pre-requant) — the tensor-parallel local step (parallel/shard.py).
    Returns (n, oh, ow, oc1x1p) int32 (padded lanes kept: bias/scale
    vectors downstream are ocp-padded too)."""
    zeros = jnp.zeros_like(corr1, dtype=jnp.float32)
    return _conv_dense(cfg, src_u8, (w3, corr0, bias0, scale0,
                                     w1, corr1, zeros, zeros),
                       emit_acc1=True)


class ConvOp:
    """Pre-packed, pre-configured conv op for repeated submission.

    The analogue of constructing ``op_conv`` once and calling ``submit()``
    per batch (``src/op_conv.h:34-96``): weights are packed and the kernel
    is traced exactly once per configuration.
    """

    def __init__(self, cfg: ConvConfig, wei, bia=None, wei1x1=None,
                 bia1x1=None):
        self.cfg = cfg
        packed = layout.pack_all(cfg, wei, bia, wei1x1, bia1x1)
        keys = self._OPERAND_KEYS[:8 if cfg.fuse_conv1x1 else 4]
        self._cache = OperandCache([packed[k] for k in keys])

    # host-side packed operands (numpy): safe to close over in traced
    # callers (shard wrappers, model forwards) — see utils/opcache.py
    @property
    def _operands(self):
        return self._cache.host

    def __call__(self, src_u8, sum_src=None, operands=None):
        """operands: optional override of the cached packed weights —
        pass them as jit ARGUMENTS from a traced caller to keep the
        compile keyed on shapes instead of weight values."""
        src = jnp.asarray(src_u8)
        if self.cfg.with_sum and sum_src is None:
            raise ValueError("config has a sum post-op; pass sum_src")
        if env.dump_code() and not getattr(self, "_dumped", False):
            # analogue of DEEPFUSION_DUMP_CODE (src/jit_generator.h:261-296)
            from ..utils.profiler import maybe_dump_lowered
            name = "conv_fused" if self.cfg.fuse_conv1x1 else "conv"
            maybe_dump_lowered(name, _conv_call, self.cfg, src,
                               *self._operands)
            self._dumped = True
        if operands is None:
            operands = self._cache.for_call(src)
        kw = {}
        if sum_src is not None:
            kw["sum_src"] = jnp.asarray(sum_src)
        return _conv_call(self.cfg, src, *operands, **kw)

    # --- packed-weight persistence (stateless-inference checkpoint
    # analogue; the reference keeps weights caller-owned, SURVEY.md §5) ---
    _OPERAND_KEYS = ("w3", "corr0", "bias0", "scale0",
                     "w1", "corr1", "bias1", "scale1")

    def save(self, path: str):
        """Save the packed operands + config to an .npz archive."""
        from ..utils.persist import dump_configs
        arrs = {k: np.asarray(v) for k, v in
                zip(self._OPERAND_KEYS, self._operands)}
        np.savez(path, __cfg__=dump_configs(cfg=self.cfg), **arrs)

    @classmethod
    def load(cls, path: str) -> "ConvOp":
        from ..utils.persist import load_configs
        data = np.load(path, allow_pickle=False)
        cfg = load_configs(data["__cfg__"], cfg=ConvConfig)["cfg"]
        op = cls.__new__(cls)
        op.cfg = cfg
        keys = cls._OPERAND_KEYS[:8 if cfg.fuse_conv1x1 else 4]
        op._cache = OperandCache([data[k] for k in keys])
        return op


def conv(src, wei, bia=None, stride=(1, 1), padding=(0, 0), *,
         dst_dtype, conv0_relu=False, conv0_scales=(1.0,),
         conv0_round_mode=round_mode.nearest,
         wei1x1=None, bia1x1=None, conv1_relu=False, conv1_scales=(1.0,),
         conv1_round_mode=round_mode.nearest, groups=1,
         sum_src=None, sum_scale=1.0):
    """Functional conv3x3(+relu)(+conv1x1+relu).

    API parity with ``deepfusion::conv`` (``include/deepfusion.h:120-145``):
    src is NHWC u8, wei is OIHW s8, bias may be u8/s8/s32/f32, scales are
    scalar or per-output-channel, round modes per stage.
    """
    src = np.asarray(src) if not isinstance(src, jnp.ndarray) else src
    wei = np.asarray(wei)
    n, ih, iw, ic = src.shape
    oc, _, kh, kw = wei.shape
    from ..utils.mathutil import conv_output_size
    oh = conv_output_size(ih, kh, stride[0], padding[0])
    ow = conv_output_size(iw, kw, stride[1], padding[1])
    out_oc = wei1x1.shape[0] if wei1x1 is not None else oc
    cfg = ConvConfig.make(
        (n, ih, iw, ic), tuple(wei.shape),
        None if bia is None else np.asarray(bia).dtype,
        stride, padding, (n, oh, ow, out_oc), dst_dtype,
        conv0_relu=conv0_relu, conv0_scales=conv0_scales,
        conv0_round=conv0_round_mode,
        wei1x1_shape=None if wei1x1 is None else tuple(np.asarray(wei1x1).shape),
        bia1x1_dt=None if bia1x1 is None else np.asarray(bia1x1).dtype,
        conv1_relu=conv1_relu, conv1_scales=conv1_scales,
        conv1_round=conv1_round_mode, groups=groups,
        sum_dt=None if sum_src is None else np.asarray(sum_src).dtype,
        sum_scale=sum_scale)
    op = ConvOp(cfg, wei, bia, wei1x1, bia1x1)
    return op(src, sum_src=sum_src)
