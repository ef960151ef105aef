"""Layout-persistent ("packed domain") fused conv path.

The reference library's hot loop never re-materialises activations between
the 3x3 and the fused 1x1 (register residency, ``src/jit_conv_kernel.cc:
275-277``) — but *between ops* it still hands the caller a plain dense u8
tensor, and the next conv pays a pad + u8->s8 shift + channel-pad pass over
it. The packed domain removes that pass: activations stay in the flat
padded layout of ``ops/conv.py`` across ops, and the conv writes its output
already packed for the next consumer.

Packed domain (``PackedSpec``): an image of logical shape (N, H, W, C) u8
is stored as an int8 array of shape ``(N, (H + 2*halo) * iwp, cp)`` where

* values are centered: ``stored = u8_value - 128`` (the int8 products are
  s8 x s8; the -128 shift is corrected exactly via the per-oc column-sum
  term, see ops/layout.py),
* the image occupies rows ``[halo, halo+H)`` and, within each row of
  ``iwp`` flat positions, columns ``[col_off, col_off+W)`` and lanes
  ``[0, C)``,
* every non-image slot holds -128 (i.e. u8 zero = the conv padding value),
* ``iwp`` is a multiple of 8.

A packed conv is one ``ops.conv.flat_conv`` call: its taps read the
incoming packed array at their flat offsets, and its epilogue masks pad
rows, margin columns and pad lanes to -128, so the output is a valid
packed image with a caller-chosen ``halo_out`` and ``col_off_out``, ready
for the next conv with no XLA glue. ``pack_image`` / ``unpack_image``
convert at the model boundary only.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ConvConfig
from ..types import dtype
from ..utils.logger import check
from ..utils.mathutil import round_up
from ..utils.opcache import OperandCache
from .conv import FlatPlan, flat_conv


@dataclasses.dataclass(frozen=True)
class PackedSpec:
    """Static description of a packed-domain image (see module docstring)."""

    h: int        # logical image height
    w: int        # logical image width
    c: int        # logical channels
    cp: int       # stored channels (lane-padded); lanes >= c hold -128
    halo: int     # pad rows above AND below the image
    col_off: int  # first image column within a flat row
    iwp: int      # flat positions per row (multiple of 8)

    def __post_init__(self):
        check(self.iwp % 8 == 0, "packed iwp must be a multiple of 8")
        check(self.col_off + self.w <= self.iwp, "image exceeds packed row")

    @property
    def rows(self) -> int:
        return self.h + 2 * self.halo

    def array_shape(self, n: int):
        return (n, self.rows * self.iwp, self.cp)

    @staticmethod
    def make(h: int, w: int, c: int, *, cp=None, halo: int = 1,
             col_off: int = 1, iwp=None) -> "PackedSpec":
        if cp is None:
            cp = max(round_up(c, 32), 32)
        if iwp is None:
            iwp = round_up(w + 2 * col_off, 8)
        return PackedSpec(h=h, w=w, c=c, cp=cp, halo=halo,
                          col_off=col_off, iwp=iwp)


def pack_image(src_u8, spec: PackedSpec, xp=np):
    """NHWC u8 -> packed centered-s8 flat array (model-boundary cost only)."""
    src = xp.asarray(src_u8)
    n, h, w, c = src.shape
    check((h, w) == (spec.h, spec.w) and c == spec.c,
          "pack_image: shape does not match spec")
    shifted = (src.astype(xp.int16) - 128).astype(xp.int8)
    padded = xp.pad(
        shifted,
        ((0, 0), (spec.halo, spec.halo),
         (spec.col_off, spec.iwp - spec.col_off - w), (0, spec.cp - c)),
        constant_values=np.int8(-128))
    return padded.reshape(n, spec.rows * spec.iwp, spec.cp)


def unpack_image(arr, spec: PackedSpec, xp=np):
    """Packed centered-s8 -> NHWC u8."""
    arr = xp.asarray(arr)
    n = arr.shape[0]
    img = arr.reshape(n, spec.rows, spec.iwp, spec.cp)[
        :, spec.halo:spec.halo + spec.h,
        spec.col_off:spec.col_off + spec.w, :spec.c]
    return (img.astype(xp.int16) + 128).astype(xp.uint8)


def pack_image_sharded(src_u8, spec_local: PackedSpec, n_shards: int,
                       xp=np):
    """NHWC u8 -> the SHARDED packed format: H split into n_shards equal
    slabs, each packed with ``spec_local`` (whose ``h`` is the per-shard
    height), concatenated on the flat-row dim. Sharding this dim over the
    mesh's sp axis gives every device a valid local packed image whose
    halo rows the sp_packed wrapper fills by ppermute exchange
    (parallel/shard.py)."""
    src = xp.asarray(src_u8)
    n, h, w, c = src.shape
    check(h == spec_local.h * n_shards,
          "pack_image_sharded: H does not split into n_shards local specs")
    slabs = [pack_image(src[:, i * spec_local.h:(i + 1) * spec_local.h],
                        spec_local, xp=xp) for i in range(n_shards)]
    return xp.concatenate(slabs, axis=1)


def unpack_image_sharded(arr, spec_local: PackedSpec, n_shards: int,
                         xp=np):
    """Inverse of pack_image_sharded (image rows only; interior halo
    bands are dropped)."""
    arr = xp.asarray(arr)
    rl = spec_local.rows * spec_local.iwp
    slabs = [unpack_image(arr[:, i * rl:(i + 1) * rl], spec_local, xp=xp)
             for i in range(n_shards)]
    return xp.concatenate(slabs, axis=1)


def validate_packed_conv(cfg: ConvConfig, sins, sout: PackedSpec,
                         ssum: PackedSpec = None):
    """Legality of running cfg from sins to sout (init_conf-style checks).

    sins is a tuple of input specs: a single entry for a plain conv, or
    several whose lane-concatenation forms the conv input (concat-free
    branch merge — the conv reads each source separately, so the channel
    concat never exists in memory).

    ssum (required iff cfg.with_sum): spec of the packed eltwise-sum
    operand. It must be the same logical image as the output with the same
    column geometry; its halo may be LARGER than the output's (halo
    erosion leaves producers with deeper halos than consumers emit — the
    conv re-bases rows by the static difference)."""
    sins = sins if isinstance(sins, (tuple, list)) else (sins,)
    sin = sins[0]
    for s in sins[1:]:
        check((s.h, s.w, s.halo, s.col_off, s.iwp)
              == (sin.h, sin.w, sin.halo, sin.col_off, sin.iwp),
              "multi-input packed conv needs uniform image geometry")
    for s in sins[:-1]:
        check(s.cp == s.c, "non-final input has pad lanes (cp > c) which "
                           "would split the conv input's image lanes")
    check(cfg.sh == 1 and cfg.sw == 1,
          "packed path requires stride 1 (strided configs are s2d-lowered "
          "by PackedConvOp before reaching here)")
    check(cfg.dst_dt == dtype.u8, "packed path requires a u8 destination")
    check(cfg.with_sum == (ssum is not None),
          "pass ssum exactly when cfg has a sum post-op")
    if ssum is not None:
        check(cfg.sum_dt == dtype.u8,
              "packed sum post-op requires a u8 sum operand")
        ocp_out = cfg.oc1x1p if cfg.fuse_conv1x1 else cfg.ocp
        out_c = cfg.oc1x1 if cfg.fuse_conv1x1 else cfg.oc
        check((ssum.h, ssum.w, ssum.c) == (cfg.oh, cfg.ow, out_c),
              "sum operand spec does not match the output image")
        check((ssum.col_off, ssum.iwp) == (sout.col_off, sout.iwp),
              "sum operand must share the output's column geometry")
        check(ssum.cp == ocp_out,
              "sum operand lane padding must match the output's")
        check(ssum.halo >= sout.halo,
              "sum operand halo must cover the output halo")
    check((sin.h, sin.w) == (cfg.ih, cfg.iw),
          "input spec does not match conv geometry")
    check(sum(s.c for s in sins) == cfg.ic,
          "input channels must sum to cfg.ic")
    check(sum(s.cp for s in sins) == cfg.icp,
          "input lane padding must sum to cfg.icp")
    out_c = cfg.oc1x1 if cfg.fuse_conv1x1 else cfg.oc
    check((sout.h, sout.w, sout.c) == (cfg.oh, cfg.ow, out_c),
          "output spec does not match conv geometry")
    ocp_out = cfg.oc1x1p if cfg.fuse_conv1x1 else cfg.ocp
    check(sout.cp == ocp_out, "output lane padding must match cfg")
    check(sin.halo >= cfg.ph, "input halo too small for kernel height")
    check(sin.col_off >= cfg.pw, "input col_off too small for kernel width")
    check(sin.iwp - sin.col_off - sin.w >= cfg.kw - 1 - cfg.pw,
          "input right margin too small for kernel width")
    # the flat tap offsets need equal row strides in and out
    check(sin.iwp == sout.iwp, "packed conv needs iwp_in == iwp_out")


@functools.partial(jax.jit,
                   static_argnames=("cfg", "sins", "sout", "ssum", "pool2",
                                    "rows", "emit_acc1"))
def _packed_call(cfg: ConvConfig, sins, sout: PackedSpec,
                 arrs, *operands, ssum: PackedSpec = None, sum_arr=None,
                 pool2: bool = False, rows: tuple = None,
                 emit_acc1: bool = False):
    """One packed conv over output rows ``rows=(r0, r1)`` of sout's padded
    row space (all of them by default; sp_packed's interior/boundary split
    asks for bands, parallel/shard.py). Output row j reads input rows
    ``j + (sin.halo - sout.halo) - ph + ki``."""
    sin = sins[0]
    r0, r1 = rows if rows is not None else (0, sout.rows)
    plan = FlatPlan(
        iwp=sin.iwp, rows_out=r1 - r0,
        row_base=r0 + sin.halo - sout.halo - cfg.ph,
        col_shift=sin.col_off - sout.col_off - cfg.pw,
        mask=(r0, sout.halo, cfg.oh, sout.col_off, cfg.ow))
    sum_off = 0
    if ssum is not None:
        sum_off = (r0 + ssum.halo - sout.halo) * sin.iwp
    out = flat_conv(cfg, plan, arrs, operands, sum_arr=sum_arr,
                    sum_off=sum_off, emit_acc1=emit_acc1)
    return _maxpool2_flat(out, sin.iwp) if pool2 else out


def _maxpool2_flat(x, iwp: int):
    """2x2/s2 max over a flat (n, rows*iwp, cp) array."""
    n, m, cp = x.shape
    x = x.reshape(n, m // (2 * iwp), 2, iwp // 2, 2, cp)
    return x.max(axis=(2, 4)).reshape(n, m // 4, cp)


def _same_image_geometry(specs):
    s0 = specs[0]
    for s in specs[1:]:
        check((s.h, s.w, s.halo, s.col_off, s.iwp)
              == (s0.h, s0.w, s0.halo, s0.col_off, s0.iwp),
              "packed operands must share image geometry")


def packed_concat(arrs, specs, post_relu: bool = True):
    """Channel concat in the packed domain = lane concatenation.

    The packed domain holds u8 images (centered to s8), and true ReLU on u8
    is the identity, so the reference's concat+relu
    (``src/jit_concat_kernel.cc:30-91``) costs nothing beyond the lane copy
    here; ``post_relu`` is kept for API parity. All inputs must share image
    geometry, and every input but the last needs ``cp == c`` so the output's
    image lanes stay contiguous in ``[0, sum(c))``.

    Returns ``(packed_array, PackedSpec)``.
    """
    del post_relu  # identity on u8 images (see docstring)
    check(len(arrs) == len(specs) and len(arrs) >= 1,
          "packed_concat needs one array per spec")
    _same_image_geometry(specs)
    for s in specs[:-1]:
        check(s.cp == s.c, "packed_concat: non-final input has pad lanes "
                           "(cp > c) which would split the output image")
    s0, sl = specs[0], specs[-1]
    ctot = sum(s.c for s in specs)
    spec = PackedSpec(h=s0.h, w=s0.w, c=ctot,
                      cp=ctot - sl.c + sl.cp, halo=s0.halo,
                      col_off=s0.col_off, iwp=s0.iwp)
    out = jnp.concatenate([jnp.asarray(a) for a in arrs], axis=-1)
    return out, spec


@jax.jit
def _packed_sum_call(a, b):
    s = a.astype(jnp.int32) + b.astype(jnp.int32) + 128
    return jnp.clip(s, -128, 127).astype(jnp.int8)


def packed_sum_relu(a, b, spec: PackedSpec, with_relu: bool = True):
    """Eltwise-sum+ReLU in the packed domain (ops/pool.py semantics).

    For u8 operands the dense op is ``sat_u8(relu(xa + xb))``; since
    xa, xb >= 0 the ReLU is the identity and the saturating sum maps to the
    centered domain as ``clip(sa + sb + 128, -128, 127)``. Non-image slots
    hold sa = sb = -128, which lands back on exactly -128 — so halo and
    margins stay valid and the result needs no re-packing.
    """
    del with_relu  # identity for u8 operands (see docstring)
    a, b = jnp.asarray(a), jnp.asarray(b)
    check(a.shape == b.shape, "packed_sum_relu operand shapes differ")
    check(a.shape == spec.array_shape(a.shape[0]),
          "packed_sum_relu: arrays do not match spec")
    return _packed_sum_call(a, b)


def validate_packed_maxpool2(spec: PackedSpec):
    check(spec.h % 2 == 0 and spec.w % 2 == 0,
          "packed maxpool2 needs even image h and w")
    check(spec.halo % 2 == 0 and spec.col_off % 2 == 0,
          "packed maxpool2 needs even halo and col_off "
          "(pass col_off_out=2 to the producing PackedConvOp)")
    check(spec.iwp % 16 == 0, "packed maxpool2 needs iwp % 16 == 0")


@functools.partial(jax.jit, static_argnames=("spec",))
def _maxpool2_call(spec: PackedSpec, arr):
    return _maxpool2_flat(arr, spec.iwp)


def packed_maxpool2(arr, spec: PackedSpec):
    """2x2/stride-2 max pooling in the packed domain.

    Max pooling commutes with the -128 centering shift (it is monotone), so
    the pool runs directly on the stored s8 values: pair rows, pair flat
    columns, take the max. Legality: h, w, halo, col_off all even (so 2x2
    windows align with the image region and halo/margins map to
    halo/margins) and iwp % 16 == 0 (so the halved row keeps iwp a
    multiple of 8). Non-image
    slots pool to max(-128, ...) = -128, keeping the output a valid packed
    image with ``halo/2``, ``col_off/2``, ``iwp/2``.

    Returns ``(packed_array, PackedSpec)``.
    """
    validate_packed_maxpool2(spec)
    arr = jnp.asarray(arr)
    check(arr.shape == spec.array_shape(arr.shape[0]),
          "packed_maxpool2: array does not match spec")
    out_spec = PackedSpec(h=spec.h // 2, w=spec.w // 2, c=spec.c, cp=spec.cp,
                          halo=spec.halo // 2, col_off=spec.col_off // 2,
                          iwp=spec.iwp // 2)
    return _maxpool2_call(spec, arr), out_spec


@functools.partial(jax.jit, static_argnames=("rspec",))
def _sum_pool_call(rspec: PackedSpec, ys, r):
    y = ys[0] if len(ys) == 1 else jnp.concatenate(ys, axis=-1)
    s = y.astype(jnp.int32) + r.astype(jnp.int32) + 128
    s = jnp.clip(s, -128, 127)          # saturating u8 sum, centered
    return _maxpool2_flat(s, rspec.iwp).astype(jnp.int8)


def packed_sum_relu_maxpool2(ys, r, yspecs, rspec: PackedSpec,
                             with_relu: bool = True):
    """Fused (concat ∘ sum+ReLU ∘ 2x2/s2 maxpool) in the packed domain.

    ``ys`` is a list of packed arrays whose lane-concatenation forms the
    left sum operand and ``r`` the right operand. Semantics =
    ``packed_maxpool2(packed_sum_relu(packed_concat(ys), r))``: the
    saturating clip commutes with the monotone max, and XLA fuses the
    concat, sum and pool into one pass — the reference's planned
    conv+sum+relu+pool post-op chain (test/test_conv_relu_pooling.cc:
    313-391).
    """
    del with_relu  # identity for u8 operands (see packed_sum_relu)
    yspecs = tuple(yspecs) if isinstance(yspecs, (tuple, list)) \
        else (yspecs,)
    ys = [jnp.asarray(a) for a in (ys if isinstance(ys, (tuple, list))
                                   else (ys,))]
    r = jnp.asarray(r)
    check(len(ys) == len(yspecs), "one array per spec")
    _same_image_geometry(list(yspecs) + [rspec])
    for s in yspecs[:-1]:
        check(s.cp == s.c, "non-final input has pad lanes (cp > c)")
    check(sum(s.cp for s in yspecs) == rspec.cp,
          "summed lane widths must match the right operand")
    check(sum(s.c for s in yspecs) == rspec.c,
          "summed channels must match the right operand")
    validate_packed_maxpool2(rspec)
    out_spec = PackedSpec(h=rspec.h // 2, w=rspec.w // 2, c=rspec.c,
                          cp=rspec.cp, halo=rspec.halo // 2,
                          col_off=rspec.col_off // 2, iwp=rspec.iwp // 2)
    return _sum_pool_call(rspec, tuple(ys), r), out_spec


@functools.partial(jax.jit, static_argnames=("spec", "round"))
def packed_global_avgpool(arr, spec: PackedSpec, round=None):
    """Global average pool (avg-exclude-padding) straight off a packed array.

    Bit-identical to ``pool(unpack_image(arr, spec), "avg_exc", (h, w),
    (h, w), (0, 0))`` but with no unpack relayout: every non-image slot of
    a packed array holds exactly -128 (u8 zero), so in the u8 domain it
    contributes 0 to the sum — the kernel just reduces the WHOLE array
    (stored + 128 == u8 value summed implicitly via a constant term):

        sum_u8(image) = sum_s8(all slots) + 128 * n_slots

    The divide/round/saturate epilogue matches ops/pool.py's avg_exc chain
    exactly (int32 sums -> f32 / (h*w) -> round -> saturate), so the
    result is bitwise the dense op's. Returns (n, 1, 1, c) u8 for the
    classification head. Reference pooling semantics:
    test/test_conv_relu_pooling.cc:238-259 (avg excludes padding)."""
    from ..types import round_mode
    from .requant import round_f32, saturate_to
    if round is None:
        round = round_mode.nearest
    arr = jnp.asarray(arr)
    n = arr.shape[0]
    check(arr.shape == spec.array_shape(n),
          "packed_global_avgpool: array does not match spec")
    n_slots = spec.rows * spec.iwp
    sums = (jnp.sum(arr.astype(jnp.int32), axis=1)
            + jnp.int32(128 * n_slots))                    # (n, cp) u8 sums
    val = sums.astype(jnp.float32) / np.float32(spec.h * spec.w)
    out = saturate_to(round_f32(val, round), dtype.u8)
    return out[:, :spec.c].reshape(n, 1, 1, spec.c)


@functools.partial(jax.jit, static_argnames=("sin", "sout"))
def repack(arr, sin: PackedSpec, sout: PackedSpec):
    """Convert between packed specs of the same logical image (XLA glue;
    use only at geometry seams the fused ops above cannot bridge)."""
    check((sin.h, sin.w, sin.c) == (sout.h, sout.w, sout.c),
          "repack cannot change the logical image")
    return pack_image(unpack_image(arr, sin, xp=jnp), sout, xp=jnp)


class PackedConvOp:
    """A conv op whose activations stay in the packed domain.

    Usage::

        pop = PackedConvOp(cfg, wei, bia, wei1, bia1)
        x   = pack_image(src_u8, pop.sin)
        y   = pop(x)                        # packed, feeds the next conv
        out = unpack_image(y, pop.sout)
    """

    def __init__(self, cfg: ConvConfig, wei, bia=None, wei1x1=None,
                 bia1x1=None, sin: PackedSpec = None,
                 col_off_out: int = None, halo_out: int = None,
                 sum_spec: PackedSpec = None, pool2: bool = False):
        from . import layout
        # strided configs run the stride-1 packed conv on the space-to-depth
        # grid (ops/layout.py); the op's sin then describes the packed s2d
        # image and pack_input() applies the regroup at the model boundary
        self.cfg_orig = None
        if cfg.sh > 1 or cfg.sw > 1:
            self.cfg_orig = cfg
            wei = layout.s2d_weights(cfg, np.asarray(wei))
            cfg = layout.s2d_cfg(cfg)
        packed = layout.pack_all(cfg, wei, bia, wei1x1, bia1x1)
        out_c = cfg.oc1x1 if cfg.fuse_conv1x1 else cfg.oc
        ocp_out = cfg.oc1x1p if cfg.fuse_conv1x1 else cfg.ocp
        min_halo = max(cfg.ph, 1)
        if sin is None:
            sin = PackedSpec.make(cfg.ih, cfg.iw, cfg.ic, cp=cfg.icp,
                                  halo=min_halo, col_off=max(cfg.pw, 1))
        sins = tuple(sin) if isinstance(sin, (tuple, list)) else (sin,)
        sin = sins[0]
        if col_off_out is None:
            col_off_out = max(cfg.pw, 1)
        if halo_out is None:
            # self-chain-friendly default: mirror the input halo
            halo_out = sin.halo
        sout = PackedSpec(h=cfg.oh, w=cfg.ow, c=out_c, cp=ocp_out,
                          halo=halo_out, col_off=col_off_out,
                          iwp=sin.iwp)
        # pad lanes must produce exactly -128: zero their scales so the
        # epilogue's f32 chain lands on round(0)-128 without any select
        packed["scale0"][cfg.oc:] = 0.0
        if cfg.fuse_conv1x1:
            packed["scale1"][cfg.oc1x1:] = 0.0
        keys = (("w3", "corr0", "bias0", "scale0")
                + (("w1", "corr1", "bias1", "scale1")
                   if cfg.fuse_conv1x1 else ()))
        # host numpy cache: safe to construct inside a traced model
        # forward (numpy cannot leak as a tracer) and safe to close over
        # in traced callers — see utils/opcache.py
        self._cache = OperandCache([packed[k] for k in keys])
        self.cfg = cfg
        validate_packed_conv(cfg, sins, sout, ssum=sum_spec)
        if pool2:
            # 2x2/s2 max pool on the conv output: its spec must satisfy
            # the packed-pool legality so the halved result is itself a
            # valid packed image
            validate_packed_maxpool2(sout)
        self.pool2 = pool2
        self.sins = sins
        self.sin = sins[0]
        self.sout = sout
        self.ssum = sum_spec

    @property
    def _operands(self):
        return self._cache.host

    @property
    def sout_pooled(self) -> PackedSpec:
        """Output spec after the pool2 step (valid when pool2)."""
        s = self.sout
        return PackedSpec(h=s.h // 2, w=s.w // 2, c=s.c, cp=s.cp,
                          halo=s.halo // 2, col_off=s.col_off // 2,
                          iwp=s.iwp // 2)

    def reheight(self, h: int) -> "PackedConvOp":
        """Shallow clone computing an h-row horizontal slab of the image
        (same W/C geometry, same packed operands) — the per-shard local
        op of the spatial-sharding wrapper (parallel/shard.sp_packed).
        Requires the self-chain geometry oh == ih / ow == iw (stride 1,
        SAME padding) so shard boundaries align, like sp_conv's sum rule."""
        import copy
        check(self.cfg_orig is None,
              "reheight does not support s2d-lowered strided ops")
        cfg = self.cfg
        check(cfg.oh == cfg.ih and cfg.ow == cfg.iw,
              "reheight requires oh == ih (stride-1 SAME geometry)")
        clone = copy.copy(self)
        sins = tuple(dataclasses.replace(s, h=h) for s in self.sins)
        sin = sins[0]
        sout = dataclasses.replace(self.sout, h=h)
        clone.cfg = dataclasses.replace(cfg, ih=h, oh=h)
        cfg = clone.cfg
        clone.sins, clone.sin, clone.sout = sins, sin, sout
        if self.ssum is not None:
            clone.ssum = dataclasses.replace(self.ssum, h=h)
        validate_packed_conv(cfg, clone.sins, sout, ssum=clone.ssum)
        if self.pool2:
            validate_packed_maxpool2(sout)
        return clone

    def pack_input(self, src_u8, xp=np):
        """Model-boundary pack: dense NHWC u8 -> this op's packed input
        (applies the s2d regroup first for strided configs). The host
        (numpy) path routes through the native C++ runtime when built
        (native/dfruntime.cc df_pack_image / df_s2d_regroup — the
        data-loader role of the reference's host runtime); the traced
        (jnp) path stays pure XLA."""
        from . import layout
        check(len(self.sins) == 1,
              "pack_input only supports single-input ops")
        if self.cfg_orig is not None:
            src_u8 = layout.s2d_image_u8(self.cfg_orig, src_u8, xp=xp)
        if xp is np:
            from ..native import runtime
            return runtime.pack_image(np.asarray(src_u8), self.sin)
        return pack_image(src_u8, self.sin, xp=xp)

    def __call__(self, packed_arr, sum_arr=None, operands=None):
        """operands: optional override of the cached packed weights (same
        order as _OPERAND_KEYS) — pass the op's weights as jit ARGUMENTS
        from a traced caller to keep the compile keyed on shapes instead
        of weight values (see bench.make_chain)."""
        arrs = (tuple(jnp.asarray(a) for a in packed_arr)
                if isinstance(packed_arr, (tuple, list))
                else (jnp.asarray(packed_arr),))
        check(len(arrs) == len(self.sins),
              "op expects one array per input spec")
        check((sum_arr is not None) == (self.ssum is not None),
              "pass sum_arr exactly when the op has a sum post-op")
        kw = {}
        if sum_arr is not None:
            sum_arr = jnp.asarray(sum_arr)
            check(sum_arr.shape == self.ssum.array_shape(arrs[0].shape[0]),
                  "sum_arr does not match the sum spec")
            kw = dict(ssum=self.ssum, sum_arr=sum_arr)
        if operands is None:
            operands = self._cache.for_call(arrs[0])
        if self.pool2:
            kw["pool2"] = True
        return _packed_call(self.cfg, self.sins, self.sout,
                            arrs, *operands, **kw)

    # --- packed-weight persistence (mirrors ConvOp.save/load; the input/
    # output PackedSpecs are part of the op's contract, so they persist
    # alongside the config) ---
    _OPERAND_KEYS = ("w3", "corr0", "bias0", "scale0",
                     "w1", "corr1", "bias1", "scale1")

    def save(self, path: str):
        """Save the packed operands + config + specs to .npz."""
        from ..utils.persist import dump_configs
        specs = {"cfg": self.cfg, "sout": self.sout}
        for i, s in enumerate(self.sins):
            specs[f"sin{i}"] = s
        if self.cfg_orig is not None:
            specs["cfg_orig"] = self.cfg_orig
        if self.ssum is not None:
            specs["ssum"] = self.ssum
        arrs = {k: np.asarray(v) for k, v in
                zip(self._OPERAND_KEYS, self._operands)}
        np.savez(path, __cfg__=dump_configs(**specs),
                 __n_sins__=np.int64(len(self.sins)),
                 __pool2__=np.bool_(self.pool2),
                 **arrs)

    @classmethod
    def load(cls, path: str) -> "PackedConvOp":
        import json

        from ..utils.persist import load_configs
        data = np.load(path, allow_pickle=False)
        n_sins = int(data["__n_sins__"])
        present = set(json.loads(str(data["__cfg__"])))
        classes = {"cfg": ConvConfig, "sout": PackedSpec}
        classes.update({f"sin{i}": PackedSpec for i in range(n_sins)})
        if "cfg_orig" in present:
            classes["cfg_orig"] = ConvConfig
        if "ssum" in present:
            classes["ssum"] = PackedSpec
        cfgs = load_configs(data["__cfg__"], **classes)
        op = cls.__new__(cls)
        op.cfg = cfgs["cfg"]
        op.cfg_orig = cfgs.get("cfg_orig")
        op.ssum = cfgs.get("ssum")
        op.pool2 = bool(data["__pool2__"]) if "__pool2__" in data else False
        op.sins = tuple(cfgs[f"sin{i}"] for i in range(n_sins))
        op.sin = op.sins[0]
        op.sout = cfgs["sout"]
        keys = cls._OPERAND_KEYS[:8 if op.cfg.fuse_conv1x1 else 4]
        op._cache = OperandCache([data[k] for k in keys])
        return op
