"""Sharded execution wrappers: DP / TP / SP over a jax Mesh.

Scale-out layer (SURVEY.md §2 parallelism checklist — all ABSENT in the
single-node reference; §7 maps each to its accelerator equivalent):

* ``dp_shard``     — batch sharding (pure data parallelism, no collectives).
* ``tp_fused_conv``— conv0 output channels (and their scales/bias) sharded
  across ``tp``; each device computes its slice of the u8 intermediate and a
  *partial* 1x1 s32 accumulator; a ``psum`` over ``tp`` completes the 1x1
  reduction BEFORE the (nonlinear) requantization — int32 adds commute, so
  the result is bit-identical to single-device execution.
* ``sp_conv``      — spatial H sharding with a 1-row halo exchange via
  ``jax.lax.ppermute`` (neighbor exchange), the image analogue of
  ring-attention's neighbor passing. Bit-exact: halo rows replace the
  zero-padding only at interior shard boundaries.

All wrappers use ``shard_map`` so collectives are explicit and XLA can
overlap them with compute.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import ConvConfig, pad_channels
from ..ops import layout
from ..ops.conv import _conv_call, conv_fused_acc1
from ..ops.requant import requant
from ..utils.logger import check, check_eq

shard_map = jax.shard_map


# ------------------------------------------------------------------ DP

def _rebatched_op(op, bs: int):
    """Shallow clone of `op` whose configs carry the per-shard batch (the
    packed operand cache is shared — weights are replicated)."""
    import copy
    from ..ops.conv import ConvOp
    from ..ops.convpool import ConvPoolOp
    from ..ops.mega import PackedConvPairOp
    from ..ops.packed import PackedConvOp
    clone = copy.copy(op)
    if isinstance(op, (ConvOp, ConvPoolOp)):
        clone.cfg = _rebatch(op.cfg, bs)
    elif isinstance(op, (PackedConvOp, PackedConvPairOp)):
        pass                    # batch derived from the array shape
    else:
        check(False, f"dp_shard does not support {type(op).__name__}")
    return clone


def dp_shard(op, mesh: Mesh, axis: str = "dp"):
    """Wrap an op so the batch dim is sharded over `axis`.

    Supports every repeated-submission op family — ``ConvOp`` (incl.
    strided and sum post-op configs), ``ConvPoolOp``,
    ``PackedConvOp`` (incl. multi-input branch merges and packed sum
    operands), and ``PackedConvPairOp``. Weights are
    replicated; no collectives — the analogue of the reference's
    OpenMP split over the batch dim (src/op_conv.cc:39-47). The
    returned callable takes the op's usual arguments (``src`` and, for
    sum configs, ``sum_src``), each sharded on the batch dim.
    """
    from ..ops.mega import PackedConvPairOp
    from ..ops.packed import PackedConvOp
    is_pair = isinstance(op, PackedConvPairOp)
    cfg = op.cfg_a if is_pair else op.cfg
    n_shard = mesh.shape[axis]
    check(cfg.bs % n_shard == 0, f"batch {cfg.bs} not divisible by {axis}")
    local = _rebatched_op(op, cfg.bs // n_shard)
    packed = isinstance(op, PackedConvOp) or is_pair
    n_in = len(op.sins) if isinstance(op, PackedConvOp) else 1
    has_sum = False if is_pair else (
        op.ssum is not None if packed else cfg.with_sum)
    rank = 3 if packed else 4           # packed arrays are (n, rows*iwp, cp)
    spec = P(axis, *([None] * (rank - 1)))

    def local_fn(*args):
        srcs, args = args[:n_in], args[n_in:]
        src = srcs if n_in > 1 else srcs[0]
        if has_sum:
            return (local(src, args[0]) if packed
                    else local(src, sum_src=args[0]))
        return local(src)

    n_args = n_in + (1 if has_sum else 0)
    fn = shard_map(local_fn, mesh=mesh, in_specs=(spec,) * n_args,
                   out_specs=spec, check_vma=False)

    def run(src, sum_src=None):
        check((sum_src is not None) == has_sum,
              "pass sum_src exactly when the op has a sum post-op")
        srcs = tuple(jnp.asarray(s) for s in src) if n_in > 1 \
            else (jnp.asarray(src),)
        extra = (jnp.asarray(sum_src),) if has_sum else ()
        return fn(*srcs, *extra)

    return jax.jit(run)


def _rebatch(cfg: ConvConfig, bs: int) -> ConvConfig:
    import dataclasses
    return dataclasses.replace(cfg, bs=bs)


# ------------------------------------------------------------------ TP

def tp_wire_bytes(cfg: ConvConfig, n_shard: int, wire: str) -> int:
    """Analytic per-device interconnect bytes for one tp_fused_conv call.

    Ring cost model: an all-reduce (psum) of B bytes moves 2*(N-1)/N * B
    per device (reduce_scatter + all_gather of the same dtype); the
    reduce_scatter wire moves (N-1)/N * B_s32 for the scatter plus
    (N-1)/N * B_dst for the gather of the already-requantized output —
    the s32->u8 width drop on the gather leg plus the nonexistence of a
    full-width replicated accumulator is the point."""
    elems = cfg.bs * cfg.oh * cfg.ow * cfg.oc1x1p
    if wire == "psum":
        return int(2 * (n_shard - 1) / n_shard * elems * 4)
    return int((n_shard - 1) / n_shard * elems * (4 + cfg.dst_dt.size))


def tp_fused_conv(cfg: ConvConfig, wei, bia, wei1x1, bia1x1,
                  mesh: Mesh, axis: str = "tp",
                  wire: str = "reduce_scatter"):
    """Tensor-parallel fused conv3x3+1x1: conv0 oc sharded over `axis`.

    Sharding plan (scaling-book style):
      wei   (oc,ic,kh,kw)  -> oc sharded     | scales0/bias0 shard with oc
      wei1  (oc1,oc,1,1)   -> ic(=oc) sharded| the collective completes the
            contraction BEFORE requantization (requant is nonlinear, so
            partial-sum requant would be wrong — the TP-correctness
            subtlety); int32 adds commute, so both wires are bit-exact vs
            single-device.

    wire = "reduce_scatter" (default): psum_scatter the s32 1x1 accumulator
      over the oc1x1 lane dim, requant the local lane shard (bias1/scale1
      shard with it), all_gather the narrow u8/s8 result — (N-1)/N*(4+1)
      bytes/elem on the wire and a 1/N share of the requant work, vs the
      psum wire's 2*(N-1)/N*4 bytes/elem + full-width replicated requant. See tp_wire_bytes.
    wire = "psum": all-reduce the full s32 accumulator, requant replicated
      — kept as the bit-exactness oracle.

    Each shard adds its own u8-shift correction (128 * colsum of its w1
    rows); the corrections sum to the global correction, keeping the
    result bit-exact vs single-device.
    """
    check(cfg.fuse_conv1x1, "tp_fused_conv needs the fused config")
    check(wire in ("psum", "reduce_scatter"),
          f"unknown tp wire {wire!r} (psum | reduce_scatter)")
    n_shard = mesh.shape[axis]
    check(cfg.oc % n_shard == 0, f"oc {cfg.oc} not divisible by {axis}")
    if wire == "reduce_scatter":
        check(cfg.oc1x1p % n_shard == 0,
              f"oc1x1p {cfg.oc1x1p} not divisible by {axis}")
    oc_l = cfg.oc // n_shard

    import dataclasses
    # local config: conv0 with oc_l channels, emitting the s32 partial acc1
    local_cfg = dataclasses.replace(cfg, oc=oc_l, ocp=pad_channels(oc_l))

    wei = np.asarray(wei)
    w1 = np.asarray(wei1x1)
    # pre-shard the packed operands on host (device_put with shardings in
    # the jitted caller)
    shards = []
    for d in range(n_shard):
        sl = slice(d * oc_l, (d + 1) * oc_l)
        w3_l = layout.pack_conv_weights(wei[sl], local_cfg.icp, local_cfg.ocp)
        w1_l = layout.pack_1x1_weights(w1[:, sl], local_cfg.ocp, cfg.oc1x1p)
        sc0 = np.asarray(cfg.conv0_scales, np.float32)
        sc0_l = sc0[sl] if sc0.size > 1 else sc0
        shards.append({
            "w3": w3_l,
            "corr0": layout.u8_shift_correction(w3_l),
            "bias0": layout.widen_bias(
                None if bia is None else np.asarray(bia)[sl],
                cfg.bia_dt, local_cfg.ocp),
            "scale0": layout.widen_scales(sc0_l, oc_l, local_cfg.ocp),
            "w1": w1_l,
            "corr1": layout.u8_shift_correction(w1_l),
        })
    bias1_full = layout.widen_bias(bia1x1, cfg.bia1x1_dt, cfg.oc1x1p)
    scale1_full = layout.widen_scales(cfg.conv1_scales, cfg.oc1x1,
                                      cfg.oc1x1p)
    if wire == "reduce_scatter":
        # bias1/scale1 shard with the scattered oc1x1 lanes
        for d in range(n_shard):
            chunk = cfg.oc1x1p // n_shard
            shards[d]["bias1"] = bias1_full[d * chunk:(d + 1) * chunk]
            shards[d]["scale1"] = scale1_full[d * chunk:(d + 1) * chunk]
    # host numpy: the jitted caller closes over these, and host-side
    # constants embed into MLIR without a device readback (utils/opcache.py)
    stacked = {k: np.stack([s[k] for s in shards]) for k in shards[0]}
    bias1 = bias1_full
    scale1 = scale1_full
    keys = tuple(shards[0])

    def local_fn(src, *sharded):
        ops_ = dict(zip(keys, sharded))
        # [0] squeezes the leading shard dim added by stacking
        acc1 = _conv_call_acc1(
            local_cfg, src, ops_["w3"][0], ops_["corr0"][0], ops_["bias0"][0],
            ops_["scale0"][0], ops_["w1"][0], ops_["corr1"][0])
        if wire == "psum":
            acc1 = jax.lax.psum(acc1, axis)
            res = requant(acc1, bias1, scale1, cfg.conv1_relu,
                          cfg.conv1_round, cfg.dst_dt)
            return res[..., :cfg.oc1x1]
        # reduce_scatter wire: complete the int32 contraction while
        # scattering over the oc1x1 lanes, requant only the local shard,
        # gather the narrow result (see docstring / tp_wire_bytes)
        part = jax.lax.psum_scatter(acc1, axis, scatter_dimension=3,
                                    tiled=True)
        res = requant(part, ops_["bias1"][0], ops_["scale1"][0],
                      cfg.conv1_relu, cfg.conv1_round, cfg.dst_dt)
        full = jax.lax.all_gather(res, axis, axis=3, tiled=True)
        return full[..., :cfg.oc1x1]

    fn = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(),) + tuple(P(axis) for _ in keys),
        out_specs=P(), check_vma=False)

    def run(src):
        return fn(jnp.asarray(src), *(stacked[k] for k in keys))

    return jax.jit(run)


# TP local step = the flagship conv in emit_acc1 mode (ops/conv.py
# conv_fused_acc1): the u8 intermediate and the partial 1x1 product stay in
# one kernel; only the s32 partial accumulator crosses into the psum.
_conv_call_acc1 = conv_fused_acc1


def tp_packed_fused(op, mesh: Mesh, axis: str = "tp",
                    wire: str = "reduce_scatter"):
    """Tensor-parallel PACKED fused conv: conv0 oc sharded over `axis`.

    The packed-domain twin of ``tp_fused_conv`` (completes the
    parallel x op-family matrix — dp/sp already cover every packed
    family). Each shard runs the packed conv in ``emit_acc1`` mode on
    its conv0 lane slice: conv0 -> requant-to-u8 (per-shard scales) ->
    partial 1x1 s32 accumulator. The collective completes the int32
    contraction BEFORE the nonlinear final requant (the TP-correctness
    subtlety); the post-collective epilogue reproduces the kernel's
    final stage exactly (same requant chain, pad lanes self-mask via
    zeroed scales, margin/halo mask applied as a host-built constant),
    so the result is bit-identical to the single-device op
    (tests/test_parallel.py).

    wire = "reduce_scatter" (default): psum_scatter the s32 accumulator
    over the oc1x1 lanes, requant the local lane chunk, all_gather the
    narrow s8 result. wire = "psum": all-reduce + replicated requant
    (the bit-exactness oracle). Requires a fused single-input op with
    no sum post-op and no pool2 epilogue; oc, ocp and (for the rs wire)
    oc1x1p divisible by the shard count.
    """
    from ..ops.packed import PackedConvOp, _packed_call
    from ..ops.requant import requant
    from ..types import dtype as _dt
    import dataclasses

    check(type(op) is PackedConvOp, "tp_packed_fused needs a PackedConvOp")
    cfg = op.cfg
    check(cfg.fuse_conv1x1, "tp_packed_fused needs the fused config")
    check(len(op.sins) == 1 and op.ssum is None and not op.pool2,
          "tp_packed_fused: single input, no sum post-op, no pool2")
    check(wire in ("psum", "reduce_scatter"),
          f"unknown tp wire {wire!r} (psum | reduce_scatter)")
    n_shard = mesh.shape[axis]
    check(cfg.oc % n_shard == 0 and cfg.ocp % n_shard == 0,
          f"oc {cfg.oc}/ocp {cfg.ocp} not divisible by {axis}")
    if wire == "reduce_scatter":
        check(cfg.oc1x1p % n_shard == 0,
              f"oc1x1p {cfg.oc1x1p} not divisible by {axis}")
    oc_l, ocp_l = cfg.oc // n_shard, cfg.ocp // n_shard
    cfg_l = dataclasses.replace(cfg, oc=oc_l, ocp=ocp_l)
    sin, sout = op.sin, op.sout

    # host-side per-shard operand slices (conv0 lanes / w1 rows); each
    # shard's corr1 is the column sum of ITS w1 rows, so the partial
    # corrections sum to the global one — bit-exact across the psum
    w3, corr0, bias0, scale0, w1, corr1, bias1, scale1 = \
        (np.asarray(a) for a in op._operands)
    shards = []
    for d in range(n_shard):
        sl = slice(d * ocp_l, (d + 1) * ocp_l)
        w1_d = w1[sl, :]
        shards.append({
            "w3": w3[:, sl], "corr0": corr0[sl], "bias0": bias0[sl],
            "scale0": scale0[sl], "w1": w1_d,
            "corr1": 128 * w1_d.astype(np.int32).sum(axis=0),
        })
    if wire == "reduce_scatter":
        chunk = cfg.oc1x1p // n_shard
        for d in range(n_shard):
            shards[d]["bias1"] = bias1[d * chunk:(d + 1) * chunk]
            shards[d]["scale1"] = scale1[d * chunk:(d + 1) * chunk]
    stacked = {k: np.stack([sh[k] for sh in shards]) for k in shards[0]}
    keys = tuple(shards[0])

    # the final stage's packed-image mask, as a host constant: margin
    # columns and halo rows force -128; pad lanes come out -128 for
    # free (zeroed scale1 lanes -> round(0) - 128)
    pos = np.arange(sout.rows * sout.iwp)
    col, row = pos % sout.iwp, pos // sout.iwp
    maskb = ((col >= sout.col_off) & (col < sout.col_off + sout.w)
             & (row >= sout.halo) & (row < sout.halo + sout.h))
    maskb = maskb[None, :, None]          # (1, rows*iwp, 1)

    def final(acc, b1, s1):
        # reproduce requant_to_u8_centered: requant to u8 (relu is
        # forced for the u8 destination), recenter, mask non-image slots
        res = requant(acc, b1 if cfg.conv1_with_bias else None, s1,
                      True, cfg.conv1_round, _dt.u8)
        out = (res.astype(jnp.int16) - 128).astype(jnp.int8)
        return jnp.where(maskb, out, np.int8(-128))

    def local_fn(x, *sharded):
        ops_d = dict(zip(keys, sharded))
        ops_l = (ops_d["w3"][0], ops_d["corr0"][0], ops_d["bias0"][0],
                 ops_d["scale0"][0], ops_d["w1"][0], ops_d["corr1"][0],
                 # bias1/scale1 ride only the requant below; feed
                 # placeholders so the kernel's operand list lines up
                 ops_d["corr1"][0] * 0.0, ops_d["corr1"][0] * 0.0)
        acc1 = _packed_call(cfg_l, op.sins, sout, (x,), *ops_l,
                            emit_acc1=True)
        if wire == "psum":
            acc1 = jax.lax.psum(acc1, axis)
            return final(acc1, bias1, scale1)
        part = jax.lax.psum_scatter(acc1, axis, scatter_dimension=2,
                                    tiled=True)
        res = final(part, ops_d["bias1"][0], ops_d["scale1"][0])
        return jax.lax.all_gather(res, axis, axis=2, tiled=True)

    fn = shard_map(local_fn, mesh=mesh,
                   in_specs=(P(),) + tuple(P(axis) for _ in keys),
                   out_specs=P(), check_vma=False)

    def run(src):
        return fn(jnp.asarray(src), *(stacked[k] for k in keys))

    return jax.jit(run)


# ------------------------------------------------------------------ SP

def _sp_stage(local, axis: str, n_shard: int, h_loc: int):
    """The per-shard body of one spatially sharded PackedConvOp (see
    sp_packed): exchange halo rows, compute the interior output rows from
    the pre-exchange arrays and the boundary rows from the exchanged
    ones, stitch."""
    from ..ops.packed import _packed_call

    cfg, sins_l, sout_l = local.cfg, tuple(local.sins), local.sout
    halo, iwp = sins_l[0].halo, sins_l[0].iwp
    rows_out = sout_l.rows
    # output row j reads input rows [j + delta - ph, j + delta - ph + kh):
    # rows [r_top, r_bot) never touch the exchanged halo bands
    delta = halo - sout_l.halo
    r_top = min(max(halo - delta + cfg.ph, 0), rows_out)
    r_bot = max(min(halo + h_loc - delta + cfg.ph - cfg.kh + 1, rows_out),
                r_top)
    if local.pool2:                 # pooled row ranges must pair rows
        r_top = min(r_top + r_top % 2, rows_out)
        r_bot = max(r_bot - r_bot % 2, r_top)

    def call(arrs, rows, sum_arr):
        kw = {}
        if local.ssum is not None:
            kw = dict(ssum=local.ssum, sum_arr=sum_arr)
        return _packed_call(cfg, sins_l, sout_l, arrs,
                            *local._cache.for_call(arrs[0]),
                            pool2=local.pool2, rows=rows, **kw)

    def stage(xs, sum_arr=None):
        idx = jax.lax.axis_index(axis)
        fwd = [(i, (i + 1) % n_shard) for i in range(n_shard)]
        bwd = [(i, (i - 1) % n_shard) for i in range(n_shard)]
        # 1. halo slabs in flight first, so the transfers can overlap the
        #    interior conv (trace order is the overlap contract)
        halos = [(jax.lax.ppermute(
            x[:, h_loc * iwp:(h_loc + halo) * iwp], axis, fwd),
                  jax.lax.ppermute(x[:, halo * iwp:2 * halo * iwp], axis,
                                   bwd)) for x in xs]

        def land(x, hl):
            top, bot = hl
            top = jnp.where(idx == 0, jnp.full_like(top, -128), top)
            bot = jnp.where(idx == n_shard - 1, jnp.full_like(bot, -128),
                            bot)
            return (x.at[:, :halo * iwp].set(top)
                    .at[:, (halo + h_loc) * iwp:].set(bot))

        # 2. interior rows on the pre-exchange arrays
        mid = call(xs, (r_top, r_bot), sum_arr) if r_bot > r_top else None
        # 3. boundary rows once the halos land
        xs_ex = tuple(land(x, hl) for x, hl in zip(xs, halos))
        if mid is None:
            return call(xs_ex, (0, rows_out), sum_arr)
        parts = [call(xs_ex, (0, r_top), sum_arr)] if r_top else []
        parts.append(mid)
        if r_bot < rows_out:
            parts.append(call(xs_ex, (r_bot, rows_out), sum_arr))
        # 4. stitch the output rows
        return jnp.concatenate(parts, axis=1) if len(parts) > 1 else mid

    return stage


def sp_packed(op, mesh: Mesh, axis: str = "sp",
              dp_axis: Optional[str] = None):
    """Spatially-sharded PACKED-domain conv: H split over `axis`, halo
    rows exchanged via ``jax.lax.ppermute``, overlapped with interior
    compute (the packed layout *materializes* its halo rows, so neighbor
    shards literally write each other's halo slabs).

    Distributed format: the input is ``pack_image_sharded``'s
    concatenation of per-shard local packed images (each a valid packed
    image of height ``h/n_shard`` with its own halo band), sharded on
    the flat-row dim. Per conv, the wrapper:

      1. ppermutes each shard's top/bottom image rows into its
         neighbors' halo bands (outer shards keep the true -128 pad);
      2. computes the output rows whose input windows never touch the
         halo bands from the *pre-exchange* array, so that conv has no
         data dependence on the permutes and can overlap them;
      3. computes the boundary output rows from the exchanged array;
      4. concatenates the output rows.

    Supports ``PackedConvOp`` (incl. sum post-ops — the sum operand
    shards in the same local format and needs no exchange, it is read
    at output rows only — and the pool2 step) and ``PackedConvPairOp``
    (one exchange per layer). Output is in the same sharded local-packed
    format (pooled spec when pool2). Bit-exact vs the single-device op on
    the image rows (tests/test_parallel.py).
    """
    from ..ops.mega import PackedConvPairOp
    from ..ops.packed import PackedConvOp

    is_pair = isinstance(op, PackedConvPairOp)
    check(is_pair or type(op) is PackedConvOp,
          f"sp_packed supports PackedConvOp/PackedConvPairOp "
          f"(got {type(op).__name__})")
    n_shard = mesh.shape[axis]
    check(op.sin.h % n_shard == 0,
          f"image height {op.sin.h} not divisible by {axis}={n_shard}")
    h_loc = op.sin.h // n_shard
    local = op.reheight(h_loc)
    layers = [local.a, local.b] if is_pair else [local]
    stages = [_sp_stage(lay, axis, n_shard, h_loc) for lay in layers]
    has_sum = (not is_pair) and op.ssum is not None
    n_in = len(local.sins) if not is_pair else 1

    def local_fn(*args):
        xs, rest = args[:n_in], args[n_in:]
        y = stages[0](xs, rest[0] if has_sum else None)
        for stage in stages[1:]:
            y = stage((y,))
        return y

    img_spec = P(dp_axis, axis, None)
    n_args = n_in + (1 if has_sum else 0)
    fn = shard_map(local_fn, mesh=mesh, in_specs=(img_spec,) * n_args,
                   out_specs=img_spec, check_vma=False)

    jfn = jax.jit(lambda *args: fn(*args))

    def run(src, sum_src=None):
        check((sum_src is not None) == has_sum,
              "pass sum_src exactly when the op has a sum post-op")
        srcs = tuple(jnp.asarray(s) for s in src) if n_in > 1 \
            else (jnp.asarray(src),)
        check(len(srcs) == n_in, "op expects one array per input spec")
        extra = (jnp.asarray(sum_src),) if has_sum else ()
        return jfn(*srcs, *extra)

    run.local_spec = local.sin
    run.local_specs = tuple(local.sins) if not is_pair else (local.sin,)
    run.local_out_spec = local.sout_pooled if local.pool2 else local.sout
    run.n_shards = n_shard
    return run


def sp_conv(conv_op, mesh: Mesh, axis: str = "sp",
            dp_axis: Optional[str] = None):
    """Spatially-sharded conv: H split over `axis` with halo exchange via
    ``jax.lax.ppermute`` (the neighbor pattern; SURVEY.md §5
    long-context row), **overlapped with interior compute**.

    Schedule (the ring-attention-shaped pipeline, SURVEY §7 hard part):

        1. issue both halo ppermutes (async collective-permutes),
        2. run the INTERIOR conv — the output rows computable from local
           input alone; no data dependence on the permutes, so XLA's async
           scheduler hides the transfer latency under the bulk of the conv,
        3. run the two tiny BOUNDARY convs (ph / kh-1-ph output rows) on
           halo+edge slabs once the permutes land,
        4. concatenate [top, interior, bottom] output rows.

    Geometry (relaxed from round 1's SAME-pad-only rule): any ph < kh with
    stride_h == 1 and ih % n_shard == 0. Each shard computes ih_l output
    rows against a zero-extended bottom edge; rows beyond the true oh are
    sliced off at the end (they read only zero padding, matching conv
    semantics; for SAME padding the slice is a no-op). stride_w may be >1.

    dp_axis: optionally also shard the batch dim over a second mesh axis
    (pure data parallelism composed with the halo exchange — the production
    dp x sp configuration exercised by ``__graft_entry__.dryrun_multichip``).

    Sum post-op configs are supported (the sum operand shards over H with
    the output; requires oh == ih so shard boundaries align). Packed op
    families have their own spatial wrapper (``sp_packed``); pooled dense
    ops fail fast — batch-shard those with ``dp_shard``.
    """
    from ..ops.conv import ConvOp
    check(type(conv_op) is ConvOp,
          f"sp_conv supports ConvOp (got {type(conv_op).__name__}); "
          "spatially sharding pooled/packed ops is not implemented — "
          "use dp_shard for those families")
    cfg = conv_op.cfg
    n_shard = mesh.shape[axis]
    check_eq(cfg.sh, 1, "sp_conv requires stride_h == 1")
    check(cfg.ih % n_shard == 0, f"ih {cfg.ih} not divisible by {axis}")
    with_sum = cfg.with_sum
    if with_sum:
        check_eq(cfg.oh, cfg.ih, "sp_conv with a sum post-op requires "
                                 "oh == ih (aligned shard boundaries)")
    ih_l = cfg.ih // n_shard
    ph = cfg.ph
    kb = cfg.kh - 1 - ph          # halo rows needed from below
    check(ih_l >= cfg.kh - 1, "shard too thin for the kernel height")
    import dataclasses
    replace_geometry = dataclasses.replace

    def conv_slab(pcfg, src, operands, sum_slab=None):
        kw = {} if sum_slab is None else dict(sum_src=sum_slab)
        return _conv_call(pcfg, src, *operands, **kw)

    def local_fn(src, *rest):
        if with_sum:
            sum_l, operands = rest[0], rest[1:]
        else:
            sum_l, operands = None, rest

        def sum_rows(lo, hi):
            return None if sum_l is None else sum_l[:, lo:hi]

        # src: (n, ih_l, iw, ic) local rows, u8
        idx = jax.lax.axis_index(axis)
        fwd = [(i, (i + 1) % n_shard) for i in range(n_shard)]
        bwd = [(i, (i - 1) % n_shard) for i in range(n_shard)]
        # 1. halos in flight (outer edges replaced by conv zero-padding)
        top = bot = None
        if ph > 0:
            top = jax.lax.ppermute(src[:, -ph:], axis, fwd)
            top = jnp.where(idx == 0, jnp.zeros_like(top), top)
        if kb > 0:
            bot = jax.lax.ppermute(src[:, :kb], axis, bwd)
            bot = jnp.where(idx == n_shard - 1, jnp.zeros_like(bot), bot)
        # 2. interior: output rows [ph, ih_l - kb) from local rows alone
        mid_cfg = replace_geometry(cfg, ph=0, ih=ih_l,
                                   oh=ih_l - cfg.kh + 1, bs=src.shape[0])
        mid = conv_slab(mid_cfg, src, operands, sum_rows(ph, ih_l - kb))
        outs = []
        # 3. boundary rows once the halos land
        if ph > 0:
            slab = jnp.concatenate([top, src[:, :cfg.kh - 1]], axis=1)
            top_cfg = replace_geometry(cfg, ph=0, ih=ph + cfg.kh - 1,
                                       oh=ph, bs=src.shape[0])
            outs.append(conv_slab(top_cfg, slab, operands, sum_rows(0, ph)))
        outs.append(mid)
        if kb > 0:
            slab = jnp.concatenate([src[:, -(cfg.kh - 1):], bot], axis=1)
            bot_cfg = replace_geometry(cfg, ph=0, ih=kb + cfg.kh - 1,
                                       oh=kb, bs=src.shape[0])
            outs.append(conv_slab(bot_cfg, slab, operands,
                                  sum_rows(ih_l - kb, ih_l)))
        # 4. stitch: ih_l output rows per shard
        return jnp.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]

    if dp_axis is not None:
        check(cfg.bs % mesh.shape[dp_axis] == 0,
              f"batch {cfg.bs} not divisible by {dp_axis}")
    img_spec = P(dp_axis, axis, None, None)
    n_img = 2 if with_sum else 1
    spec_in = (img_spec,) * n_img + tuple(
        P(None) for _ in conv_op._operands)
    fn = shard_map(local_fn, mesh=mesh, in_specs=spec_in,
                   out_specs=img_spec, check_vma=False)

    def run(src, sum_src=None):
        check((sum_src is not None) == with_sum,
              "pass sum_src exactly when the op has a sum post-op")
        extra = (jnp.asarray(sum_src),) if with_sum else ()
        out = fn(jnp.asarray(src), *extra, *conv_op._operands)
        # shards compute n*ih_l = ih rows; the true output is the first oh
        # (extra bottom rows read only the zero-extended edge)
        return out[:, :cfg.oh]

    return jax.jit(run)
