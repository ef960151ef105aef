"""Multi-device sharding tests on the 8-device virtual CPU mesh.

Checks the scale-out layer produces bit-identical results to single-device
execution: DP (batch), TP (oc + psum before requant), SP (H halo exchange
via ppermute). The reference has no distributed layer; these validate the
scale-out extension (SURVEY.md §7 step 6).
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from deepfusion_tpu.config import ConvConfig
from deepfusion_tpu.ops.conv import ConvOp
from deepfusion_tpu.ops.ref import conv_ref
from deepfusion_tpu.parallel import (dp_shard, factorize_mesh, make_mesh,
                                     sp_conv, tp_fused_conv)

from helpers import compare, fill_data


def need_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def make_fused_cfg(rng, mb=4, ic=16, hw=12, oc=32, oc1=16, ph=1, sw=1):
    src = fill_data((mb, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    wei1 = fill_data((oc1, oc, 1, 1), "s8", rng)
    bia1 = fill_data((oc1,), "s32", rng)
    oh = hw + 2 * ph - 2
    ow = (hw + 2 * ph - 3) // sw + 1
    cfg = ConvConfig.make(
        (mb, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (1, sw), (ph, ph),
        (mb, oh, ow, oc1), "u8", conv0_scales=(0.02,),
        wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=bia1.dtype,
        conv1_relu=True, conv1_scales=(0.4,))
    return cfg, src, wei, bia, wei1, bia1


def test_dp_shard_bit_exact(rng):
    need_devices(2)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng)
    mesh = make_mesh(dp=2)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    out = dp_shard(op, mesh)(src)
    compare(np.asarray(out), conv_ref(cfg, src, wei, bia, wei1, bia1), "dp")


def test_tp_fused_bit_exact(rng):
    need_devices(2)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng)
    mesh = make_mesh(tp=2)
    fn = tp_fused_conv(cfg, wei, bia, wei1, bia1, mesh)
    out = fn(src)
    compare(np.asarray(out), conv_ref(cfg, src, wei, bia, wei1, bia1), "tp")


def test_tp_4way(rng):
    need_devices(4)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, oc=64)
    mesh = make_mesh(tp=4)
    out = tp_fused_conv(cfg, wei, bia, wei1, bia1, mesh)(src)
    compare(np.asarray(out), conv_ref(cfg, src, wei, bia, wei1, bia1),
            "tp4")


@pytest.mark.parametrize("n", [2, 4])
def test_tp_wire_modes_bit_exact(rng, n):
    # both wires must agree with the oracle exactly: int32 adds commute,
    # so psum == psum_scatter-then-gather elementwise
    need_devices(n)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, oc=16 * n)
    mesh = make_mesh(tp=n)
    ref = conv_ref(cfg, src, wei, bia, wei1, bia1)
    for wire in ("psum", "reduce_scatter"):
        out = tp_fused_conv(cfg, wei, bia, wei1, bia1, mesh, wire=wire)(src)
        compare(np.asarray(out), ref, f"tp-{wire}-{n}way")


def test_tp_wire_bytes_accounting():
    from deepfusion_tpu.parallel.shard import tp_wire_bytes
    cfg, *_ = make_fused_cfg(np.random.default_rng(0))
    ps = tp_wire_bytes(cfg, 4, "psum")
    rs = tp_wire_bytes(cfg, 4, "reduce_scatter")
    # ring model: psum = 2*(N-1)/N*4B, rs+ag = (N-1)/N*(4+1)B -> 1.6x
    assert ps / rs == pytest.approx(8 / 5)


def test_sp_halo_bit_exact(rng):
    need_devices(2)
    # SAME conv so rows shard evenly; halo rows must replace zero-padding
    # at the interior boundary exactly
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, hw=12, ph=1)
    mesh = make_mesh(sp=2)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    out = sp_conv(op, mesh)(src)
    compare(np.asarray(out), conv_ref(cfg, src, wei, bia, wei1, bia1), "sp")


def test_sp_4way(rng):
    need_devices(4)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, hw=16, ph=1)
    mesh = make_mesh(sp=4)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    out = sp_conv(op, mesh)(src)
    compare(np.asarray(out), conv_ref(cfg, src, wei, bia, wei1, bia1), "sp4")


def test_sp_valid_pad(rng):
    # relaxed geometry: ph=0 / VALID — no top halo, the
    # bottom-slab kb = kh-1 arithmetic and the oh slice do the work
    need_devices(2)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, hw=12, ph=0)
    mesh = make_mesh(sp=2)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    out = sp_conv(op, mesh)(src)
    compare(np.asarray(out), conv_ref(cfg, src, wei, bia, wei1, bia1),
            "sp-valid")


def test_sp_valid_pad_4way(rng):
    need_devices(4)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, hw=16, ph=0)
    mesh = make_mesh(sp=4)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    out = sp_conv(op, mesh)(src)
    compare(np.asarray(out), conv_ref(cfg, src, wei, bia, wei1, bia1),
            "sp-valid4")


def test_sp_strided_w(rng):
    # relaxed geometry: stride_w > 1 routes every slab
    # through the s2d lowering
    need_devices(2)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, hw=12, ph=1, sw=2)
    assert cfg.sw == 2
    mesh = make_mesh(sp=2)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    out = sp_conv(op, mesh)(src)
    compare(np.asarray(out), conv_ref(cfg, src, wei, bia, wei1, bia1),
            "sp-sw2")


def test_sp_with_dp_axis(rng):
    # the production dp x sp composition used by dryrun_multichip
    need_devices(4)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, mb=4, hw=12)
    mesh = make_mesh(dp=2, sp=2)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    out = sp_conv(op, mesh, dp_axis="dp")(src)
    compare(np.asarray(out), conv_ref(cfg, src, wei, bia, wei1, bia1),
            "dp x sp via sp_conv")


def test_sp_overlap_structure(rng):
    """Overlap evidence: the interior conv must not
    depend on the halo permutes, and the permutes must be issued first.

    Structural check on the traced program: data-flow independence is what
    ALLOWS an async scheduler to hide the transfer latency under the
    interior conv; program order (permutes first) is what makes it happen.

    Parts (a) program order and (b) data independence are what this test
    PROVES, on any backend. Part (c) — collective-permute-start/done
    straddling the interior kernel in compiled HLO — only executes on a
    multi-device GPU backend (the CPU mesh lowers collectives
    synchronously), so the hlo text check below is dormant on the CPU.
    """
    need_devices(2)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, hw=12, ph=1)
    mesh = make_mesh(sp=2)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    fn = sp_conv(op, mesh)
    jaxpr = jax.make_jaxpr(fn)(src)
    # walk into the shard_map body
    def find_shmap(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "shard_map":
                return eqn.params["jaxpr"]
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):
                    r = find_shmap(v.jaxpr)
                    if r is not None:
                        return r
        return None

    body = find_shmap(jaxpr.jaxpr)
    assert body is not None, "no shard_map in sp_conv's jaxpr"

    def contains_pallas(eqn):
        # the interior conv may be wrapped in a jit/pjit closed call
        if eqn.primitive.name == "pallas_call":
            return True
        for v in eqn.params.values():
            jx = getattr(v, "jaxpr", v)
            if hasattr(jx, "eqns") and any(contains_pallas(e)
                                           for e in jx.eqns):
                return True
        return False

    names = [e.primitive.name for e in body.eqns]
    perm_idx = [i for i, n in enumerate(names) if n == "ppermute"]
    conv_idx = [i for i, e in enumerate(body.eqns) if contains_pallas(e)]
    assert perm_idx and conv_idx, (names,)
    # (a) program order: both permutes issued before the interior conv
    assert max(perm_idx) < conv_idx[0], \
        f"halo permutes not issued before interior conv: {names}"
    # (b) data-flow: the interior conv consumes none of the permute outputs
    perm_outs = set()
    for i in perm_idx:
        perm_outs.update(map(id, body.eqns[i].outvars))
    interior = body.eqns[conv_idx[0]]
    # trace the interior conv's operand closure back through the body
    frontier = set(map(id, interior.invars))
    for eqn in reversed(body.eqns[:conv_idx[0]]):
        if any(id(v) in frontier for v in eqn.outvars):
            assert eqn.primitive.name != "ppermute", \
                "interior conv depends on a halo permute"
            frontier.update(map(id, eqn.invars))
    # (c) GPU backend: async start/done pair straddles the interior kernel
    hlo = jax.jit(fn).lower(src).compile().as_text()
    if "collective-permute-start" in hlo:
        lines = hlo.splitlines()
        starts = [i for i, l in enumerate(lines)
                  if "collective-permute-start" in l]
        dones = [i for i, l in enumerate(lines)
                 if "collective-permute-done" in l]
        kerns = [i for i, l in enumerate(lines)
                 if "custom-call" in l and "triton" in l]
        assert starts and dones and kerns
        assert min(starts) < max(kerns) < max(dones), \
            "no interior kernel scheduled between permute start/done"


def test_dp_sp_combined(rng):
    need_devices(4)
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, mb=4, hw=12)
    mesh = make_mesh(dp=2, sp=2)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    # compose: dp over batch, sp inside — via sp_conv on a mesh with both
    # axes: batch spec uses dp, rows use sp
    import dataclasses

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from deepfusion_tpu.parallel.shard import _conv_call

    oh_l = cfg.oh // 2
    local_cfg = dataclasses.replace(cfg, bs=cfg.bs // 2)

    def local_fn(s, *ops_):
        idx = jax.lax.axis_index("sp")
        halo = cfg.ph
        top = jax.lax.ppermute(s[:, -halo:], "sp", [(0, 1), (1, 0)])
        bot = jax.lax.ppermute(s[:, :halo], "sp", [(0, 1), (1, 0)])
        top = jnp.where(idx == 0, jnp.zeros_like(top), top)
        bot = jnp.where(idx == 1, jnp.zeros_like(bot), bot)
        s = jnp.concatenate([top, s, bot], axis=1)
        pcfg = dataclasses.replace(local_cfg, ph=0, ih=s.shape[1], oh=oh_l)
        return _conv_call(pcfg, s, *ops_)

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P("dp", "sp", None, None),) + (P(None),) * len(op._operands),
        out_specs=P("dp", "sp", None, None), check_vma=False)
    out = jax.jit(lambda s: fn(s, *op._operands))(jnp.asarray(src))
    compare(np.asarray(out), conv_ref(cfg, src, wei, bia, wei1, bia1),
            "dp x sp")


def test_factorize_mesh():
    for n in (1, 2, 4, 8, 6, 12):
        dp, sp, tp = factorize_mesh(n)
        assert dp * sp * tp == n


@pytest.mark.slow
def test_multihost_two_process_dp():
    """The multi-host code path EXECUTES: two OS
    processes, ``jax.distributed.initialize`` over a localhost
    coordinator (the DCN path at process granularity), cross-process CPU
    collectives, a dp=2-sharded ConvOp forward fed with process-local
    batch halves, each shard bit-exact vs the unsharded op. The same
    plumbing ``bench.py --op scaling --hosts N`` drives on a real pod."""
    import socket
    import subprocess
    import sys as _sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # 1 CPU device per process
    procs = [subprocess.Popen(
        [_sys.executable, worker, str(port), str(i), "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MULTIHOST_OK {i} procs=2" in out, out
        # the packed-domain halo exchange also executed cross-process
        assert f"MULTIHOST_SP_OK {i}" in out, out


# ----- dp_shard across op families -----

def test_dp_shard_convpool(rng):
    need_devices(2)
    from deepfusion_tpu.config import PoolConfig
    from deepfusion_tpu.ops.convpool import ConvPoolOp
    from deepfusion_tpu.utils.mathutil import conv_output_size
    n, ic, hw, oc = 4, 16, 12, 32
    src = fill_data((n, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    oh = conv_output_size(hw, 3, 1, 1)
    cfg = ConvConfig.make((n, hw, hw, ic), (oc, ic, 3, 3), bia.dtype,
                          (1, 1), (1, 1), (n, oh, oh, oc), "u8",
                          conv0_relu=True, conv0_scales=(0.05,))
    pc = PoolConfig.make("max", (oh, oh), (2, 2), (2, 2), (0, 0))
    op = ConvPoolOp(cfg, pc, wei, bia)
    out = dp_shard(op, make_mesh(dp=2))(src)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(op(src)))


def test_dp_shard_packed(rng):
    need_devices(4)
    from deepfusion_tpu.ops.packed import PackedConvOp, pack_image
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, ic=32, oc=32,
                                                    oc1=32)
    op = PackedConvOp(cfg, wei, bia, wei1, bia1)
    x = pack_image(src, op.sin)
    out = dp_shard(op, make_mesh(dp=4))(x)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(op(x)))


def test_dp_shard_packed_sum_multi_input(rng):
    """dp over a packed op with BOTH extras: two lane-concatenated inputs
    and a packed sum operand."""
    need_devices(2)
    import dataclasses
    from deepfusion_tpu.ops.packed import (PackedConvOp, PackedSpec,
                                           pack_image)
    from deepfusion_tpu.types import dtype as dt
    mb, hw, ca, cb, oc = 4, 12, 32, 32, 32
    srca = fill_data((mb, hw, hw, ca), "u8", rng)
    srcb = fill_data((mb, hw, hw, cb), "u8", rng)
    wei = fill_data((oc, ca + cb, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    cfg = ConvConfig.make((mb, hw, hw, ca + cb), (oc, ca + cb, 3, 3),
                          bia.dtype, (1, 1), (1, 1), (mb, hw, hw, oc),
                          "u8", conv0_scales=(0.05,))
    cfg = dataclasses.replace(cfg, with_sum=True, sum_dt=dt.u8,
                              sum_scale=0.7)
    sa = PackedSpec.make(hw, hw, ca, cp=ca)
    sb = PackedSpec.make(hw, hw, cb, cp=cb)
    ssum = PackedSpec.make(hw, hw, oc)
    op = PackedConvOp(cfg, wei, bia, sin=(sa, sb), sum_spec=ssum)
    xa, xb = pack_image(srca, sa), pack_image(srcb, sb)
    sum_arr = pack_image(fill_data((mb, hw, hw, oc), "u8", rng), ssum)
    fn = dp_shard(op, make_mesh(dp=2))
    out = fn((xa, xb), sum_arr)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(op((xa, xb), sum_arr)))


def test_dp_shard_conv_sum_postop(rng):
    need_devices(2)
    import dataclasses
    from deepfusion_tpu.types import dtype as dt
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng)
    cfg = dataclasses.replace(cfg, with_sum=True, sum_dt=dt.u8,
                              sum_scale=0.6)
    sum_src = fill_data((cfg.bs, cfg.oh, cfg.ow, cfg.oc1x1), "u8", rng)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    out = dp_shard(op, make_mesh(dp=2))(src, sum_src)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(op(src, sum_src=sum_src)))


def test_sp_conv_sum_postop(rng):
    need_devices(2)
    import dataclasses
    from deepfusion_tpu.types import dtype as dt
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, hw=12, ph=1)
    cfg = dataclasses.replace(cfg, with_sum=True, sum_dt=dt.u8,
                              sum_scale=0.6)
    sum_src = fill_data((cfg.bs, cfg.oh, cfg.ow, cfg.oc1x1), "u8", rng)
    op = ConvOp(cfg, wei, bia, wei1, bia1)
    out = sp_conv(op, make_mesh(sp=2))(src, sum_src)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(op(src, sum_src=sum_src)))


def test_sp_conv_rejects_non_convop(rng):
    from deepfusion_tpu.ops.packed import PackedConvOp
    from deepfusion_tpu.utils.logger import CheckError
    cfg, src, wei, bia, wei1, bia1 = make_fused_cfg(rng, ic=32, oc=32,
                                                    oc1=32)
    op = PackedConvOp(cfg, wei, bia, wei1, bia1)
    with pytest.raises(CheckError):
        sp_conv(op, make_mesh(sp=2))


def test_dp_shard_pair_megakernel(rng):
    need_devices(2)
    from deepfusion_tpu.ops.mega import PackedConvPairOp
    from deepfusion_tpu.ops.packed import PackedSpec, pack_image
    from test_packed import build_cfg
    hw = 12
    cfg_a, src, wa, ba, *_ = build_cfg(4, 32, hw, 32, 1, rng=rng)
    cfg_b, _, wb, bb, *_ = build_cfg(4, 32, hw, 32, 1, rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=2, col_off=2, iwp=16)
    pair = PackedConvPairOp(cfg_a, (wa, ba), cfg_b, (wb, bb), sin=sin,
                            halo_out=2, col_off_out=2, pool2=True)
    x = pack_image(src, sin)
    out = dp_shard(pair, make_mesh(dp=2))(x)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(pair(x)))


def test_three_stage_plan_mesh_invariant(rng):
    """The composed dp x sp x tp plan (parallel/plan.py — the builder
    shared by the driver dryrun and bench.py's scaling harness) must be
    bit-identical across mesh shapes: every stage's collective completes
    integer contractions before the nonlinear requant."""
    need_devices(8)
    from deepfusion_tpu.parallel.plan import three_stage_plan

    mb, hw, ic, oc, oc1 = 4, 16, 16, 32, 32
    src = rng.integers(0, 17, (mb, hw, hw, ic)).astype(np.uint8)
    outs = []
    for dp, sp, tp in [(1, 1, 1), (2, 2, 2), (1, 2, 4)]:
        mesh = make_mesh(dp=dp, sp=sp, tp=tp)
        plan, pair, _ = three_stage_plan(
            mesh, mb, hw, ic, oc, oc1, rng=np.random.default_rng(7))
        out = np.asarray(jax.jit(plan)(src))
        assert out.shape == (mb, hw // 2, hw // 2, oc1)
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def _count_prims(jx, name="pallas_call"):
    """Recursively count eqns of a primitive in a (Closed)Jaxpr."""
    jx = getattr(jx, "jaxpr", jx)
    n = 0
    for eqn in jx.eqns:
        if eqn.primitive.name == name:
            n += 1
        for v in eqn.params.values():
            vs = v if isinstance(v, (tuple, list)) else (v,)
            for u in vs:
                if hasattr(u, "jaxpr") or hasattr(u, "eqns"):
                    n += _count_prims(u, name)
    return n


_count_pallas_calls = _count_prims


def _sp_packed_check(rng, op, src, n_shard, dp=1, sum_src=None,
                     expect_split=False):
    """sp_packed(op) over n_shard shards must reproduce the single-device
    op's image rows exactly (the sharded local-packed format drops
    nothing but interior halo bands, which hold -128 by contract).
    expect_split: additionally assert the interior/boundary OVERLAP
    SPLIT engaged (>= 3 pallas calls in the traced program) — the
    split-path tests must not silently degrade to the full-exchange
    call."""
    from deepfusion_tpu.ops.packed import (pack_image, pack_image_sharded,
                                           unpack_image,
                                           unpack_image_sharded)
    from deepfusion_tpu.parallel import sp_packed

    need_devices(n_shard * dp)
    xg = pack_image(src, op.sin)
    if sum_src is not None:
        want = np.asarray(op(xg, sum_arr=pack_image(sum_src, op.ssum)))
    else:
        want = np.asarray(op(xg))
    out_spec = op.sout_pooled if op.pool2 else op.sout
    want_img = unpack_image(want, out_spec)

    mesh = make_mesh(dp=dp, sp=n_shard)
    fn = sp_packed(op, mesh, dp_axis="dp" if dp > 1 else None)
    xs = pack_image_sharded(src, fn.local_spec, n_shard)
    if expect_split:
        npc = _count_pallas_calls(jax.make_jaxpr(lambda a: fn(a))(xs))
        assert npc >= 3, f"overlap split did not engage ({npc} calls)"
    if sum_src is not None:
        from dataclasses import replace
        sum_local = replace(op.ssum, h=op.ssum.h // n_shard)
        got = fn(xs, pack_image_sharded(sum_src, sum_local, n_shard))
    else:
        got = fn(xs)
    got_img = unpack_image_sharded(np.asarray(got), fn.local_out_spec,
                                   n_shard)
    np.testing.assert_array_equal(got_img, want_img)


@pytest.mark.parametrize("n_shard", [2, 4])
def test_sp_packed_conv_bit_exact(n_shard, rng):
    from deepfusion_tpu.ops.packed import PackedConvOp
    from test_packed import build_cfg

    hw = 16
    cfg, src, wei, bia, wei1, bia1 = build_cfg(2, 32, hw, 32, 1, oc1=32,
                                               rng=rng)
    op = PackedConvOp(cfg, wei, bia, wei1, bia1)
    _sp_packed_check(rng, op, src, n_shard)


def test_sp_packed_conv_dp_composed(rng):
    from deepfusion_tpu.ops.packed import PackedConvOp
    from test_packed import build_cfg

    cfg, src, wei, bia, *_ = build_cfg(4, 32, 16, 32, 1, rng=rng)
    op = PackedConvOp(cfg, wei, bia)
    _sp_packed_check(rng, op, src, 2, dp=2)


def test_sp_packed_conv_sum_postop(rng):
    import dataclasses
    from deepfusion_tpu.ops.packed import PackedConvOp, PackedSpec
    from test_packed import build_cfg
    from helpers import fill_data

    hw = 16
    cfg, src, wei, bia, *_ = build_cfg(2, 32, hw, 32, 1, rng=rng)
    cfg = dataclasses.replace(cfg, with_sum=True, sum_dt=cfg.dst_dt,
                              sum_scale=0.5)
    sum_spec = PackedSpec.make(hw, hw, 32, halo=1, col_off=1)
    op = PackedConvOp(cfg, wei, bia, sum_spec=sum_spec)
    sum_src = fill_data((2, hw, hw, 32), "u8", rng)
    _sp_packed_check(rng, op, src, 2, sum_src=sum_src)


def test_sp_packed_pool2(rng):
    from deepfusion_tpu.ops.packed import PackedConvOp, PackedSpec
    from test_packed import build_cfg

    hw = 16
    cfg, src, wei, bia, *_ = build_cfg(2, 32, hw, 32, 1, rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=2, col_off=2, iwp=32)
    op = PackedConvOp(cfg, wei, bia, sin=sin, halo_out=2, col_off_out=2,
                      pool2=True)
    _sp_packed_check(rng, op, src, 2)


@pytest.mark.parametrize("n_shard", [2, 4])
def test_sp_packed_pair_megakernel(n_shard, rng):
    from deepfusion_tpu.ops.mega import PackedConvPairOp
    from deepfusion_tpu.ops.packed import PackedSpec
    from test_packed import build_cfg

    hw = 16
    cfg_a, src, wa, ba, wa1, ba1 = build_cfg(2, 32, hw, 32, 1, oc1=32,
                                             rng=rng)
    cfg_b, _, wb, bb, wb1, bb1 = build_cfg(2, 32, hw, 32, 1, oc1=32,
                                           rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=3, col_off=1)
    pair = PackedConvPairOp(cfg_a, (wa, ba, wa1, ba1),
                            cfg_b, (wb, bb, wb1, bb1), sin=sin,
                            halo_out=1)
    _sp_packed_check(rng, pair, src, n_shard)


def test_sp_packed_pair_rejects_shallow_halo(rng):
    """A pair with the shallowest legal halos (1) shards layer by layer,
    one halo exchange per layer, and stays exact."""
    from deepfusion_tpu.ops.mega import PackedConvPairOp
    from test_packed import build_cfg

    cfg_a, src, wa, ba, *_ = build_cfg(2, 32, 16, 32, 1, rng=rng)
    cfg_b, _, wb, bb, *_ = build_cfg(2, 32, 16, 32, 1, rng=rng)
    pair = PackedConvPairOp(cfg_a, (wa, ba), cfg_b, (wb, bb))  # halo 1
    _sp_packed_check(rng, pair, src, 2)


def test_sp_packed_pair_msplit_pool2(rng):
    """sp_packed composes with the pair's pool2 step."""
    from deepfusion_tpu.ops.mega import PackedConvPairOp
    from deepfusion_tpu.ops.packed import PackedSpec
    from test_packed import build_cfg

    hw = 16
    cfg_a, src, wa, ba, *_ = build_cfg(2, 32, hw, 32, 1, rng=rng)
    cfg_b, _, wb, bb, *_ = build_cfg(2, 32, hw, 32, 1, rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=4, col_off=2, iwp=32)
    pair = PackedConvPairOp(cfg_a, (wa, ba), cfg_b, (wb, bb), sin=sin,
                            halo_out=2, col_off_out=2, pool2=True)
    _sp_packed_check(rng, pair, src, 2)


def test_sp_packed_split_path_conv(rng):
    """Exercise the interior/boundary OVERLAP SPLIT on a wide row: the
    wrapper computes the interior rows from the pre-exchange array and
    the boundary rows from the exchanged one (three conv calls)."""
    from deepfusion_tpu.ops.packed import PackedConvOp, PackedSpec
    from helpers import fill_data

    hw = 32
    src = fill_data((1, hw, hw, 32), "u8", rng)
    wei = fill_data((32, 32, 3, 3), "s8", rng)
    bia = fill_data((32,), "s32", rng)
    cfg = ConvConfig.make((1, hw, hw, 32), (32, 32, 3, 3), bia.dtype,
                          (1, 1), (1, 1), (1, hw, hw, 32), "u8",
                          conv0_relu=True, conv0_scales=(0.02,))
    sin = PackedSpec.make(hw, hw, 32, halo=1, col_off=1, iwp=1024)
    op = PackedConvOp(cfg, wei, bia, sin=sin)
    _sp_packed_check(rng, op, src, 2, expect_split=True)


def test_sp_packed_split_path_pair(rng):
    """The conv pair through the interior/boundary split (one split per
    layer)."""
    from deepfusion_tpu.ops.mega import PackedConvPairOp
    from deepfusion_tpu.ops.packed import PackedSpec
    from test_packed import build_cfg

    hw = 32
    cfg_a, src, wa, ba, *_ = build_cfg(1, 32, hw, 32, 1, rng=rng)
    cfg_b, _, wb, bb, *_ = build_cfg(1, 32, hw, 32, 1, rng=rng)
    sin = PackedSpec.make(hw, hw, 32, halo=3, col_off=1, iwp=1024)
    pair = PackedConvPairOp(cfg_a, (wa, ba), cfg_b, (wb, bb), sin=sin,
                            halo_out=1, col_off_out=1)
    _sp_packed_check(rng, pair, src, 2, expect_split=True)


def test_sp_packed_multi_input_sum(rng):
    """sp_packed over a branch-merge op: TWO lane-concatenated inputs
    (each sharded and halo-exchanged) plus a packed sum operand."""
    import dataclasses
    from deepfusion_tpu.ops.packed import (PackedConvOp, PackedSpec,
                                           pack_image, pack_image_sharded,
                                           unpack_image,
                                           unpack_image_sharded)
    from deepfusion_tpu.parallel import sp_packed
    from deepfusion_tpu.types import dtype as dt

    need_devices(2)
    mb, hw, ca, cb, oc = 2, 16, 32, 32, 32
    srca = fill_data((mb, hw, hw, ca), "u8", rng)
    srcb = fill_data((mb, hw, hw, cb), "u8", rng)
    wei = fill_data((oc, ca + cb, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    cfg = ConvConfig.make((mb, hw, hw, ca + cb), (oc, ca + cb, 3, 3),
                          bia.dtype, (1, 1), (1, 1), (mb, hw, hw, oc),
                          "u8", conv0_scales=(0.05,))
    cfg = dataclasses.replace(cfg, with_sum=True, sum_dt=dt.u8,
                              sum_scale=0.7)
    sa = PackedSpec.make(hw, hw, ca, cp=ca)
    sb = PackedSpec.make(hw, hw, cb, cp=cb)
    ssum = PackedSpec.make(hw, hw, oc)
    op = PackedConvOp(cfg, wei, bia, sin=(sa, sb), sum_spec=ssum)
    sum_src = fill_data((mb, hw, hw, oc), "u8", rng)

    want = unpack_image(np.asarray(op(
        (pack_image(srca, sa), pack_image(srcb, sb)),
        pack_image(sum_src, ssum))), op.sout)

    fn = sp_packed(op, make_mesh(sp=2))
    xs = tuple(pack_image_sharded(s, spec, 2) for s, spec in
               ((srca, fn.local_specs[0]), (srcb, fn.local_specs[1])))
    sum_local = dataclasses.replace(ssum, h=hw // 2)
    got = fn(xs, pack_image_sharded(sum_src, sum_local, 2))
    got_img = unpack_image_sharded(np.asarray(got), fn.local_out_spec, 2)
    np.testing.assert_array_equal(got_img, want)


@pytest.mark.parametrize("wire", ["psum", "reduce_scatter"])
def test_tp_packed_fused_bit_exact(wire, rng):
    """Packed-domain TP (round 5): conv0 oc sharded, partial 1x1 s32
    accumulators completed by the collective BEFORE the final requant,
    bit-identical to the single-device PackedConvOp."""
    from deepfusion_tpu.ops.packed import PackedConvOp, pack_image
    from deepfusion_tpu.parallel.shard import tp_packed_fused
    from test_packed import build_cfg

    need_devices(2)
    hw = 12
    cfg, src, wei, bia, wei1, bia1 = build_cfg(2, 32, hw, 64, 1, oc1=32,
                                               rng=rng)
    op = PackedConvOp(cfg, wei, bia, wei1, bia1)
    x = pack_image(src, op.sin)
    want = np.asarray(op(x))
    got = np.asarray(tp_packed_fused(op, make_mesh(tp=2), wire=wire)(x))
    np.testing.assert_array_equal(got, want)


def test_tp_packed_fused_4way_strided_sparse(rng):
    """TP over a wide strided packed op (space-to-depth grid)."""
    from deepfusion_tpu.ops.packed import PackedConvOp, pack_image
    from deepfusion_tpu.parallel.shard import tp_packed_fused
    from helpers import fill_data

    need_devices(4)
    mb, hw, ic, oc, oc1 = 1, 10, 128, 128, 32
    oh = conv_output_size_local(hw, 3, 2, 1)
    src = fill_data((mb, hw, hw, ic), "u8", rng)
    wei = fill_data((oc, ic, 3, 3), "s8", rng)
    bia = fill_data((oc,), "s32", rng)
    wei1 = fill_data((oc1, oc, 1, 1), "s8", rng)
    bia1 = fill_data((oc1,), "s32", rng)
    cfg = ConvConfig.make(
        (mb, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (2, 2), (1, 1),
        (mb, oh, oh, oc1), "u8", conv0_relu=True, conv0_scales=(0.02,),
        wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=bia1.dtype,
        conv1_relu=True, conv1_scales=(0.4,))
    op = PackedConvOp(cfg, wei, bia, wei1, bia1)
    x = op.pack_input(src)
    want = np.asarray(op(x))
    got = np.asarray(tp_packed_fused(op, make_mesh(tp=4))(x))
    np.testing.assert_array_equal(got, want)


def conv_output_size_local(i, k, s, p):
    from deepfusion_tpu.utils.mathutil import conv_output_size
    return conv_output_size(i, k, s, p)


def test_sp_packed_overlap_trace_order(rng):
    """The halo ppermutes must be ISSUED before the interior Pallas call
    in trace order (the overlap contract). Walks the shard_map
    body: in split mode, both ppermutes precede the first pallas_call."""
    from deepfusion_tpu.ops.packed import (PackedConvOp, PackedSpec,
                                           pack_image_sharded)
    from deepfusion_tpu.parallel import sp_packed
    from helpers import fill_data

    need_devices(2)
    hw = 32
    src = fill_data((1, hw, hw, 32), "u8", rng)
    wei = fill_data((32, 32, 3, 3), "s8", rng)
    bia = fill_data((32,), "s32", rng)
    cfg = ConvConfig.make((1, hw, hw, 32), (32, 32, 3, 3), bia.dtype,
                          (1, 1), (1, 1), (1, hw, hw, 32), "u8",
                          conv0_relu=True, conv0_scales=(0.02,))
    sin = PackedSpec.make(hw, hw, 32, halo=1, col_off=1, iwp=1024)
    op = PackedConvOp(cfg, wei, bia, sin=sin)
    fn = sp_packed(op, make_mesh(sp=2))
    xs = pack_image_sharded(src, fn.local_spec, 2)
    jaxpr = jax.make_jaxpr(lambda a: fn(a))(xs)

    def find_shmap(jx):
        jx = getattr(jx, "jaxpr", jx)
        for eqn in jx.eqns:
            if eqn.primitive.name == "shard_map":
                return eqn.params["jaxpr"]
            for v in eqn.params.values():
                if hasattr(v, "jaxpr") or hasattr(v, "eqns"):
                    r = find_shmap(v)
                    if r is not None:
                        return r
        return None

    body = getattr(find_shmap(jaxpr), "jaxpr", find_shmap(jaxpr))
    assert body is not None

    def order_of(jx, name):
        jx = getattr(jx, "jaxpr", jx)
        idx = []
        for i, eqn in enumerate(jx.eqns):
            found = eqn.primitive.name == name
            if not found:
                for v in eqn.params.values():
                    vs = v if isinstance(v, (tuple, list)) else (v,)
                    for u in vs:
                        if (hasattr(u, "jaxpr") or hasattr(u, "eqns")) \
                                and _count_prims(u, name):
                            found = True
            if found:
                idx.append(i)
        return idx

    perms = order_of(body, "ppermute")
    pallas = order_of(body, "pallas_call")
    assert len(perms) >= 2 and pallas, (perms, pallas)
    assert max(perms[:2]) < pallas[0], \
        f"ppermutes at {perms} must precede the interior pallas_call " \
        f"at {pallas[0]}"


def test_tp_packed_fused_fail_fast(rng):
    """Unsupported configs reject before compile (util/log.h contract)."""
    from deepfusion_tpu.ops.packed import PackedConvOp, PackedSpec
    from deepfusion_tpu.parallel.shard import tp_packed_fused
    from deepfusion_tpu.utils.logger import CheckError
    from test_packed import build_cfg

    need_devices(2)
    mesh = make_mesh(tp=2)
    # not fused
    cfg, src, wei, bia, *_ = build_cfg(1, 32, 12, 64, 1, rng=rng)
    with pytest.raises(CheckError):
        tp_packed_fused(PackedConvOp(cfg, wei, bia), mesh)
    # pool2 epilogue
    cfgf, _, wf, bf, wf1, bf1 = build_cfg(1, 32, 12, 64, 1, oc1=32,
                                          rng=rng)
    sin = PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=32)
    pool_op = PackedConvOp(cfgf, wf, bf, wf1, bf1, sin=sin, halo_out=2,
                           col_off_out=2, pool2=True)
    with pytest.raises(CheckError):
        tp_packed_fused(pool_op, mesh)
    # oc not divisible
    cfg3, _, w3, b3, w31, b31 = build_cfg(1, 32, 12, 48, 1, oc1=32,
                                          rng=rng)
    need_devices(5)
    with pytest.raises(CheckError):
        tp_packed_fused(PackedConvOp(cfg3, w3, b3, w31, b31),
                        make_mesh(tp=5))
