#!/usr/bin/env python3
"""Smoke check of the INT8 engine on one GPU (or four, with ``--four``).

    python chip_smoke.py           # one card: ops, FusionNet, server, timing
    python chip_smoke.py --four    # four cards: dp / sp / tp / 3-stage plan

Every check compares against the numpy oracles of ``deepfusion_tpu/ops/
ref.py`` (float64 accumulation, exact) or against the single-device
result, and must be exact. The last line of standard output is one JSON
object, ``{"ok": true, "device": {...}}``, printed only when every phase
passed. The script exits non-zero, printing no result, when JAX finds no
GPU or any phase fails. Everything runs in this one process.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FLAGSHIP = dict(n=8, hw=126, ic=256, oc=256, oc1=256)
FUSIONNET = dict(batch=8, hw=56, in_ch=32, width=128, num_classes=128)


def card_info() -> str:
    """Name and power limit of the card, read without JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def time_call(f, *args, n: int = 20):
    """(median of n blocking calls, mean of n back-to-back calls), in us,
    after a warm-up."""
    import jax

    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.2:
        jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t)
    t = time.perf_counter()
    for _ in range(n):
        out = f(*args)
    jax.block_until_ready(out)
    loop = (time.perf_counter() - t) / n
    return float(np.median(ts) * 1e6), float(loop * 1e6)


def _mem(f, *args) -> str:
    m = f.lower(*args).compile().memory_analysis()
    if m is None:
        return "memory_analysis: n/a"
    return (f"args {m.argument_size_in_bytes} B, out "
            f"{m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B")


def _maxdiff(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def _conv_case(rng, n, hw, ic, oc, *, oc1=None, stride=1, sum_dt=None,
               dst="u8"):
    from deepfusion_tpu.config import ConvConfig
    from deepfusion_tpu.utils.mathutil import conv_output_size

    oh = conv_output_size(hw, 3, stride, 1)
    wei = rng.integers(-16, 17, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-500, 501, oc).astype(np.int32)
    acc_std = np.sqrt(9 * ic) * 74.0 * 9.2
    kw = dict(conv0_relu=True,
              conv0_scales=rng.uniform(0.8, 1.2, oc).astype(np.float32)
              * np.float32(48.0 / acc_std))
    w1 = b1 = None
    if oc1:
        w1 = rng.integers(-16, 17, (oc1, oc, 1, 1)).astype(np.int8)
        b1 = rng.integers(-500, 501, oc1).astype(np.int32)
        kw.update(wei1x1_shape=w1.shape, bia1x1_dt=b1.dtype,
                  conv1_relu=True,
                  conv1_scales=rng.uniform(0.8, 1.2, oc1).astype(np.float32)
                  * np.float32(48.0 / (np.sqrt(oc) * 30.0 * 9.2)))
    cfg = ConvConfig.make((n, hw, hw, ic), wei.shape, bia.dtype,
                          (stride, stride), (1, 1),
                          (n, oh, oh, oc1 or oc), dst, sum_dt=sum_dt,
                          sum_scale=0.5, **kw)
    x = rng.integers(0, 256, (n, hw, hw, ic)).astype(np.uint8)
    return cfg, x, wei, bia, w1, b1


def op_phase(rng, flagship=FLAGSHIP, small: int = 1, log=print):
    """Each op at real widths against ops/ref.py. ``small`` divides the
    spatial sizes (tests run it tiny). Returns the list of results."""
    import jax
    import jax.numpy as jnp

    from deepfusion_tpu.config import ConcatConfig, PoolConfig
    from deepfusion_tpu.ops import ref
    from deepfusion_tpu.ops.concat import _concat_call
    from deepfusion_tpu.ops.conv import ConvOp, _conv_call
    from deepfusion_tpu.ops.pool import _pool_call, _sum_relu_call
    from deepfusion_tpu.types import dtype

    results = []

    def record(name, impl, f, args, got, want):
        d = _maxdiff(got, want)
        results.append(dict(op=name, impl=impl, max_abs_diff=d))
        log(f"[op] {name}: impl={impl} max_abs_diff={d} "
            f"{_mem(f, *args)}")

    def conv_check(name, cfg, x, wei, bia, w1, b1, sum_src=None):
        op = ConvOp(cfg, wei, bia, w1, b1)
        ops = [jnp.asarray(o) for o in op._operands]
        f = jax.jit(lambda x, s, *o: _conv_call(cfg, x, *o, sum_src=s))
        args = (jnp.asarray(x), None if sum_src is None
                else jnp.asarray(sum_src), *ops)
        got = f(*args)
        want = ref.conv_ref(cfg, x, wei, bia, w1, b1, sum_src=sum_src)
        impl = ("pallas-triton df_flat_conv" if cfg.sh == 1
                else "xla (strided taps + int8 GEMM)")
        record(name, impl, f, args, got, want)

    fs = flagship
    hw = max(fs["hw"] // small, 4)
    cfg, x, wei, bia, w1, b1 = _conv_case(rng, fs["n"], hw, fs["ic"],
                                          fs["oc"], oc1=fs["oc1"])
    conv_check(f"fused conv3x3+1x1 {fs['n']}x{hw}^2x{fs['ic']}"
               f"->{fs['oc']}->{fs['oc1']}", cfg, x, wei, bia, w1, b1)

    hw = max(56 // small, 4)
    cfg, x, wei, bia, _, _ = _conv_case(rng, 8, hw, 128, 128, sum_dt="u8")
    s = rng.integers(0, 256, (8, hw, hw, 128)).astype(np.uint8)
    conv_check(f"conv3x3+sum 8x{hw}^2x128", cfg, x, wei, bia, None, None,
               sum_src=s)

    cfg, x, wei, bia, _, _ = _conv_case(rng, 8, hw, 256, 256, stride=2)
    conv_check(f"conv3x3/s2 8x{hw}^2x256", cfg, x, wei, bia, None, None)

    hw = max(244 // small, 4)
    srcs = [rng.integers(-128, 128, (4, hw, hw, c)).astype(np.int8)
            for c in (128, 256, 128, 256)]
    ccfg = ConcatConfig.make([s.shape for s in srcs], "s8", True)
    f = jax.jit(lambda *a: _concat_call(ccfg, *a))
    args = [jnp.asarray(s) for s in srcs]
    record(f"concat+relu 4x{hw}^2x{{128,256,128,256}} s8", "xla", f, args,
           f(*args), ref.concat_relu_ref(srcs, True))

    hw = max(112 // small, 4)
    x = rng.integers(0, 256, (8, hw, hw, 128)).astype(np.uint8)
    for kind, k, s_, p in (("max", 2, 2, 0), ("avg_exc", 3, 1, 1)):
        pc = PoolConfig.make(kind, (hw, hw), (k, k), (s_, s_), (p, p))
        f = jax.jit(lambda a, pc=pc: _pool_call(pc, dtype.u8, a))
        a = jnp.asarray(x)
        record(f"pool {kind} {k}x{k}/s{s_} 8x{hw}^2x128 u8", "xla", f, (a,),
               f(a), ref.pool_ref(x, pc))

    hw = max(56 // small, 4)
    a = rng.integers(0, 256, (8, hw, hw, 256)).astype(np.uint8)
    b = rng.integers(0, 256, (8, hw, hw, 256)).astype(np.uint8)
    f = jax.jit(lambda a, b: _sum_relu_call(dtype.u8, True, a, b))
    args = (jnp.asarray(a), jnp.asarray(b))
    record(f"eltwise sum+relu 8x{hw}^2x256 u8", "xla", f, args, f(*args),
           ref.eltwise_sum_relu_ref(a, b, True))
    return results


def model_phase(net, log=print):
    """FusionNet logits vs the oracle composition; packed_call vs
    __call__. Returns (results, jitted forward, example input)."""
    import jax

    x = net.example_input()
    fwd = jax.jit(net.__call__)
    got = np.asarray(fwd(x))
    want = net.reference(x)
    # f32 head: exact expected; the reference's own f32 tolerance is 1e-4
    # relative (test/test_utils.h:73-85)
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6)))
    packed = np.asarray(net.jit_packed()(x))
    res = [dict(check="fusionnet logits vs oracle",
                max_abs_diff=_maxdiff(got, want), max_rel_diff=rel,
                ok=bool(rel <= 1e-4)),
           dict(check="packed_call == __call__",
                max_abs_diff=_maxdiff(packed, got),
                ok=bool(np.array_equal(packed, got)))]
    for r in res:
        log(f"[model] {r}")
    log(f"[model] forward {_mem(fwd, x)}")
    return res, fwd, x


def serving_phase(net, fwd, n_requests: int = 20, log=print):
    """BatchServer over the jitted forward: every answer equals the
    matching row of the direct forward (the last flush is padded)."""
    from deepfusion_tpu.serving import BatchServer

    rng = np.random.default_rng(5)
    batch = net.cfg.batch
    xs = rng.integers(0, 256, (n_requests,) + net.input_shape[1:],
                      dtype=np.uint8)
    with BatchServer(fwd, batch=batch, input_shape=net.input_shape[1:],
                     max_delay_ms=2.0) as srv:
        futs = [srv.submit(x) for x in xs]
        answers = [f.result(timeout=600) for f in futs]
        stats = dict(srv.stats)
    pad = -n_requests % batch
    full = np.concatenate([xs, np.zeros((pad,) + xs.shape[1:], xs.dtype)])
    direct = np.concatenate([np.asarray(fwd(full[i:i + batch]))
                             for i in range(0, len(full), batch)])
    ok = all(np.array_equal(a, direct[i]) for i, a in enumerate(answers))
    res = dict(check=f"{n_requests} served answers == direct forward",
               ok=bool(ok), flushes=stats["flushes"],
               padded_rows=stats["padded_rows"])
    log(f"[serve] {res}")
    return res


def timing_phase(rng, net, flagship=FLAGSHIP, n: int = 20, log=print):
    """The hand-written conv kernel against XLA's plain version (the same
    math as whole-array ops: im2col + int8 GEMM), at the flagship op and
    inside the FusionNet forward."""
    import jax
    import jax.numpy as jnp

    from deepfusion_tpu.ops.conv import ConvOp, _conv_call, use_impl

    fs = flagship
    cfg, x, wei, bia, w1, b1 = _conv_case(rng, fs["n"], fs["hw"], fs["ic"],
                                          fs["oc"], oc1=fs["oc1"])
    ops = [jnp.asarray(o) for o in ConvOp(cfg, wei, bia, w1, b1)._operands]
    xd = jnp.asarray(x)
    xm = jnp.asarray(net.example_input())
    out = {}
    for impl in ("triton", "xla"):
        with use_impl(impl):
            f = jax.jit(lambda x, *o: _conv_call(cfg, x, *o))
            out[f"flagship_{impl}"] = time_call(f, xd, *ops, n=n)
            fwd = jax.jit(net.__call__)
            out[f"fusionnet_{impl}"] = time_call(fwd, xm, n=n)
    for k, (med, loop) in out.items():
        log(f"[time] {k}: median {med:.1f} us, back-to-back {loop:.1f} us")
    return out


def four_phase(rng, small: int = 1, log=print):
    """dp=4 FusionNet, the 3-stage plan on factorize_mesh(4), tp_fused_conv
    and sp_conv at flagship widths — each bit-exact with one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepfusion_tpu.models import FusionNet, FusionNetConfig
    from deepfusion_tpu.ops.conv import ConvOp
    from deepfusion_tpu.parallel import (factorize_mesh, make_mesh,
                                         sp_conv, tp_fused_conv)
    from deepfusion_tpu.parallel.plan import three_stage_plan

    results = []

    def record(name, got, want, sharded):
        ids = sorted({s.device.id for s in sharded.addressable_shards})
        r = dict(check=name, exact=bool(np.array_equal(
            np.asarray(got), np.asarray(want))), shard_devices=ids)
        results.append(r)
        log(f"[four] {r}")

    one = jax.devices()[0]
    mesh = make_mesh(dp=4)
    fc = dict(FUSIONNET, hw=max(FUSIONNET["hw"] // small, 8))
    net = FusionNet(FusionNetConfig(**fc))
    fwd = jax.jit(jax.shard_map(net.__call__, mesh=mesh,
                                in_specs=P("dp", None, None, None),
                                out_specs=P("dp", None), check_vma=False))
    xs = rng.integers(0, 256, (4 * fc["batch"],) + net.input_shape[1:],
                      dtype=np.uint8)
    xg = jax.device_put(xs, jax.NamedSharding(
        mesh, P("dp", None, None, None)))
    got = fwd(xg)
    single = jax.jit(net.__call__)
    want = np.concatenate([np.asarray(single(jax.device_put(
        xs[i:i + fc["batch"]], one))) for i in range(0, len(xs),
                                                    fc["batch"])])
    record("dp=4 FusionNet", got, want, got)

    dp, sp, tp = factorize_mesh(4)
    mesh = make_mesh(dp=dp, sp=sp, tp=tp)
    mb, hw = 2 * dp, max(64 // small, 8) * sp
    src = rng.integers(0, 256, (mb, hw, hw, 128), dtype=np.uint8)
    plan, _, _ = three_stage_plan(mesh, mb, hw, 128, 128 * tp, 128,
                                  rng=np.random.default_rng(3))
    got = jax.jit(plan)(jnp.asarray(src))
    one_mesh = make_mesh(devices=[one])
    plan1, _, _ = three_stage_plan(one_mesh, mb, hw, 128, 128 * tp, 128,
                                   rng=np.random.default_rng(3))
    want = jax.jit(plan1)(jax.device_put(src, one))
    record(f"three_stage_plan dp={dp} sp={sp} tp={tp}", got, want, got)

    fs = FLAGSHIP
    hw = max(fs["hw"] // small, 8) // 4 * 4
    cfg, x, wei, bia, w1, b1 = _conv_case(rng, 2, hw, fs["ic"], fs["oc"],
                                          oc1=fs["oc1"])
    op = ConvOp(cfg, wei, bia, w1, b1)
    want = np.asarray(op(jax.device_put(x, one)))
    got = tp_fused_conv(cfg, wei, bia, w1, b1, make_mesh(tp=4))(x)
    record(f"tp_fused_conv tp=4 {hw}^2x{fs['ic']}", got, want, got)
    cfg, x, wei, bia, _, _ = _conv_case(rng, 2, hw, fs["ic"], fs["oc"])
    op = ConvOp(cfg, wei, bia)
    want = np.asarray(op(jax.device_put(x, one)))
    got = sp_conv(op, make_mesh(sp=4))(x)
    record(f"sp_conv sp=4 {hw}^2x{fs['ic']}", got, want, got)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its comparisons")
    args = ap.parse_args(argv)

    import jax

    from deepfusion_tpu.utils import env

    devs = jax.devices()
    print(f"devices: {devs}  jax {jax.__version__}", flush=True)
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform}", file=sys.stderr)
        return 1
    if args.four and len(devs) < 4:
        print(f"--four needs 4 GPUs, JAX found {len(devs)}",
              file=sys.stderr)
        return 1
    print(f"compile cache: {env.enable_compile_cache()}", flush=True)
    print(f"card: {card_info()}", flush=True)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    ok = True
    if args.four:
        res = four_phase(rng)
        ok = all(r["exact"] for r in res) and all(
            len(r["shard_devices"]) > 1 for r in res)
    else:
        from deepfusion_tpu.models import FusionNet, FusionNetConfig

        res = op_phase(rng)
        ok &= all(r["max_abs_diff"] == 0 for r in res)
        net = FusionNet(FusionNetConfig(**FUSIONNET))
        mres, fwd, _ = model_phase(net)
        ok &= all(r["ok"] for r in mres)
        ok &= serving_phase(net, fwd)["ok"]
        timing_phase(rng, net)
    print(f"elapsed {time.perf_counter() - t0:.1f} s; card: {card_info()}",
          flush=True)
    if not ok:
        print("FAILED: a check did not hold", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
