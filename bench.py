"""deepfusion_tpu benchmark harness.

Reference-parity protocol (``benchmark/bench_concat.cc:86-121``): warm-up
then timed iterations, averaged. The timed work is a chain of N
data-dependent iterations inside ONE jit (a ``fori_loop`` with a DYNAMIC
trip count feeding each iteration's output into the next input, so nothing
can be elided and the paired short/long chains share one compile), ending
in a scalar checksum whose host readback forces completion. Per-iteration
time = paired-chain difference / 3N (the difference cancels the fixed
per-call dispatch and readback cost), median of spread reps
(timeit_chain). A SIGTERM/SIGALRM mid-run prints the median of the reps
completed so far, flagged ``"partial": true``.

Headline metric: the fused INT8 conv3x3+relu+conv1x1+relu chain as % of
the device's published INT8 peak (``PEAKS``), counting LOGICAL MACs
(2 * oh*ow*(kh*kw*ic*oc + oc*oc1x1) per image) — no credit for padding.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}
vs_baseline is value / 90.0 (the reference itself publishes no numbers,
BASELINE.md).
"""
import argparse
import json
import os
import signal
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Published dense peaks by device_kind (NVIDIA H100 data sheet, SXM part,
# at its full 700 W power limit): int8 tensor-core ops/s, HBM bytes/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops": 1979e12, "hbm_bytes": 3.35e12},
}


def peak_for(kind: str) -> dict:
    """The peak row of a device kind; an unknown device is an error, never
    a default."""
    if kind not in PEAKS:
        raise SystemExit(f"no published peak for device {kind!r}; add it "
                         f"to bench.PEAKS with its source")
    return PEAKS[kind]


def peak_ops():
    import jax

    kind = jax.devices()[0].device_kind
    return peak_for(kind)["int8_ops"], kind


def _timed_readback(fn, *args):
    t0 = time.perf_counter()
    float(fn(*args))
    return time.perf_counter() - t0


def make_chain(step_fn, with_aux=False):
    """ONE jitted chain of a dynamic number of data-dependent step_fn
    applications ending in a scalar checksum (the readback forces true
    completion). The trip count is a traced scalar so the short and long
    chains of the paired protocol share a single compile.

    with_aux: step_fn takes (carry, aux) and aux (e.g. the op's packed
    weights) is threaded through as a jit ARGUMENT instead of closed
    over. Closed-over weights embed as program constants, so every new
    weight set is a fresh compile cache key; as arguments the compile is
    keyed on SHAPES only — the reference's JIT-per-config behavior
    (src/jit_conv_kernel.cc init_conf), and a ~10-minute remote-compile
    saving per weight change."""
    import jax
    import jax.numpy as jnp

    def checksum(tree):
        leaves = jax.tree_util.tree_leaves(tree)
        return sum(l.astype(jnp.float32).sum() for l in leaves)

    if with_aux:
        @jax.jit
        def chain(x, n, aux):
            x = jax.lax.fori_loop(0, n, lambda i, c: step_fn(c, aux), x)
            return checksum(x)
    else:
        @jax.jit
        def chain(x, n, aux):
            del aux
            x = jax.lax.fori_loop(0, n, lambda i, c: step_fn(c), x)
            return checksum(x)
    return chain


# Incremental measurement state consulted by the timeout handler: every
# completed rep lands here, so a timeout degrades the reported number's
# precision instead of erasing it. "result" freezes a COMPLETED primary
# measurement: once a bench's main timeit_chain finishes, later auxiliary
# chains (e.g. the --compare-xla baseline) overwrite "diffs", and an
# interrupt must emit the frozen result, never the auxiliary diffs under
# the primary metric.
_PARTIAL = {"diffs": [], "iters": 0, "builder": None, "done": False,
            "result": None}


def timeit_chain(step_fn, x0, iters, reps=5, spread_s=10.0, aux=None):
    """Seconds per iteration of step_fn (x -> x, same pytree structure).

    Protocol: PAIRED chains — `iters` and `4*iters` data-dependent
    applications run back-to-back; per-iteration time = (wall_long -
    wall_short) / (3*iters). The subtraction cancels the fixed per-call
    cost (dispatch, checksum readback) measured in the same instant. Both
    lengths run through ONE compiled function with a dynamic trip count
    (make_chain).

    The per-rep difference still carries the variance of that fixed cost,
    so (a) the per-iteration cost must dominate the difference (use
    iters >= 64 for sub-ms kernels) and (b) the MEDIAN of reps is
    reported, never the min: the median of a symmetric-noise difference
    is unbiased, while min() compounds with rep count. reps are spread
    over `spread_s` seconds so a transient slow phase doesn't dominate
    every sample."""
    import jax.numpy as jnp

    chain = make_chain(step_fn, with_aux=aux is not None)
    n1 = jnp.int32(iters)
    n4 = jnp.int32(4 * iters)
    _PARTIAL["diffs"] = diffs = []
    _PARTIAL["iters"] = iters
    float(chain(x0, n1, aux))           # compile + warm (excluded from reps)
    gap = spread_s / max(reps - 1, 1)
    for r in range(reps):
        if r and gap:
            time.sleep(gap)
        t1 = _timed_readback(chain, x0, n1, aux)
        t4 = _timed_readback(chain, x0, n4, aux)
        diffs.append((t4 - t1) / (3 * iters))
    return _median_sec(diffs)


def _median_sec(diffs):
    s = sorted(diffs)
    return max(s[len(s) // 2], 1e-12)


def _partial_result():
    """The JSON line a mid-run interruption should print: the median of
    completed reps flagged partial, or a zero-valued note line when the
    signal lands before the first measurement. None if the full result
    already printed."""
    if _PARTIAL["done"]:                      # full line already printed
        return None
    if _PARTIAL["result"] is not None:        # primary measurement done;
        return _PARTIAL["result"]             # interrupt hit an aux chain
    builder, diffs = _PARTIAL["builder"], _PARTIAL["diffs"]
    if builder is not None and diffs:
        result = builder(_median_sec(diffs))
        result.update(partial=True, reps_completed=len(diffs))
        return result
    # before the first measurement: take the ACTIVE bench's metric/unit
    # from its builder (pure function of sec) instead of hardcoding the
    # fused headline name (a conv/concat/model interrupt must not file a
    # zero under the wrong metric)
    if builder is not None:
        probe = builder(1.0)
        metric, unit = probe["metric"], probe["unit"]
    else:
        metric, unit = "fused_conv3x3_1x1_int8_roofline_pct", "%"
    return {"metric": metric, "value": 0.0, "unit": unit,
            "vs_baseline": 0.0, "partial": True, "reps_completed": 0,
            "note": "timeout before first measurement"}


def _emit_partial(signum, frame):
    """SIGTERM/SIGINT/SIGALRM: print a parseable JSON line from whatever
    reps completed, flagged partial, then exit. `timeout N python bench.py`
    therefore always yields a number once at least one rep (or nothing but
    a note, if the signal lands mid-compile) exists."""
    result = _partial_result()
    if result is None:
        raise SystemExit(0)
    print(json.dumps(result), flush=True)
    os._exit(0)


def bench_fused(args):
    """Flagship: fused conv3x3+relu+conv1x1+relu, wide channels.

    Default path is the layout-persistent packed-domain op (ops/packed.py):
    activations stay in the padded/shifted s8 layout between convs, exactly
    as a multi-layer int8 model would run them — no per-op HBM prep pass.
    --dense measures the standalone dense-in/dense-out op instead.

    Chain protocol: the default is the REFERENCE-PARITY fresh-inputs
    loop — each step re-runs the op on the same source buffers (exactly
    bench_concat.cc:141-160's repeated submission) with the data
    dependence through one element folded back in place. --carry chains
    producer->consumer instead (the output buffer feeds the next step's
    input), as adjacent layers of a model do."""
    from deepfusion_tpu.config import ConvConfig
    from deepfusion_tpu.ops.conv import ConvOp
    from deepfusion_tpu.ops.packed import PackedConvOp, pack_image

    n, hw, ic, oc, oc1 = args.batch, args.hw, args.ic, args.oc, args.oc1x1
    if oc1 != ic:
        raise SystemExit("--oc1x1 must equal --ic (output feeds next input)")
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (n, hw, hw, ic), dtype=np.uint8)
    wei = rng.integers(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-100, 101, (oc,)).astype(np.int32)
    wei1 = rng.integers(-127, 128, (oc1, oc, 1, 1)).astype(np.int8)
    bia1 = rng.integers(-100, 101, (oc1,)).astype(np.int32)
    cfg = ConvConfig.make(
        (n, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (1, 1), (1, 1),
        (n, hw, hw, oc1), "u8", conv0_scales=(0.001,),
        wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=bia1.dtype,
        conv1_relu=True, conv1_scales=(0.05,))
    import jax

    convs_per_step = 1
    if args.dense:
        op = ConvOp(cfg, wei, bia, wei1, bia1)
        x = jax.device_put(src)
    elif args.pair:
        # two chained packed fused convs per step (ops/mega.py)
        from deepfusion_tpu.ops.mega import PackedConvPairOp
        wei_b = rng.integers(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
        bia_b = rng.integers(-100, 101, (oc,)).astype(np.int32)
        wei1_b = rng.integers(-127, 128, (oc1, oc, 1, 1)).astype(np.int8)
        bia1_b = rng.integers(-100, 101, (oc1,)).astype(np.int32)
        op = PackedConvPairOp(cfg, (wei, bia, wei1, bia1),
                              cfg, (wei_b, bia_b, wei1_b, bia1_b))
        x = jax.device_put(pack_image(src, op.sin))
        convs_per_step = 2
    else:
        # DEFAULT: the single packed fused op (ops/packed.py)
        op = PackedConvOp(cfg, wei, bia, wei1, bia1)
        x = jax.device_put(pack_image(src, op.sin))
    macs = convs_per_step * n * hw * hw * (9 * ic * oc + oc * oc1)
    peak, kind = peak_ops()

    def builder(sec):
        pct = 100.0 * (2 * macs / sec) / peak
        return {"metric": "fused_conv3x3_1x1_int8_roofline_pct",
                "value": round(pct, 2), "unit": "%",
                "vs_baseline": round(pct / 90.0, 4)}

    _PARTIAL["builder"] = builder
    # weights ride as jit arguments (shape-keyed compile, make_chain)
    aux = tuple(jax.device_put(np.asarray(a)) for a in op._operands)
    if args.carry:
        def step(c, a):
            return op(c, operands=a)
    else:
        import jax.numpy as jnp

        def step(c, a):
            out = op(c, operands=a)
            bump = (out[(0,) * out.ndim].astype(jnp.int32)
                    & 1).astype(c.dtype)
            return c.at[(0,) * c.ndim].add(bump)

    sec = timeit_chain(step, x, args.iters, aux=aux)
    if builder(sec)["value"] > 100.0:
        # a draw above the hardware peak is a protocol fluke (a host stall
        # inflated the short chain's wall time); re-measure once
        print("# >100% of peak measured: protocol fluke, re-measuring",
              file=sys.stderr)
        sec = timeit_chain(step, x, args.iters, aux=aux)
    _PARTIAL["result"] = builder(sec)   # freeze before any aux chain runs
    ops = 2 * macs / sec
    pct = 100.0 * ops / peak
    imgs = n / sec
    print(f"# fused {n}x{hw}x{hw}x{ic}->3x3:{oc}->1x1:{oc1} "
          f"{sec*1e3:.3f} ms/iter  {imgs:.1f} imgs/s  "
          f"{ops/1e12:.1f} TOPS on {kind}", file=sys.stderr)
    if args.compare_xla:
        # the same op through XLA's plain version of the conv (im2col +
        # int8 GEMM, ops/conv.py _conv_xla) — the "what the compiler does
        # unaided" baseline
        from deepfusion_tpu.ops.conv import use_impl

        with use_impl("xla"):
            sec_x = timeit_chain(step, x, args.iters, aux=aux)
        print(f"# xla-baseline {sec_x*1e3:.3f} ms/iter "
              f"(kernel speedup {sec_x/sec:.2f}x)", file=sys.stderr)
    return builder(sec)


def bench_conv(args):
    """conv3x3 standalone; --stride 2 measures the strided conv. Strided
    chains keep the timing loop data-dependent via a parity bump on the
    input instead of output feedback (spatial shrinks).

    --packed: a PackedConvOp (for strides > 1 its space-to-depth regroup
    runs at pack time, so the chain times what a model pays per conv
    after the one-time model-boundary pack)."""
    from deepfusion_tpu.config import ConvConfig
    from deepfusion_tpu.ops.conv import ConvOp
    from deepfusion_tpu.ops.packed import PackedConvOp
    from deepfusion_tpu.utils.mathutil import conv_output_size

    n, hw, ic, oc, s = args.batch, args.hw, args.ic, args.oc, args.stride
    if s == 1 and oc != ic:
        raise SystemExit("--oc must equal --ic (output feeds next input)")
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (n, hw, hw, ic), dtype=np.uint8)
    wei = rng.integers(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-100, 101, (oc,)).astype(np.int32)
    oh = conv_output_size(hw, 3, s, 1)
    cfg = ConvConfig.make((n, hw, hw, ic), (oc, ic, 3, 3), bia.dtype,
                          (s, s), (1, 1), (n, oh, oh, oc), "u8",
                          conv0_scales=(0.001,))
    import jax
    import jax.numpy as jnp

    kernel_mode = args.packed
    if kernel_mode:
        # stride 1: the layout-persistent packed conv; stride > 1: the
        # stride-1 conv on the space-to-depth grid, regrouped at pack time
        op = PackedConvOp(cfg, wei, bia)
        x = jax.device_put(op.pack_input(src))

        if s == 1 and args.carry:
            def step(x, a):
                return op(x, operands=a)
        else:
            def step(x, a):
                out = op(x, operands=a)
                bump = out[0, 0, 0].astype(jnp.int8) & 1
                return x.at[0, 0, 0].add(bump)
    else:
        op = ConvOp(cfg, wei, bia)
        x = jax.device_put(src)
        if s == 1:
            def step(x, a):
                return op(x, operands=a)
        else:
            def step(x, a):
                out = op(x, operands=a)
                # data dependency through ONE element, not a full-output
                # reduction, which would bill an extra pass to the conv
                bump = (out[0, 0, 0, 0].astype(jnp.int32)
                        & 1).astype(jnp.uint8)
                return x.at[0, 0, 0, 0].add(bump)

    aux = tuple(jax.device_put(np.asarray(a)) for a in op._operands)
    peak, kind = peak_ops()
    if s == 1:
        metric = ("conv3x3_packed_int8_roofline_pct" if kernel_mode
                  else "conv3x3_int8_roofline_pct")
    else:
        metric = (f"conv3x3_stride{s}_"
                  f"{'kernel_' if kernel_mode else ''}"
                  f"int8_roofline_pct")

    def builder(sec):
        pct = 100.0 * (2 * n * oh * oh * 9 * ic * oc / sec) / peak
        return {"metric": metric, "value": round(pct, 2),
                "unit": "%", "vs_baseline": round(pct / 90.0, 4)}

    _PARTIAL["builder"] = builder
    sec = timeit_chain(step, x, args.iters, aux=aux)
    if builder(sec)["value"] > 100.0:
        print("# >100% of peak measured: protocol fluke, re-measuring",
              file=sys.stderr)
        sec = timeit_chain(step, x, args.iters, aux=aux)
    ops = 2 * n * oh * oh * 9 * ic * oc / sec
    pct = 100.0 * ops / peak
    tag = f"conv3x3/s{s}" if s > 1 else "conv3x3"
    print(f"# {tag} {sec*1e3:.3f} ms/iter {ops/1e12:.1f} TOPS on {kind}",
          file=sys.stderr)
    return builder(sec)


def bench_concat(args):
    """Reference default workload (benchmark/bench_concat.cc:226-242):
    4 inputs s8, relu on; --concat-hw picks among the reference's three
    default shape sets ({128,256}ch@244^2 default, {64,96}ch@64^2,
    {16,64}ch@9^2). Bandwidth-bound; metric = % of the device's HBM
    peak (``PEAKS``).

    Default chain = FRESH-INPUTS loop: each step concats the same source buffers and the
    data dependence flows through ONE element folded back in place, so
    the op is billed its own read+write only — the reference protocol
    also re-runs concat on unchanged inputs (bench_concat.cc:141-160).
    --feedback chains by splitting the output back into the sources and
    bills that full extra pass to the op."""
    from deepfusion_tpu.ops.concat import concat
    import jax
    import jax.numpy as jnp

    # the reference's three default shape sets (bench_concat.cc:226-242)
    sets = {244: (128, 256, 128, 256), 64: (64, 96, 64, 96),
            9: (16, 64, 16, 64)}
    hw = args.concat_hw
    chans = sets[hw]
    rng = np.random.default_rng(0)
    srcs = tuple(
        jax.device_put(rng.integers(-10, 11, (4, hw, hw, c)).astype(np.int8))
        for c in chans)

    if args.feedback:
        def step(srcs):
            y = concat(list(srcs), post_relu=True)
            outs, off = [], 0
            for c in chans:
                # flip sign so relu doesn't collapse to a constant
                outs.append((-y[..., off:off + c]).astype(jnp.int8))
                off += c
            return tuple(outs)

        # the chain moves the bytes twice: concat (read srcs + write y)
        # and the feedback negate-split (read y + write srcs)
        nbytes = 4 * sum(4 * hw * hw * c for c in chans)
    else:
        def step(srcs):
            y = concat(list(srcs), post_relu=True)
            bump = (y[0, 0, 0, 0].astype(jnp.int32) & 1).astype(jnp.int8)
            return tuple(s.at[0, 0, 0, 0].add(bump) for s in srcs)

        # the op's own traffic: read srcs + write y
        nbytes = 2 * sum(4 * hw * hw * c for c in chans)
    peak_bw = peak_for(jax.devices()[0].device_kind)["hbm_bytes"] / 1e9

    mname = ("concat_relu_hbm_pct" if hw == 244
             else f"concat_relu_hw{hw}_hbm_pct")

    def builder(sec):
        pct = 100.0 * (nbytes / sec / 1e9) / peak_bw
        return {"metric": mname, "value": round(pct, 2),
                "unit": "%", "vs_baseline": round(pct / 90.0, 4)}

    _PARTIAL["builder"] = builder
    sec = timeit_chain(step, srcs, args.iters)
    gbps = nbytes / sec / 1e9
    print(f"# concat {sec*1e3:.3f} ms/iter {gbps:.0f} GB/s", file=sys.stderr)
    return builder(sec)


def bench_model(args):
    import jax
    import jax.numpy as jnp

    if args.model == "resfusion":
        from deepfusion_tpu.models import ResFusionNet, ResFusionNetConfig
        net = ResFusionNet(ResFusionNetConfig(batch=args.batch,
                                              hw=args.model_hw or 64,
                                              in_ch=32, width=128,
                                              num_classes=128))
    elif args.model == "vggfusion":
        from deepfusion_tpu.models import VGGFusion, VGGFusionConfig
        net = VGGFusion(VGGFusionConfig(batch=args.batch,
                                        hw=args.model_hw or 56,
                                        in_ch=32, width=64,
                                        num_classes=128))
    else:
        from deepfusion_tpu.models import FusionNet, FusionNetConfig
        net = FusionNet(FusionNetConfig(batch=args.batch,
                                        hw=args.model_hw or 56, in_ch=32,
                                        width=128, num_classes=128))
    x0 = jax.device_put(net.example_input())
    # default path per model family: packed for FusionNet and for
    # VGGFusion from hw 96 up (halo rows/columns are a small share of
    # big images), dense otherwise; --packed / --dense force either.
    # Which path is faster on the GPU is not measured yet.
    use_packed = args.packed or (not args.dense and (
        args.model == "fusionnet"
        or (args.model == "vggfusion" and (args.model_hw or 56) >= 96)))
    if args.hybrid:
        if not hasattr(net, "hybrid_call"):
            raise SystemExit(f"--hybrid is not defined for {args.model}")
        fwd, use_packed = net.hybrid_call, False
    else:
        fwd = net.packed_call if use_packed else net.__call__

    def step(x):
        out = fwd(x)
        # fold the logits checksum back into the input IN PLACE: keeps
        # the chain data-dependent without billing an extra full pass
        # over x to the model
        bump = (out.astype(jnp.int32).sum() & 1).astype(jnp.uint8)
        return x.at[(0,) * x.ndim].add(bump)

    tag = args.model + (f"@{args.model_hw}" if args.model_hw else "") \
        + ("/hybrid" if args.hybrid else
           "/packed" if use_packed else "/dense")

    def builder(sec):
        return {"metric": f"{args.model}_imgs_per_sec",
                "value": round(args.batch / sec, 1),
                "unit": "imgs/s", "vs_baseline": 1.0, "path": tag}

    _PARTIAL["builder"] = builder
    sec = timeit_chain(step, x0, args.iters)
    imgs = args.batch / sec
    print(f"# {tag} {sec*1e3:.3f} ms/iter {imgs:.0f} imgs/s",
          file=sys.stderr)
    return builder(sec)


def _parse_mesh(spec: str):
    """'dp=4' / 'dp=2,sp=2,tp=2' -> dict; missing axes default to 1."""
    axes = {"dp": 1, "sp": 1, "tp": 1}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in axes:
            raise SystemExit(f"unknown mesh axis {k!r} (dp/sp/tp)")
        axes[k] = int(v)
    return axes


def bench_scaling(args):
    """Multi-card/multi-host scaling (BASELINE.md scaling table): run the
    dp(/sp/tp)-sharded FusionNet forward step over a device mesh and
    report imgs/s/card. The same harness runs 1 card / 1 host / >=2 hosts
    (one process per host; each process drives that host's cards):

        # 1 card:
        python bench.py --op scaling --mesh dp=1
        # 1 host, 4 cards:
        python bench.py --op scaling --mesh dp=4
        # 2 hosts x 4 cards (run on every host):
        python bench.py --op scaling --mesh dp=8 --hosts 2 \\
            --coordinator host0:1234 --process-id $ID

    Sharding plan: batch over dp (no collectives), H over sp (ppermute
    halos in the stem), conv0-oc over tp in the fused blocks (psum before
    requant) — the mesh axes from parallel/mesh.py. The dp-only default is
    the throughput configuration; sp/tp exist to bound the latency of big
    single images and are measured by the same harness."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepfusion_tpu.models import FusionNet, FusionNetConfig
    from deepfusion_tpu.parallel import distributed, make_mesh

    if args.hosts and args.hosts > 1:
        distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.hosts,
                               process_id=args.process_id)
    axes = _parse_mesh(args.mesh)
    dp, sp, tp = axes["dp"], axes["sp"], axes["tp"]
    n_chips = dp * sp * tp
    if len(jax.devices()) < n_chips:
        raise SystemExit(f"mesh {args.mesh} needs {n_chips} devices, "
                         f"have {len(jax.devices())}")
    if sp != 1 or tp != 1:
        # op-level sharded scaling: the model forward is a local callable,
        # so sp/tp meshes run the flagship fused conv through the
        # production sharded wrappers instead (parallel/shard.py)
        return _bench_scaling_op(args, dp, sp, tp)
    mesh = make_mesh(dp=dp, sp=sp, tp=tp)

    # per-chip batch stays constant (weak scaling): global = batch * dp
    local = FusionNet(FusionNetConfig(batch=args.batch, hw=56, in_ch=32,
                                      width=128, num_classes=128))
    fwd = jax.shard_map(local.__call__, mesh=mesh,
                        in_specs=P("dp", None, None, None),
                        out_specs=P("dp", None), check_vma=False)
    rng = np.random.default_rng(0)
    gb = args.batch * dp
    x0 = rng.integers(0, 256, (gb,) + local.input_shape[1:], dtype=np.uint8)
    x0 = jax.device_put(
        x0, jax.NamedSharding(mesh, P("dp", None, None, None)))

    def step(x):
        out = fwd(x)
        # fold the logits checksum back into the input IN PLACE
        bump = (out.astype(jnp.int32).sum() & 1).astype(jnp.uint8)
        return x.at[(0,) * x.ndim].add(bump)

    def builder(sec):
        return {"metric": "fusionnet_imgs_per_sec_per_chip",
                "value": round(gb / sec / n_chips, 1),
                "unit": "imgs/s/chip", "vs_baseline": 1.0,
                "mesh": {"dp": dp, "sp": sp, "tp": tp,
                         "hosts": jax.process_count()}}

    _PARTIAL["builder"] = builder
    sec = timeit_chain(step, x0, args.iters)
    print(f"# scaling mesh(dp={dp},sp={sp},tp={tp}) "
          f"{jax.process_count()} host(s) {sec*1e3:.3f} ms/step "
          f"{gb/sec:.0f} imgs/s total", file=sys.stderr)
    return builder(sec)


def _bench_scaling_plan(args, dp, sp, tp):
    """Throughput of the composed dp x sp x tp three-stage plan
    (parallel/plan.three_stage_plan — the dryrun's exact builder):
    sp_conv halo exchange -> tp reduce_scatter fused conv -> dp-sharded
    conv pair + pool2. Chain stays data-dependent through a one-element
    in-place bump (the output spec differs from the input's)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepfusion_tpu.parallel import make_mesh
    from deepfusion_tpu.parallel.plan import three_stage_plan

    n_chips = dp * sp * tp
    mesh = make_mesh(dp=dp, sp=sp, tp=tp)
    mb = args.batch * dp
    hw = args.model_hw or 16 * sp
    ic = oc = oc1 = 64
    rng = np.random.default_rng(0)
    plan, pair, cfg2 = three_stage_plan(mesh, mb, hw, ic, oc, oc1,
                                        rng=rng)
    src = rng.integers(0, 256, (mb, hw, hw, ic), dtype=np.uint8)
    x0 = jax.device_put(src, jax.NamedSharding(
        mesh, P("dp", "sp", None, None)))

    def step(x):
        out = plan(x)
        bump = (out[0, 0, 0, 0].astype(jnp.int32) & 1).astype(jnp.uint8)
        return x.at[0, 0, 0, 0].add(bump)

    def builder(sec):
        return {"metric": "three_stage_plan_imgs_per_sec_per_chip",
                "value": round(mb / sec / n_chips, 1),
                "unit": "imgs/s/chip", "vs_baseline": 1.0,
                "mesh": {"dp": dp, "sp": sp, "tp": tp,
                         "hosts": jax.process_count()}}

    _PARTIAL["builder"] = builder
    sec = timeit_chain(step, x0, args.iters)
    print(f"# scaling-plan mesh(dp={dp},sp={sp},tp={tp}) "
          f"{sec*1e3:.3f} ms/step (3 sharded stages) "
          f"{mb/sec:.0f} imgs/s total", file=sys.stderr)
    return builder(sec)


def _bench_scaling_op(args, dp, sp, tp):
    """sp/tp-mesh scaling on the flagship fused conv via the production
    sharded wrappers: sp_conv (H halo exchange, optionally composed with
    dp batch sharding) or tp_fused_conv (oc sharding + reduce_scatter
    wire). Latency-bound single-image configs are what sp/tp exist for;
    throughput configs use the dp model path."""
    import jax
    from jax.sharding import PartitionSpec as P

    from deepfusion_tpu.config import ConvConfig
    from deepfusion_tpu.ops.conv import ConvOp
    from deepfusion_tpu.parallel import make_mesh
    from deepfusion_tpu.parallel.shard import (sp_conv, sp_packed,
                                               tp_fused_conv,
                                               tp_packed_fused)

    if tp != 1 and (sp != 1 or dp != 1):
        # tp composed with dp/sp: time the SAME three-stage plan the
        # multi-device dryrun proves (parallel/plan.py)
        if args.packed:
            raise SystemExit("--packed applies to single-axis sp/tp "
                             "meshes; the composed dp x sp x tp mesh "
                             "times the fixed three-stage plan (which "
                             "already includes the sp_packed stage)")
        return _bench_scaling_plan(args, dp, sp, tp)
    n_chips = dp * sp * tp
    hw, c = 128, 256            # ih divisible by sp; oc1x1 == ic chains
    bs = args.batch * dp
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (bs, hw, hw, c), dtype=np.uint8)
    wei = rng.integers(-127, 128, (c, c, 3, 3)).astype(np.int8)
    bia = rng.integers(-100, 101, (c,)).astype(np.int32)
    wei1 = rng.integers(-127, 128, (c, c, 1, 1)).astype(np.int8)
    bia1 = rng.integers(-100, 101, (c,)).astype(np.int32)
    cfg = ConvConfig.make(
        (bs, hw, hw, c), (c, c, 3, 3), bia.dtype, (1, 1), (1, 1),
        (bs, hw, hw, c), "u8", conv0_scales=(0.001,),
        wei1x1_shape=(c, c, 1, 1), bia1x1_dt=bia1.dtype,
        conv1_relu=True, conv1_scales=(0.05,))
    mesh = make_mesh(dp=dp, sp=sp, tp=tp)
    dp_ax = "dp" if dp > 1 else None
    # --packed routes the sharded step through the PACKED-domain
    # wrappers (tp_packed_fused / sp_packed) instead of the dense ones
    if tp > 1 and args.packed:
        from deepfusion_tpu.ops.packed import PackedConvOp, pack_image
        pop = PackedConvOp(cfg, wei, bia, wei1, bia1)
        fn = tp_packed_fused(pop, mesh)
        x0 = jax.device_put(pack_image(src, pop.sin),
                            jax.NamedSharding(mesh, P()))
    elif tp > 1:
        fn = tp_fused_conv(cfg, wei, bia, wei1, bia1, mesh)
        x0 = jax.device_put(src, jax.NamedSharding(mesh, P()))
    elif args.packed:
        from deepfusion_tpu.ops.packed import (PackedConvOp,
                                               pack_image_sharded)
        pop = PackedConvOp(cfg, wei, bia, wei1, bia1)
        fn = sp_packed(pop, mesh, dp_axis=dp_ax)
        x0 = jax.device_put(
            pack_image_sharded(src, fn.local_spec, sp),
            jax.NamedSharding(mesh, P(dp_ax, "sp", None)))
    else:
        op = ConvOp(cfg, wei, bia, wei1, bia1)
        fn = sp_conv(op, mesh, dp_axis=dp_ax)
        x0 = jax.device_put(src, jax.NamedSharding(
            mesh, P(dp_ax, "sp", None, None)))

    def builder(sec):
        return {"metric": "fused_conv_imgs_per_sec_per_chip",
                "value": round(bs / sec / n_chips, 1),
                "unit": "imgs/s/chip", "vs_baseline": 1.0,
                "mesh": {"dp": dp, "sp": sp, "tp": tp,
                         "hosts": jax.process_count()}}

    _PARTIAL["builder"] = builder
    sec = timeit_chain(fn, x0, args.iters)
    print(f"# scaling-op mesh(dp={dp},sp={sp},tp={tp}) "
          f"{sec*1e3:.3f} ms/conv {bs/sec:.0f} imgs/s total",
          file=sys.stderr)
    return builder(sec)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--op", default="fused",
                   choices=["fused", "conv", "concat", "model", "scaling"])
    # default fused shape: wide channels and an alignment-friendly width
    # (126 + 2*pad = 128 flat positions/row -> 1.6% of positions padding;
    # hw=56 pads 58->64, 12.5%)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--hw", type=int, default=126)
    p.add_argument("--ic", type=int, default=256)
    p.add_argument("--oc", type=int, default=256)
    p.add_argument("--oc1x1", type=int, default=256)
    p.add_argument("--stride", type=int, default=1,
                   help="conv: stride")
    p.add_argument("--iters", type=int, default=96,
                   help="chain length inside one jit (the paired-chain "
                        "difference spans 3*iters iterations)")
    p.add_argument("--compare-xla", action="store_true",
                   help="also time a plain-XLA composition of the same op")
    p.add_argument("--concat-hw", type=int, default=244,
                   choices=[244, 64, 9],
                   help="concat: which reference default shape set "
                        "(benchmark/bench_concat.cc:226-242)")
    p.add_argument("--feedback", action="store_true",
                   help="concat: feedback chain that splits the output "
                        "back into the sources (bills that pass too)")
    p.add_argument("--carry", action="store_true",
                   help="fused: producer->consumer chain (the output "
                        "buffer feeds the next step) instead of the "
                        "reference-parity fresh-inputs loop; measures "
                        "the HBM write->read-back turnaround too")
    p.add_argument("--dense", action="store_true",
                   help="fused/model: time the dense path instead of the "
                        "packed-domain chain (model: packed is the default "
                        "for fusionnet, where it measures faster)")
    p.add_argument("--pair", action="store_true",
                   help="fused: chain two packed fused convs per step "
                        "(ops/mega.py) instead of the single packed op")
    p.add_argument("--packed", action="store_true",
                   help="model: time the layout-persistent packed path "
                        "instead of the dense op-by-op path")
    p.add_argument("--hybrid", action="store_true",
                   help="model (vggfusion): packed conv pair for the "
                        "big-image block, dense for the shrunken tail")
    p.add_argument("--model", default="fusionnet",
                   choices=["fusionnet", "resfusion", "vggfusion"],
                   help="model: which model family to time")
    p.add_argument("--model-hw", type=int, default=None,
                   help="model: input image side (default 56 fusionnet / "
                        "64 resfusion). The packed path's halo columns are "
                        "a fixed per-row tax, so packed-vs-dense may flip "
                        "with this")
    p.add_argument("--mesh", default="dp=1",
                   help="scaling: mesh axes, e.g. dp=4 or dp=2,sp=2")
    p.add_argument("--hosts", type=int, default=1,
                   help="scaling: number of host processes (multi-host)")
    p.add_argument("--coordinator", default=None,
                   help="scaling: jax.distributed coordinator host:port")
    p.add_argument("--process-id", type=int, default=None,
                   help="scaling: this host's process index")
    args = p.parse_args()
    # a `timeout` (SIGTERM) or wall-clock guard must degrade the number's
    # precision, never erase it
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGALRM):
        signal.signal(sig, _emit_partial)
    import jax

    from deepfusion_tpu.utils import env
    env.enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{dev.platform}")
    result = {"fused": bench_fused, "conv": bench_conv,
              "concat": bench_concat, "model": bench_model,
              "scaling": bench_scaling}[args.op](args)
    _PARTIAL["done"] = True
    result["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
