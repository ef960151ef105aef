"""FusionNet model smoke + determinism tests (CPU interpret mode)."""
import numpy as np
import pytest

from deepfusion_tpu.models import FusionNet, FusionNetConfig


@pytest.fixture(scope="module")
def small_net():
    return FusionNet(FusionNetConfig(batch=1, hw=8, in_ch=16, width=32,
                                     num_classes=16))


def test_forward_shape(small_net):
    x = small_net.example_input()
    out = np.asarray(small_net(x))
    assert out.shape == (1, 16)
    assert out.dtype == np.float32
    assert np.isfinite(out).all()


def test_deterministic(small_net):
    x = small_net.example_input()
    a = np.asarray(small_net(x))
    b = np.asarray(small_net(x))
    assert np.array_equal(a, b)


def test_input_sensitivity(small_net):
    rng = np.random.default_rng(0)
    a = np.asarray(small_net(small_net.example_input(rng)))
    b = np.asarray(small_net(small_net.example_input(rng)))
    assert not np.array_equal(a, b)


def test_packed_path_bit_identical():
    """The layout-persistent forward (packed_call) must produce bitwise the
    same logits as the dense op-by-op path."""
    from deepfusion_tpu.models import FusionNet, FusionNetConfig
    net = FusionNet(FusionNetConfig(batch=2, hw=24, in_ch=32, width=64,
                                    num_classes=32))
    x = net.example_input()
    dense = np.asarray(net(x))
    packed = np.asarray(net.jit_packed()(x))
    np.testing.assert_array_equal(dense, packed)


# ----- ResFusionNet: strided stem + sum post-op residual + fused
# conv+pool downsample (the op families FusionNet does not touch) -----

@pytest.fixture(scope="module")
def res_net():
    from deepfusion_tpu.models import ResFusionNet, ResFusionNetConfig
    return ResFusionNet(ResFusionNetConfig(batch=1, hw=16, in_ch=16,
                                           width=32, num_classes=16))


def test_resfusion_forward_shape(res_net):
    x = res_net.example_input()
    out = np.asarray(res_net(x))
    assert out.shape == (1, 16)
    assert out.dtype == np.float32
    assert np.isfinite(out).all()


def test_resfusion_matches_oracle(res_net):
    """The whole model forward, differentially against the numpy oracle
    composition (conv_ref / pool_ref / the sum post-op contract)."""
    from deepfusion_tpu.config import PoolConfig
    from deepfusion_tpu.ops.ref import conv_ref, pool_ref

    P = res_net.params
    x = res_net.example_input()
    y = conv_ref(P["stem"].cfg, x, P["stem"].wei, P["stem"].bia)
    blk = P["block1"]
    y2 = conv_ref(blk.cfg, y, blk.wei, blk.bia, blk.wei1, blk.bia1,
                  sum_src=y)
    dn = P["down"]
    y3 = pool_ref(conv_ref(dn.cfg, y2, dn.wei, dn.bia), res_net.down.pc)
    b2 = P["block2"]
    y4 = conv_ref(b2.cfg, y3, b2.wei, b2.bia, b2.wei1, b2.bia1)
    hw2 = y4.shape[1]
    pc2 = PoolConfig.make("avg_exc", (hw2, hw2), (hw2, hw2), (hw2, hw2),
                          (0, 0))
    y5 = pool_ref(y4, pc2)
    hd = P["head"]
    logits = conv_ref(hd.cfg, y5, hd.wei, hd.bia)
    got = np.asarray(res_net(x))
    np.testing.assert_array_equal(
        got, np.asarray(logits).reshape(logits.shape[0], -1))


def test_resfusion_packed_path_bit_identical():
    """ResFusionNet's layout-persistent forward — strided s2d stem, packed
    sum post-op residual, packed downsample+pool — must produce bitwise
    the dense path's logits."""
    from deepfusion_tpu.models import ResFusionNet, ResFusionNetConfig
    net = ResFusionNet(ResFusionNetConfig(batch=2, hw=32, in_ch=16,
                                          width=64, num_classes=32))
    x = net.example_input()
    dense = np.asarray(net(x))
    packed = np.asarray(net.jit_packed()(x))
    np.testing.assert_array_equal(dense, packed)


def test_packed_build_under_trace():
    """Ops constructed lazily inside a traced forward (the benchmark scan
    builds the packed pipeline during its first trace) must not leak
    tracers into later traces (regression: UnexpectedTracerError in
    bench --op model --packed)."""
    import jax
    import jax.numpy as jnp

    from deepfusion_tpu.models import ResFusionNet, ResFusionNetConfig
    net = ResFusionNet(ResFusionNetConfig(batch=1, hw=16, in_ch=16,
                                          width=32, num_classes=16))
    x0 = jnp.asarray(net.example_input())

    def step(x):
        out = net.packed_call(x)
        bump = (out.astype(jnp.int32).sum() & 1).astype(jnp.uint8)
        return x + bump

    def chain(n):
        @jax.jit
        def run(x):
            x, _ = jax.lax.scan(lambda c, _: (step(c), None), x, None,
                                length=n)
            return x.sum()
        return run

    a = float(chain(2)(x0))   # first trace builds the packed pipeline
    b = float(chain(2)(x0))   # second trace reuses the cached ops
    assert a == b


# ----- VGGFusion: conv-pair blocks (ops/mega.py pool2) -----

def _vgg_net():
    from deepfusion_tpu.models import VGGFusion, VGGFusionConfig
    return VGGFusion(VGGFusionConfig(batch=2, hw=16, in_ch=16, width=32,
                                     num_classes=16))


def test_vggfusion_forward_shape():
    net = _vgg_net()
    out = np.asarray(net(net.example_input()))
    assert out.shape == (2, 16)
    assert out.dtype == np.float32
    assert np.abs(out).sum() > 0


def test_vggfusion_packed_path_bit_identical():
    """The packed forward (one PackedConvPairOp per conv-conv-pool
    block) must equal the dense ConvOp+ConvPoolOp forward bitwise."""
    net = _vgg_net()
    x = net.example_input()
    dense = np.asarray(net(x))
    packed = np.asarray(net.packed_call(x))
    np.testing.assert_array_equal(dense, packed)


def test_vggfusion_packed_under_jit():
    net = _vgg_net()
    x = net.example_input()
    np.testing.assert_array_equal(np.asarray(net.jit_packed()(x)),
                                  np.asarray(net(x)))


def test_vggfusion_hybrid_path_bit_identical():
    """The mixed schedule (packed pair for the big-image block, dense
    tail) must equal both pure forwards bitwise."""
    net = _vgg_net()
    x = net.example_input()
    np.testing.assert_array_equal(np.asarray(net.hybrid_call(x)),
                                  np.asarray(net(x)))
