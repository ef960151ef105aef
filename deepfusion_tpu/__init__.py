"""deepfusion_tpu — fused INT8 inference primitives for the GPU.

A ground-up JAX/XLA/Pallas re-design with the capabilities of the reference
``deep-fusion`` library (x86 AVX512/VNNI JIT kernels): fused concat+ReLU and
conv3x3+ReLU+conv1x1+ReLU INT8 inference ops with exact requantization
semantics, plus the roadmap ops (conv+relu+pooling, eltwise-sum+relu),
a differential-oracle test suite, multi-device sharding, and a native C++
host runtime.

Two API layers:
  * functional: ``deepfusion_tpu.ops.concat/conv/...``
    — pure functions over jax arrays, jit-friendly.
  * object (reference-parity): ``deepfusion_tpu.memory`` + factory
    ``concat()/conv()`` returning ops with ``submit()``
    (``include/deepfusion.h:105-145``).
"""
from . import config, ops, serving, types, utils  # noqa: F401
from .api import concat, conv, eltwise_sum_relu, op, pool  # noqa: F401
from .config import ConcatConfig, ConvConfig, PoolConfig, device_capabilities  # noqa: F401
from .types import dtype, f32, format, memory, round_mode, s8, s32, u8  # noqa: F401

__version__ = "0.1.0"
