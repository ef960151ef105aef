"""Core type system: dtypes, layouts, rounding modes, and the `memory` container.

Re-design of the reference's type layer
(``include/deepfusion.h:27-103``): the reference carries a raw aligned buffer
plus (dims, format, dtype); here the container wraps a host numpy array or a
device ``jax.Array`` and the *physical* layout is always NHWC for activations
(the only activation layout the reference kernels accept,
``src/jit_concat_kernel.cc:150-153``) and a matmul-packed layout for
weights (the analogue of the reference's ``OIhw4i16o4i``,
``include/deepfusion.h:59``).
"""
from __future__ import annotations

import enum
from typing import Sequence, Union

import numpy as np

try:  # jax is the compute backend; numpy-only mode still works for oracles
    import jax.numpy as jnp

    _HAVE_JAX = True
except Exception:  # pragma: no cover
    jnp = None
    _HAVE_JAX = False


class dtype(enum.Enum):
    """Supported element types (reference: ``include/deepfusion.h:66-72``)."""

    undef = 0
    f32 = 1
    s32 = 2
    s8 = 3
    u8 = 4

    @property
    def np(self) -> np.dtype:
        return _DTYPE_TO_NP[self]

    @property
    def size(self) -> int:
        """Byte size (reference: ``util/memory.cc:42-56``)."""
        return _DTYPE_TO_NP[self].itemsize

    @property
    def is_int(self) -> bool:
        return self in (dtype.s32, dtype.s8, dtype.u8)

    @classmethod
    def from_any(cls, dt: "DTypeLike") -> "dtype":
        if isinstance(dt, cls):
            return dt
        if isinstance(dt, str):
            try:
                return cls[dt]
            except KeyError:
                pass
        npdt = np.dtype(dt)
        for k, v in _DTYPE_TO_NP.items():
            if v == npdt:
                return k
        raise ValueError(f"unsupported dtype: {dt!r}")


_DTYPE_TO_NP = {
    dtype.f32: np.dtype(np.float32),
    dtype.s32: np.dtype(np.int32),
    dtype.s8: np.dtype(np.int8),
    dtype.u8: np.dtype(np.uint8),
}

DTypeLike = Union[dtype, str, np.dtype, type]

# convenience aliases mirroring `typedef`s at include/deepfusion.h:27-30
f32 = dtype.f32
s32 = dtype.s32
s8 = dtype.s8
u8 = dtype.u8


class format(enum.Enum):
    """Logical/physical layouts (reference: ``include/deepfusion.h:53-61``).

    ``nchw``/``oihw`` are *logical description* formats: like the reference's
    ``memory(nchw_dims, fmt, dt)`` constructor, dims may be given in NCHW order
    and are permuted to the physical layout (``src/deepfusion.cc:25-57``).
    Physical activation layout is always ``nhwc`` (channels innermost).
    ``tpu_pack`` (an API name kept from the project's first build)
    replaces ``OIhw4i16o4i``: weights packed to a 2-D
    ``(kh*kw*ic_padded, oc_padded)`` int8 matrix ready for the int8
    products.
    """

    undef = 0
    x = 1
    nchw = 2
    oihw = 2  # alias, same as reference
    nhwc = 3
    OIhw4i16o4i = 4  # accepted for API parity; mapped to tpu_pack
    gOIhw4i16o4i = 5
    tpu_pack = 6


class round_mode(enum.Enum):
    """Requantization rounding (reference: ``include/deepfusion.h:46-49``).

    ``nearest`` is round-to-nearest-even (x86 ``vcvtps2dq {rn-sae}``,
    ``src/jit_conv_kernel.cc:269``); ``down`` is toward -inf (``{rd-sae}``).
    """

    nearest = 0
    down = 1

    @classmethod
    def from_any(cls, rm: "RoundModeLike") -> "round_mode":
        if isinstance(rm, cls):
            return rm
        return cls[str(rm)]


RoundModeLike = Union[round_mode, str]


def nchw2format(nchw_dims: Sequence[int], fmt: format) -> list:
    """Permute logical-NCHW dims to the physical layout's dim order.

    Mirrors ``src/deepfusion.cc:25-57``.
    """
    n, c, h, w = nchw_dims
    if fmt in (format.nchw,):
        return [n, c, h, w]
    if fmt == format.nhwc:
        return [n, h, w, c]
    if fmt in (format.OIhw4i16o4i, format.tpu_pack):
        # logical oihw; physical handled by ops.layout.pack_conv_weights
        return [n, c, h, w]
    if fmt == format.x:
        return list(nchw_dims)
    raise ValueError(f"unsupported format {fmt}")


class memory:
    """Tensor container: array + dims + layout + dtype.

    Reference parity: ``deepfusion::memory`` (``include/deepfusion.h:51-103``)
    owns a 4096-byte-aligned buffer; here the buffer is a numpy array (host)
    or jax.Array (device). Constructed either from ``nchw_dims`` (logical,
    permuted like the reference) or raw ``dims`` in the physical layout.
    """

    def __init__(self, dims: Sequence[int], fmt: format, dt: DTypeLike,
                 *, nchw: bool | None = None, data=None):
        dt = dtype.from_any(dt)
        dims = list(int(d) for d in dims)
        if nchw is None:
            nchw = len(dims) == 4 and fmt in (
                format.nchw, format.nhwc, format.OIhw4i16o4i, format.tpu_pack)
        if nchw and len(dims) == 4:
            self._std_dims = list(dims)  # nchw or oihw
            dims = nchw2format(dims, fmt)
        else:
            self._std_dims = list(dims)
        self._dims = dims
        self._fmt = fmt
        self._dt = dt
        if data is None:
            data = np.zeros(dims, dtype=dt.np)
        self._data = data

    # --- reference-parity accessors (include/deepfusion.h:86-92) ---
    def size(self) -> int:
        return int(np.prod(self._dims))

    def buffer_size(self) -> int:
        return self.size() * self._dt.size

    def actual_dims(self) -> list:
        return list(self._dims)

    def std_dims(self) -> list:
        return list(self._std_dims)

    def data_type(self) -> dtype:
        return self._dt

    def dim_format(self) -> format:
        return self._fmt

    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, value):
        value = np.asarray(value, dtype=self._dt.np) if isinstance(
            value, (list, tuple, np.ndarray)) else value
        if tuple(value.shape) != tuple(self._dims):
            raise ValueError(
                f"shape mismatch: memory dims {self._dims}, got {value.shape}")
        self._data = value

    def numpy(self) -> np.ndarray:
        return np.asarray(self._data)

    def fill_random(self, rng: np.random.Generator | None = None):
        """Test-style data fill (reference: ``test/test_utils.h:49-63``)."""
        rng = rng or np.random.default_rng()
        if self._dt == dtype.f32:
            i = np.arange(self.size(), dtype=np.float32).reshape(self._dims)
            self._data = (1.0 + 0.01 * np.sin(i % 37)).astype(np.float32)
        elif self._dt == dtype.u8:
            self._data = rng.integers(0, 17, self._dims, dtype=np.uint8)
        else:
            self._data = rng.integers(-10, 11, self._dims).astype(self._dt.np)
        return self
