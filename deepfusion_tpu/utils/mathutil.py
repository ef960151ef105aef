"""Math / partitioning helpers.

Reference parity: ``util/math_func.cc:22-28`` (output-size formulas) and
``util/deepfusion_utils.h:91-255`` (divisibility helpers, ``balance211`` work
split, ``nd_iterator``). On the device XLA owns work partitioning, but
``balance211``/``nd_iterator`` remain useful for host-side sharding (data
loading, per-host batch splits) and are also implemented natively in
``native/dfruntime.cc``.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple


def conv_output_size(image: int, kernel: int, stride: int, padding: int) -> int:
    """Reference: ``util/math_func.cc:22-24``: (i + 2p - k) / s + 1."""
    return (image + 2 * padding - kernel) // stride + 1


def pool_output_size(image: int, kernel: int, stride: int, padding: int) -> int:
    """Reference: ``util/math_func.cc:26-28`` (ceil division semantics)."""
    return (image + 2 * padding - kernel + stride - 1) // stride + 1


def div_up(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return div_up(a, b) * b


def one_of(x, *args) -> bool:
    return x in args


def all_true(*args) -> bool:
    return all(args)


def dividable_of(n: int, *candidates: int) -> int:
    """First candidate that divides n, else 1 (util/deepfusion_utils.h:117-126)."""
    for c in candidates:
        if n % c == 0:
            return c
    return 1


def find_dividable(n: int, hi: int) -> int:
    """Largest d <= hi dividing n (util/deepfusion_utils.h:128-140)."""
    hi = min(hi, n)
    for d in range(hi, 0, -1):
        if n % d == 0:
            return d
    return 1


def balance211(amount: int, team: int, member: int) -> Tuple[int, int]:
    """Near-equal contiguous split of `amount` items over `team` workers.

    Returns the [start, end) range for `member`.
    Reference: ``util/deepfusion_utils.h:190-208``.
    """
    if team <= 1 or amount <= 1:
        return (0, amount) if member == 0 else (amount, amount)
    base = amount // team
    extra = amount % team
    if member < extra:
        start = member * (base + 1)
        end = start + base + 1
    else:
        start = extra * (base + 1) + (member - extra) * base
        end = start + base
    return start, end


def nd_iterator_init(start: int, dims: Sequence[int]) -> list:
    """Decompose flat index into multi-dim coords
    (reference: ``util/deepfusion_utils.h:210-230``)."""
    coords = [0] * len(dims)
    for i in range(len(dims) - 1, -1, -1):
        coords[i] = start % dims[i]
        start //= dims[i]
    return coords


def nd_iterator_step(coords: list, dims: Sequence[int]) -> bool:
    """Advance coords by one; returns False on wrap-around
    (reference: ``util/deepfusion_utils.h:232-244``)."""
    for i in range(len(dims) - 1, -1, -1):
        coords[i] += 1
        if coords[i] < dims[i]:
            return True
        coords[i] = 0
    return False


def nd_range(start: int, end: int, dims: Sequence[int]) -> Iterable[tuple]:
    """Iterate coords for flat indices [start, end) over `dims`."""
    coords = nd_iterator_init(start, dims)
    for _ in range(end - start):
        yield tuple(coords)
        nd_iterator_step(coords, dims)
