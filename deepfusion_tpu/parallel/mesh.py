"""Device-mesh construction helpers.

The reference is single-process OpenMP (SURVEY.md §2, parallelism table):
its only parallelism is intra-op threading over batch x spatial
(``src/op_conv.cc:39-47``). The scale-out axes here are the idiomatic
replacements demanded by BASELINE.md's north star:

  dp — data (batch) parallelism        [reference analogue: none]
  sp — spatial (H) parallelism w/ halo [analogue: row-chunk OpenMP split]
  tp — tensor (output-channel) par.    [analogue: oc-chunk OpenMP split]
"""
from __future__ import annotations

from typing import Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = dp * sp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(dp, sp, tp)
    return Mesh(dev, axis_names=("dp", "sp", "tp"))


def factorize_mesh(n: int) -> Tuple[int, int, int]:
    """Pick a (dp, sp, tp) factorization for n devices: prefer giving
    factors to dp (cheapest), then tp, then sp."""
    def largest_pow2(x):
        p = 1
        while x % 2 == 0:
            x //= 2
            p *= 2
        return p

    p2 = largest_pow2(n)
    rest = n // p2
    # split the power of two between dp and tp, leave remainder on dp
    tp = min(p2, 2)
    sp = min(p2 // tp, 2)
    dp = (p2 // (tp * sp)) * rest
    return dp, sp, tp
