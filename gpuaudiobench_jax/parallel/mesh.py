"""Device-mesh construction for multi-device benchmark variants.

The reference is single-device (SURVEY.md s2.4); this build adds an
optional multi-device extension over a jax.sharding.Mesh with three axes:

* "dp": data parallel -- the track/voice axis (the reference's
  thread-per-track axis scaled across chips),
* "tp": tensor parallel -- the mode axis of the modal bank (partial
  banks per chip, psum-reduced into the shared output tracks),
* "sp": sequence parallel -- the sample/time axis for convolution
  (halo exchange of the IR tail between neighboring shards).

Expert parallelism has no counterpart in this domain (no MoE; documented
n/a in SURVEY.md s2.4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def _factor3(n: int) -> Tuple[int, int, int]:
    """Split n devices into (dp, tp, sp) factors, largest first on dp."""
    best = (n, 1, 1)
    for sp in (1, 2, 4, 8):
        for tp in (1, 2, 4, 8):
            if n % (sp * tp) == 0:
                dp = n // (sp * tp)
                cand = (dp, tp, sp)
                # prefer balanced meshes
                if max(cand) - min(cand) < max(best) - min(best):
                    best = cand
    return best


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    sp: Optional[int] = None,
) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    if dp is None or tp is None or sp is None:
        dp, tp, sp = _factor3(n)
    if dp * tp * sp != n:
        raise ValueError(f"mesh {dp}x{tp}x{sp} != {n} devices")
    mesh_devices = np.asarray(devices[:n]).reshape(dp, tp, sp)
    return Mesh(mesh_devices, axis_names=("dp", "tp", "sp"))
