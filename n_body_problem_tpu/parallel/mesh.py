"""Device-mesh construction for particle sharding.

The reference is strictly single-GPU — its only "transport" is the CUDA-GL
interop handoff (``kernel.cu:1225, 1242``). Cross-chip scaling here uses a
1-D ring mesh: bodies are sharded over the ``shards`` axis and body tiles
rotate around the ring with ``ppermute`` each force evaluation (SURVEY.md §5,
BASELINE.json configs 4-5).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

RING_AXIS = "shards"


def make_ring_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D ring mesh over ``n_devices`` (default: all local devices).

    The ring follows the algorithm alone: the cards of one host reach each
    other all to all at the same rate.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (RING_AXIS,))
