"""Batch- and channel-sharded wideband fits over several devices."""

from pulseportraiture_tpu_torch.parallel.mesh import (
    Mesh, fit_portrait_full_sharded, make_mesh, shard_fit_inputs)

__all__ = ["Mesh", "fit_portrait_full_sharded", "make_mesh",
           "shard_fit_inputs"]
