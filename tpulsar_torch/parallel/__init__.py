"""Parallel layer: device meshes, sharded search, distributed FFT —
counterpart of tpulsar/parallel/.

A (beam, dm) mesh of torch devices carries data-parallel beams and
DM-trial sharding; long time series can additionally be sharded along
time, with a ring-halo dedispersion and a four-step distributed FFT.
One process drives every shard (parallel/mesh.py), and the
collectives are plain functions over per-shard tensors
(parallel/collectives.py).  The reference's parallel/compat.py, which
resolves jax.shard_map's spelling across jax versions, has no
counterpart here.
"""

from tpulsar_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    sharded_search_step,
    SearchStepSpec,
)
