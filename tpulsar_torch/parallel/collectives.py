"""The mesh's collectives, as plain functions over the list of
per-shard tensors (shard order along one mesh axis).

Counterparts of the lax collectives tpulsar/parallel/ calls inside
shard_map:

  all_gather(parts, dim)            <- jax.lax.all_gather(x, axis,
                                       axis=dim, tiled=True)
  ring_halo(parts, S)               <- the jax.lax.ppermute ring of
                                       parallel/seq_dedisperse.py::
                                       halo_extend, with its last-shard
                                       edge rule
  all_to_all(parts, split, concat)  <- jax.lax.all_to_all(x, axis,
                                       split, concat, tiled=True)

The port's mesh is driven by one process (parallel/mesh.py), so a
collective sees every shard at once.  Across distinct GPUs each move
is a peer copy (Tensor.to); between shards of one device it is a view
or a concatenation, and Tensor.to of a tensor already on its device
copies nothing.
"""

from __future__ import annotations

import torch


def all_gather(parts: list[torch.Tensor], dim: int) -> torch.Tensor:
    """Concatenate the shards along `dim` in shard order, on the first
    shard's device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def ring_halo(parts: list[torch.Tensor], S: int) -> list[torch.Tensor]:
    """Each (rows, chunk) time shard's right halo of S columns: the
    first S columns of its right neighbour, and for the last shard its
    own final column repeated S times (the single-device edge
    clamp)."""
    halos = []
    for i, p in enumerate(parts):
        if i + 1 < len(parts):
            halos.append(parts[i + 1][:, :S].to(p.device))
        else:
            halos.append(p[:, -1:].expand(p.shape[0], S))
    return halos


def all_to_all(parts: list[torch.Tensor], split_dim: int,
               concat_dim: int) -> list[torch.Tensor]:
    """Tiled all-to-all: shard i's tensor is cut along `split_dim` into
    one block per shard; shard j receives block j of every shard,
    concatenated along `concat_dim` in shard order, on its own
    device."""
    n = len(parts)
    if parts[0].shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of size "
                         f"{parts[0].shape[split_dim]} does not split "
                         f"over {n} shards")
    blocks = [torch.chunk(p, n, dim=split_dim) for p in parts]
    return [torch.cat([blocks[i][j].to(parts[j].device) for i in range(n)],
                      dim=concat_dim) for j in range(n)]
