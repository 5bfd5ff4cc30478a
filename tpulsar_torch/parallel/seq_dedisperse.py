"""Sequence-parallel dedispersion: the time axis sharded over a mesh
axis with a ring halo — counterpart of
tpulsar/parallel/seq_dedisperse.py.

Each shard owns a contiguous time chunk of the subband block plus a
halo of `max_shift` samples from its right neighbour (the window the
shift-gather reads past the chunk's end):

    out[d, t] = sum_s subb[s, min(t + shift[d, s], T-1)]

equals stage 2 of the whole block bit for bit; the last shard's halo
replicates its final sample (the edge clamp).  On the card each
shard's window goes through one launch of the stage-2 kernel
(kernels/dedisperse.dedisperse_stream_step), which computes the whole
window and keeps the first `chunk` columns: every shift is <= the
halo, so no kept column reads past the window and the kernel's clamp
never fires.  On the CPU the window goes through the plain
dedisperse_window_scan.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulsar_torch.kernels import dedisperse as dd
from tpulsar_torch.parallel import collectives as coll
from tpulsar_torch.parallel.mesh import Mesh, shard_map


def halo_extend(parts: list[torch.Tensor], S: int) -> list[torch.Tensor]:
    """Extend each per-shard (rows, chunk) time shard with an S-sample
    halo: the first S columns of its right neighbour, the last shard's
    own final sample repeated (collectives.ring_halo).  Shared by
    seq_dedisperse (which the sharded pass's seq route calls) and
    seq_dist_search's single-pulse search."""
    return [torch.cat([p, h], dim=1)
            for p, h in zip(parts, coll.ring_halo(parts, S))]


def seq_dedisperse(subbands, sub_shifts, mesh: Mesh,
                   axis_name: str = "dm", max_shift: int | None = None
                   ) -> list[torch.Tensor]:
    """(nsub, T) subbands + (ndms, nsub) shifts -> the (ndms, T) DM
    series time-sharded over `axis_name`: a list of (ndms, T / n)
    tensors in shard order, each on its shard's device.

    T must divide the axis size; every shift must be <= max_shift and
    max_shift <= T // axis_size (the halo is one neighbour deep)."""
    if axis_name != "dm":
        raise ValueError(f"the mesh shards time over 'dm', not "
                         f"{axis_name!r}")
    shifts_np = np.asarray(sub_shifts, np.int32)
    n_dev = mesh.shape[axis_name]
    nsub, T = subbands.shape
    if T % n_dev:
        raise ValueError(f"T={T} not divisible by {n_dev} devices")
    chunk = T // n_dev
    actual_max = int(shifts_np.max(initial=0))
    S = actual_max if max_shift is None else max_shift
    if actual_max > S:
        raise ValueError(
            f"shift table max {actual_max} exceeds max_shift={S}")
    if S > chunk:
        raise ValueError(
            f"max shift {S} exceeds per-device chunk {chunk}; "
            f"use fewer devices or a deeper halo")
    parts = shard_map(lambda i, s: s, mesh, (1,),
                      torch.as_tensor(subbands))
    return shard_map(
        lambda i, ext: dd.dedisperse_stream_step(ext, shifts_np, chunk),
        mesh, (0,), halo_extend(parts, S))
