"""tpulsar_torch — the pulsar search on PyTorch and CUDA.

The JAX package ``tpulsar`` is the reference; this package mirrors its
layout module for module (``tpulsar_torch.kernels.dedisperse`` is the
counterpart of ``tpulsar.kernels.dedisperse``) and imports nothing of
it.  Plain tensor code is PyTorch; the two Pallas kernels of the
reference (stage-1 subband formation and stage-2 shift-and-sum
dedispersion) are CUDA kernels written for Hopper
(``tpulsar_torch/csrc/dedisperse.cu``, bound in
``tpulsar_torch/kernels/cuda_dd.py``).

Every public entry point takes ``device=`` and defaults to ``"cuda"``.
Without a GPU the caller must pass ``device="cpu"`` explicitly: the
package never moves to the CPU on its own.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on.

    None means the default, ``"cuda"``.  A CUDA device is refused with
    a RuntimeError when no GPU is present: running on the CPU is the
    caller's explicit choice (``device="cpu"``), never a fallback."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpulsar_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
