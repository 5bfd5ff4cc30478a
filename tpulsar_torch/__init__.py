"""tpulsar_torch — the pulsar search on PyTorch and CUDA.

The JAX package ``tpulsar`` is the reference; this package mirrors its
layout module for module (``tpulsar_torch.kernels.dedisperse`` is the
counterpart of ``tpulsar.kernels.dedisperse``) and imports nothing of
it.  It runs the reference's default single-beam search on one
device: dedispersion, single-pulse search, the zero-accel and hi-accel
(FDAS) periodicity searches, sifting, harmpolish refinement, candidate
folding and plots, with pass-level checkpoint/resume, the per-beam
job a queue runs (``python -m tpulsar_torch.cli.search_job``) and the
resident server (``python -m tpulsar_torch serve``, ``--batch N`` for
coalesced groups of beams, ``--stream`` for real-time sessions through
the streaming plane, ``stream/``), and the network front door in
front of it (``python -m tpulsar_torch gateway``: HTTP submission, a
SQLite ticket queue, the content-addressed blob store a beam is
staged from by digest and its candidates are published to).  Plain
tensor code is PyTorch (FFTs through ``torch.fft``, cuFFT on the
GPU); the two Pallas kernels of the
reference (stage-1 subband formation and stage-2 shift-and-sum
dedispersion) are CUDA kernels written for Hopper
(``tpulsar_torch/csrc/dedisperse.cu``, bound in
``tpulsar_torch/kernels/cuda_dd.py``), which the search, refinement,
folding and the stream's emissions all call; the hi stage's harmonic
sums, z maxima and block maxima are a third CUDA kernel
(``tpulsar_torch/csrc/accel_stage.cu``, XLA in the reference).

Every public entry point that computes takes ``device=`` (the job:
``--device``) and defaults to ``"cuda"``; the control plane (the
gateway, the queues, the blob store, the client) touches no tensor
and never initializes CUDA.  Without a GPU the caller must pass
``device="cpu"`` explicitly: the package never moves to the CPU on its
own.
"""

from __future__ import annotations

#: the results DB's version_number when the tree has no git history
#: (orchestrate/uploader.py::pipeline_version)
__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> "torch.device":
    """The torch.device an entry point runs on.

    None means the default, ``"cuda"``.  A CUDA device is refused with
    a RuntimeError when no GPU is present: running on the CPU is the
    caller's explicit choice (``device="cpu"``), never a fallback.
    (torch is imported here, not with the package, so the control
    plane — the gateway, the queues, the orchestration daemons —
    starts without it.)"""
    import torch

    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpulsar_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def as_device_tensor(x, device=None) -> "torch.Tensor":
    """``x`` (a tensor or anything numpy reads) as a tensor on
    :func:`resolve_device`'s device: the entry points that take the
    JAX package's array arguments call this first."""
    import numpy as np
    import torch

    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(resolve_device(device))

