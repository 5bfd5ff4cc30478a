"""Device mesh and the sharded per-pass search — counterpart of
tpulsar/parallel/mesh.py.

Beams are data-parallel along the mesh's `beam` axis; within a beam
the DM-trial axis (the reference's per-DM loop,
PALFA2_presto_search.py:532-594) is sharded along `dm`, and only the
per-trial top-k blocks are gathered at the end.

Execution model.  JAX's shard_map is single-controller: one process
drives every device of the mesh.  The port keeps that: a Mesh is an
(n_beam, n_dm) array of torch.device, shard_map below runs a body once
per shard in this process, and the collectives (parallel/
collectives.py) are plain functions over the list of per-shard
tensors.  There is no torch.distributed: NCCL refuses two ranks on one
GPU, and gloo has no all_gather or all_to_all for CUDA tensors.  A
device may repeat in a mesh: repeated devices are logical shards of
one device, which run one after another (a mesh of four shards on
cuda:0 is how one H100 runs the mesh, as eight virtual CPU devices are
how the JAX package's tests do).

Layout, as in the reference:
  * the subband block (nsub, T') is replicated across `dm` (on one
    device Tensor.to copies nothing, so it is held once);
  * the stage-2 shift table (ndms, nsub) is sharded along `dm`;
  * each shard computes its DM trials' series, SP top-k, spectrum,
    whitening, lo and hi stages; the top-k blocks are the only
    arrays gathered.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpulsar_torch.parallel import collectives as coll

AXES = ("beam", "dm")


class Mesh:
    """A (beam, dm) mesh of torch devices: ``shape`` is
    {"beam": n_beam, "dm": n_dm} (as JAX's mesh.shape), ``devices``
    the (n_beam, n_dm) object array of torch.device."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices[0, 0].type

    def shard_devices(self, row: int = 0) -> list[torch.device]:
        """The devices of beam row `row`'s dm axis, in shard order."""
        return list(self.devices[row])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.ravel()]})")


def make_mesh(n_beam: int = 1, n_dm: int | None = None,
              devices=None) -> Mesh:
    """Build a (beam, dm) mesh.  devices=None means every visible CUDA
    device, and raises without a GPU (pass e.g. ``[torch.device("cpu")]
    * 8`` to run the mesh on the CPU).  A device may repeat: repeated
    devices are logical shards of one device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices= "
                "(e.g. [torch.device('cpu')] * n) to run the mesh on "
                "the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"mesh devices of more than one type: "
                         f"{sorted({d.type for d in devices})}")
    n_dev = len(devices)
    if n_dm is None:
        if n_dev % n_beam:
            raise ValueError(f"{n_dev} devices not divisible by "
                             f"beam={n_beam}")
        n_dm = n_dev // n_beam
    if n_beam * n_dm != n_dev:
        raise ValueError(f"mesh {n_beam}x{n_dm} != {n_dev} devices")
    arr = np.empty(n_dev, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_beam, n_dm))


def _local(arg, dim, i: int, n: int, dev: torch.device):
    """Shard i of n of one argument: the whole argument when dim is
    None, else its i-th contiguous block along `dim` (for a list, one
    item per shard, its i-th item).  Tensors move to the shard's device
    (no copy when already there); NumPy arrays are host tables and
    stay on the host."""
    if isinstance(arg, list):
        if dim != 0 or len(arg) != n:
            raise ValueError(f"shard_map: a list argument holds one item "
                             f"per shard ({len(arg)} for {n} shards, "
                             f"dim {dim})")
        arg = arg[i]
    elif dim is not None:
        size = arg.shape[dim]
        if size % n:
            raise ValueError(f"shard_map: dimension {dim} of size {size} "
                             f"does not split over {n} shards")
        blk = size // n
        if isinstance(arg, torch.Tensor):
            arg = arg.narrow(dim, i * blk, blk)
        else:
            arg = arg[(slice(None),) * dim + (slice(i * blk,
                                                    (i + 1) * blk),)]
    if isinstance(arg, torch.Tensor):
        return arg.to(dev)
    return arg


def shard_map(body, mesh: Mesh, in_dims: tuple, *args, row: int = 0
              ) -> list:
    """Run ``body(i, *local_args)`` once per shard i of the dm axis of
    beam row `row` and return the per-shard outputs in shard order
    (the counterpart of the reference's shard_map over `dm`).
    in_dims[k] is None for an argument every shard receives whole
    (replicated), or the dimension along which argument k is split
    into equal contiguous blocks; a list argument is already split
    (one item per shard, a collective's output) and takes 0."""
    devs = mesh.shard_devices(row)
    n = len(devs)
    return [body(i, *[_local(a, d, i, n, dev)
                      for a, d in zip(args, in_dims)])
            for i, dev in enumerate(devs)]


def shard_dm_table(sub_shifts: np.ndarray, n_dm: int) -> np.ndarray:
    """Pad the (ndms, nsub) stage-2 shift table so ndms divides the dm
    axis size (padded trials repeat the last row; their duplicate
    candidates merge away in sifting)."""
    ndms = sub_shifts.shape[0]
    rem = (-ndms) % n_dm
    if rem:
        pad = np.repeat(sub_shifts[-1:], rem, axis=0)
        sub_shifts = np.concatenate([sub_shifts, pad], axis=0)
    return sub_shifts


def _dd_local(subb: torch.Tensor, shifts) -> torch.Tensor:
    """Per-shard stage 2 on the replicated subband block — the
    counterpart of the reference's _pallas_dd_local (its Pallas
    kernel over static staging geometry, so that it traces inside
    shard_map).  On a CUDA tensor this is one launch of the port's
    stage-2 kernel, dedisperse_kernel<R>, through
    kernels/cuda_dd.dedisperse_subbands, whose host wrapper plans the
    launch from the shard's own shift table; on a CPU tensor its plain
    version.  Both sum in s order with the edge clamp, so the rows are
    bit-identical to the reference's _dedisperse_subbands_scan."""
    from tpulsar_torch.kernels import cuda_dd

    return cuda_dd.dedisperse_subbands(subb, shifts)


# ------------------------------------------------ the (beam, dm) demo step

@dataclasses.dataclass(frozen=True)
class SearchStepSpec:
    """Static configuration of one sharded search step.  (The
    reference's dd_pad, a static shift bound its traced scan needed,
    has no counterpart: stage 2 plans from the host shift table.)"""
    nsub: int
    nfft: int          # padded FFT length (power of 2)
    max_numharm: int
    topk: int
    whiten_edges: tuple[int, ...]
    whiten_est: str = "median"  # block noise estimator


def _local_search(subbands, sub_shifts, keep_mask, spec: SearchStepSpec):
    """Per-shard body: dedisperse the local DM chunk -> rfft -> whiten
    -> interbin -> harmonic top-k.  Returns {stage: (vals, bins)};
    bins are in HALF-BIN units (the dr=0.5 detection grid,
    fourier.interbin_powers)."""
    from tpulsar_torch.kernels import fourier as fr

    series = _dd_local(subbands, sub_shifts)
    series = series - series.mean(dim=-1, keepdim=True)
    nfft = spec.nfft
    T = series.shape[-1]
    if T < nfft:
        series = torch.nn.functional.pad(series, (0, nfft - T))
    else:
        series = series[:, :nfft]
    cspec = torch.fft.rfft(series, dim=-1)
    powers = cspec.abs() ** 2
    powers[..., 0] = 0.0
    powers = powers * keep_mask
    wpow = fr.whiten_powers(powers, spec.whiten_edges,
                            estimator=spec.whiten_est)
    wpow = wpow * keep_mask
    p2 = fr.interbin_powers(fr.scale_spectrum(cspec, powers, wpow))
    return {h: fr.blockmax_topk(fr.harmonic_sum(p2, h), spec.topk)
            for h in fr.harmonic_stages(spec.max_numharm)}


def sharded_search_step(mesh: Mesh, spec: SearchStepSpec):
    """The multi-device search step for one dedispersion pass.

    Returns fn(subbands[nbeams, nsub, T'], sub_shifts[nbeams, ndms,
    nsub], keep_mask[nfft//2+1]) -> {stage: (vals, bins)}, each
    (nbeams, ndms, topk): beam b on beam row b of the mesh, its DM
    trials over that row's dm axis, the candidate blocks gathered
    along dm in shard order."""
    from tpulsar_torch.kernels import fourier as fr

    def step(subbands, sub_shifts, keep_mask):
        subbands = torch.as_tensor(subbands)
        n_beam = mesh.shape["beam"]
        if subbands.shape[0] != n_beam:
            raise ValueError(f"{subbands.shape[0]} beams on a mesh with "
                             f"beam={n_beam}")
        keep = torch.as_tensor(keep_mask, dtype=torch.float32)
        per_beam = []
        for b in range(n_beam):
            parts = shard_map(
                lambda i, subb, sh, k: _local_search(subb, sh, k, spec),
                mesh, (None, 0, None), subbands[b],
                np.asarray(sub_shifts[b]), keep, row=b)
            per_beam.append({
                h: tuple(coll.all_gather([p[h][j] for p in parts], 0)
                         for j in range(2))
                for h in fr.harmonic_stages(spec.max_numharm)})
        dev = mesh.devices[0, 0]
        return {h: tuple(torch.stack([r[h][j].to(dev) for r in per_beam])
                         for j in range(2))
                for h in per_beam[0]}

    return step


# ------------------------------------------------ the production pass

@dataclasses.dataclass(frozen=True)
class PassSpec:
    """Static configuration of the full sharded per-pass search
    (dedisperse -> SP boxcars -> whiten -> lo harmonic stages -> hi
    z-template correlation).  The reference's pallas_dd, dd_stage_s
    and dd_interpret have no counterpart: one stage-2 kernel serves
    every caller, and there is no fallback to switch to."""
    nfft: int                   # FFT-friendly padded series length
    max_numharm: int            # lo-accel harmonic stages
    topk: int
    sp_widths: tuple[int, ...]
    sp_topk: int
    hi: bool                    # run the accelerated (zmax>0) search
    sp_detrend: str = "median"  # SP baseline estimator
    whiten_est: str = "median"  # whitening block estimator
    hi_numharm: int = 8
    hi_seg: int = 0             # TemplateBank geometry
    hi_step: int = 0
    hi_width: int = 0
    hi_nz: int = 0
    dd_pad: int = 0             # the seq route's halo depth (>= max
    #                             sub_shift, <= T'/n_dm)
    seq_sharded: bool = False   # sequence-parallel front end: subbands
    #                             TIME-sharded over dm, stage 2 on each
    #                             time chunk with a ring halo, one
    #                             all_to_all to DM-sharded full-length
    #                             series for the (unchanged) tail


def sharded_pass_fn(mesh: Mesh, spec: PassSpec):
    """The sharded per-pass search.

    Returns fn(subbands[nsub, T'], sub_shifts[ndms, nsub] (host),
               keep_mask[nbins] bool or None, bank_fft[nz, seg] complex
               tensor or None)
    -> dict of gathered tensors (on the mesh's first device):
         lo_vals/lo_bins: (nstages_lo, ndms, topk)
         sp_snr/sp_idx:   (nwidths, ndms, sp_topk)
         hi_vals/hi_rbins/hi_zidx: (ndms, nstages_hi, topk)  [hi only]

    ndms must be a multiple of mesh.shape['dm'] (shard_dm_table pads).
    Only the DM-trial axis is sharded, and the per-trial top-k blocks
    are the only arrays gathered — the reference's embarrassingly
    parallel per-DM loop (PALFA2_presto_search.py:532-594)."""
    from tpulsar_torch.kernels import accel as ak
    from tpulsar_torch.kernels import fourier as fr
    from tpulsar_torch.kernels import singlepulse as sp_k
    from tpulsar_torch.parallel.seq_dedisperse import seq_dedisperse

    def seq_series(subb, shifts) -> list[torch.Tensor]:
        """Sequence-parallel dedispersion: seq_dedisperse's time
        shards (a dd_pad-sample ring halo, stage 2 on each window),
        then the tiled all_to_all from time-sharded (ndms, chunk) to
        DM-sharded (ndms / n_dev, T') series — the Ulysses-style
        reshard (the DM axis is this pipeline's 'heads')."""
        series = seq_dedisperse(subb, shifts, mesh, max_shift=spec.dd_pad)
        return coll.all_to_all(series, split_dim=0, concat_dim=1)

    def tail(i, series, keep, bank):
        norm = sp_k.normalize_series(series, estimator=spec.sp_detrend)
        sp_snr, sp_idx = sp_k.boxcar_search(norm, spec.sp_widths,
                                            spec.sp_topk)
        cspec = fr.complex_spectrum(fr.pad_series(series, spec.nfft))
        powers, wpow = fr.whitened_powers(cspec, keep,
                                          estimator=spec.whiten_est)
        # half-bin detection grid, as on the single-device path: bin
        # indices are in half-bin units (the host applies 0.5)
        wspec = fr.scale_spectrum(cspec, powers, wpow)
        p2 = fr.interbin_powers(wspec)
        lo = [fr.stage_candidates(p2, h, spec.topk)
              for h in fr.harmonic_stages(spec.max_numharm)]
        out = {"lo_vals": torch.stack([v for v, _b in lo]),
               "lo_bins": torch.stack([b for _v, b in lo]),
               "sp_snr": sp_snr, "sp_idx": sp_idx}
        if spec.hi:
            (out["hi_vals"], out["hi_rbins"],
             out["hi_zidx"]) = ak._accel_block_topk(
                wspec, bank, spec.hi_seg, spec.hi_step, spec.hi_width,
                spec.hi_nz, spec.hi_numharm, spec.topk)
        return out

    def fn(subb, shifts, keep, bank):
        shifts = np.asarray(shifts)
        if spec.seq_sharded:
            series = seq_series(subb, shifts)
            parts = shard_map(tail, mesh, (0, None, None),
                              series, keep, bank)
        else:
            parts = shard_map(
                lambda i, s, sh, k, b: tail(i, _dd_local(s, sh), k, b),
                mesh, (None, 0, None, None), subb, shifts, keep, bank)
        dims = {"lo_vals": 1, "lo_bins": 1, "sp_snr": 1, "sp_idx": 1,
                "hi_vals": 0, "hi_rbins": 0, "hi_zidx": 0}
        return {k: coll.all_gather([p[k] for p in parts], d)
                for k, d in dims.items() if k in parts[0]}

    return fn


# --------------------------------------------- ultra-long-series dist pass

def seq_dist_search(mesh: Mesh, subbands, sub_shifts, dms, dt_ds: float,
                    nfft: int, params, axis_name: str = "dm"):
    """One pass over DM trials whose per-trial spectral tail exceeds a
    device (parallel/dist_fft.spectral_bytes_per_trial > the memory
    budget): the seq-shard all_to_all reshard to whole per-device
    series is impossible, so the series STAYS time-sharded end to end
    and the spectrum is computed with the distributed four-step FFT —
    only top-k candidate bins are gathered.

    Returns (candidates, sp_events) like the sharded pass.

    Documented deviations from the single-device tail (this mode only
    engages beyond single-chip scale, far outside the golden
    scenarios): whitening block medians are estimated from each
    device's comb sample of the block (unbiased, not bit-identical);
    single-pulse normalization is per time-chunk; periodicity reports
    FUNDAMENTAL (numharm=1) candidates — harmonic summing across
    transposed shards is future work; zaplists are not applied.
    """
    from tpulsar_torch.kernels import singlepulse as sp_k
    from tpulsar_torch.parallel import dist_fft as dfft
    from tpulsar_torch.parallel.seq_dedisperse import (halo_extend,
                                                       seq_dedisperse)
    from tpulsar_torch.search import degraded, sifting
    from tpulsar_torch.search.executor import _lo_sigma_fn

    n_dev = int(mesh.shape[axis_name])
    nsub, T = subbands.shape
    ndms = len(dms)
    chunk = T // n_dev
    degraded.note("seq_dist_spectral",
                  "per-trial spectrum beyond one device: distributed "
                  "FFT tail, fundamental-only, no zaplist")

    series = seq_dedisperse(subbands, np.asarray(sub_shifts)[:ndms],
                            mesh, axis_name=axis_name)  # time shards

    # single-pulse: local-chunk boxcars with a right halo so no pulse
    # straddling a shard boundary is lost; halo hits are the right
    # neighbour's to report (masked out here)
    sp_halo = max(params.sp_widths)
    est = sp_k.detrend_estimator(params.sp_detrend)

    def sp_body(i, ext):
        norm = sp_k.normalize_series(ext, estimator=est)
        snr, idx = sp_k.boxcar_search(norm, tuple(params.sp_widths),
                                      sp_k.DEFAULT_TOPK)
        snr = torch.where(idx < chunk, snr,
                          torch.full_like(snr, float("-inf")))
        return snr, idx + i * chunk

    sp = shard_map(sp_body, mesh, (0,), halo_extend(series, sp_halo))
    sp_snr = coll.all_gather([s for s, _ in sp], 2)
    sp_idx = coll.all_gather([x for _, x in sp], 2)
    events = sp_k.events_from_topk(
        sp_snr.cpu().numpy(), sp_idx.cpu().numpy(), np.asarray(dms),
        dt_ds, threshold=params.sp_threshold,
        widths=tuple(params.sp_widths))

    # periodicity: per-trial distributed spectral top-k (fundamental)
    nbins = nfft // 2 + 1
    topk = params.topk_per_stage
    vals = np.empty((ndms, topk), np.float32)
    bins = np.empty((ndms, topk), np.int64)
    for i in range(ndms):
        x = _reshard_padded([s[i] for s in series], nfft, mesh)
        vals[i], bins[i] = dfft.dist_spectral_topk(x, mesh, axis_name,
                                                   nfft, topk=topk)
    cands = sifting.make_candidates(
        {1: (vals, bins)}, np.asarray(dms), nfft * dt_ds,
        _lo_sigma_fn(nbins), sigma_min=params.sifting.sigma_threshold)
    return cands, events


def _reshard_padded(parts: list[torch.Tensor], N: int, mesh: Mesh
                    ) -> list[torch.Tensor]:
    """A 1-d series given as contiguous per-shard blocks, zero-padded
    to length N and re-split into N / n blocks, complex64, each built
    on its shard's device from the pieces of the blocks it overlaps
    (peer copies across devices, views on one)."""
    devs = mesh.shard_devices()
    L = N // len(devs)
    starts = np.cumsum([0] + [p.shape[0] for p in parts])
    out = []
    for j, dev in enumerate(devs):
        lo, hi = j * L, (j + 1) * L
        pieces = [p[max(lo, s0) - s0: min(hi, s0 + p.shape[0]) - s0]
                  .to(dev) for p, s0 in zip(parts, starts[:-1])
                  if s0 < hi and s0 + p.shape[0] > lo]
        have = sum(x.shape[0] for x in pieces)
        pieces.append(torch.zeros(L - have, dtype=parts[0].dtype,
                                  device=dev))
        out.append(torch.cat(pieces).to(torch.complex64))
    return out
