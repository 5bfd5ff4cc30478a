"""The synthetic PALFA Mock beam a run searches, made on the device.

A beam is the block that the per-beam search hands to search_block
for a 4-bit Mock observation: (nchan, nsamp) uint8 levels 0..15,
channel-major, channels in ascending frequency.  Each level is
round(mean + std * N(0, 1) + pulse) clipped to 0..15, where the pulse
is one dispersed pulsar: a top-hat of the drawn duty cycle whose
phase drifts as a constant frequency derivative, so that its
fundamental drifts by the drawn z bins over the observation.  The
pulsar's period, DM, duty cycle, drift, phase and single-pulse S/N are
drawn from the traffic file's ranges by the seed; the noise comes from
a torch.Generator on the device seeded the same way.  The same seed
gives the same block.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

#: dispersion constant, MHz^2 s per (pc cm^-3) (PRESTO's 1 / 2.41e-4)
KDM = 1.0 / 2.41e-4


@dataclasses.dataclass(frozen=True)
class Geometry:
    nchan: int
    nsamp: int
    tsamp_s: float
    fctr_mhz: float
    bw_mhz: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Geometry":
        b = cfg["beam"]
        return cls(int(b["nchan"]), int(b["nsamp"]), float(b["tsamp_s"]),
                   float(b["fctr_mhz"]), float(b["bw_mhz"]))

    def freqs(self) -> np.ndarray:
        """Ascending channel centre frequencies (MHz)."""
        df = self.bw_mhz / self.nchan
        lo = self.fctr_mhz - self.bw_mhz / 2 + df / 2
        return lo + np.arange(self.nchan) * df


@dataclasses.dataclass(frozen=True)
class Pulsar:
    period_s: float
    dm: float
    duty: float
    z: float             # drift of the fundamental over the beam, bins
    phase0: float
    sp_snr: float        # S/N of one pulse at its own width, all channels


def draw_pulsar(traffic: dict, seed: int) -> Pulsar:
    """The seed's pulsar, from the traffic file's ranges (the period
    log-uniform, the rest uniform)."""
    rng = np.random.default_rng(int(seed))
    r = traffic["pulsar"]
    lo, hi = r["period_s"]
    period = float(math.exp(rng.uniform(math.log(lo), math.log(hi))))
    return Pulsar(period_s=period,
                  dm=float(rng.uniform(*r["dm"])),
                  duty=float(rng.uniform(*r["duty"])),
                  z=float(rng.uniform(*r["z"])),
                  phase0=float(rng.uniform(0.0, 1.0)),
                  sp_snr=float(rng.uniform(*r["sp_snr"])))


def make_beam(geom: Geometry, traffic: dict, seed: int,
              device: torch.device) -> tuple[torch.Tensor, Pulsar]:
    """The seed's (nchan, nsamp) uint8 block on `device`, and its
    pulsar.  Made a few channels at a time, so the float temporaries
    stay near a gigabyte."""
    psr = draw_pulsar(traffic, seed)
    noise = traffic["noise"]
    mean, std = float(noise["mean"]), float(noise["std"])
    nlev = int(noise["levels"]) - 1
    freqs = geom.freqs()
    delays = KDM * psr.dm * (freqs ** -2.0 - freqs[-1] ** -2.0)
    width = psr.duty * psr.period_s / geom.tsamp_s      # samples
    amp = psr.sp_snr * std / math.sqrt(geom.nchan * max(width, 1.0))
    f0 = 1.0 / psr.period_s
    fdot = psr.z / (geom.nsamp * geom.tsamp_s) ** 2
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    t = torch.arange(geom.nsamp, dtype=torch.float64,
                     device=device) * geom.tsamp_s
    block = torch.empty((geom.nchan, geom.nsamp), dtype=torch.uint8,
                        device=device)
    group = max(1, min(geom.nchan, (1 << 27) // geom.nsamp))
    for c0 in range(0, geom.nchan, group):
        c1 = min(geom.nchan, c0 + group)
        x = torch.randn((c1 - c0, geom.nsamp), generator=gen,
                        device=device, dtype=torch.float32)
        x.mul_(std).add_(mean)
        d = torch.as_tensor(delays[c0:c1], device=device)
        tt = t[None, :] - d[:, None]
        ph = psr.phase0 + f0 * tt + 0.5 * fdot * tt * tt
        on = (ph - torch.floor(ph)) < psr.duty
        del tt, ph
        x.add_(on.to(torch.float32), alpha=amp)
        del on
        block[c0:c1] = torch.clamp(torch.round(x), 0, nlev).to(torch.uint8)
        del x
    return block, psr
