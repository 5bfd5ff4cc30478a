"""The yardstick's peaks and the least work each measured layer needs.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor
cores.  Bytes count each input byte read once and each output byte
written once; operations count what the problem needs at the
configuration's stated precision (float32), never what one
implementation happens to do.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

#: the hi stage's overlap-save constants, frozen here: a segment of
#: SEG spectrum bins is correlated at the half-bin grid (2 * SEG
#: points) against each z template of template_width(zmax) bins
HI_SEG = 1 << 13
HI_DZ = 2.0
#: bytes of one hi-stage candidate written (power f32, r int32, z f32)
HI_CAND_BYTES = 12


def choose_n(n: int, factors=(2, 3, 5, 7), multiple_of: int = 64) -> int:
    """Smallest FFT length >= n that is a product of the small primes
    and a multiple of 64 (PRESTO's choose_N as the survey pads each
    dedispersed series)."""
    if n <= multiple_of:
        return multiple_of
    target = -(-n // multiple_of)
    best = None
    stack = [(1, 0)]
    while stack:
        prod, i = stack.pop()
        if prod >= target:
            if best is None or prod < best:
                best = prod
            continue
        for j in range(i, len(factors)):
            nxt = prod * factors[j]
            if best is None or nxt < best:
                stack.append((nxt, j))
    return best * multiple_of


def pass_nbins(nsamp: int, downsamp: int) -> int:
    """Spectrum bins of one dedispersed series of a pass."""
    return choose_n(nsamp // downsamp) // 2 + 1


def stage1_bytes(nchan: int, nsamp: int, nsub: int, downsamp: int,
                 in_itemsize: int = 1) -> int:
    """Subband formation: the block read once, the float32 subbands
    written once."""
    return nchan * nsamp * in_itemsize + nsub * (nsamp // downsamp) * 4


def stage2_bytes(nsub: int, nsamp: int, downsamp: int, ndms: int) -> int:
    """Dedispersion: the float32 subbands read once, every float32
    trial row written once."""
    t = nsamp // downsamp
    return (nsub + ndms) * t * 4


def template_width(zmax: float) -> int:
    """Template length in bins: the drift plus the Fresnel ringing,
    rounded up to a power of two."""
    w = int(2 * math.ceil(abs(zmax) / 2) + 32)
    return int(2 ** math.ceil(math.log2(w)))


def hi_nz(zmax: float) -> int:
    return 2 * int(round(zmax / HI_DZ)) + 1


def hi_row_flops(nbins: int, zmax: float) -> float:
    """The hi stage's FFT correlation of one spectrum: one forward FFT
    of each segment and one inverse a (segment, z), 5 N log2 N each at
    N = 2 * HI_SEG."""
    step = HI_SEG - template_width(zmax)
    nsegs = -(-nbins // step)
    n = 2 * HI_SEG
    return nsegs * (1 + hi_nz(zmax)) * 5.0 * n * math.log2(n)


def hi_row_bytes(nbins: int, numharm: int, topk: int) -> int:
    """The complex64 spectrum read once and the candidates written
    once: no plane."""
    nstages = int(math.log2(numharm)) + 1
    return nbins * 8 + nstages * topk * HI_CAND_BYTES


def hi_row_bound_s(nbins: int, zmax: float, numharm: int,
                   topk: int) -> float:
    return max(hi_row_flops(nbins, zmax) / F32_FLOP_PER_S,
               hi_row_bytes(nbins, numharm, topk) / HBM_BYTES_PER_S)
