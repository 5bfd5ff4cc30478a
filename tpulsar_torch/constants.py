"""Physical constants and survey conventions shared across tpulsar.

The dispersion constant follows the pulsar-community convention used by
the reference pipeline's compute plane (PRESTO): the cold-plasma
dispersion delay between infinite frequency and frequency f is

    t(s) = DM / (2.41e-4 * f_MHz**2)

i.e. K_DM = 1/2.41e-4 ~= 4148.808 MHz^2 pc^-1 cm^3 s.  Using the exact
same constant as the reference's executables is required for
candidate-list parity (reference: lib/python/DDplan2b.py:30 uses the
equivalent 0.000241 form).
"""

# Dispersion constant, MHz^2 s per (pc cm^-3).
KDM = 1.0 / 2.41e-4

SECPERDAY = 86400.0

# Speed of light, m/s (used by barycentric velocity estimates).
C_MS = 299792458.0


def dispersion_delay_s(dm, freqs_mhz, ref_mhz):
    """Cold-plasma dispersion delay (s) of each frequency relative to
    ref_mhz; positive for freqs below the reference.  The single
    source of truth for the delay convention — synth, kernels, and
    planning all import this."""
    import numpy as np

    return KDM * np.asarray(dm) * (np.asarray(freqs_mhz, dtype=np.float64)
                                   ** -2.0 - float(ref_mhz) ** -2.0)
