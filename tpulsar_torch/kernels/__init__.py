"""PyTorch compute stages and the CUDA kernels — the counterparts of
``tpulsar.kernels``:

  rfi.py          <- rfifind          (time-freq stats + mask)
  dedisperse.py   <- prepsubband      (subbands + incoherent dedispersion)
  cuda_dd.py      <- the stage-1 and stage-2 CUDA kernels that replace
                     tpulsar/kernels/pallas_dd.py
  fourier.py      <- realfft, zapbirds, rednoise + zero-accel periodicity
  singlepulse.py  <- single_pulse_search (boxcar matched filter)
"""
