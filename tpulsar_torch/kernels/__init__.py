"""PyTorch compute stages and the CUDA kernels — the counterparts of
``tpulsar.kernels``:

  rfi.py          <- rfifind          (time-freq stats + mask)
  dedisperse.py   <- prepsubband      (subbands + incoherent dedispersion)
  cuda_dd.py      <- the stage-1 and stage-2 CUDA kernels that replace
                     tpulsar/kernels/pallas_dd.py (stage 2 with a beam
                     axis too)
  tree_dd.py      <- the log-depth shift-tree stage-2 family
  beam_batch.py   <- batch-of-beams planning and coalesced stages 1, 2
  fourier.py      <- realfft, zapbirds, rednoise + zero-accel periodicity
  accel.py        <- accelsearch -zmax (FDAS hi-accel stage)
  accel_batch.py  <- the hi stage's host-side batch planner
  fold.py         <- prepfold (per-candidate fold + p/pdot/DM search)
  fold_batch.py   <- prepfold, tier-batched (the default fold path)
  singlepulse.py  <- single_pulse_search (boxcar matched filter)
"""
