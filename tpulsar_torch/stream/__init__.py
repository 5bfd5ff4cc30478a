"""The streaming plane — counterpart of tpulsar/stream/: chunked
ingest + incremental dedispersion + bounded-latency single-pulse
triggers.

Everything else in the port searches a whole beam; this package is
the real-time second data path.  Chunk frames arrive through a
session spool (stream/ingest.py, the JAX package's frame format,
manifest and triggers.jsonl byte for byte), are dedispersed against
a carried per-channel buffer (stream/dedisp_state.py — each emission
is one launch of the CUDA stage-2 kernel with the channels as its
"subbands", bit-identical to the batch dedispersion of the whole
block), and completed spans are searched for single pulses with a
per-chunk latency SLO (stream/trigger.py).  stream/worker.py ties the
plane to the ticket queue's exactly-once machinery and the checkpoint
store, so a SIGKILLed session resumes without reprocessing
acknowledged chunks; the JAX package's worker and server read and
write the same files.

ingest and worker import no kernel module; dedisp_state and trigger
reach the kernels only on the torch backend.
"""

#: default stream profile — the session geometry the CPU tests use
#: and the stream server's boot warms (one emission).  dm_max is
#: chosen so the maximum channel delay stays inside one 256-sample pad
#: bucket (the window width is chunk_len + 256 for every DM list under
#: it).  The same values as the JAX package's STREAM_PROFILE.
STREAM_PROFILE = {"nchan": 64, "chunk_len": 1024, "ndms": 32,
                  "span_chunks": 4, "f_lo_mhz": 1300.0,
                  "f_hi_mhz": 1500.0, "dt": 1e-4, "dm_max": 30.0}
