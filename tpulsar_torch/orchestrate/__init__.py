"""Orchestration — counterpart of tpulsar/orchestrate/: the
job-tracker DB (jobtracker.py), the downloader and its transports
(downloader.py, transports.py), the job pool and its queue backends
(pool.py, queue_managers/), the uploader with its results DB,
verify-after-write uploadables and diagnostics (uploader.py,
results_db.py, uploadables.py, diagnostics.py), and the custom-zaplist
refresh (zaplists.py).  Both packages' daemons share one tracker DB
and one results DB schema."""
