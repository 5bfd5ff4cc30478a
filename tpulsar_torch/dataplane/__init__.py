"""The data plane — counterpart of tpulsar/dataplane/: the
content-addressed blob store (blobstore.py), its HTTP client
(transfer.py) and the persistent candidate index (index.py)."""
