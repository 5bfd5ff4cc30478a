"""The data plane — counterpart of tpulsar/dataplane/: so far the
persistent candidate index (index.py).  The blob store and its
transfer client are not ported yet."""
