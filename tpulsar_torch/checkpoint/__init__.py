"""Checkpointed beam search: pass-level crash resume with
checksummed artifact manifests (see store.py for the contract) —
counterpart of tpulsar/checkpoint/."""

from tpulsar_torch.checkpoint.hashing import (  # noqa: F401
    sha256_bytes,
    sha256_file,
)
from tpulsar_torch.checkpoint.store import (  # noqa: F401
    MANIFEST,
    SCHEMA,
    CheckpointStore,
    clean,
    default_root,
    manifest_path,
    progress_marker,
    read_manifest,
    verify_root,
)
