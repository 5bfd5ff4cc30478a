"""Carrying a search's state across from the JAX package.

The search has no model weights: its carried state is the search
configuration, the dedispersion plan and the RFI mask.  These helpers
take each in the plain form the JAX package exports it (a provenance
dict, plain tuples or dicts, an `_rfifind.npz` file), so that both
packages can search with identical configuration without this package
importing the other.
"""

from __future__ import annotations

import dataclasses

from tpulsar_torch.kernels.rfi import RFIMask
from tpulsar_torch.plan.ddplan import DedispStep
from tpulsar_torch.search.executor import SearchParams
from tpulsar_torch.search.sifting import SiftParams

_STEP_FIELDS = tuple(f.name for f in dataclasses.fields(DedispStep))


def search_params_from_jax(provenance: dict) -> SearchParams:
    """SearchParams from the JAX package's SearchParams.provenance()
    dict (the same field names, the sifting block as a nested dict).
    An unknown field raises TypeError rather than being dropped."""
    d = dict(provenance)
    sift = d.pop("sifting", None)
    if isinstance(sift, dict):
        d["sifting"] = SiftParams(**sift)
    elif sift is not None:
        d["sifting"] = SiftParams(**dataclasses.asdict(sift))
    if "sp_widths" in d:
        d["sp_widths"] = tuple(int(w) for w in d["sp_widths"])
    return SearchParams(**d)


def plan_from_jax(steps) -> list[DedispStep]:
    """DedispSteps from the JAX package's plan: each step as a tuple
    (lodm, dmstep, dms_per_pass, numpasses, numsub, downsamp), a dict
    with those keys, or any object with those attributes."""
    out = []
    for s in steps:
        if isinstance(s, dict):
            vals = [s[k] for k in _STEP_FIELDS]
        elif isinstance(s, (tuple, list)):
            vals = list(s)
        else:
            vals = [getattr(s, k) for k in _STEP_FIELDS]
        if len(vals) != len(_STEP_FIELDS):
            raise ValueError(f"a plan step has {len(_STEP_FIELDS)} "
                             f"fields {_STEP_FIELDS}, got {vals!r}")
        lodm, dmstep, dpp, npass, nsub, ds = vals
        out.append(DedispStep(float(lodm), float(dmstep), int(dpp),
                              int(npass), int(nsub), int(ds)))
    return out


def load_rfi_mask(path: str) -> RFIMask:
    """Read an `_rfifind.npz` written by either package."""
    return RFIMask.load(path)


def save_rfi_mask(mask: RFIMask, path: str, qscale=None,
                  qoff=None) -> None:
    """Write an `_rfifind.npz` that the JAX package's RFIMask.load
    reads back equal."""
    mask.save(path, qscale=qscale, qoff=qoff)
