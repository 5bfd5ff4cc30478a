"""Dedispersion planning: smearing-balanced DM steps and survey plans."""

from tpulsar_torch.plan.ddplan import (  # noqa: F401
    DedispPass,
    DedispStep,
    Observation,
    dm_smear,
    generate_ddplan,
    guess_dmstep,
    survey_plan,
)
