"""The interleaved plan is the survey plan, in proportion at every
prefix."""

import numpy as np

from port_bench import harness, plan
from tpulsar_torch.plan import ddplan


def table():
    _c, cfg, _t = harness.find_cell(harness.load_benchmark(),
                                     "mock_default.plan")
    return cfg["plan"]


def test_table_is_the_survey_plan():
    assert [tuple(r) for r in table()] == \
        [tuple(float(x) if i < 2 else x for i, x in enumerate(r))
         for r in ddplan._PALFA_MOCK]


def test_interleaved_passes_equal_the_survey_plan():
    il = plan.interleaved(table())
    assert len(il) == 57 and plan.total_trials(il) == 4188
    survey = [(s.downsamp, s.numsub, p.subdm, p.dms)
              for s in ddplan.survey_plan("pdev") for p in s.passes()]
    mine = [(p.downsamp, p.numsub, p.subdm, p.dms) for p in il]
    assert sorted(mine) == sorted(survey)
    # each pass as the one-pass step the program is handed
    for p, step in zip(il, harness.program_plan(il)):
        (q,) = step.passes()
        assert (q.subdm, q.dms) == (p.subdm, p.dms)


def test_every_prefix_is_in_proportion():
    t = table()
    il = plan.interleaved(t)
    n = np.asarray([r[3] for r in t], float)
    counts = np.zeros(len(t))
    for m, p in enumerate(il, start=1):
        counts[p.step] += 1
        assert np.all(np.abs(counts - m * n / n.sum()) <= 1.0)


def test_warm_passes_cover_every_step_once():
    w = plan.warm_passes(table())
    assert [p.step for p in w] == list(range(6))
