"""The result store: query candidates out of finished tickets —
counterpart of tpulsar/frontdoor/results.py (the outdir parse is
``dataplane/index.py::candidate_rows``, shared with the index's
rebuild path rather than copied twice).

The serving stack already makes every beam's outcome durable — a
result record in the queue plus a results directory (search_params,
report, ``*.accelcands``, tarballs) laid out identically to the batch
path.  This module is the read side the gateway serves: it joins the
two (result record -> outdir -> parsed candidate list) into JSON rows
a network client can query without filesystem access to the host.

Candidates come from the sifted ``<basenm>.accelcands`` list
(io/accelcands.py — the same file the uploader consumes), so the
query API returns exactly what the pipeline would upload, not a
recomputation.
"""

from __future__ import annotations

import os

from tpulsar_torch.dataplane.index import candidate_rows


def result_with_candidates(queue, ticket: str) -> dict | None:
    """One ticket's terminal record joined with its candidate rows
    (None while the ticket has no result yet)."""
    rec = queue.read_result(ticket)
    if rec is None:
        return None
    out = dict(rec)
    outdir = rec.get("outdir", "")
    out["candidates"] = (candidate_rows(outdir)
                         if outdir and os.path.isdir(outdir) else [])
    return out


def query_candidates(queue, ticket: str | None = None,
                     min_sigma: float = 0.0,
                     limit: int = 200) -> dict:
    """The candidate query API: rows across one ticket (or every done
    ticket), filtered by sigma, sorted strongest first, truncated to
    ``limit`` with the truncation made explicit (``truncated: true``
    plus ``total`` counting the matching rows BEFORE the cut — a
    capped result must never read as a complete one).  A
    non-positive ``limit`` is a caller bug and raises ValueError
    (the gateway answers 400), never a silent clamp."""
    if limit <= 0:
        raise ValueError(f"limit must be positive (got {limit})")
    tickets = ([ticket] if ticket is not None
               else queue.list_tickets("done"))
    rows: list[dict] = []
    searched = 0
    for tid in tickets:
        rec = queue.read_result(tid)
        if rec is None or rec.get("status") != "done":
            continue
        searched += 1
        outdir = rec.get("outdir", "")
        if not outdir or not os.path.isdir(outdir):
            continue
        for row in candidate_rows(outdir):
            if row.get("sigma", 0.0) < min_sigma:
                continue
            row["ticket"] = tid
            rows.append(row)
    rows.sort(key=lambda r: -r.get("sigma", 0.0))
    return {"total": len(rows), "returned": min(len(rows), limit),
            "truncated": len(rows) > limit,
            "tickets_searched": searched,
            "min_sigma": min_sigma, "source": "parse",
            "candidates": rows[:limit]}
