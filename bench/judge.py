"""The comparison that decides ``correct``.

Every answer of every call the run made is judged against the plain
reference (``bench/references/<name>.py``), once the window has closed and
the program's state is freed.  Four numbers are compared, each with its
limit (PERF.md gives the readings each limit was set from):

* ``undelivered``: queries whose answer is missing or holds an id outside
  the base set (the engines write -1 for a query that never finished).
  An exact count: limit 0.
* ``bad_rows``: answered queries whose ids repeat or whose distances do
  not ascend.  An exact count: limit 0.
* ``dist_rel_err``: the largest relative gap between a distance the
  program reported and the reference's float32 distance of the same id.
  The engines re-rank by exact distance, so a sound run reads float32's
  rounding; a distance from a lower precision, or an id or distance
  altered where it is produced, reads far above it.

* ``recall_miss``: 1 - recall@k over every answer, against 1 - the
  configuration's ``recall_floor``, the operating point it states.  An
  approximate search misses some neighbours, so sound runs read well above
  0; a search that lost part of its work (a kernel that scores with a
  part of the PQ subspaces, a partition's results left out of a gather)
  still returns real ids at exact distances, and only this number sees it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# limit of dist_rel_err: sound runs read at most ~1e-6 (float32 rounding of
# a sum of 96 squares in another order), the TF32 control ~1e-3 and more
DIST_REL_ERR_LIMIT = 1e-4


@dataclasses.dataclass
class Verdict:
    correct: bool
    attempted: int
    failed: int
    recall: float
    checks: dict        # name -> {"value": ..., "limit": ...}

    def lines(self) -> list:
        return [f"check {name}: {c['value']} (limit {c['limit']})"
                for name, c in self.checks.items()]


def judge(ref_mod, base: torch.Tensor, queries: torch.Tensor,
          ids: np.ndarray, dists: np.ndarray, k: int, recall_floor: float,
          block: int = 1024) -> Verdict:
    """Judge (Q, k) answers to ``queries`` (rows of all calls, in order)
    over ``base`` (N, d), both on the reference's device."""
    n = base.shape[0]
    ids_t = torch.as_tensor(np.ascontiguousarray(ids[:, :k]), device=base.device)
    dists_t = torch.as_tensor(np.ascontiguousarray(dists[:, :k], np.float32),
                              device=base.device)
    valid = ((ids_t >= 0) & (ids_t < n)).all(1)
    undelivered = int((~valid).sum())

    srt = torch.sort(ids_t, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    unsorted = (dists_t[:, 1:] < dists_t[:, :-1]).any(1)
    bad_rows = int((valid & (dup | unsorted)).sum())

    hits, worst = 0, 0.0
    for s in range(0, queries.shape[0], block):
        q = queries[s:s + block]
        ok = valid[s:s + block]
        got = ids_t[s:s + block]
        exact = ref_mod.search(base, q, k)
        hit = (got[:, :, None] == exact[:, None, :]).any(2) & ok[:, None]
        hits += int(hit.sum())
        if bool(ok.any()):
            ref_d = ref_mod.distances(base, q[ok], got[ok])
            gap = (dists_t[s:s + block][ok] - ref_d).abs() / \
                ref_d.clamp_min(torch.finfo(torch.float32).tiny)
            gap = torch.where(torch.isnan(gap), torch.inf, gap)
            worst = max(worst, float(gap.max()))
    n_q = queries.shape[0]
    recall = hits / (n_q * k)
    checks = {
        "undelivered": {"value": undelivered, "limit": 0},
        "bad_rows": {"value": bad_rows, "limit": 0},
        "dist_rel_err": {"value": worst, "limit": DIST_REL_ERR_LIMIT},
        "recall_miss": {"value": 1.0 - recall, "limit": 1.0 - recall_floor},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return Verdict(correct=correct, attempted=n_q, failed=undelivered,
                   recall=recall, checks=checks)
