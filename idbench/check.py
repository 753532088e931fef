"""The comparison that decides ``correct``.

Once the window has closed and the program's index is freed, the inputs
are made again from the seed and the float64 reference
(``reference/ivf.py``) judges every sampled query's result, as the timed
path returned it. Two numbers, each the largest over the sampled queries,
each beside its limit from the configuration file (``limits``):

- ``dist_err``: a returned distance against the reference's distance of the
  returned id, relative to 2 ||x||^2 (the scan, the translate);
- ``rank_gap``: the returned results against the reference's top-k over
  the lists the query surely probes (the coarse stage, the scan's
  completeness, the merge; a missing, repeated or unprobed id reads
  ``reference.ivf.MISSING``).
"""

from __future__ import annotations

import torch

from .reference.ivf import ReferenceIVF

NUMBERS = ("dist_err", "rank_gap")


def judge(ref: ReferenceIVF, xq: torch.Tensor, D: torch.Tensor, I: torch.Tensor,
          nprobe: int, limits: dict) -> dict:
    """{number: (largest reading, limit)}, and the count of sampled queries
    that break a limit, under ``"failed"``."""
    dist_err, rank_gap = ref.judge(xq, D, I, nprobe)
    per = {"dist_err": dist_err, "rank_gap": rank_gap}
    bad = torch.zeros_like(dist_err, dtype=torch.bool)
    out = {}
    for name in NUMBERS:
        bad |= ~(per[name] <= limits[name])  # NaN breaks too
        out[name] = (float(per[name].max()) if per[name].numel() else 0.0, limits[name])
    out["failed"] = int(bad.sum())
    return out


def passed(result: dict) -> bool:
    return result["failed"] == 0 and all(result[n][0] <= result[n][1] for n in NUMBERS)
