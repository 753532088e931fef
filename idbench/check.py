"""The comparison that decides ``correct``.

Once the window has closed and the program's index is freed, the kind's
``Reference`` (``kinds/<kind>.py``) makes the inputs again from the seed,
has its plain reference under ``reference/`` read every sampled result as
the timed path returned it, and hands ``judge`` one reading per sampled
query for each of its numbers. Each number is reported as its largest
reading, beside its limit from the configuration file (``limits``); a
reading for every limit, and a limit for every reading, or ``judge``
raises, so a kind cannot leave a stated limit unchecked.
"""

from __future__ import annotations

from typing import Dict

import torch


def judge(per: Dict[str, torch.Tensor], limits: dict) -> dict:
    """{number: (largest reading, limit)} of the readings ``per`` (one a
    sampled query), and the count of sampled queries that break a limit,
    under ``"failed"``. Raises ``ValueError`` where there are no limits, or
    the numbers read are not those that ``limits`` names."""
    if not limits or set(per) != set(limits):
        raise ValueError(f"the check read {sorted(per)}, the configuration's limits are "
                         f"{sorted(limits)}")
    bad = False
    out = {}
    for name, x in per.items():
        bad = bad | ~(x <= limits[name])  # NaN breaks too
        out[name] = (float(x.max()) if x.numel() else 0.0, limits[name])
    out["failed"] = int(bad.sum())
    return out


def numbers(result: dict) -> list:
    """The numbers of a ``judge`` result, in its order."""
    return [n for n in result if n != "failed"]


def passed(result: dict) -> bool:
    return result["failed"] == 0 and all(result[n][0] <= result[n][1] for n in numbers(result))
