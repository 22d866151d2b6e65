"""The verdict: each number the reference read, beside its limit.

A cell's limits are ``portbench/limits/<workload>.json``: a number's name
and the most it may read (under ``"tiny"``, the limits of the CPU tests'
tiny sizes). A run is correct when every number named there is within
its limit; a limit without a number makes the run incorrect (a check
that was not made has not passed).
"""

from __future__ import annotations

import math
from typing import Dict, List


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict:
    checks = {}
    ok = True
    for name in sorted(limits):
        v, lim = readings.get(name), limits.get(name)
        good = (v is not None and lim is not None and not math.isnan(v)
                and v <= lim)
        ok = ok and good
        checks[name] = {"value": v, "limit": lim}
    return {"correct": bool(ok), "checks": checks}


def lines(verdict: Dict) -> List[str]:
    out = [f"check {name}: {c['value']} (limit {c['limit']})"
           for name, c in verdict["checks"].items()]
    out.append(f"correct: {verdict['correct']}")
    return out
