"""Regenerate models/ub_cache.json: the per-robot UltimateBound constants
(mass-matrix eigenvalue bracket, certified m_min where it holds, and the
co-derived V_max / eps), counterpart of scripts/derive_ub_cache.py.

    python3 -m armour_tpu_torch.scripts.derive_ub_cache [out.json]

The derivation (config.derive_ultimate_bound: the sampled bracket and the
interval branch-and-bound of certify.py) and the flatness evidence of the
uncertified robots are host float64 work, as in the JAX package: this
module stays on the CPU and launches no kernel.  By default it writes this
package's armour_tpu_torch/models/ub_cache.json.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..config import _ub_cache_key, derive_ultimate_bound
from ..models import zoo
from ..models.kinova import kinova_gen3

CACHE = Path(__file__).resolve().parent.parent / "models" / "ub_cache.json"

WAIVER = (
    "m_min is the SAMPLED heuristic, not certified: this arm's URDF carries "
    "no transmission/rotor inertia, so lambda_min(M) ~ 1e-3 is dominated by "
    "the bare wrist-link inertia and is nearly FLAT over the joint box "
    "(flatness evidence: sampled_min vs sampled_p05/p50 below), which makes "
    "sampling low-variance but puts a certified-positive interval bound out "
    "of reach (the B&B enclosure certifies 0).  Backstop: the closed-loop "
    "ultimate_bound oracle (simulator.py) checks the realized tracking "
    "error on every move."
)


def _flatness(r, n=4096, seed=1):
    """min / 5th pct / median of sampled lambda_min(M): near-equal values
    mean the minimum is achieved on a flat manifold, so the sampled bound
    has low variance (the waiver's quantitative evidence)."""
    from .. import rnea_numeric

    rng = np.random.default_rng(seed)
    lo = np.maximum(r.position_limits_lb, -3.141592653589793)
    hi = np.minimum(r.position_limits_ub, 3.141592653589793)
    qs = rng.uniform(lo, hi, (n, r.num_factors))
    with torch.no_grad():
        M = rnea_numeric.mass_matrix(r, torch.as_tensor(qs, dtype=torch.float64)).numpy()
    ev = np.linalg.eigvalsh(M)[..., 0]
    return {"sampled_min": float(ev.min()),
            "sampled_p05": float(np.percentile(ev, 5)),
            "sampled_p50": float(np.percentile(ev, 50)),
            "n_samples": n}


def derive_ub_cache(*, out=None) -> dict:
    """Derive the entry of the flagship Kinova and of every zoo robot, write
    them to `out` (this package's cache by default) with indent 1, sorted
    keys and a final newline, and return them."""
    robots = [kinova_gen3()] + [zoo.load_zoo_robot(n) for n in zoo.list_robots()]
    entries = {}
    for r in robots:
        t0 = time.perf_counter()
        ub, prov = derive_ultimate_bound(r, use_cache=False, return_provenance=True)
        dt = time.perf_counter() - t0
        if not prov["certified"]:
            prov["waiver"] = WAIVER
            prov["flatness"] = _flatness(r)
        key = _ub_cache_key(r, 10.0, 5.0, 512, 0, 0.1, 0.4)
        entries[key] = {**dataclasses.asdict(ub), "provenance": prov}
        print(f"{r.name}: m_min={ub.m_min:.4g} "
              f"({'CERTIFIED' if prov['certified'] else 'sampled/waived'}) "
              f"m_max={ub.m_max:.4g} v_max={ub.v_max:.4g} eps={ub.eps:.4g} "
              f"qde={ub.qde:.4g} "
              f"min_speed={float(min(r.speed_limits)):.4g}  [{dt:.1f}s]", flush=True)
    p = Path(CACHE if out is None else out)
    p.write_text(json.dumps(entries, indent=1, sort_keys=True) + "\n")
    print(f"wrote {p}")
    return entries


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    derive_ub_cache(out=argv[0] if argv else None)


if __name__ == "__main__":
    main()
