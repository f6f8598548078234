"""Replace provably-impossible scenes in a world suite with solvable ones
(counterpart of scripts/regenerate_unsolvable.py).

    python3 -m armour_tpu_torch.scripts.regenerate_unsolvable [results.json] [world_dir]

Reads the solvability verdicts that solvability.main attached to a results
file; every scene whose verdict is static_blocked, no_path_found,
frs_blocked_start or frs_blocked_goal is regenerated (same obstacle count,
the solvability-checked sampler of worlds.random_world, one generator
seeded 20260821 for the whole file) IN PLACE under its original filename.
A sidecar REGENERATED.json in world_dir records which scenes were replaced
and why.  The sampler's rest-FRS test runs on the card unless the caller
passes device="cpu".
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..planner import resolve_device
from ..worlds import load_world_csv, random_world, save_world_csv

IMPOSSIBLE = ("static_blocked", "no_path_found", "frs_blocked_start", "frs_blocked_goal")


def regenerate_unsolvable(results, world_dir, robot, *, device=None) -> list:
    """Regenerate, in place under world_dir, every scene that the results
    file at path `results` marks impossible; write world_dir/REGENERATED.json
    and return its "replaced" list."""
    dev = resolve_device(device)
    with open(results) as f:
        doc = json.load(f)
    replaced = []
    rng = np.random.default_rng(20260821)
    for rec in doc["results"]:
        v = rec.get("solvability")
        if not v or v["verdict"] not in IMPOSSIBLE:
            continue
        path = os.path.join(world_dir, rec["world"])
        old = load_world_csv(path)
        w = random_world(rng, robot, old.num_obstacles, ensure_solvable=True, device=dev)
        save_world_csv(w, path)
        replaced.append({"world": rec["world"], "verdict": v["verdict"],
                         "n_obstacles": int(old.num_obstacles)})
        print(f"regenerated {rec['world']} ({v['verdict']}, "
              f"{old.num_obstacles} obstacles)", flush=True)
    sidecar = os.path.join(world_dir, "REGENERATED.json")
    with open(sidecar, "w") as f:
        json.dump({"replaced": replaced, "source_results": results}, f, indent=1)
    print(f"{len(replaced)} scenes replaced; log in {sidecar}")
    return replaced


def main(argv=None) -> None:
    from ..models.kinova import kinova_gen3

    argv = sys.argv[1:] if argv is None else argv
    results = argv[0] if len(argv) > 0 else "results_worlds.json"
    world_dir = argv[1] if len(argv) > 1 else "saved_worlds/random"
    regenerate_unsolvable(results, world_dir, kinova_gen3())


if __name__ == "__main__":
    main()
