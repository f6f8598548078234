"""Extract the multi-robot model zoo from the reference URDFs into a
self-contained JSON data bundle (counterpart of
scripts/extract_robot_zoo.py).

    python3 -m armour_tpu_torch.scripts.extract_robot_zoo [ref_dir]

Run at development time; the package itself only reads the bundle.  The
reference supports these robots through urdfs/ + load_robot_params.m; the
same kinematic / inertial data is extracted with this package's parser
(models/urdf.py) and mesh boxes (models/mesh.py) and stored as plain
numeric arrays.  main writes this package's models/zoo_data.json.  The
reference tree is ~/reference/urdfs by default; a missing tree raises.
"""

from __future__ import annotations

import dataclasses
import io
import json
import sys
from pathlib import Path

import numpy as np

from ..models.mesh import link_boxes_from_urdf
from ..models.urdf import load_urdf

REF = Path.home() / "reference" / "urdfs"
BUNDLE = Path(__file__).resolve().parent.parent / "models" / "zoo_data.json"

# robot name -> URDF path under the reference's urdfs/
ZOO = {
    "kinova_urdf": Path("kinova_gen3_7dof") / "kinova_arm.urdf",
    "kinova_dumbbell": Path("kinova_gen3_7dof") / "kinova_with_dumbbell.urdf",
    "fetch_arm": Path("fetch_arm") / "fetch_arm_7DOF.urdf",
    "kuka_iiwa": Path("kuka_arm") / "lbr_iiwa7_r800.urdf",
    "panda": Path("panda_arm") / "panda_arm.urdf",
    "ur5": Path("ur5_arm") / "ur5_robot.urdf",
}

FIELDS = ("num_joints", "num_factors", "axes", "trans", "rots", "mass",
          "com", "inertia", "friction", "damping", "armature",
          "position_limits_lb", "position_limits_ub", "speed_limits",
          "torque_limits", "gravity", "link_center", "link_generators")

# Kinova Gen3 transmission (motor) inertia: URDFs do not carry motor
# inertia, so the reference hard-codes it into every Kinova agent
# ("matlab doesn't import these from urdf", kinova_run_100_worlds.m:95).
# The dumbbell variant is the same physical arm, so it gets the same values.
KINOVA_ARMATURE = [8.02999999999999936, 11.99620246153036440, 9.00254278617515169,
                   11.58064393167063599, 8.46650409179141228, 8.85370693737424297,
                   8.85873036646853151]


def _read(path: Path) -> str:
    text = path.read_text()
    if path.name == "ur5_robot.urdf":
        # the reference ships the elbow-to-end-effector section commented
        # out; restore it (one comment block from elbow_joint to ee_link).
        # Anchor the closing-marker replacement AFTER the opening marker so
        # an unrelated earlier comment block can never be corrupted.
        start = text.find('<!-- <joint name="elbow_joint"')
        assert start >= 0, "expected commented elbow block in ur5_robot.urdf"
        end = text.find("</link> -->", start)
        assert end >= 0, "unterminated elbow comment block in ur5_robot.urdf"
        block = text[start:end + len("</link> -->")]
        fixed = block.replace('<!-- <joint name="elbow_joint"',
                              '<joint name="elbow_joint"', 1)
        fixed = fixed[: -len("</link> -->")] + "</link>"
        text = text[:start] + fixed + text[end + len("</link> -->"):]
    return text


def extract(ref_dir=REF, *, out=None) -> dict:
    """{robot name: its numeric fields and "mesh_boxes"} for every robot of
    ZOO whose URDF under ref_dir parses (a failing robot is printed and
    skipped); written to `out` when one is given."""
    ref = Path(ref_dir)
    if not ref.is_dir():
        raise FileNotFoundError(f"the reference URDF directory {ref} does not exist")
    bundle = {}
    for name, rel in ZOO.items():
        path = ref / rel
        try:
            # mesh-derived per-link AABBs (create_pz_bounding_boxes.m,
            # uarmtd_agent.m:60); links without resolvable geometry keep
            # load_urdf's conservative joint-span fallback
            boxes = link_boxes_from_urdf(io.StringIO(_read(path)), mesh_dir=str(path.parent))
            robot = load_urdf(io.StringIO(_read(path)), name=name, link_boxes=boxes)
            n_mesh = len(boxes)
        except Exception as e:
            print(f"FAIL {name}: {type(e).__name__}: {e}")
            continue
        if name in ("kinova_urdf", "kinova_dumbbell"):
            arm = np.zeros(robot.num_joints)
            arm[:7] = KINOVA_ARMATURE
            robot = dataclasses.replace(robot, armature=arm)
        d = {}
        for field in FIELDS:
            v = getattr(robot, field)
            d[field] = v.tolist() if isinstance(v, np.ndarray) else v
        d["mesh_boxes"] = n_mesh
        bundle[name] = d
        print(f"ok   {name}: J={robot.num_joints} F={robot.num_factors} "
              f"mass={robot.mass.sum():.2f}kg mesh_boxes={n_mesh}")
    if out is not None:
        Path(out).write_text(json.dumps(bundle, indent=1))
        print(f"wrote {out} ({len(bundle)} robots)")
    return bundle


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    extract(argv[0] if argv else REF, out=BUNDLE)


if __name__ == "__main__":
    main()
