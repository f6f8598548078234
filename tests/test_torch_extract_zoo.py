"""The port's zoo extractor (armour_tpu_torch.scripts.extract_robot_zoo)
against the JAX script's steps on a reference tree written here: a
Kinova-like 7-joint URDF (the Kinova armature applied), a UR5-like URDF
whose elbow-to-end-effector section is commented out as the reference
ships it (the _read patch restores it) with STL meshes, and a broken URDF
that both skip.  The port's bundle must equal, as JSON text, the dict that
the JAX load_urdf / link_boxes_from_urdf / KINOVA_ARMATURE steps give on
the same files.  The JAX script's main (which writes into armour_tpu/) is
never run."""

import ast
import dataclasses
import importlib.util
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from armour_tpu_torch.scripts import extract_robot_zoo as t_x

ROOT = Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(22)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as every port test file pins."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_extract_robot_zoo", ROOT / "scripts" / "extract_robot_zoo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _binary_stl(path, tris):
    with open(path, "wb") as f:
        f.write(b"binary stl written by the test".ljust(80, b" "))
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0.0, 0.0, 1.0))
            f.write(struct.pack("<9f", *t.reshape(-1)))
            f.write(struct.pack("<H", 0))


def _link(name, i, geometry):
    m = 1.0 + 0.1 * i
    return (f'  <link name="{name}">\n'
            f'    <inertial><origin xyz="0.001 {0.01 * i:.3f} 0.05"/><mass value="{m:.2f}"/>\n'
            f'      <inertia ixx="{0.01 + 0.001 * i:.4f}" ixy="0.0001" ixz="-0.0002" '
            f'iyy="0.012" iyz="0.0003" izz="0.004"/></inertial>\n'
            f"    <collision><geometry>{geometry}</geometry></collision>\n"
            f"  </link>\n")


def _joint(name, parent, child, i, axis):
    return (f'  <joint name="{name}" type="revolute">\n'
            f'    <parent link="{parent}"/><child link="{child}"/>\n'
            f'    <origin xyz="0 {0.005 * i:.3f} 0.12" rpy="{0.1 * i:.2f} 0 {-0.05 * i:.2f}"/>\n'
            f'    <axis xyz="{axis}"/>\n'
            f'    <limit lower="{-2.0 - 0.1 * i:.2f}" upper="{2.0 + 0.1 * i:.2f}" '
            f'velocity="{1.2 + 0.1 * i:.2f}" effort="{30 + 5 * i}"/>\n'
            f"  </joint>\n")


def _kinova_like():
    links = ["base_link"] + [f"link_{i}" for i in range(1, 8)]
    text = '<?xml version="1.0"?>\n<robot name="kinova_like">\n'
    for i, name in enumerate(links):
        text += _link(name, i, f'<box size="0.08 0.07 {0.1 + 0.01 * i:.2f}"/>')
    for i in range(1, 8):
        text += _joint(f"joint_{i}", links[i - 1], links[i], i, "0 0 1" if i % 2 else "0 1 0")
    return text + "</robot>\n"


def _ur5_like(mesh_dir: Path):
    mesh_dir.mkdir()
    names = ["base_link", "shoulder_link", "upper_arm_link", "forearm_link",
             "wrist_1_link", "ee_link"]
    for n in names:
        _binary_stl(mesh_dir / f"{n}.stl",
                    RNG.uniform(-0.05, 0.05, (6, 3, 3)) + np.array([0.0, 0.01, 0.08]))

    def link(i, n):
        return _link(n, i, f'<mesh filename="package://ur_description/meshes/{n}.stl"/>')

    text = ('<?xml version="1.0"?>\n<robot name="ur5_like">\n'
            "  <!-- an unrelated comment block that the patch must leave alone -->\n")
    text += link(0, names[0]) + link(1, names[1]) + link(2, names[2])
    text += _joint("shoulder_pan_joint", names[0], names[1], 1, "0 0 1")
    text += _joint("shoulder_lift_joint", names[1], names[2], 2, "0 1 0")
    hidden = (_joint("elbow_joint", names[2], names[3], 3, "0 1 0") + link(3, names[3])
              + _joint("wrist_1_joint", names[3], names[4], 4, "0 1 0") + link(4, names[4])
              + _joint("ee_fixed_joint", names[4], names[5], 5, "1 0 0") + link(5, names[5]))
    text += "  <!-- " + hidden.lstrip()[:-1] + " -->\n"
    return text + "</robot>\n"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference") / "urdfs"
    (root / "kinova_gen3_7dof").mkdir(parents=True)
    (root / "kinova_gen3_7dof" / "kinova_arm.urdf").write_text(_kinova_like())
    (root / "ur5_arm").mkdir()
    (root / "ur5_arm" / "ur5_robot.urdf").write_text(_ur5_like(root / "ur5_arm" / "meshes"))
    (root / "panda_arm").mkdir()
    (root / "panda_arm" / "panda_arm.urdf").write_text("<robot name='broken'><link")
    return root


def _jax_bundle(ref_dir: Path) -> dict:
    """The JAX script's main loop on ref_dir (without its write)."""
    from armour_tpu.models.mesh import link_boxes_from_urdf
    from armour_tpu.models.urdf import load_urdf

    js = _jax_script()
    out = {}
    for name, path in js.ZOO.items():
        path = ref_dir / path.relative_to(js.REF)
        try:
            boxes = link_boxes_from_urdf(io.StringIO(js._read(path)), mesh_dir=str(path.parent))
            robot = load_urdf(io.StringIO(js._read(path)), name=name, link_boxes=boxes)
            n_mesh = sum(1 for _ in boxes)
        except Exception:
            continue
        if name in ("kinova_urdf", "kinova_dumbbell"):
            arm = np.zeros(robot.num_joints)
            arm[:7] = js.KINOVA_ARMATURE
            robot = dataclasses.replace(robot, armature=arm)
        d = {f: getattr(robot, f) for f in t_x.FIELDS}
        d = {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in d.items()}
        d["mesh_boxes"] = n_mesh
        out[name] = d
    return out


def test_extracted_bundle_is_the_jax_scripts(ref, tmp_path):
    out = tmp_path / "zoo_data.json"
    got = t_x.extract(ref, out=out)
    want = _jax_bundle(ref)
    assert sorted(got) == ["kinova_urdf", "ur5"]
    assert json.dumps(got, indent=1) == json.dumps(want, indent=1)
    assert out.read_text() == json.dumps(want, indent=1)
    assert got["kinova_urdf"]["armature"] == t_x.KINOVA_ARMATURE + [0.0] * (
        got["kinova_urdf"]["num_joints"] - 7)
    # the patch restored the commented elbow section and every mesh boxed a link
    assert got["ur5"]["num_joints"] == 5 and got["ur5"]["mesh_boxes"] == 6


def test_tables_are_the_jax_scripts():
    js = _jax_script()
    assert {k: v.relative_to(js.REF) for k, v in js.ZOO.items()} == t_x.ZOO
    assert js.KINOVA_ARMATURE == t_x.KINOVA_ARMATURE
    main = next(n for n in ast.parse((ROOT / "scripts" / "extract_robot_zoo.py").read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    fields = next(ast.literal_eval(n.iter) for n in ast.walk(main) if isinstance(n, ast.For)
                  and isinstance(n.iter, ast.Tuple))
    assert fields == t_x.FIELDS


def test_read_patch_is_the_jax_scripts(ref):
    js = _jax_script()
    path = ref / "ur5_arm" / "ur5_robot.urdf"
    assert t_x._read(path) == js._read(path)
    assert "<!-- <joint" not in t_x._read(path) and "unrelated comment" in t_x._read(path)


def test_absent_reference_directory_is_refused(tmp_path):
    missing = tmp_path / "no_such_reference" / "urdfs"
    with pytest.raises(FileNotFoundError, match=str(missing)):
        t_x.extract(missing)
    with pytest.raises(FileNotFoundError, match="no_such_reference"):
        t_x.main([str(missing)])
