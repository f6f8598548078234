"""The port's URDF and mesh readers (armour_tpu_torch/models/urdf.py,
mesh.py) against the JAX package's, exactly, on a 3-joint URDF written
here: box, cylinder and sphere collision primitives, a binary STL, an ASCII
STL, an OBJ and a COLLADA .dae with node transforms, a (-) joint axis and a
trailing fixed joint to a link with inertia."""

import dataclasses
import io
import struct

import numpy as np
import pytest
import torch

from armour_tpu.models import mesh as j_mesh, urdf as j_urdf
from armour_tpu_torch.models import mesh as t_mesh, urdf as t_urdf

RNG = np.random.default_rng(21)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as every port test file pins."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tri(n):
    return RNG.uniform(-0.05, 0.05, (n, 3, 3)) + np.array([0.0, 0.02, 0.1])


def _binary_stl(path, tris):
    with open(path, "wb") as f:
        f.write(b"binary stl written by the test".ljust(80, b" "))
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0.0, 0.0, 1.0))
            f.write(struct.pack("<9f", *t.reshape(-1)))
            f.write(struct.pack("<H", 0))


def _ascii_stl(path, tris):
    lines = ["solid part"]
    for t in tris:
        lines += ["  facet normal 0 0 1", "    outer loop"]
        lines += [f"      vertex {x:.9g} {y:.9g} {z:.9g}" for x, y, z in t]
        lines += ["    endloop", "  endfacet"]
    lines.append("endsolid part")
    path.write_text("\n".join(lines) + "\n")


def _obj(path, verts):
    lines = ["# obj written by the test", "o part"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    lines += ["vn 0 0 1", "f 1 2 3", "f 2 3 4"]
    path.write_text("\n".join(lines) + "\n")


def _dae(path, verts):
    floats = " ".join(f"{x:.9g}" for x in verts.reshape(-1))
    path.write_text(f"""<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><unit name="centimeter" meter="0.01"/><up_axis>Y_UP</up_axis></asset>
  <library_geometries>
    <geometry id="part-mesh" name="part">
      <mesh>
        <source id="part-positions">
          <float_array id="part-positions-array" count="{verts.size}">{floats}</float_array>
        </source>
        <source id="part-normals">
          <float_array id="part-normals-array" count="3">0 0 1</float_array>
        </source>
        <vertices id="part-vertices">
          <input semantic="POSITION" source="#part-positions"/>
        </vertices>
        <triangles count="1"><input semantic="VERTEX" source="#part-vertices" offset="0"/>
          <p>0 1 2</p></triangles>
      </mesh>
    </geometry>
  </library_geometries>
  <library_visual_scenes>
    <visual_scene id="scene">
      <node id="outer">
        <translate>1.5 -2 3</translate>
        <rotate>0 0 1 30</rotate>
        <scale>2 1 0.5</scale>
        <node id="inner">
          <matrix>1 0 0 0.5 0 0 -1 1 0 1 0 -0.25 0 0 0 1</matrix>
          <instance_geometry url="#part-mesh"/>
        </node>
      </node>
    </visual_scene>
  </library_visual_scenes>
</COLLADA>
""")


URDF = """<?xml version="1.0"?>
<robot name="three_joint_test_arm">
  <link name="base">
    <inertial><mass value="2.0"/><inertia ixx="0.01" iyy="0.01" izz="0.01"/></inertial>
    <collision><origin xyz="0 0 0.05" rpy="0 0 0.3"/><geometry><box size="0.2 0.16 0.1"/></geometry></collision>
  </link>
  <link name="upper">
    <inertial><origin xyz="0.01 0 0.12"/><mass value="1.3"/>
      <inertia ixx="0.011" ixy="0.001" ixz="-0.002" iyy="0.012" iyz="0.0005" izz="0.004"/></inertial>
    <collision><origin xyz="0 0 0.12" rpy="0.1 -0.2 0.05"/><geometry><cylinder radius="0.04" length="0.24"/></geometry></collision>
    <collision><geometry><mesh filename="package://test_arm/meshes/upper.stl" scale="1 1 1.2"/></geometry></collision>
    <visual><geometry><sphere radius="0.06"/></geometry></visual>
  </link>
  <link name="fore">
    <inertial><origin xyz="0 0.02 0.1"/><mass value="0.9"/>
      <inertia ixx="0.006" iyy="0.005" izz="0.002"/></inertial>
    <collision><origin xyz="0 0 0.1"/><geometry><sphere radius="0.05"/></geometry></collision>
    <collision><origin xyz="0.01 0 0.02" rpy="0 1.5707963 0"/><geometry><mesh filename="meshes/fore_ascii.stl"/></geometry></collision>
    <visual><origin xyz="0 0 0.1"/><geometry><mesh filename="meshes/fore.obj"/></geometry></visual>
  </link>
  <link name="wrist">
    <inertial><mass value="0.4"/><inertia ixx="0.001" iyy="0.001" izz="0.001"/></inertial>
    <collision><origin xyz="0 0 0.03" rpy="0.3 0 0"/><geometry><mesh filename="meshes/wrist.dae"/></geometry></collision>
    <visual><geometry><mesh filename="meshes/missing_part.stl"/></geometry></visual>
  </link>
  <link name="tool">
    <inertial><origin xyz="0 0 0.02"/><mass value="0.2"/><inertia ixx="0.0002" iyy="0.0002" izz="0.0001"/></inertial>
    <visual><geometry><box size="0.03 0.03 0.04"/></geometry></visual>
  </link>
  <link name="tcp_frame"/>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="upper"/>
    <origin xyz="0 0 0.1" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.6" upper="2.6" velocity="1.4" effort="39"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="upper"/><child link="fore"/>
    <origin xyz="0 0.005 0.24" rpy="1.5707963 0 0"/><axis xyz="0 -1 0"/>
    <limit lower="-2.2" upper="2.2" velocity="1.2" effort="30"/>
  </joint>
  <joint name="j3" type="continuous">
    <parent link="fore"/><child link="wrist"/>
    <origin xyz="0 0 0.21" rpy="0 -0.4 0.2"/><axis xyz="1 0 0"/>
    <limit velocity="2.0" effort="9"/>
  </joint>
  <joint name="j_tool" type="fixed">
    <parent link="wrist"/><child link="tool"/>
    <origin xyz="0.02 0 0.07"/>
  </joint>
  <joint name="j_tcp" type="fixed">
    <parent link="tool"/><child link="tcp_frame"/>
    <origin xyz="0 0 0.05"/>
  </joint>
</robot>
"""


@pytest.fixture(scope="module")
def robot_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("urdf_robot")
    meshes = root / "meshes"
    meshes.mkdir()
    _binary_stl(meshes / "upper.stl", _tri(5))
    _ascii_stl(meshes / "fore_ascii.stl", _tri(4))
    _obj(meshes / "fore.obj", RNG.uniform(-0.03, 0.03, (7, 3)))
    _dae(meshes / "wrist.dae", RNG.uniform(-2.0, 2.0, (6, 3)))
    (root / "arm.urdf").write_text(URDF)
    return root


def _fields_equal(a, b) -> None:
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _dicts_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for name in a:
        x, y = a[name], b[name]
        if isinstance(x, tuple):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and np.array_equal(u, v), name
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("fmt, name", [("binary_stl", "upper.stl"),
                                       ("ascii_stl", "fore_ascii.stl"),
                                       ("obj", "fore.obj"), ("dae", "wrist.dae")])
def test_mesh_vertices_match_jax(robot_dir, fmt, name):
    path = str(robot_dir / "meshes" / name)
    got, want = t_mesh.load_mesh_vertices(path), j_mesh.load_mesh_vertices(path)
    assert got.shape[0] > 0 and got.shape[1] == 3
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_dae_applies_its_node_transforms(robot_dir):
    """The .dae's vertices went through the nodes' matrix / translate /
    rotate / scale, the unit and the Y_UP swap (so the file exercises
    them), in both packages alike."""
    path = str(robot_dir / "meshes" / "wrist.dae")
    v = t_mesh.load_dae(path)
    raw = np.array(
        [float(x) for x in (robot_dir / "meshes" / "wrist.dae").read_text()
         .split('count="18">')[1].split("<")[0].split()]).reshape(-1, 3)
    assert v.shape == raw.shape and not np.allclose(v, raw * 0.01)


@pytest.mark.parametrize("kw", [{}, {"name": "renamed", "link_radius": 0.02, "gravity": 9.8},
                                "mesh_boxes"], ids=["default", "options", "mesh_boxes"])
def test_load_urdf_matches_jax(robot_dir, kw):
    path = str(robot_dir / "arm.urdf")
    if kw == "mesh_boxes":
        kw = {"link_boxes": j_mesh.link_boxes_from_urdf(path)}
    got, want = t_urdf.load_urdf(path, **kw), j_urdf.load_urdf(path, **kw)
    _fields_equal(got, want)
    assert (got.num_joints, got.num_factors) == (4, 3)
    assert list(got.axes) == [3, -2, 1, 0]
    assert got.position_limits_ub[2] == 1000.0


@pytest.mark.parametrize("prefer", ["collision", "visual"])
def test_link_boxes_match_jax(robot_dir, prefer):
    path = str(robot_dir / "arm.urdf")
    got = t_mesh.link_boxes_from_urdf(path, prefer)
    want = j_mesh.link_boxes_from_urdf(path, prefer)
    _dicts_equal(got, want)
    assert set(got) == {"base", "upper", "fore", "wrist", "tool"}


@pytest.mark.parametrize("source", ["path", "file_like"])
def test_link_point_clouds_match_jax(robot_dir, source):
    path = robot_dir / "arm.urdf"
    if source == "path":
        got = t_mesh.link_point_clouds(str(path))
        want = j_mesh.link_point_clouds(str(path))
    else:
        got = t_mesh.link_point_clouds(io.StringIO(URDF), mesh_dir=str(robot_dir))
        want = j_mesh.link_point_clouds(io.StringIO(URDF), mesh_dir=str(robot_dir))
    _dicts_equal(got, want)
    # the upper link: cylinder corners and the scaled binary STL, together
    assert got["upper"].shape == (8 + 15, 3)


def test_mesh_paths_resolve_alike(robot_dir):
    for name in ("package://test_arm/meshes/upper.stl", "meshes/fore.obj", "fore.dae",
                 "meshes/missing_part.stl"):
        assert (t_mesh.resolve_mesh_path(str(robot_dir), name)
                == j_mesh.resolve_mesh_path(str(robot_dir), name))
