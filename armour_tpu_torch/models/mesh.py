"""Mesh-derived link bounding boxes (create_pz_bounding_boxes.m equivalent);
a copy of armour_tpu/models/mesh.py (numpy only).

The reference builds each link's PZ bounding box as the axis-aligned bounds
of the link mesh's vertices (create_pz_bounding_boxes.m:5-31, called from
uarmtd_agent.m:60).  This module does the same from the URDF's collision
(preferred) or visual geometry — STL (binary/ascii), OBJ and COLLADA .dae
vertex extraction in plain numpy, no mesh library — and, unlike the
reference (which ignores the visual origin), applies the geometry origin
transform so the box is exact in the LINK frame the FK chain uses.
Primitive geometries (box / cylinder / sphere) are boxed analytically.
"""

from __future__ import annotations

import os
import re
import struct
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple

import numpy as np

from ..robot import rpy_matrix


# ---------------------------------------------------------------------------
# vertex loaders
# ---------------------------------------------------------------------------


def load_stl(path: str) -> np.ndarray:
    """Vertices [N, 3] of a binary or ascii STL."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(84)
        if len(head) >= 84:
            (n,) = struct.unpack("<I", head[80:84])
            if 84 + 50 * n == size:
                data = np.fromfile(f, dtype=np.uint8, count=50 * n)
                rec = data.reshape(n, 50)
                tri = rec[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
                return tri.reshape(-1, 3).astype(np.float64)
    # ascii fallback
    verts = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            t = line.split()
            if len(t) == 4 and t[0] == "vertex":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    return np.asarray(verts, float).reshape(-1, 3)


def load_obj(path: str) -> np.ndarray:
    verts = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                t = line.split()
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    return np.asarray(verts, float).reshape(-1, 3)


def _parse_floats(text: str) -> np.ndarray:
    return np.array(text.split(), dtype=float)


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def load_dae(path: str) -> np.ndarray:
    """Scene-transformed vertices [N, 3] of a COLLADA file: POSITION source
    arrays of each geometry, pushed through the visual-scene node transforms
    (<matrix>/<translate>/<rotate>/<scale>), unit-scaled, Y_UP converted."""
    root = ET.parse(path).getroot()

    unit = 1.0
    up = "Z_UP"
    for el in root.iter():
        t = _strip_ns(el.tag)
        if t == "unit":
            unit = float(el.get("meter", "1"))
        elif t == "up_axis" and el.text:
            up = el.text.strip()

    # geometry id -> positions [N, 3]
    geoms: Dict[str, np.ndarray] = {}
    for g in root.iter():
        if _strip_ns(g.tag) != "geometry":
            continue
        gid = g.get("id")
        sources = {}
        pos_src = None
        for el in g.iter():
            t = _strip_ns(el.tag)
            if t == "source":
                arr = None
                for fa in el.iter():
                    if _strip_ns(fa.tag) == "float_array":
                        arr = _parse_floats(fa.text) if fa.text else np.zeros(0)
                sources[el.get("id")] = arr
            elif t == "input" and el.get("semantic") == "POSITION":
                pos_src = el.get("source", "").lstrip("#")
        if pos_src and sources.get(pos_src) is not None:
            geoms[gid] = sources[pos_src].reshape(-1, 3)

    # walk visual scene nodes, accumulating transforms
    verts = []

    def node_matrix(node) -> np.ndarray:
        M = np.eye(4)
        for el in node:
            t = _strip_ns(el.tag)
            if t == "matrix" and el.text:
                M = M @ _parse_floats(el.text).reshape(4, 4)
            elif t == "translate" and el.text:
                T = np.eye(4)
                T[:3, 3] = _parse_floats(el.text)
                M = M @ T
            elif t == "rotate" and el.text:
                x, y, z, deg = _parse_floats(el.text)
                a = np.deg2rad(deg)
                c, s = np.cos(a), np.sin(a)
                u = np.array([x, y, z])
                n = np.linalg.norm(u)
                if n > 0:
                    u = u / n
                    K = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]],
                                  [-u[1], u[0], 0]])
                    R = np.eye(3) + s * K + (1 - c) * (K @ K)
                    T = np.eye(4)
                    T[:3, :3] = R
                    M = M @ T
            elif t == "scale" and el.text:
                T = np.eye(4)
                np.fill_diagonal(T[:3, :3], _parse_floats(el.text))
                M = M @ T
        return M

    def walk(node, M):
        M = M @ node_matrix(node)
        for el in node:
            t = _strip_ns(el.tag)
            if t == "instance_geometry":
                gid = el.get("url", "").lstrip("#")
                if gid in geoms:
                    v = geoms[gid]
                    verts.append(v @ M[:3, :3].T + M[:3, 3])
            elif t == "node":
                walk(el, M)

    for vs in root.iter():
        if _strip_ns(vs.tag) == "visual_scene":
            for el in vs:
                if _strip_ns(el.tag) == "node":
                    walk(el, np.eye(4))

    if not verts:  # no scene: raw geometry union
        verts = list(geoms.values())
    v = np.concatenate(verts, axis=0) if verts else np.zeros((0, 3))
    v = v * unit
    if up == "Y_UP":
        v = v[:, [0, 2, 1]] * np.array([1.0, -1.0, 1.0])
    elif up == "X_UP":
        v = v[:, [1, 0, 2]] * np.array([-1.0, 1.0, 1.0])
    return v


def load_mesh_vertices(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".stl":
        return load_stl(path)
    if ext == ".obj":
        return load_obj(path)
    if ext == ".dae":
        return load_dae(path)
    raise ValueError(f"unsupported mesh format {path}")


# ---------------------------------------------------------------------------
# URDF geometry -> link-frame AABB
# ---------------------------------------------------------------------------


def resolve_mesh_path(urdf_dir: str, filename: str) -> Optional[str]:
    """Resolve a URDF mesh filename (possibly package://) to a real file;
    falls back to a basename search under the URDF directory and to sibling
    extensions (the panda URDF references .obj files shipped as .dae)."""
    rel = re.sub(r"^package://[^/]+/", "", filename)
    cands = [os.path.join(urdf_dir, filename), os.path.join(urdf_dir, rel)]
    base = os.path.basename(rel)
    stem, ext = os.path.splitext(base)
    alt_exts = [ext, ".STL", ".stl", ".dae", ".DAE", ".obj"]
    for c in cands:
        if os.path.isfile(c):
            return c
    hits = {}
    for dirpath, _, files in os.walk(urdf_dir):
        for f in files:
            fs, fe = os.path.splitext(f)
            if fs == stem and fe in alt_exts:
                hits[fe] = os.path.join(dirpath, f)
    for e in alt_exts:
        if e in hits:
            return hits[e]
    return None


def _geom_vertices(geom, urdf_dir: str) -> Optional[np.ndarray]:
    """Representative vertices of one <geometry> element in its own frame."""
    mesh = geom.find("mesh")
    if mesh is not None:
        p = resolve_mesh_path(urdf_dir, mesh.get("filename", ""))
        if p is None:
            return None
        v = load_mesh_vertices(p)
        scale = mesh.get("scale")
        if scale:
            v = v * np.array([float(x) for x in scale.split()])
        return v
    box = geom.find("box")
    if box is not None:
        h = np.array([float(x) for x in box.get("size").split()]) / 2.0
        sgn = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], float)
        return sgn * h
    cyl = geom.find("cylinder")
    if cyl is not None:
        r = float(cyl.get("radius"))
        L = float(cyl.get("length")) / 2.0
        return np.array([[sx * r, sy * r, sz * L] for sx in (-1, 1)
                         for sy in (-1, 1) for sz in (-1, 1)], float)
    sph = geom.find("sphere")
    if sph is not None:
        r = float(sph.get("radius"))
        return np.array([[sx * r, sy * r, sz * r] for sx in (-1, 1)
                         for sy in (-1, 1) for sz in (-1, 1)], float)
    return None


def link_boxes_from_urdf(urdf_source, prefer: str = "collision",
                         mesh_dir: Optional[str] = None,
                         ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{link_name: (center [3], half_extents [3])} in the LINK frame, from
    the AABB of all collision (fallback: visual) geometry vertices with
    their origin transforms applied.  Links with no resolvable geometry are
    omitted (the caller keeps its conservative joint-span fallback).

    urdf_source: path or file-like; pass mesh_dir when file-like (the
    directory mesh filenames resolve against)."""
    return {
        name: ((lo + hi) / 2.0, (hi - lo) / 2.0)
        for name, pts in link_point_clouds(urdf_source, prefer, mesh_dir).items()
        for lo, hi in [(pts.min(axis=0), pts.max(axis=0))]
    }


def link_point_clouds(urdf_source, prefer: str = "collision",
                      mesh_dir: Optional[str] = None,
                      ) -> Dict[str, np.ndarray]:
    """{link_name: vertices [N, 3]} in the LINK frame (origin transforms
    applied) — the raw point clouds link_boxes_from_urdf boxes, exposed for
    FK containment tests."""
    if isinstance(urdf_source, (str, os.PathLike)):
        urdf_dir = os.path.dirname(os.path.abspath(urdf_source))
    else:
        assert mesh_dir is not None, "mesh_dir required for file-like input"
        urdf_dir = mesh_dir
    if mesh_dir is not None:
        urdf_dir = mesh_dir
    root = ET.parse(urdf_source).getroot()
    out: Dict[str, np.ndarray] = {}
    for link in root.findall("link"):
        pts = []
        for kind in ([prefer, "visual" if prefer == "collision" else "collision"]):
            for g in link.findall(kind):
                geom = g.find("geometry")
                if geom is None:
                    continue
                v = _geom_vertices(geom, urdf_dir)
                if v is None or len(v) == 0:
                    continue
                origin = g.find("origin")
                xyz = np.zeros(3)
                R = np.eye(3)
                if origin is not None:
                    xyz = np.array([float(x) for x in
                                    (origin.get("xyz") or "0 0 0").split()])
                    rpy = [float(x) for x in
                           (origin.get("rpy") or "0 0 0").split()]
                    R = rpy_matrix(*rpy)
                pts.append(v @ R.T + xyz)
            if pts:
                break
        if pts:
            out[link.get("name")] = np.concatenate(pts, axis=0)
    return out
