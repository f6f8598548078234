"""Entry points and boundaries of the PyTorch port: the planners and the
closed loop run on the card unless asked for the CPU, the package and chip_smoke.py import neither
JAX nor the JAX package, and the kernel launchers take CUDA tensors only
(no silent fallback)."""

import ast
import dataclasses
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch import simulator as tsim
from armour_tpu_torch.batch_sim import run_trials_batched
from armour_tpu_torch import armour_io, dynamics, kinematics, solvability
from armour_tpu_torch.jrs import build_jrs
from armour_tpu_torch.kernels import (build, collision as kcol, jrs as kjrs, pz as kpz,
                                      reach as kreach, sim as ksim, solver as ksolver)
from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.planner import (make_batch_planner, make_planner, make_realtime_planner,
                                      make_rescue_planner)
from armour_tpu_torch.worlds import load_world_csv
from armour_tpu_torch.pz import bpz
from armour_tpu_torch.pz.basis import make_basis

ROOT = Path(__file__).resolve().parent.parent
# _build holds build outputs (git-ignored), not the port's sources
PORT_FILES = sorted(p for p in (ROOT / "armour_tpu_torch").rglob("*.py")
                    if "_build" not in p.relative_to(ROOT).parts) + [ROOT / "chip_smoke.py"]


def _one_world_suite(robot, cfg, **kw):
    """run_trials_batched on one saved world, no iteration past the warm-up."""
    w = load_world_csv(str(ROOT / "saved_worlds/random/scene_013_001.csv"))
    return run_trials_batched([w], robot, cfg, max_iterations=0, **kw)


@pytest.mark.parametrize("maker", [make_planner, make_batch_planner, make_rescue_planner,
                                   tsim.make_rollout, tsim.make_oracles, _one_world_suite])
def test_planners_default_to_the_card(maker):
    if torch.cuda.is_available():
        maker(kinova_gen3(), ArmourConfig())
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            maker(kinova_gen3(), ArmourConfig())
    if maker is not _one_world_suite:
        maker(kinova_gen3(), ArmourConfig(), device="cpu")


def test_rest_frs_checker_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            solvability.make_rest_frs_checker(kinova_gen3())
    solvability.make_rest_frs_checker(kinova_gen3(), device="cpu")


def test_plan_from_armour_in_defaults_to_the_card(tmp_path):
    """Without a device it plans on the card, and raises before any work
    where there is none (its CPU run is tests/test_torch_reach_entry.py)."""
    data = armour_io.ArmourIn(q0=np.zeros(7), qd0=np.zeros(7), qdd0=np.zeros(7),
                              q_des=np.full(7, 0.02), centers=np.array([[2.5, 2.5, 2.5]]),
                              generators=np.diag([0.05] * 3)[None])
    path = str(tmp_path / "armour.in")
    armour_io.write_armour_in(path, data)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            armour_io.plan_from_armour_in(path, str(tmp_path / "out"), kinova_gen3(),
                                          ArmourConfig())
        assert not (tmp_path / "out").exists()


def test_realtime_planner_defaults_to_the_card():
    """Without a device it calibrates on the card, and raises before any
    work where there is none (its CPU run is tests/test_torch_solver.py)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_realtime_planner(kinova_gen3(), ArmourConfig())


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "armour_tpu"), f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    mods = sorted({".".join(p.relative_to(ROOT).with_suffix("").parts)
                   for p in PORT_FILES if p.name != "chip_smoke.py"})
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'armour_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


def test_precision_pins():
    import armour_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _cpu_bpz(shape, basis):
    return bpz.zeros(shape, basis, torch.float32)


def test_kernel_launchers_refuse_cpu_tensors():
    """A launcher never computes on the CPU: the plain version is taken by
    the public wrapper, for CPU tensors only."""
    basis = make_basis(7, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kpz.matmul_linear(_cpu_bpz((2, 3, 3), basis), _cpu_bpz((2, 3, 3), basis), basis)
    with pytest.raises(ValueError, match="CUDA"):
        kpz.cross(_cpu_bpz((2, 3), basis), _cpu_bpz((2, 3), basis), basis)
    with pytest.raises(ValueError, match="CUDA"):
        kcol.build_hyperplanes(torch.zeros(1, 2, 7, 3, 3), torch.zeros(1, 2, 7, 3),
                               torch.zeros(1, 4, 3), torch.zeros(1, 4, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kcol.collision_rows(torch.zeros(1, 3, 36, 8), torch.zeros(1, 36, 8),
                            torch.zeros(1, 36, 8), torch.zeros(1, 8, dtype=torch.int32),
                            torch.ones(1, 8, dtype=torch.bool), torch.zeros(1, 2, 3, 14))
    robot, cfg = kinova_gen3(), ArmourConfig()
    z, zn = torch.zeros(2, 7), torch.zeros(2, 3, 7)
    tp = tsim.TrueParams(torch.zeros(2, 7), torch.zeros(2, 7, 3, 3), torch.zeros(2, 7, 3))
    with pytest.raises(ValueError, match="CUDA"):
        ksim.rollout(robot, cfg, z, z, zn, zn, zn, tp, 1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        ksim.oracle_check(robot, cfg, zn, zn, zn, zn, zn, torch.zeros(2, 4, 3),
                          torch.zeros(2, 4, 3, 3), torch.ones(2, 4, dtype=torch.bool))
    cfg4 = ArmourConfig(num_time_steps=2)
    jrs = build_jrs(*(torch.zeros(1, 7) for _ in range(3)), robot, cfg4, basis)
    with pytest.raises(ValueError, match="CUDA"):
        kreach.fk_chain(jrs, robot, cfg4, basis)
    with pytest.raises(ValueError, match="CUDA"):
        kreach.rnea_chain(jrs, robot, cfg4, basis)
    rows = ksolver.AlmRows(prob=None, cfg=None, basis=basis, tensors={},
                           args=ksolver.AlmArgs(W=1, F=7, M=10), M=10)
    k, lam, rho = torch.zeros(1, 2, 7), torch.zeros(1, 2, 10), torch.ones(1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ksolver.alm_newton(rows, k, lam, rho)
    with pytest.raises(ValueError, match="CUDA"):
        ksolver.alm_values(rows, k, lam, rho, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kjrs.jrs_armtd(torch.zeros(2, 7), torch.zeros(2, 7), robot, cfg4, basis)
    with pytest.raises(ValueError, match="CUDA"):
        kjrs.jrs_bernstein(torch.zeros(2, 7), torch.zeros(2, 7), torch.zeros(2, 7), robot, cfg4,
                           basis)
    with pytest.raises(ValueError, match="CUDA"):
        kcol.screen_collision(torch.zeros(1, 2, 7, 3, 3), torch.zeros(1, 2, 7, 3),
                              torch.zeros(1, 4, 3), torch.zeros(1, 4, 3, 3),
                              torch.zeros(1, 2, 7, 3, 120), torch.zeros(1, 2, 7, 3),
                              torch.ones(1, 4, dtype=torch.bool), 16)
    links, u_both = _cpu_bpz((1, 2, 7, 3), basis), _cpu_bpz((1, 2, 2, 7), basis)
    with pytest.raises(ValueError, match="CUDA"):
        kreach.reach_assembly(links, u_both, robot, cfg4, basis)


def test_cpu_wrappers_take_the_plain_versions():
    basis = make_basis(7, 3)
    rng = np.random.default_rng(0)
    a = bpz.BPZ(torch.as_tensor(rng.normal(size=(2, 3, 3, basis.size))),
                torch.as_tensor(rng.normal(size=(2, 3, 3, 38))),
                torch.as_tensor(np.abs(rng.normal(size=(2, 3, 3)))))
    for f, plain in ((bpz.matmul_linear, bpz.matmul_linear_plain),
                     (bpz.matmul_linear_right, bpz.matmul_linear_right_plain)):
        got, want = f(a, a, basis, 1e-6), plain(a, a, basis, 1e-6)
        assert torch.equal(got.coef, want.coef) and torch.equal(got.rad, want.rad)
    v = bpz.BPZ(a.coef[:, 0], a.egen[:, 0], a.rad[:, 0])
    assert torch.equal(bpz.cross(v, v, basis).rad, bpz.cross_plain(v, v, basis).rad)


def test_cpu_chain_wrappers_take_the_plain_versions():
    """forward_occupancy and rnea_pz_sets (K9 / K10 on the card) take
    their plain versions for CPU tensors, also for an uncertain COM."""
    robot, cfg = kinova_gen3(), ArmourConfig(num_time_steps=2, dtype=torch.float64)
    basis = make_basis(7, 3)
    rng = np.random.default_rng(2)
    jrs = build_jrs(*(torch.as_tensor(rng.uniform(-0.5, 0.5, (2, 7))) for _ in range(3)),
                    robot, cfg, basis)
    got = kinematics.forward_occupancy(jrs, robot, cfg, basis)
    want = kinematics.forward_occupancy_plain(jrs, robot, cfg, basis)
    assert torch.equal(got.coef, want.coef) and torch.equal(got.rad, want.rad)
    for r in (robot, dataclasses.replace(robot, com_uncertainty=0.05)):
        got = dynamics.rnea_pz_sets(jrs, r, cfg, basis)
        want = dynamics.rnea_pz_sets_plain(jrs, r, cfg, basis)
        assert torch.equal(got.coef, want.coef) and torch.equal(got.rad, want.rad)


def test_cpu_closed_loop_wrappers_take_the_plain_versions():
    robot, cfg = kinova_gen3(), ArmourConfig(dtype=torch.float64)
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.uniform(-1, 1, (2, 7)))
    qr = [torch.as_tensor(rng.uniform(-1, 1, (2, 3, 7))) for _ in range(3)]
    tp = tsim.TrueParams(
        *(torch.as_tensor(np.stack([x, x]))
          for x in (robot.mass, robot.inertia, robot.com)))
    got = tsim.rollout_move(robot, cfg, q, q * 0, *qr, tp, 1e-3)
    want = tsim.rollout_plain(robot, cfg, q, q * 0, *qr, tp, 1e-3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    logs = {"q": qr[0], "qd": qr[1], "u": qr[2], "q_des": qr[0], "qd_des": qr[1]}
    obs = tsim.ObstacleSet(centers=torch.zeros(2, 1, 3, dtype=torch.float64),
                           generators=0.1 * torch.eye(3, dtype=torch.float64).expand(2, 1, 3, 3),
                           mask=torch.ones(2, 1, dtype=torch.bool))
    for g, w in zip(tsim.oracle_check(robot, cfg, logs, obs),
                    tsim.oracle_check_plain(robot, cfg, logs, obs)):
        assert torch.equal(g, w)


def test_build_flags_keep_ieee_float32():
    assert "-use_fast_math" not in build.FLAGS and "--use_fast_math" not in build.FLAGS
    assert "-fmad=false" in build.FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.FLAGS
    for src in (ROOT / "armour_tpu_torch" / "csrc").glob("*.cu"):
        text = src.read_text()
        for fast in ("rsqrtf", "__fdividef", "__frsqrt", "__fsqrt"):
            assert fast not in text, f"{src.name} uses {fast}"


def test_kernel_argument_structs_fit_the_parameter_space():
    """The argument structs travel as kernel parameters (4 KB limit)."""
    for s in (kpz.K1Args, kpz.K2Args, kreach.K9Args, kreach.K10Args, kcol.K3Args, kcol.K4Args, ksim.K5Args, ksim.K6Args,
              ksolver.AlmArgs, kjrs.K11Args, kjrs.K12Args, kcol.K13Args):
        assert ctypes.sizeof(s) <= 4096
    assert ctypes.sizeof(kpz.PZView) == 3 * 8 + 9 * 8 + 6 * 8


def _c_struct_fields(source: str, name: str):
    """Field names, in order, of `struct name { ... };` in a CUDA source."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        first, *rest = [p.strip() for p in decl.split(",")]
        names.append(re.sub(r"\[.*\]", "", first).split()[-1].lstrip("*"))
        names += [re.sub(r"\[.*\]", "", r).lstrip("*") for r in rest]
    return names


@pytest.mark.parametrize("src, structs", [
    ("rollout.cu", (ksim.K5Robot, ksim.K5Args)),
    ("oracle_check.cu", (ksim.K6Robot, ksim.K6Args)),
    ("alm_rows.cuh", (ksolver.AlmArgs,)),
    ("pz_ops.cuh", (kpz.PZTables,)),
    ("pz_matmul_linear.cu", (kpz.K1Args,)),
    ("pz_cross.cu", (kpz.K2Args,)),
    ("fk_chain.cu", (kreach.K9Args,)),
    ("rnea_chain.cu", (kreach.K10Args,)),
    ("jrs_tail.cuh", (kjrs.JrsTrig,)),
    ("jrs_armtd.cu", (kjrs.K11Args,)),
    ("jrs_bernstein.cu", (kjrs.K12Args,)),
    ("screen_collision.cu", (kcol.K13Args,))])
def test_closed_loop_structs_match_the_sources(src, structs):
    """The ctypes mirrors list the C structs' fields in the same order (no
    compiler here checks the layout)."""
    text = (build.CSRC / src).read_text()
    for s in structs:
        assert _c_struct_fields(text, s.__name__) == [f[0] for f in s._fields_], s.__name__


def test_every_kernel_has_a_source():
    for name, src in build.SOURCES.items():
        assert (build.CSRC / src).exists(), name


# Deliberate divergences from the JAX signatures, applied to the JAX
# parameter list before the order is compared: the solver's row functions
# take no robot (the plain versions read everything from prob), plan_cost
# takes the continuous-joint mask where JAX takes the robot, and
# utils/timing.sync waits for a device where JAX's blocks on a pytree.
_SIG_DIVERGENCES = {
    ("nlp.py", "solve"): {"robot": None},
    ("nlp.py", "max_violations"): {"robot": None},
    ("nlp.py", "is_feasible"): {"robot": None},
    ("nlp.py", "constraint_stack"): {"robot": None},
    ("nlp.py", "plan_cost"): {"robot": "continuous"},
    ("utils/timing.py", "sync"): {"out": "device"},
}


def _public_functions(path: Path) -> dict:
    return {n.name: n for n in ast.parse(path.read_text()).body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


def _shared_functions():
    """(module, function) of every public module-level function that the
    port and the JAX package both define in modules of the same path."""
    out = []
    for p in sorted((ROOT / "armour_tpu_torch").rglob("*.py")):
        rel = p.relative_to(ROOT / "armour_tpu_torch")
        ref = ROOT / "armour_tpu" / rel
        if "_build" in rel.parts or not ref.exists():
            continue
        for name in sorted(set(_public_functions(p)) & set(_public_functions(ref))):
            out.append((rel.as_posix(), name))
    return out


@pytest.mark.parametrize("module, name", _shared_functions(), ids=lambda x: str(x))
def test_shared_functions_keep_the_jax_positional_order(module, name):
    """A call written for the JAX package binds the same values in the
    port: the port's positional parameters are the JAX ones in the JAX
    order (a trailing JAX parameter may be missing), and a parameter only
    the port has is keyword-only."""
    port = _public_functions(ROOT / "armour_tpu_torch" / module)[name].args
    ref = _public_functions(ROOT / "armour_tpu" / module)[name].args
    rename = _SIG_DIVERGENCES.get((module, name), {})
    want = [rename.get(a.arg, a.arg) for a in ref.posonlyargs + ref.args
            if rename.get(a.arg, a.arg) is not None]
    got = [a.arg for a in port.posonlyargs + port.args]
    assert got == want[:len(got)], f"{module}:{name} positional {got}, JAX order {want}"


def test_extra_stats_passed_ninth_lands_in_batch_stats(tmp_path):
    """run_world_suite_batched takes extra_stats 9th, as the JAX package
    does: a dict passed there by position is merged into the saved
    batch_stats, and the 10th position is rescue_solver."""
    import json

    from armour_tpu_torch.experiments import run_world_suite_batched

    cfg = ArmourConfig(num_time_steps=8, dtype=torch.float64, max_obstacles=16, screen_k=128,
                       solver_outer_iters=2, solver_inner_iters=2)
    out = tmp_path / "r.json"
    res = run_world_suite_batched([str(ROOT / "saved_worlds/random/scene_013_001.csv")],
                                  kinova_gen3(), cfg, 1, 1.0, 0, False, str(out),
                                  {"marker": 17}, False, device="cpu")
    assert len(res) == 1
    stats = json.loads(out.read_text())["batch_stats"]
    assert stats["marker"] == 17
    assert stats["rescue_solver"] is False and stats["guidance"] == "straight"


def test_compare_results_lists_the_worlds_that_differ(tmp_path):
    """experiments.compare_results: per world the iterations and rescued
    plans of both files where either differs, buckets that differ, totals
    over the worlds both files hold."""
    import json

    from armour_tpu_torch.experiments import compare_results

    def write(name, rows):
        path = tmp_path / name
        path.write_text(json.dumps({"results": [
            {"world": w, "bucket": b, "iterations": it, "rescued_plans": rp}
            for w, b, it, rp in rows]}))
        return str(path)

    a = write("a.json", [("s1", "goal", 10, 0), ("s2", "goal", 12, 1), ("s3", "stuck", 40, 3),
                         ("s4", "goal", 5, 0)])
    b = write("b.json", [("s1", "goal", 10, 0), ("s2", "goal", 15, 1), ("s3", "goal", 30, 2)])
    out = compare_results(a, b)
    assert out["worlds_compared"] == 3 and out["only_in_one"] == ["s4"]
    assert out["buckets_differ"] == ["s3"]
    assert out["iterations"] == [62, 55] and out["rescued_plans"] == [4, 3]
    assert [d["world"] for d in out["differing_worlds"]] == ["s3", "s2"]
    assert out["differing_worlds"][1] == {"world": "s2", "bucket": ["goal", "goal"],
                                          "iterations": [12, 15], "rescued_plans": [1, 1]}


def test_compare_results_holds_two_traces_of_a_world(tmp_path):
    """experiments.compare_results on two files that trace the same world:
    per common iteration the largest state and k differences, the first
    iteration whose k differs at all and the first a different plan."""
    import json

    from armour_tpu_torch.experiments import compare_results

    def rec(it, q, k, cost):
        return {"it": it, "q0": [0.0, q], "k": [k, 0.5], "cost": cost, "gd": 1.0 - it,
                "guidance": "straight"}

    def write(name, recs):
        path = tmp_path / name
        path.write_text(json.dumps({
            "results": [{"world": "w", "bucket": "goal", "iterations": len(recs),
                         "rescued_plans": 0}],
            "batch_stats": {"trace": {"w": recs}}}))
        return str(path)

    a = write("a.json", [rec(0, 0.0, 0.25, 3.0), rec(1, 0.0, 0.25, 2.0), rec(2, 1e-7, 0.25, 1.0),
                         rec(3, 2e-7, 0.25, 1.0)])
    b = write("b.json", [rec(0, 0.0, 0.25, 3.0), rec(1, 0.0, 0.25 + 1e-6, 2.0),
                         rec(2, 1e-7, -0.5, 1.5)])
    t = compare_results(a, b)["traces"]["w"]
    assert t["iterations"] == [4, 3]
    assert t["first_k_difference"] == 1 and t["first_fork"] == 2
    assert [r[0] for r in t["rows"]] == [0, 1, 2]
    assert t["rows"][2][1:5] == [0.0, 0.75, 1.0, 1.5]
