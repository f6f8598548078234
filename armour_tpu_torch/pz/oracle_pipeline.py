"""Oracle (sparse, float64) version of the JRS -> FK -> RNEA pipeline (the
port's counterpart of armour_tpu/pz/oracle_pipeline.py).

Runs the exact reference PZ semantics with SparsePZ objects at a single time
index of one world, to validate the dense BPZ pipeline: k-polynomial
coefficients must agree to float tolerance and the dense radii must dominate
(conservatism) while staying close (tightness).  The port's JRS tensors are
copied to host float64 numpy at the call, whatever their device and dtype.
"""

from __future__ import annotations

import numpy as np

from ..robot import RobotModel
from .basis import KBasis, error_layout
from .oracle import SparsePZ


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().to("cpu").double().numpy()
    return np.asarray(x, dtype=np.float64)


def jrs_to_oracle(jrs, robot: RobotModel, basis: KBasis, t: int, *, world: int = 0):
    """Convert the BPZ JRS tensors ([W, T, ...]) of one world at time index
    t into SparsePZ objects."""
    lay = error_layout(basis.nf)
    lin = basis.lin_idx
    F = robot.num_factors
    J = robot.num_joints

    def at(x):
        return _np(x[world, t])

    def vel(arr, group):
        coef, egen = at(arr.coef), at(arr.egen)
        out = []
        for i in range(F):
            out.append(SparsePZ.from_terms(
                coef[i, 0], [(coef[i, int(lin[i])], {("k", i): 1}),
                             (egen[i, lay[group].start + i], {(group, i): 1})]))
        return out

    qd = vel(jrs.qd, "qde")
    qda = vel(jrs.qda, "qdae")
    qdda = vel(jrs.qdda, "qddae")

    R_coef, R_egen = at(jrs.R.coef), at(jrs.R.egen)
    R = []
    for i in range(J + 1):
        terms = []
        if i < F:
            terms = [
                (R_coef[i, :, :, int(lin[i])], {("k", i): 1}),
                (R_egen[i, :, :, lay["cosqe"].start + i], {("cosqe", i): 1}),
                (R_egen[i, :, :, lay["sinqe"].start + i], {("sinqe", i): 1}),
            ]
        R.append(SparsePZ.from_terms(R_coef[i, :, :, 0], terms))
    return {"qd": qd, "qda": qda, "qdda": qdda, "R": R}


def oracle_fk(oj, robot: RobotModel, threshold: float = 0.0):
    """Sparse-PZ forward kinematics (Dynamics.cu:69-81)."""
    fk_r = SparsePZ(np.eye(3))
    fk_t = SparsePZ(np.zeros(3))
    links = []
    for i in range(robot.num_joints):
        P = SparsePZ(_np(robot.trans[i]))
        fk_t = (fk_t + fk_r.matvec(P)).simplify(threshold)
        fk_r = (fk_r * oj["R"][i]).simplify(threshold)
        box = SparsePZ.from_terms(
            _np(robot.link_center[i]),
            [
                (np.eye(3)[:, j] * robot.link_generators[i, j], {("shape", j): 1})
                for j in range(3)
            ],
        )
        links.append((fk_r.matvec(box) + fk_t).simplify(threshold))
    return links


def oracle_rnea(oj, robot: RobotModel, uncertain: bool, threshold: float = 0.0,
                set_gravity: bool = True):
    """Sparse-PZ RNEA (Dynamics.cu:83-181)."""
    J = robot.num_joints

    def s(x):
        return x.simplify(threshold)

    w = SparsePZ(np.zeros(3))
    w_aux = SparsePZ(np.zeros(3))
    wdot = SparsePZ(np.zeros(3))
    lin_acc = SparsePZ(np.array([0.0, 0.0, robot.gravity if set_gravity else 0.0]))

    Fs, Ns = [], []
    for i in range(J):
        Rt = oj["R"][i].transpose()
        trans_i = SparsePZ(_np(robot.trans[i]))
        com_i = SparsePZ(_np(robot.com[i]))
        lin_acc = s(Rt.matvec(lin_acc + wdot.cross(trans_i) + w.cross(w_aux.cross(trans_i))))
        w = s(Rt.matvec(w))
        w_aux = s(Rt.matvec(w_aux))
        wdot = s(Rt.matvec(wdot))
        axis = int(robot.axes[i])
        if axis != 0 and i < robot.num_factors:
            ax = abs(axis) - 1
            e = np.eye(3)[ax]
            qd_vec = SparsePZ(np.zeros(3)) + oj["qd"][i] * SparsePZ(e)
            w = s(w + qd_vec)
            wdot = s(wdot + w_aux.cross(qd_vec) + oj["qdda"][i] * SparsePZ(e))
            w_aux = s(w_aux + oj["qda"][i] * SparsePZ(e))
        mass_c = _np(robot.mass[i]).reshape(())
        m_pz = SparsePZ(mass_c, indep=np.asarray(robot.mass_uncertainty * abs(mass_c)) if uncertain else None)
        I_c = _np(robot.inertia[i])
        I_pz = SparsePZ(I_c, indep=robot.inertia_uncertainty * np.abs(I_c) if uncertain else None)
        Fs.append(s(m_pz * s(lin_acc + wdot.cross(com_i) + w.cross(w_aux.cross(com_i)))))
        Ns.append(s(I_pz.matvec(wdot) + w_aux.cross(I_pz.matvec(w))))

    f = SparsePZ(np.zeros(3))
    n = SparsePZ(np.zeros(3))
    taus = [None] * robot.num_factors
    for i in reversed(range(J)):
        R_ip1 = oj["R"][i + 1]
        com_i = SparsePZ(_np(robot.com[i]))
        trans_ip1 = SparsePZ(_np(robot.trans[i + 1]))
        rf = s(R_ip1.matvec(f))
        n = s(Ns[i] + R_ip1.matvec(n) + com_i.cross(Fs[i]) + trans_ip1.cross(rf))
        f = s(rf + Fs[i])
        axis = int(robot.axes[i])
        if axis != 0 and i < robot.num_factors:
            ax = abs(axis) - 1
            tau = SparsePZ(
                n.center[ax],
                {k: v[ax] for k, v in n.poly.items()},
                n.indep[ax],
            )
            tau = tau + oj["qdda"][i].scale(robot.armature[i])
            if robot.damping[i] != 0.0:
                tau = tau + oj["qd"][i].scale(robot.damping[i])
            taus[i] = tau
    return taus
