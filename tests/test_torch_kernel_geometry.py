"""Launch geometry of kernels K1 (pz_matmul_linear), K2 (pz_cross), K5 (rollout), K6
(oracle_check), K7 (alm_newton), K8 (alm_values), K9 (fk_chain) and K10
(rnea_chain), pure Python on the CPU: every row, query, seed, chain,
element and (world, logged step, link, obstacle) is covered exactly once,
the grid reaches 2 x 132 CTAs wherever the work allows, and the shared
memory each block asks for fits the H100 (227 KB a block, 228 KB an SM), so
that a launch the card would refuse shows up here.  The Python mirrors of
the kernels' shared-memory formulas are held against the constants of the
CUDA sources.  K4's (collision_rows, both modes), K13's (screen_collision)
and K15's (reach_assembly) ctypes argument structs are held field for field against the structs parsed out
of their sources, and their launchers' values against the inputs with the
library stubbed; so are K16's (grasp_rows), with its pair tables and
shared memory, and K10's arguments for fixed joints and the contact wrench;
K7 / K8's tiles cover the dumbbell's rows (3 T J = 3456, the grasp group).

The cuda-marked tests run K1, K2, K5, K6, K7, K8, K9, K10 and K15 against
their plain versions on the card, K11 and K7 / K8's ARMTD branch against
theirs, and the grasp path's: K16 (bit for bit), K10 with the wrench at
F < J, K7 / K8's grasp rows, a grasp step and a UR5 (F = 6) step (they
skip where there is no card; K12 and K13 are in
test_torch_jrs_screen_kernels.py)."""

import contextlib
import ctypes
import dataclasses
import re
import types

import numpy as np
import pytest
import torch

from armour_tpu_torch.kernels import build, jrs as kjrs, pz as kpz, reach, sim as ksim
from armour_tpu_torch.kernels import solver as ks

SMS = 132
BLOCK_SMEM = 232448
# flagship widths: Kinova Gen3 (T = 128, J = F = 7), B = 120, E = 38, K = 4096
T, J, F, B, E, K = 128, 7, 7, 120, 38, 4096
N_POLY = 3 * T * J + T * F
LD, LDL = B + E + 1, reach.lin_ld(F, E)
WORLDS = [1, 64, 128]
QUERIES = [2, 4, 6, 12]
SEEDS = [2, 4]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _source(name):
    return (build.CSRC / name).read_text()


def _define(text, name):
    return int(re.search(r"#define %s (\d+)" % name, text).group(1))


@pytest.mark.parametrize("Wn", WORLDS)
@pytest.mark.parametrize("Q", QUERIES)
def test_k8_rows_and_queries_covered_once(Wn, Q):
    geo = ks.k8_geometry(Wn, Q, N_POLY, K)
    # step (a): tile t takes rows [t R, t R + R); every query of every tile
    rows = np.zeros(N_POLY, dtype=int)
    for t in range(geo.tiles_a):
        rows[t * geo.R:min((t + 1) * geo.R, N_POLY)] += 1
    assert (rows == 1).all() and (geo.tiles_a - 1) * geo.R < N_POLY
    # step (b): thread x of CTA (bx, by) takes row bx 128 + x and queries by G ..
    pairs = np.zeros((K, Q), dtype=int)
    for bx in range(geo.tiles_b):
        r = np.arange(bx * ks.K8_COL_THREADS, (bx + 1) * ks.K8_COL_THREADS)
        r = r[r < K]
        for by in range(-(-Q // geo.G)):
            q = np.arange(by * geo.G, min((by + 1) * geo.G, Q))
            pairs[np.ix_(r, q)] += 1
    assert (pairs == 1).all()
    # the scratch of link centres holds every query group whole
    assert geo.Qp % geo.G == 0 and Q <= geo.Qp < Q + geo.G


@pytest.mark.parametrize("Wn", WORLDS)
@pytest.mark.parametrize("Q", QUERIES)
def test_k8_grid_fills_the_card(Wn, Q):
    geo = ks.k8_geometry(Wn, Q, N_POLY, K, SMS)
    ctas_a, ctas_b = geo.ctas(Wn, Q)
    # step (a): the smallest tile is 8 rows
    if Wn * N_POLY >= 2 * SMS * ks.K8_TILES[-1]:
        assert ctas_a >= 2 * SMS
    else:
        assert geo.R == ks.K8_TILES[-1]
    # step (b): one row and one query per thread at the least
    if Wn * K * Q >= 2 * SMS * ks.K8_COL_THREADS:
        assert ctas_b >= 2 * SMS
    else:
        assert geo.G == 1
    # the widest tile and group that do (each row read once for more queries)
    bigger = [r for r in ks.K8_TILES if r > geo.R]
    assert all(Wn * -(-N_POLY // r) < 2 * SMS for r in bigger)


@pytest.mark.parametrize("R", ks.K8_TILES)
def test_k8_shared_memory_fits(R):
    text = _source("alm_values.cu")
    assert _define(text, "K8_MAXQ") == ks.K8_MAXQ
    assert _define(text, "K8A_THREADS") == ks.K8_ROWS_THREADS
    assert _define(text, "K8B_THREADS") == ks.K8_COL_THREADS
    assert ks.k8_pitch(B) == 124 and (ks.k8_pitch(B) // 4) % 2 == 1
    assert ks.k8_rows_smem(B, R) <= BLOCK_SMEM
    assert ks.k8_rows_smem(ks.MAX_B, R) <= BLOCK_SMEM


def test_k8_takes_at_most_16_queries():
    with pytest.raises(ValueError, match="queries"):
        ks.k8_geometry(1, 17, N_POLY, K)


@pytest.mark.parametrize("Wn", WORLDS)
@pytest.mark.parametrize("S", SEEDS)
def test_k7_rows_covered_once(Wn, S):
    """Step (a)'s tiles take every polynomial row once, the tiles from
    t_first on hold every torque row, step (b)'s tiles every screened row
    once, and each of those tiles owns one partial slot per seed."""
    n_centre, n_torque = 3 * T * J, T * F
    geo = ks.k7_geometry(Wn, S, n_centre, n_torque, K)
    rows = np.zeros(N_POLY, dtype=int)
    for t in range(geo.tiles_a):
        rows[t * geo.R:min((t + 1) * geo.R, N_POLY)] += 1
    assert (rows == 1).all() and (geo.tiles_a - 1) * geo.R < N_POLY
    # tiles before t_first hold centre rows only; t_first holds the first torque row
    assert geo.t_first * geo.R <= n_centre < (geo.t_first + 1) * geo.R
    screened = np.zeros(K, dtype=int)
    for t in range(geo.tiles_b):
        screened[t * geo.RB:min((t + 1) * geo.RB, K)] += 1
    assert (screened == 1).all()
    slots = [("a", t) for t in range(geo.t_first, geo.tiles_a)] + \
        [("b", t) for t in range(geo.tiles_b)]
    assert len(slots) == geo.npart
    # step (c): a CTA per (world, seed)
    assert geo.ctas(Wn, S)[2] == Wn * S


@pytest.mark.parametrize("Wn", WORLDS)
@pytest.mark.parametrize("S", SEEDS)
def test_k7_grid_fills_the_card(Wn, S):
    geo = ks.k7_geometry(Wn, S, 3 * T * J, T * F, K, SMS)
    ctas_a, ctas_b, _ = geo.ctas(Wn, S)
    if Wn * N_POLY >= 2 * SMS * ks.K7_TILES[-1]:
        assert ctas_a >= 2 * SMS
    else:
        assert geo.R == ks.K7_TILES[-1]
    if Wn * K >= 2 * SMS * ks.K7_COL_TILES[-1]:
        assert ctas_b >= 2 * SMS
    else:
        assert geo.RB == ks.K7_COL_TILES[-1]
    # the largest tiles that do (each row read once for all seeds, fewer partials)
    assert all(Wn * -(-N_POLY // r) < 2 * SMS for r in ks.K7_TILES if r > geo.R)
    assert all(Wn * -(-K // r) < 2 * SMS for r in ks.K7_COL_TILES if r > geo.RB)


@pytest.mark.parametrize("R", ks.K7_TILES)
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_k7_shared_memory_fits(R, S):
    text = _source("alm_newton.cu")
    assert _define(text, "K7_MAXS") == ks.K7_MAXS
    assert _define(text, "K7A_THREADS") == ks.K7_ROWS_THREADS
    assert _define(text, "K7C_THREADS") == ks.K7_FINISH_THREADS
    assert _define(text, "K7C_CHUNKS") == ks.K7_FINISH_CHUNKS
    assert re.search(r"case %d: err = k7_rows<NF, %d>" % (R, R), text)
    assert ks.k7_nacc(F) == 37 and ks.k7_nacc(F) * ks.K7_FINISH_CHUNKS <= ks.K7_FINISH_THREADS
    # the torque values of step (a) reuse the staged rows' space
    assert S * (1 + F) <= ks.k8_pitch(B)
    assert re.search(r"__shared__ float red\[SM\]\[\(R \+ 31\) / 32\]\[NACC\]", text)
    static = ks.k7_rows_static_smem(F, S, R)
    assert static == 4 * {1: 1, 2: 2, 4: 4, 8: 8}[S] * -(-R // 32) * 37
    assert ks.k7_rows_smem(B, F, S, R) + static <= BLOCK_SMEM
    assert ks.k7_rows_smem(ks.MAX_B, F, S, R) + static <= BLOCK_SMEM
    # above 48 KB a block only by opt-in: the launcher always asks for it
    assert "cudaFuncSetAttribute(k7_rows_kernel<NF, R, SM>" in text


def test_k7_takes_at_most_8_seeds():
    with pytest.raises(ValueError, match="seeds"):
        ks.k7_geometry(1, 9, 3 * T * J, T * F, K)


@pytest.mark.parametrize("J_, F_", [(7, 7), (7, 6), (6, 6), (8, 7), (8, 8), (1, 1), (7, 1),
                                    (9, 7), (9, 9)])
def test_k5_lanes_cover_every_chain(J_, F_):
    """K5 runs the 2 + 4J + F chains of a control step in one round: one
    lane each, 32 lanes when they fit one warp, else 64; the Gauss-Jordan
    inverse takes 2F lanes of the first warp, and rollout.cu has the
    instantiation."""
    lanes = ksim.k5_geometry(J_, F_)
    chains = ksim.k5_chains(J_, F_)
    assert chains == 2 + 4 * J_ + F_ and chains <= lanes and 2 * F_ <= 32
    assert lanes == (32 if chains <= 32 else 64)
    text = _source("rollout.cu")
    assert re.search(r"case %d: return k5_go<%d, %d>" % (J_, J_, lanes), text)


def test_k5_geometry_refuses_what_the_kernel_does_not_take():
    for J_, F_ in ((10, 7), (7, 8), (7, 0)):
        with pytest.raises(ValueError, match="closed-loop"):
            ksim.k5_geometry(J_, F_)


@pytest.mark.parametrize("Wn", WORLDS)
def test_k10_elements_covered_once(Wn):
    n = Wn * T
    geo = reach.k10_geometry(n, LD, LDL, SMS)
    seen = np.zeros(n, dtype=int)
    for b in range(geo.grid):
        for gi in range(geo.NG):
            seen[geo.elements(b, gi, n)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("Wn", WORLDS)
def test_k10_grid_fills_the_card(Wn):
    n = Wn * T
    geo = reach.k10_geometry(n, LD, LDL, SMS)
    assert geo.G in (32, 64, 256) and geo.NG <= 15
    assert geo.G * geo.NG <= max(reach.K10_THREADS, geo.G)
    if n >= 2 * SMS:
        assert geo.grid >= 2 * SMS
    else:
        # one element per block, eight warps each: W = 1 spreads over the card
        assert geo.NG == 1 and geo.grid == n and geo.G == 256
    # the persistent grid never asks for more blocks than the card holds at once
    per_sm = kpz.SM_SMEM // (reach.k10_smem(LD, LDL, geo.NG) + kpz.BLOCK_SMEM_RESERVED)
    assert per_sm >= 1 and geo.grid <= SMS * per_sm


def test_k10_shared_memory_fits():
    ops, k10 = _source("pz_ops.cuh"), _source("rnea_chain.cu")
    assert _define(ops, "PZ_TAB_BYTES") == kpz.PZ_TAB_BYTES
    assert _define(ops, "PZ_MAXMASS") == kpz.PZ_MAXMASS
    assert 3 * _define(k10, "K10_SLOTS") + 3 * _define(k10, "K10_TEMPS") == reach.K10_ENTRIES
    assert LDL == 52 and LDL % 4 == 0
    # up to K10_THREADS threads a block, three blocks an SM
    assert re.search(r"__launch_bounds__\(G > %d \? G : %d, G > %d \? 1 : 3\)"
                     % ((reach.K10_THREADS,) * 3), k10)
    for NG in (1, 2, 4):
        assert reach.k10_smem(LD, LDL, NG) <= BLOCK_SMEM
    # four warps a block, three blocks an SM at the flagship widths
    assert 3 * (reach.k10_smem(LD, LDL, 4) + kpz.BLOCK_SMEM_RESERVED) <= kpz.SM_SMEM


K9_WORLDS = [1, 4, 64, 512]


@pytest.mark.parametrize("Wn", K9_WORLDS)
def test_k9_elements_covered_once(Wn):
    n = Wn * T
    geo = reach.k9_geometry(n, LD, LDL, SMS)
    seen = np.zeros(n, dtype=int)
    for b in range(geo.grid):
        for gi in range(geo.NG):
            seen[geo.elements(b, gi, n)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("Wn", K9_WORLDS)
def test_k9_grid_fills_the_card(Wn):
    n = Wn * T
    geo = reach.k9_geometry(n, LD, LDL, SMS)
    assert geo.G in (32, 64, 256) and geo.NG <= 15 and geo.G * geo.NG <= reach.K9_THREADS
    if n >= 2 * SMS:
        assert geo.grid >= 2 * SMS
    else:
        # one element per block, eight warps each: W = 1 spreads over the card
        assert geo.NG == 1 and geo.grid == n and geo.G == 256
    if n >= 8 * SMS:
        # a warp per element, eight a block, two blocks an SM
        assert geo.G == 32 and geo.NG == 8 and geo.grid == 2 * SMS
    per_sm = kpz.SM_SMEM // (reach.k9_smem(LD, LDL, geo.NG) + kpz.BLOCK_SMEM_RESERVED)
    assert per_sm >= 1 and geo.grid <= SMS * per_sm


def test_k9_shared_memory_fits():
    ops, k9 = _source("pz_ops.cuh"), _source("fk_chain.cu")
    assert _define(ops, "PZ_TAB_BYTES") == kpz.PZ_TAB_BYTES
    assert _define(ops, "PZ_MAXMASS") == kpz.PZ_MAXMASS
    assert 3 * _define(k9, "K9_SLOTS") + 3 == reach.K9_ENTRIES
    assert _define(k9, "K9_THREADS") == reach.K9_THREADS
    assert _define(k9, "K9_MAXJ") == reach.MAX_J
    # at most K9_THREADS threads a block, two blocks an SM
    assert re.search(r"__launch_bounds__\(K9_THREADS, 2\)", k9)
    for NG in range(1, reach.K9_THREADS // 32 + 1):
        assert reach.k9_smem(LD, LDL, NG) <= BLOCK_SMEM
    assert 2 * (reach.k9_smem(LD, LDL, 8) + kpz.BLOCK_SMEM_RESERVED) <= kpz.SM_SMEM
    # past 48 KB a launch needs the opt-in: it is asked for on every launch,
    # whatever the size (a conditional opt-in was K7's cudaError 1)
    launch = k9[k9.index('extern "C" int k9_launch'):]
    assert re.search(r"\n  cudaError_t err = cudaFuncSetAttribute\(k9_kernel, "
                     r"cudaFuncAttributeMaxDynamicSharedMemorySize", launch)
    assert reach.k9_smem(LD, LDL, 8) > 48 * 1024


K6_WORLDS = [1, 4, 64, 512]
N_LOG, O_MAX = 500, 40         # logged steps of a closed-loop move, obstacles


@pytest.mark.parametrize("Wn", K6_WORLDS)
def test_k6_states_and_links_covered_once(Wn):
    """Every (world, chunk, split) is one block, the chunks cover the logged
    steps once, and a chunk's split blocks test every (link, real obstacle)
    pair once between their warps, whatever the number of real obstacles."""
    geo = ksim.k6_geometry(Wn, N_LOG, SMS)
    blocks = np.zeros((Wn, geo.chunks, geo.splits), dtype=int)
    for b in range(geo.grid):
        w, s0, split = geo.block(b)
        blocks[w, s0 // ksim.K6_STEPS, split] += 1
    assert (blocks == 1).all()
    steps = np.zeros(N_LOG, dtype=int)
    for c in range(geo.chunks):
        steps[c * ksim.K6_STEPS:(c + 1) * ksim.K6_STEPS] += 1
    assert (steps == 1).all() and (geo.chunks - 1) * ksim.K6_STEPS < N_LOG
    for nobs in (0, 1, 13, O_MAX):
        pairs = np.zeros((J, max(nobs, 1)), dtype=int)
        for split in range(geo.splits):
            for warp in range(ksim.K6_THREADS // 32):
                for j, k in geo.pairs(split, warp, J, nobs):
                    pairs[j, k] += 1
        assert (pairs == (1 if nobs else 0)).all(), nobs


@pytest.mark.parametrize("Wn", K6_WORLDS)
def test_k6_grid_fills_the_card(Wn):
    geo = ksim.k6_geometry(Wn, N_LOG, SMS)
    assert 1 <= geo.splits <= ksim.K6_MAXSPLIT
    assert geo.grid == Wn * geo.chunks * geo.splits
    if Wn * geo.chunks >= 2 * SMS:
        assert geo.splits == 1          # no chunk's FK is run twice
    else:
        # W = 1: 16 chunks x 16 splits, 256 blocks of 8 warps
        assert geo.grid >= 2 * SMS or geo.splits == ksim.K6_MAXSPLIT
    assert geo.grid >= SMS


def test_k6_shared_memory_fits():
    k6 = _source("oracle_check.cu")
    assert _define(k6, "K6_MAXJ") == ksim.MAXJ
    assert _define(k6, "K6_STEPS") == ksim.K6_STEPS == 32
    assert _define(k6, "K6_THREADS") == ksim.K6_THREADS
    assert _define(k6, "K6_MAXSPLIT") == ksim.K6_MAXSPLIT
    assert _define(k6, "K6_FRAME") == ksim.K6_FRAME
    assert _define(k6, "K6_OBS") == ksim.K6_OBS
    assert ksim.K6_FRAME == 12 + 3 * _define(k6, "K6_AXIS")
    for O in (0, 1, O_MAX, 1000):
        assert ksim.k6_smem(O) <= BLOCK_SMEM
    # nine links' frames (the dumbbell's bodies): 4 (9 x 27 x 32 + 32 O) bytes,
    # under the 48 KB default up to O = 141
    assert ksim.MAXJ == 9
    assert ksim.k6_smem(O_MAX) == 4 * (9 * 27 * 32 + 32 * O_MAX) == 36224
    assert ksim.k6_smem(141) <= 48 * 1024 < ksim.k6_smem(142)
    # four blocks an SM at the flagship's 40 obstacles
    assert 4 * (ksim.k6_smem(O_MAX) + kpz.BLOCK_SMEM_RESERVED) <= kpz.SM_SMEM
    launch = k6[k6.index('extern "C" int k6_launch'):]
    # the opt-in on every launch, whatever the size; the one output buffer
    # zeroed by one memset before the kernel, which only adds to it
    assert re.search(r"\n  err = cudaFuncSetAttribute\(k6_kernel, "
                     r"cudaFuncAttributeMaxDynamicSharedMemorySize", launch)
    assert launch.count("cudaMemsetAsync(args->out, 0, (size_t)args->W * (8 + 4)") == 1
    kernel = k6[k6.index("k6_kernel(const K6Args args)"):k6.index('extern "C" int k6_launch')]
    assert "memset" not in kernel and not re.search(r"flags\[\d\] = 0", kernel)


def test_k6_refuses_logs_of_another_width():
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3

    z = torch.zeros(2, 3, 6)
    saved = ksim._require
    ksim._require = lambda *a, **k: None      # past the device checks, to the width check
    try:
        with pytest.raises(ValueError, match="logs of 6 joints"):
            ksim.oracle_check(kinova_gen3(), ArmourConfig(), z, z, z, z, z,
                              torch.zeros(2, 4, 3), torch.zeros(2, 4, 3, 3),
                              torch.ones(2, 4, dtype=torch.bool))
    finally:
        ksim._require = saved


K2_ELEMENTS = [128, 4 * 128, 64 * 128, 2 * 64 * 128, 2 * 512 * 128]


@pytest.mark.parametrize("n", K2_ELEMENTS)
def test_k2_elements_covered_once(n):
    geo = kpz.k2_geometry(n, LD, SMS)
    seen = np.zeros(n, dtype=int)
    for b in range(geo.grid):
        for gi in range(geo.NG):
            seen[geo.elements(b, gi, n)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n", K2_ELEMENTS)
def test_k2_grid_fills_the_card(n):
    geo = kpz.k2_geometry(n, LD, SMS)
    assert geo.G in (32, 64, 256) and geo.G * geo.NG <= kpz.K2_THREADS and geo.NG <= 15
    if n >= 2 * SMS:
        assert geo.grid >= 2 * SMS
    else:
        assert geo.NG == 1 and geo.grid == n and geo.G == 256
    if n >= 8 * SMS:
        # a warp per element, eight a block, two blocks an SM (its registers):
        # the flagship's 8,192 and 16,384 elements on a grid of 264 blocks
        assert geo.G == 32 and geo.NG == 8 and geo.grid == 2 * SMS
    per_sm = kpz.SM_SMEM // (kpz.k2_smem(LD, geo.NG) + kpz.BLOCK_SMEM_RESERVED)
    assert per_sm >= 1 and geo.grid <= SMS * min(per_sm, kpz.K2_BLOCKS_PER_SM)


def test_k2_shared_memory_fits():
    ops, k2 = _source("pz_ops.cuh"), _source("pz_cross.cu")
    assert _define(ops, "PZ_TAB_BYTES") == kpz.PZ_TAB_BYTES
    assert _define(ops, "PZ_MAXMASS") == kpz.PZ_MAXMASS
    assert _define(k2, "K2_THREADS") == kpz.K2_THREADS
    assert "__launch_bounds__(K2_THREADS, %d)" % kpz.K2_BLOCKS_PER_SM in k2
    # the group area: mass scratch and the entries of a, b and the result
    assert "(4 * PZ_MAXMASS + 9 * ld + 3) / 4 * 4" in k2
    for NG in range(1, kpz.K2_THREADS // 32 + 1):
        assert kpz.k2_smem(LD, NG) <= BLOCK_SMEM
        assert kpz.k2_smem(kpz.MAX_B + kpz.MAX_E + 1, NG) <= BLOCK_SMEM
    assert 4 * (kpz.k2_smem(LD, 8) + kpz.BLOCK_SMEM_RESERVED) <= kpz.SM_SMEM
    # past 48 KB a launch needs the opt-in: it is asked for on every launch,
    # whatever the size (a conditional opt-in was K7's cudaError 1)
    launch = k2[k2.index('extern "C" int k2_launch'):]
    assert re.search(r"\n  cudaError_t err = cudaFuncSetAttribute\(k2_kernel, "
                     r"cudaFuncAttributeMaxDynamicSharedMemorySize", launch)
    assert kpz.k2_smem(LD, 8) > 48 * 1024
    # the element loop of K2 is the persistent grid's (ChainGeometry.elements)
    assert "base += (long long)gridDim.x * NG" in k2


def test_k2_strided_views_match_expand():
    """kernels/pz.py forms each operand's batch strides without
    Tensor.expand: the same strides wherever a batch dim has more than one
    element (a broadcast dim has stride 0), for vectors and matrices,
    broadcast parameter sets and transposed operands."""
    from armour_tpu_torch.pz.bpz import BPZ

    def mk(shape, Bw=5, Ew=3):
        return BPZ(coef=torch.zeros(*shape, Bw), egen=torch.zeros(*shape, Ew),
                   rad=torch.zeros(*shape))

    def expanded(p, bshape, nval):
        nb = len(bshape)
        full = [1] * (3 - nb) + list(bshape)
        ts = (p.coef.expand(*bshape, *p.coef.shape[-nval - 1:]),
              p.egen.expand(*bshape, *p.egen.shape[-nval - 1:]),
              p.rad.expand(*bshape, *p.rad.shape[-nval:]))
        bat = [[s if n > 1 else 0 for s, n in zip([0] * (3 - nb) + list(t.stride()[:nb]), full)]
               for t in ts]
        val = [(list(t.stride()[nb:t.dim() - tr]) + [0, 0])[:2] for t, tr in zip(ts, (1, 1, 0))]
        return bat, val

    cases = [((64, 1, 128, 3), (64, 1, 128, 3), 1), ((64, 1, 128, 3), (2, 1, 3), 1),
             ((2, 1, 3), (64, 2, 128, 3), 1), ((7, 3), (7, 3), 1), ((3,), (4, 3), 1),
             ((2, 1, 4, 3, 3), (2, 3, 4, 3, 4), 2), ((5, 3, 3), (3, 2), 2)]
    for sa, sb, nval in cases:
        a, b = mk(sa), mk(sb)
        bshape = kpz._batch_shape(a, b, nval)
        assert bshape == tuple(torch.broadcast_shapes(sa[:-nval], sb[:-nval]))
        full = [1] * (3 - len(bshape)) + list(bshape)
        for p in (a, b):
            v = kpz._view(p, bshape, nval, "t")
            bat = [[s if n > 1 else 0 for s, n in zip(list(x), full)] for x in (v.cb, v.eb, v.rb)]
            assert (bat, [list(v.cv), list(v.ev), list(v.rv)]) == expanded(p, bshape, nval)
    m = mk((2, 3, 4, 3, 3))
    t = BPZ(coef=m.coef.transpose(-3, -2), egen=m.egen.transpose(-3, -2),
            rad=m.rad.transpose(-2, -1))
    v = kpz._view(t, (2, 3, 4), 2, "t")
    assert ([list(v.cb), list(v.cv), list(v.rv)]
            == [expanded(t, (2, 3, 4), 2)[0][0], [5, 15], [1, 3]])
    with pytest.raises(ValueError, match="broadcast"):
        kpz._batch_shape(mk((2, 3)), mk((3, 3)), 1)


# (n, m) of K1's rotation operand a: 3x3 in all three products on its path
# (its shared memory holds a and one column of b and of the result, so the
# result's width p does not enter), and smaller ones the kernel also takes
K1_SHAPES = [(3, 3), (2, 3), (3, 1)]


@pytest.mark.parametrize("n", K2_ELEMENTS)
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_elements_covered_once(n, shape):
    geo = kpz.k1_geometry(n, LD, LDL, *shape, SMS)
    seen = np.zeros(n, dtype=int)
    for b in range(geo.grid):
        for gi in range(geo.NG):
            seen[geo.elements(b, gi, n)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n", K2_ELEMENTS)
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_grid_fills_the_card(n, shape):
    geo = kpz.k1_geometry(n, LD, LDL, *shape, SMS)
    assert geo.G in (32, 64, 256) and geo.G * geo.NG <= kpz.K1_THREADS and geo.NG <= 15
    if n >= 2 * SMS:
        assert geo.grid >= 2 * SMS
    else:
        assert geo.NG == 1 and geo.grid == n and geo.G == 256
    if n >= 8 * SMS:
        # a warp per element, eight a block, two blocks an SM (its registers):
        # the flagship's 8,192 and 16,384 elements on a grid of 264 blocks
        assert geo.G == 32 and geo.NG == 8 and geo.grid == 2 * SMS
    per_sm = kpz.SM_SMEM // (kpz.k1_smem(LD, LDL, *shape, geo.NG) + kpz.BLOCK_SMEM_RESERVED)
    assert per_sm >= kpz.K1_BLOCKS_PER_SM and geo.grid <= SMS * kpz.K1_BLOCKS_PER_SM


def test_k1_shared_memory_fits():
    k1 = _source("pz_matmul_linear.cu")
    assert _define(k1, "K1_THREADS") == kpz.K1_THREADS
    assert "__launch_bounds__(K1_THREADS, %d)" % kpz.K1_BLOCKS_PER_SM in k1
    # the group area: mass scratch, a compact, one column of b and the result
    assert "(4 * PZ_MAXMASS + n * m * ldl + (m + n) * ld + 3) / 4 * 4" in k1
    assert _define(_source("pz_ops.cuh"), "PZ_MAXM") == 3
    ld_max, ldl_max = kpz.MAX_B + kpz.MAX_E + 1, kpz.lin_ld(kpz.MAX_NF, kpz.MAX_E)
    for shape in K1_SHAPES:
        for ld, ldl in ((LD, LDL), (ld_max, ldl_max)):
            geo = kpz.k1_geometry(64 * 128, ld, ldl, *shape, SMS)
            assert geo.NG >= 1 and kpz.k1_smem(ld, ldl, *shape, geo.NG) <= BLOCK_SMEM
            assert kpz.K1_BLOCKS_PER_SM * (kpz.k1_smem(ld, ldl, *shape, geo.NG)
                                           + kpz.BLOCK_SMEM_RESERVED) <= kpz.SM_SMEM
    # a's compact entries start 16-byte aligned (PZLinA reads them as float4)
    assert kpz.PZ_TAB_BYTES % 16 == 0 and LDL % 4 == 0
    # past 48 KB a launch needs the opt-in: it is asked for on every launch
    launch = k1[k1.index('extern "C" int k1_launch'):]
    assert re.search(r"\n  cudaError_t err = cudaFuncSetAttribute\(k1_kernel, "
                     r"cudaFuncAttributeMaxDynamicSharedMemorySize", launch)
    assert kpz.k1_smem(LD, LDL, 3, 3, 8) > 48 * 1024
    # the element loop of K1 is the persistent grid's (ChainGeometry.elements)
    assert "base += (long long)gridDim.x * NG" in k1


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are built with nvcc there)")
    return torch.device("cuda")


def _small_problem(dev):
    import glob

    from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.worlds import load_world_csv, straight_line_waypoint

    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float32, num_time_steps=16, screen_k=512)
    basis = make_basis(7, 3)
    ws = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:3]]
    rng = np.random.default_rng(0)
    q0 = torch.as_tensor(np.stack([w.start for w in ws]), dtype=torch.float32, device=dev)
    qd0 = torch.as_tensor(rng.uniform(-0.3, 0.3, q0.shape), dtype=torch.float32, device=dev)
    q_des = torch.as_tensor(np.stack([straight_line_waypoint(w.start, w.goal,
                                                             continuous=robot.continuous_joints)
                                      for w in ws]), dtype=torch.float32, device=dev)
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                         cfg.max_obstacles, cfg.dtype) for w in ws])
    obs = type(obs)(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                    mask=obs.mask.to(dev))
    return robot, cfg, basis, plan_problem(q0, qd0, 0.5 * qd0, q_des, obs, robot, cfg, basis)


@pytest.mark.cuda
def test_k8_matches_its_plain_version_on_the_card():
    """Merit within 1e-4 |merit|, rows within 1e-5 of their terms, feasibility
    identical but for queries with a row that close to its threshold, and
    the same bits on a second call."""
    from armour_tpu_torch import nlp

    dev = _card()
    robot, cfg, basis, prob = _small_problem(dev)
    rows = ks.alm_rows(prob, cfg, basis)
    Wn, S, A = prob.q_des.shape[0], 4, 3
    g = torch.Generator().manual_seed(0)
    kq = ((torch.rand(Wn, S * A, 7, generator=g) * 2 - 1) * 0.5).to(dev)
    lam = (torch.rand(Wn, S, rows.M, generator=g) * 3).to(dev)
    rho = torch.full((Wn, S), 10.0, device=dev)
    seed = torch.arange(S, dtype=torch.int32).repeat_interleave(A).to(dev)
    m, f, _, c = ks.alm_values(rows, kq, lam, rho, seed, True)
    m2, f2, _, c2 = ks.alm_values(rows, kq, lam, rho, seed, True)
    m0, f0, _, c0 = nlp.alm_values_plain(kq, lam, rho, seed, prob, cfg, basis, True)
    assert torch.equal(m, m2) and torch.equal(c, c2) and torch.equal(f, f2)
    assert ((m - m0).abs() <= 1e-4 * (m0.abs() + 1e-6)).all()
    # a torque row's terms: sum_b |u_coef_b phi_b| + |hi|, twice (+u - hi, -u - hi)
    t = (torch.matmul(basis.phi(kq).abs(), rows.tensors["u_coef"].abs().transpose(1, 2))
         + rows.tensors["u_hi"].abs()[:, None])
    mag = 1.0 + c0.abs()
    mag[..., :2 * rows.args.TF] += torch.cat([t, t], dim=-1)
    assert ((c - c0).abs() <= 1e-5 * mag).all()
    near = ((c0 - nlp._stack_thresholds(prob, cfg)).abs() <= 1e-5 * mag).any(-1)
    assert ((f == f0) | near).all()


@pytest.mark.cuda
def test_k10_matches_its_plain_version_on_the_card():
    """Every entry within 1e-5 of the plain entry's total mass, and the same
    bits on a second call."""
    from armour_tpu_torch import dynamics
    from armour_tpu_torch.jrs import build_jrs

    dev = _card()
    robot, cfg, basis, prob = _small_problem(dev)
    rng = np.random.default_rng(1)
    q = [torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 7)), dtype=torch.float32, device=dev)
         for _ in range(3)]
    jrs = build_jrs(*q, robot, cfg, basis)
    got = reach.rnea_chain(jrs, robot, cfg, basis)
    again = reach.rnea_chain(jrs, robot, cfg, basis)
    ref = dynamics.rnea_pz_sets_plain(jrs, robot, cfg, basis)
    mass = ref.coef.abs().sum(-1) + ref.egen.abs().sum(-1) + ref.rad.abs()
    for f in ("coef", "egen", "rad"):
        assert torch.equal(getattr(got, f), getattr(again, f))
        m = mass if f == "rad" else mass[..., None]
        assert ((getattr(got, f) - getattr(ref, f)).abs() <= 1e-5 * (m + 1e-6)).all()


@pytest.mark.cuda
def test_k9_matches_its_plain_version_on_the_card():
    """Every link entry within 1e-5 of the plain entry's total mass, the
    same bits on a second call and under other launch geometries."""
    from armour_tpu_torch import kinematics
    from armour_tpu_torch.jrs import build_jrs

    dev = _card()
    robot, cfg, basis, _ = _small_problem(dev)
    rng = np.random.default_rng(2)
    q = [torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 7)), dtype=torch.float32, device=dev)
         for _ in range(3)]
    jrs = build_jrs(*q, robot, cfg, basis)
    got = reach.fk_chain(jrs, robot, cfg, basis)
    ref = kinematics.forward_occupancy_plain(jrs, robot, cfg, basis)
    mass = ref.coef.abs().sum(-1) + ref.egen.abs().sum(-1) + ref.rad.abs()
    for f in ("coef", "egen", "rad"):
        m = mass if f == "rad" else mass[..., None]
        assert ((getattr(got, f) - getattr(ref, f)).abs() <= 1e-5 * (m + 1e-6)).all()
    default = reach.k9_geometry
    try:
        for G, NG, grid in ((256, 1, 5), (64, 2, 7), (32, 8, 1), (32, 3, 2), (None, 0, 0)):
            if G is not None:
                reach.k9_geometry = lambda *a, g=reach.ChainGeometry(G, NG, grid), **k: g
            else:
                reach.k9_geometry = default
            again = reach.fk_chain(jrs, robot, cfg, basis)
            assert all(torch.equal(getattr(got, f), getattr(again, f))
                       for f in ("coef", "egen", "rad")), (G, NG, grid)
    finally:
        reach.k9_geometry = default


@pytest.mark.cuda
def test_k7_matches_its_plain_version_on_the_card():
    """m0 within 1e-4 |m0|, g and H within 1e-4 of their summed terms, the
    step's backward error within 1e-4, feasibility identical, and the same
    bits on a second call (seeds 4 and 2)."""
    from armour_tpu_torch import nlp

    dev = _card()
    robot, cfg, basis, prob = _small_problem(dev)
    rows = ks.alm_rows(prob, cfg, basis)
    Wn = prob.q_des.shape[0]
    g = torch.Generator().manual_seed(0)
    for S in (4, 2):
        k = ((torch.rand(Wn, S, 7, generator=g) * 2 - 1) * 0.5).to(dev)
        lam = (torch.rand(Wn, S, rows.M, generator=g) * 3).to(dev)
        rho = torch.full((Wn, S), 10.0, device=dev)
        got = ks.alm_newton(rows, k, lam, rho, want_system=True)
        again = ks.alm_newton(rows, k, lam, rho, want_system=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        step, m0, feas, _, gk, Hk = got
        _, m00, f0, _ = nlp.alm_newton_plain(k, lam, rho, prob, cfg, basis)
        g0, H0, c0 = nlp.alm_newton_system(k, lam, rho, prob, cfg, basis)
        _, Jc = nlp.constraint_stack(k, prob, cfg, basis, with_grad=True)
        z0 = lam + rho[..., None] * c0
        w = torch.where(z0 > 0, rho[..., None], torch.zeros_like(c0))
        le = torch.where(z0 > 0, z0, torch.zeros_like(c0))
        Ja = Jc.abs()
        g_mag = nlp.plan_cost_grad(k, prob.traj, prob.q_des, prob.limits.continuous,
                                   cfg).abs() + (Ja * le[..., None]).sum(-2)
        H_mag = torch.matmul(Ja.transpose(-1, -2) * w[..., None, :], Ja) \
            + nlp.plan_cost_hessian(prob.traj, cfg) + 1e-3
        assert ((m0 - m00).abs() <= 1e-4 * (m00.abs() + 1e-6)).all()
        assert ((gk - g0).abs() <= 1e-4 * (g_mag + 1e-6)).all()
        assert ((Hk - H0).abs() <= 1e-4 * (H_mag + 1e-6)).all()
        resid = (torch.matmul(H0, step[..., None])[..., 0] - g0).abs()
        assert (resid <= 1e-4 * (torch.matmul(H0.abs(), step.abs()[..., None])[..., 0]
                                 + g0.abs() + 1e-6)).all()
        assert torch.equal(feas, f0)


@pytest.mark.cuda
def test_k5_matches_its_plain_version_on_the_card():
    """A 60-step move of three worlds under each controller: |dq| <= 1e-4
    rad, |dqd| <= 1e-3 rad/s, |du| <= 1e-4 (|u| + 1), and the same bits on
    a second call."""
    from armour_tpu_torch import simulator as tsim
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.controller import ALTHOFF_DEFAULT
    from armour_tpu_torch.models.kinova import kinova_gen3

    dev = _card()
    robot, cfg = kinova_gen3(), ArmourConfig(dtype=torch.float32)
    rng = np.random.default_rng(0)
    Wn, n = 3, 60

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev).contiguous()

    q, qd = f32(rng.uniform(-1, 1, (Wn, 7))), f32(rng.uniform(-0.3, 0.3, (Wn, 7)))
    t = np.arange(n) * 1e-3
    amp = [rng.uniform(-1, 1, (Wn, 1, 7)) for _ in range(3)]
    q_des = f32(q.cpu().numpy()[:, None] + 0.2 * np.sin(3 * t)[None, :, None] * amp[0])
    qd_des = f32(0.6 * np.cos(3 * t)[None, :, None] * amp[1])
    qdd_des = f32(-1.8 * np.sin(3 * t)[None, :, None] * amp[2])
    tps = [tsim.sample_true_params(robot, rng, scale=1.0) for _ in range(Wn)]
    tp = tsim.TrueParams(*(f32(np.stack([getattr(x, a).numpy() for x in tps]))
                           for a in ("mass", "inertia", "com")))
    noise = f32(1e-4 * rng.standard_normal((Wn, n, 2, 7)))
    for controller, nz in (("robust", None), ("althoff", None), ("nominal", None),
                           ("robust", noise)):
        a = (robot, cfg, q, qd, q_des, qd_des, qdd_des, tp, 1e-3, 2, controller, nz,
             ALTHOFF_DEFAULT)
        got, again = ksim.rollout(*a), ksim.rollout(*a)
        ref = tsim.rollout_plain(*a)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        assert float((got[2] - ref[2]).abs().max()) <= 1e-4
        assert float((got[3] - ref[3]).abs().max()) <= 1e-3
        assert ((got[4] - ref[4]).abs() <= 1e-4 * (ref[4].abs() + 1.0)).all()


K6_MARGIN = 1e-5     # m: an overlap whose deciding margin is this close may flip (chip_smoke.py)


def _k6_logs(dev, seed=3, Wn=4, N=70, O=12):
    """Logged states of W worlds (the first third of world 0 at q = 0, so
    link axes are parallel to the axis-aligned obstacles' and some cross
    axes vanish), obstacles around the logged link centres, some with a
    zero generator, a quarter masked out."""
    from armour_tpu_torch import simulator as tsim
    from armour_tpu_torch.models.kinova import kinova_gen3

    robot = kinova_gen3()
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (Wn, 1, 7)) + 0.3 * np.linspace(0, 1, N)[None, :, None] \
        * rng.uniform(-1, 1, (Wn, 1, 7))
    q[0, :N // 3] = 0.0
    qd = 0.3 * rng.uniform(-1, 1, (Wn, N, 7))

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).contiguous()

    _, link_c, _ = tsim._link_boxes(robot, f32(q))
    centers, gens = np.zeros((Wn, O, 3)), np.zeros((Wn, O, 3, 3))
    for w in range(Wn):
        for o in range(O):
            centers[w, o] = link_c[w, rng.integers(0, N), rng.integers(0, 7)].numpy() \
                + rng.uniform(-0.3, 0.3, 3)
            A = np.eye(3) if o % 3 == 0 else np.linalg.qr(rng.standard_normal((3, 3)))[0]
            h = rng.uniform(0.02, 0.15, 3)
            h[o % 3] = 0.0 if o % 4 == 1 else h[o % 3]
            gens[w, o] = A * h[None, :]
    logs = dict(q=f32(q), qd=f32(qd), u=f32(20 * rng.uniform(-1, 1, (Wn, N, 7))),
                q_des=f32(q + 1e-3 * rng.standard_normal((Wn, N, 7))),
                qd_des=f32(qd + 1e-3 * rng.standard_normal((Wn, N, 7))))
    logs = {k: v.to(dev) for k, v in logs.items()}
    return robot, logs, f32(centers).to(dev), f32(gens).to(dev), \
        torch.as_tensor(rng.uniform(size=(Wn, O)) > 0.25).to(dev)


@pytest.mark.cuda
def test_k6_matches_its_plain_version_on_the_card():
    """Flags identical to oracle_check_plain's and overlap counts equal up
    to the triples whose deciding margin lies within K6_MARGIN, on logs with
    vanishing cross axes and zero generators and on copies with a planted
    fault each (obstacles on the links, torque, ultimate bound, joint
    limit); the same bits on a second call and under other grid splits."""
    from armour_tpu_torch import simulator as tsim
    from armour_tpu_torch.collision import ObstacleSet
    from armour_tpu_torch.config import ArmourConfig

    dev = _card()
    robot, logs, centers, gens, mask = _k6_logs(dev)
    cfg = ArmourConfig(dtype=torch.float32)
    Wn, N, _ = logs["q"].shape
    lim = torch.as_tensor(robot.torque_limits, dtype=torch.float32, device=dev)
    ub = torch.as_tensor(robot.position_limits_ub, dtype=torch.float32, device=dev)
    _, link_c, _ = tsim._link_boxes(robot, logs["q"])
    copies = [(None, logs, centers)]
    for flag in range(4):
        x, c = {k: v.clone() for k, v in logs.items()}, centers.clone()
        if flag == 0:
            c[1, :3] = link_c[1, N // 2, 2:5]
        elif flag == 1:
            x["u"][1] *= 1.01 / float((x["u"][1].abs() / lim).max())
        elif flag == 2:
            x["q_des"][1, N // 2, 3] += 1.5 * cfg.ub.qe
        else:
            x["q"][1, N // 3, int(torch.argmin(ub))] = ub.min() + 0.01
        copies.append((flag, x, c))
    default = ksim.k6_geometry
    for flag, x, c in copies:
        obs = ObstacleSet(centers=c, generators=gens, mask=mask)
        args = (robot, cfg, x["q"], x["qd"], x["u"], x["q_des"], x["qd_des"], c, gens, mask)
        got = ksim.oracle_check(*args)
        fp, op = tsim.oracle_check_plain(robot, cfg, x, obs)
        R_w, link_centers, link_h = tsim._link_boxes(robot, x["q"])
        axes, half = tsim.obstacle_axes_halves(gens)
        margin = tsim.sat_margin(link_centers[:, :, :, None], R_w[:, :, :, None],
                                 link_h[:, None], c[:, None, None], axes[:, None, None],
                                 half[:, None, None])
        amb = ((margin.abs() <= K6_MARGIN) & mask[:, None, None]).flatten(1).sum(-1)
        assert torch.equal(got[0], fp), flag
        assert bool(((got[1] - op).abs() <= amb).all()), flag
        if flag is not None:
            assert bool(fp[1, flag]) and not bool(fp[0, flag])
        try:
            for splits in (None, 1, 3, ksim.K6_MAXSPLIT):
                if splits is not None:
                    geo = default(Wn, N)
                    ksim.k6_geometry = lambda *a, g=dataclasses.replace(
                        geo, splits=splits, grid=Wn * geo.chunks * splits), **k: g
                again = ksim.oracle_check(*args)
                assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]), splits
        finally:
            ksim.k6_geometry = default


@pytest.mark.cuda
def test_k2_matches_its_plain_version_on_the_card():
    """Every entry within 1e-5 of the plain version's summed |terms| (the
    product on |a|, |b|, plus both sides of the overflow), a broadcast
    parameter-set operand (stride 0) included, and the same bits on a
    second call and under two other launch geometries."""
    from armour_tpu_torch.pz import bpz
    from armour_tpu_torch.pz.basis import error_layout, make_basis
    from armour_tpu_torch.pz.bpz import BPZ

    dev = _card()
    basis = make_basis(7, 3)
    Ew = error_layout(basis.nf)["size"]
    rng = np.random.default_rng(4)

    def rand(shape):
        coef = rng.standard_normal(shape + (basis.size,)) * 0.3 ** rng.integers(0, 4, basis.size)
        return BPZ(*(torch.as_tensor(x, dtype=torch.float32).contiguous().to(dev) for x in (
            coef, 0.01 * rng.standard_normal(shape + (Ew,)), 0.01 * rng.uniform(size=shape))))

    def absp(p):
        return BPZ(coef=p.coef.abs(), egen=p.egen.abs(), rad=p.rad.abs())

    default = kpz.k2_geometry
    for sa, sb in (((3, 1, 40, 3), (3, 1, 40, 3)), ((3, 1, 40, 3), (2, 1, 3)),
                   ((2, 1, 3), (3, 2, 40, 3))):
        a, b = rand(sa), rand(sb)
        got = kpz.cross(a, b, basis, 1e-6)
        ref = bpz.cross_plain(a, b, basis, 1e-6)
        mag = bpz.bilinear(absp(a), absp(b), bpz._cross_abs_t, bpz._cross_abs, basis, 1e-6,
                           absprod_t=bpz._cross_abs_t)
        mag.rad = mag.rad + 2.0 * bpz._cross_abs(a.coef.abs().sum(-1), b.coef.abs().sum(-1))
        for f in ("coef", "egen", "rad"):
            assert ((getattr(got, f) - getattr(ref, f)).abs()
                    <= 1e-5 * (getattr(mag, f).abs() + 1e-6)).all(), (sa, sb, f)
        try:
            for geo in (None, kpz.ChainGeometry(96, 2, 7), kpz.ChainGeometry(32, 3, 5)):
                if geo is not None:
                    kpz.k2_geometry = lambda *x, g=geo: g
                again = kpz.cross(a, b, basis, 1e-6)
                assert all(torch.equal(getattr(got, f), getattr(again, f))
                           for f in ("coef", "egen", "rad")), (sa, sb, geo)
        finally:
            kpz.k2_geometry = default


@pytest.mark.cuda
def test_k1_matches_its_plain_version_on_the_card():
    """Every entry within 1e-5 of the plain version's summed |terms| (the
    product on |a|, |b|), on the forward and backward rotation shapes (a
    broadcast over parameter sets by a stride of 0) and the transposed FK
    product, and the same bits on a second call and under two other
    launch geometries."""
    from armour_tpu_torch.pz import bpz
    from armour_tpu_torch.pz.basis import error_layout, make_basis
    from armour_tpu_torch.pz.bpz import BPZ

    dev = _card()
    basis = make_basis(7, 3)
    Ew = error_layout(basis.nf)["size"]
    rng = np.random.default_rng(5)

    def rand(shape):
        coef = rng.standard_normal(shape + (basis.size,)) * 0.3 ** rng.integers(0, 4, basis.size)
        return BPZ(*(torch.as_tensor(x, dtype=torch.float32).contiguous().to(dev) for x in (
            coef, 0.01 * rng.standard_normal(shape + (Ew,)), 0.01 * rng.uniform(size=shape))))

    def absp(p):
        return BPZ(coef=p.coef.abs(), egen=p.egen.abs(), rad=p.rad.abs())

    def plain(a, b, tr):
        out = bpz.matmul_linear_plain(a, b, basis, 1e-6)
        return bpz._transpose_mat(out) if tr else out

    default = kpz.k1_geometry
    for sa, sb, tr in (((3, 1, 40, 3, 3), (3, 1, 40, 3, 4), False),
                       ((3, 1, 40, 3, 3), (3, 2, 40, 3, 2), False),
                       ((3, 40, 3, 3), (3, 40, 3, 3), True)):
        a, b = rand(sa), rand(sb)
        got = kpz.matmul_linear(a, b, basis, 1e-6, transpose_out=tr)
        ref, mag = plain(a, b, tr), plain(absp(a), absp(b), tr)
        for f in ("coef", "egen", "rad"):
            assert ((getattr(got, f) - getattr(ref, f)).abs()
                    <= 1e-5 * (getattr(mag, f).abs() + 1e-6)).all(), (sa, sb, f)
        try:
            for geo in (None, kpz.ChainGeometry(96, 2, 7), kpz.ChainGeometry(32, 3, 5)):
                if geo is not None:
                    kpz.k1_geometry = lambda *x, g=geo: g
                again = kpz.matmul_linear(a, b, basis, 1e-6, transpose_out=tr)
                assert all(torch.equal(getattr(got, f), getattr(again, f))
                           for f in ("coef", "egen", "rad")), (sa, sb, geo)
        finally:
            kpz.k1_geometry = default


def _armtd_problem(dev, W=4, T=16):
    """An ARMTD plan's inputs on the card: start velocities at g_k's floor,
    in its adaptive range and at its cap."""
    from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
    from armour_tpu_torch.config import ArmourConfig

    cfg = ArmourConfig(num_time_steps=T, dtype=torch.float32, max_obstacles=4, screen_k=64,
                       traj_family="armtd")
    rng = np.random.default_rng(2)
    q0 = torch.as_tensor(rng.uniform(-2, 2, (W, 7)), dtype=torch.float32).to(dev)
    qd0 = torch.as_tensor(rng.uniform(-1, 1, (W, 7)) * np.array([[0.0], [0.3], [2.0], [5.0]]),
                          dtype=torch.float32).to(dev)
    obs = stack_obstacles([pad_obstacles(np.array([[0.6, 0.6, 0.5]]), np.diag([0.05] * 3)[None],
                                         4, torch.float32)] * W)
    obs = type(obs)(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                    mask=obs.mask.to(dev))
    return cfg, q0, qd0, q0 + 0.1, obs


@pytest.mark.cuda
def test_k11_matches_its_plain_version_on_the_card():
    """K11 against build_jrs_armtd_plain on the card: the velocity PZs and
    the trajectory scalars bit for bit (g_k's |qd0| / 3 is an IEEE division
    in both), R and Rt within 1e-6 (1 + |plain|) (its cos / sin and 3x3
    products may round differently); a repeat gives the same bits."""
    from armour_tpu_torch import armtd, kernels
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.pz.basis import make_basis

    dev = _card()
    robot, basis = kinova_gen3(), make_basis(7, 3)
    cfg, q0, qd0, _, _ = _armtd_problem(dev)
    kernels.reset_counts()
    got = armtd.build_jrs_armtd(q0, qd0, robot, cfg, basis)
    again = armtd.build_jrs_armtd(q0, qd0, robot, cfg, basis)
    assert kernels.counts()["jrs_armtd"] == 2
    ref = armtd.build_jrs_armtd_plain(q0, qd0, robot, cfg, basis)
    for f in ("R", "Rt", "qd", "qda", "qdda"):
        for g in ("coef", "egen", "rad"):
            a, b = getattr(getattr(got, f), g), getattr(getattr(ref, f), g)
            assert torch.equal(a, getattr(getattr(again, f), g))
            if f in ("R", "Rt"):
                assert bool(((a - b).abs() <= 1e-6 * (1 + b.abs())).all()), (f, g)
            else:
                assert torch.equal(a, b), (f, g)
    for n in ("qdd0", "Tqd0", "TTqdd0", "k_scale"):
        assert torch.equal(getattr(got.traj, n), getattr(ref.traj, n)), n


@pytest.mark.cuda
def test_k7_k8_armtd_branch_matches_plain_on_the_card():
    """K7 / K8 on an ARMTD plan against alm_newton_plain / alm_values_plain:
    the state rows bit for bit, merit and m0 within 1e-5 relative, the step
    within 1e-4 relative."""
    from armour_tpu_torch import nlp
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis

    dev = _card()
    robot, basis = kinova_gen3(), make_basis(7, 3)
    cfg, q0, qd0, q_des, obs = _armtd_problem(dev)
    prob = plan_problem(q0, qd0, torch.zeros_like(q0), q_des, obs, robot, cfg, basis)
    rows = ks.alm_rows(prob, cfg, basis)
    assert rows.args.armtd == 1
    W, S, F = q0.shape[0], 4, 7
    g = torch.Generator(device="cpu").manual_seed(0)
    k = (2 * torch.rand((W, S, F), generator=g) - 1).to(dev)
    k[:, 0] = 0.0
    lam = torch.zeros(W, S, rows.M, device=dev)
    rho = torch.full((W, S), 10.0, device=dev)
    seed = torch.arange(S, dtype=torch.int32, device=dev)
    merit, feas, _, c = ks.alm_values(rows, k, lam, rho, seed, want_c=True)
    m0, f0, _, c0 = nlp.alm_values_plain(k, lam, rho, seed, prob, cfg, basis, want_c=True)
    assert torch.equal(c[..., -8 * F:], c0[..., -8 * F:])
    assert float(((merit - m0).abs() / (1 + m0.abs())).max()) <= 1e-5
    step, m1, _, _ = ks.alm_newton(rows, k, lam, rho)
    st0, m10, _, _ = nlp.alm_newton_plain(k, lam, rho, prob, cfg, basis)
    assert float(((m1 - m10).abs() / (1 + m10.abs())).max()) <= 1e-5
    assert float(((step - st0).abs() / (1 + st0.abs())).max()) <= 1e-4


# ---------------------------------------------------------------------------
# K13 (screen_collision) and K15 (reach_assembly): the argument structs
# against the sources, the launchers' values, the launch geometry
# ---------------------------------------------------------------------------

# ctypes.c_longlong is c_long where long has 64 bits
_C_TYPES = {"int": "c_int", "long long": ctypes.c_longlong.__name__, "float": "c_float",
            "short": "c_short", "unsigned char": "c_ubyte"}


def _struct_fields(src, name):
    """[(field, ctypes type name or (type name, length))] of `struct name`
    in csrc/src: pointers are c_void_p, arrays (type, #define'd length)."""
    text = _source(src)
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    out = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m = re.match(r"(?:const )?((?:unsigned )?(?:long long|int|float|char|short))\s*(\*?)"
                     r"\s*(.*)$",
                     decl, re.S)
        base, ptr, names = m.groups()
        for nm in (x.strip() for x in names.split(",")):
            arr = re.match(r"(\w+)\[(\w+)(?: \+ (\d+))?\]$", nm)
            if ptr or nm.startswith("*"):
                out.append((nm.lstrip("* "), "c_void_p"))
            elif arr:
                out.append((arr.group(1), (_C_TYPES[base], _define(text, arr.group(2))
                                           + int(arr.group(3) or 0))))
            else:
                out.append((nm, _C_TYPES[base]))
    return out


def _ctypes_fields(cls):
    out = []
    for nm, ty in cls._fields_:
        if hasattr(ty, "_length_"):
            out.append((nm, (ty._type_.__name__, ty._length_)))
        else:
            out.append((nm, ty.__name__))
    return out


def test_k13_args_match_the_source():
    """K13Args names csrc/screen_collision.cu's struct field for field, in
    order and type, and holds no hyperplane tensor: K13 forms its rows."""
    from armour_tpu_torch.kernels import collision as kcol

    assert _ctypes_fields(kcol.K13Args) == _struct_fields("screen_collision.cu", "K13Args")
    names = {n for n, _ in kcol.K13Args._fields_}
    assert not names & {"A", "d", "delta"}
    assert '#include "hyperplane_cell.cuh"' in _source("screen_collision.cu")
    assert '#include "hyperplane_cell.cuh"' in _source("build_hyperplanes.cu")


def test_k15_args_match_the_source():
    assert _ctypes_fields(reach.K15Args) == _struct_fields("reach_assembly.cu", "K15Args")
    text = _source("reach_assembly.cu")
    assert _define(text, "K15_TILE") == reach.K15_TILE
    assert "#define K15_THREADS (32 * K15_TILE)" in text
    assert reach.K15_THREADS == 32 * reach.K15_TILE
    assert _define(text, "K15_STAGES") == reach.K15_STAGES
    assert _define(text, "K15_RANGES") == reach.K15_RANGES
    assert _define(text, "K15_PART") == reach.K15_PART
    assert _define(text, "K15_MAXF") == reach.K15_MAX_F
    assert _define(text, "K15_MAXJ3") == reach.K15_MAX_J3


@pytest.mark.parametrize("Wn", WORLDS)
@pytest.mark.parametrize("Kq", [1, 512, K, 40000])
def test_k13_passes_cover_rows_and_choices_once(Wn, Kq):
    """Pass (a) a thread per (world, row), pass (c) a thread per (world,
    chosen row): every one covered, no block wholly idle."""
    from armour_tpu_torch.kernels import collision as kcol

    O = 40
    N = T * J * O
    Kk = min(Kq, N)
    geo = kcol.k13_geometry(Wn, N, Kk)
    bx, by = geo.bound_grid
    assert by == Wn and bx * kcol.K13_BOUND_THREADS >= N > (bx - 1) * kcol.K13_BOUND_THREADS
    G = kcol.K13_GATHER_THREADS
    assert geo.gather_blocks * G >= Wn * Kk > (geo.gather_blocks - 1) * G


@pytest.mark.parametrize("Wn", WORLDS)
def test_k15_geometry_fits(Wn):
    """A block of K15_TILE warps, a warp a time step of its tile; the
    ring's K15_STAGES tiles, the warps' parts and the zero fit a block's
    shared memory after the opt-in up to 8 factors and 9 links with the
    basis of 8 factors, and two blocks fit an SM at the flagship's and the
    dumbbell's widths; the Python mirror of the shared memory repeats the
    source's formula."""
    from armour_tpu_torch.pz.basis import make_basis

    text = _source("reach_assembly.cu")
    assert "return (K15_TILE * k15_count(a, r) + 3 + 3) / 4 * 4;" in text
    assert ("return sizeof(float) * ((size_t)K15_STAGES * k15_stage_floats(a) +\n"
            "                          K15_TILE * K15_PART * K15_MAXF);") in text
    counts = reach.k15_counts(F, 3 * J, B, E)
    assert reach.k15_smem(F, 3 * J, B, E) == 4 * (
        2 * sum((4 * c + 6) // 4 * 4 for c in counts) + 4 * 5 * 8)
    b8 = make_basis(8, 3)
    E8 = 5 * 8 + 3
    assert reach.k15_smem(8, 27, b8.size, E8) <= reach.K15_SMEM_MAX <= BLOCK_SMEM
    for J3 in (3 * J, 3 * JD):
        geo = reach.k15_geometry(Wn, T, F, J3, B, E, SMS)
        assert geo.per_sm == 2 and geo.smem == reach.k15_smem(F, J3, B, E)
        assert geo.grid == min(Wn * T // reach.K15_TILE, 2 * SMS)
    assert Wn * T < 2 ** 31


@pytest.mark.parametrize("Fn, J3", [(F, 3 * J), (F, 27), (6, 18), (8, 27), (2, 6)])
def test_k15_lanes_take_each_sum_once(Fn, J3):
    """A Python copy of a warp's sums (reach_assembly.cu): lane f < F takes
    factor f's long sum, lane F + f its two egen sums, and link row p goes
    to lane (2F + p) mod 32, so every sum is taken once, no lane takes two
    of the long or egen sums, and a lane takes at most two link rows (one
    after a long or egen sum)."""
    text = _source("reach_assembly.cu")
    assert "part[lane] = k15_long_sum(ic + lane * B, nc + lane * B, B);" in text
    assert ("for (int p = lane >= 2 * F ? lane - 2 * F : lane + 32 - 2 * F; p < J3; "
            "p += 32) {") in text
    assert "2 * args->F + args->J3 > 64" in text
    assert 2 * reach.K15_MAX_F + reach.K15_MAX_J3 <= 64 and 2 * Fn + J3 <= 64
    rows = {}
    for lane in range(32):
        p = lane - 2 * Fn if lane >= 2 * Fn else lane + 32 - 2 * Fn
        while p < J3:
            rows.setdefault(lane, []).append(p)
            p += 32
    assert sorted(p for ps in rows.values() for p in ps) == list(range(J3))
    assert all(len(ps) == 1 for lane, ps in rows.items() if lane < 2 * Fn)
    assert all(len(ps) <= 2 for ps in rows.values())


@pytest.mark.parametrize("Wn", [1, 3, 64])
@pytest.mark.parametrize("Tn", [128, 6, 10])
def test_k15_tiles_cover_every_step_once(Wn, Tn):
    """The persistent grid walks every (world, time step) once, also where
    T is not a multiple of the tile (the ragged last tile of each world)
    and where the grid holds fewer blocks than tiles."""
    for sms in (SMS, 1):
        geo = reach.k15_geometry(Wn, Tn, F, 3 * J, B, E, sms)
        assert geo.tiles == Wn * -(-Tn // reach.K15_TILE) and 1 <= geo.grid <= geo.tiles
        seen = sorted(p for b in range(geo.grid) for p in geo.steps(b, Tn))
        assert seen == [(w, t) for w in range(Wn) for t in range(Tn)]


def _ring_copies(off, n, slot):
    """A Python copy of csrc/ring_copy.cuh:ring_copy: the (tensor float,
    stage float, bytes) of each copy of n floats at offset off into the
    slot starting at stage float `slot`."""
    ph = off % 4
    head = min((4 - ph) % 4, n)
    chunks = (n - head) // 4
    tail = n - head - 4 * chunks
    starts = [(off + i, 4) for i in range(head)]
    starts += [(off + head + 4 * k, 16) for k in range(chunks)]
    starts += [(off + n - tail + i, 4) for i in range(tail)]
    return [(g, slot + ph + g - off, size) for g, size in starts]


def _check_ring_ranges(ranges):
    """ranges: (tensor offset, floats, slot start, slot end) of a tile's
    ranges, in stage order.  Every float copied once, 16-byte copies
    aligned in the tensor and in the stage, each range inside its slot at
    its phase, the slots contiguous multiples of 4 floats."""
    assert ranges[0][2] == 0
    for (off, n, lo, hi), nxt in zip(ranges, ranges[1:] + [None]):
        cps = _ring_copies(off, n, lo)
        got = sorted(g + i for g, _, size in cps for i in range(size // 4))
        assert got == list(range(off, off + n))
        assert all(g % 4 == 0 and s % 4 == 0 for g, s, size in cps if size == 16)
        assert lo % 4 == 0 and hi % 4 == 0 and lo + off % 4 + n <= hi
        assert nxt is None or nxt[2] == hi


@pytest.mark.parametrize("Tn", [128, 6, 10])
@pytest.mark.parametrize("J3", [21, 27])
def test_k15_copies_cover_each_range_once(Tn, J3):
    """The eight ranges of every tile (reach_assembly.cu:k15_issue: u_both's
    coef, egen, rad of each plane, the links' egen and rad) copied through
    ring_copy into their slots (_check_ring_ranges), at the flagship's,
    the dumbbell's and the UR5's widths (B = 84, E = 33, F = 6)."""
    assert "ring_copy(st, k15_base(a, r), k15_offset(a, r, w, t0)" in _source("reach_assembly.cu")
    for Fn, Bn, En in ((F, B, E), (6, 84, 33)):
        counts = reach.k15_counts(Fn, J3, Bn, En)
        for w in (0, 1, 2):
            for t0 in range(0, Tn, reach.K15_TILE):
                nv = min(reach.K15_TILE, Tn - t0)
                ranges, lo = [], 0
                for r, c in enumerate(counts):
                    row = (w * 2 + (r & 1)) * Tn + t0 if r < 6 else w * Tn + t0
                    ranges.append((row * c, nv * c, lo, lo + reach.k15_slot(c)))
                    lo += reach.k15_slot(c)
                _check_ring_ranges(ranges)


def test_k15_wrapper_raises_on_a_misaligned_view(monkeypatch):
    """The kernel places each range at the phase of its offset in its
    tensor, so a view that does not start 16-byte aligned is refused
    before anything launches."""
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.pz import bpz
    from armour_tpu_torch.pz.basis import make_basis

    robot, cfg, basis = kinova_gen3(), ArmourConfig(num_time_steps=4), make_basis(7, 3)
    calls = []
    links, u_both = bpz.zeros((1, 4, J, 3), basis), bpz.zeros((1, 2, 4, F), basis)
    flat = torch.zeros(u_both.egen.numel() + 1)
    shifted = bpz.BPZ(coef=u_both.coef, egen=flat[1:].view(u_both.egen.shape), rad=u_both.rad)
    assert shifted.egen.data_ptr() % 16 == 4
    monkeypatch.setattr(reach, "launcher", _fake_launcher(calls))
    monkeypatch.setattr(reach, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(reach, "_sms", lambda t: 1)
    monkeypatch.setattr(reach, "launched", lambda *a: None)
    monkeypatch.setattr(reach, "_require", lambda p, what, shape: p)
    with pytest.raises(ValueError, match="16-byte aligned"):
        reach.reach_assembly(links, shifted, robot, cfg, basis)
    assert not calls
    reach.reach_assembly(links, u_both, robot, cfg, basis)
    assert len(calls) == 1


def _fake_launcher(calls):
    def launcher(name, symbol, argtypes):
        def fn(*args):
            calls.append((name, symbol, argtypes, args))
            return 0
        return fn
    return launcher


def test_k13_launcher_passes_the_cells(monkeypatch):
    """The launcher hands K13 the cells' inputs (no hyperplanes), the
    sizes and the geometry, with the library and the device check
    stubbed."""
    from armour_tpu_torch import kernels
    from armour_tpu_torch.kernels import collision as kcol

    calls = []
    monkeypatch.setattr(kcol, "launcher", _fake_launcher(calls))
    monkeypatch.setattr(kcol, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(kcol, "launched", lambda *a: None)
    monkeypatch.setattr(kcol, "_require", lambda *a, **k: None)
    Wn, Tn, Jn, O, Bn = 2, 3, 7, 4, 120
    ins = [torch.zeros(Wn, Tn, Jn, 3, 3), torch.zeros(Wn, Tn, Jn, 3), torch.zeros(Wn, O, 3),
           torch.zeros(Wn, O, 3, 3), torch.zeros(Wn, Tn, Jn, 3, Bn), torch.zeros(Wn, Tn, Jn, 3),
           torch.ones(Wn, O, dtype=torch.bool)]
    out = kcol.screen_collision(*ins, 50, 2)
    (name, symbol, argtypes, (args, smem, _)), = calls
    assert (name, symbol) == ("screen_collision", "k13_launch")
    a = args._obj
    N = Tn * Jn * O
    geo = kcol.k13_geometry(Wn, N, 50)
    for f, t in zip(("shape_gens", "radius", "centers", "gens", "center", "env", "obs_mask"),
                    ins):
        assert getattr(a, f) == t.data_ptr(), f
    for f, t in zip(("A_out", "d_out", "delta_out", "row", "mask"), out):
        assert getattr(a, f) == t.data_ptr(), f
    assert (a.W, a.N, a.TJ, a.O, a.B, a.K, a.quota, a.Kp, a.smem_sort) == (
        Wn, N, Tn * Jn, O, Bn, 50, 2, geo.Kp, 1)
    assert smem == geo.smem_bytes and a.sort is None
    assert tuple(out[0].shape) == (Wn, 3, 36, 50) and out[3].dtype == torch.int32


def test_k4_args_match_the_source():
    """K4Args names csrc/collision_rows.cu's struct field for field, in
    order and type (the cell mode's cells beside the row mode's tensors);
    the launcher's constants are the source's; the cell mode forms its rows
    with K3's device code."""
    from armour_tpu_torch.kernels import collision as kcol

    assert _ctypes_fields(kcol.K4Args) == _struct_fields("collision_rows.cu", "K4Args")
    text = _source("collision_rows.cu")
    assert _define(text, "K4_THREADS") == kcol.K4_THREADS
    assert _define(text, "K4_MAX_G") == kcol.K4_MAX_G == max(kcol.K4_GROUPS)
    assert '#include "hyperplane_cell.cuh"' in text
    cases = re.findall(r"case (\d+): k4_launch_g<(\d+)>\(a, s\); break;", text)
    assert [(int(c), int(g)) for c, g in cases] == [(g, g) for g in kcol.K4_GROUPS]
    assert ("  dim3 grid((unsigned int)((a.R + K4_THREADS - 1) / K4_THREADS),\n"
            "            (unsigned int)((a.Q + G - 1) / G), (unsigned int)a.W);") in text


@pytest.mark.parametrize("Q", [1, 2, 3, 4, 5, 7, 8, 9, 12, 16, 17, 24, 33])
def test_k4_groups_cover_every_query_once(Q):
    """k4_group takes the fewest groups of at most K4_MAX_G queries, then the
    least instantiated G that covers Q in them; the grid's groups cover
    every query once, the last group's queries past Q written nowhere
    (collision_rows.cu: q0 + g < Q); the planning paths' Q = 1, 2, 4, 6,
    12 pad no query."""
    from armour_tpu_torch.kernels import collision as kcol

    G = kcol.k4_group(Q)
    assert G in kcol.K4_GROUPS
    by = -(-Q // G)                   # the grid's groups (k4_launch_g)
    assert by == -(-Q // kcol.K4_MAX_G)
    assert G == min(g for g in kcol.K4_GROUPS if g * by >= Q)
    written = [q0 * G + g for q0 in range(by) for g in range(G) if q0 * G + g < Q]
    assert written == list(range(Q))
    if Q in (1, 2, 4, 6, 12):
        assert by * G == Q


def _k4_stubbed(monkeypatch):
    from armour_tpu_torch.kernels import collision as kcol

    calls = []
    monkeypatch.setattr(kcol, "launcher", _fake_launcher(calls))
    monkeypatch.setattr(kcol, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(kcol, "launched", lambda *a: None)
    monkeypatch.setattr(kcol, "_require", lambda *a, **k: None)
    return kcol, calls


@pytest.mark.parametrize("group", [0, 1, 4])
def test_k4_launcher_passes_the_cells(monkeypatch, group):
    """The cell mode's launcher hands K4 the cells' inputs and no hyperplane
    tensor, no dg, C = 36, R = T J O and the group (k4_group(Q) through
    collision_cells, else the one _collision_cells is given), with the
    library and the device check stubbed."""
    kcol, calls = _k4_stubbed(monkeypatch)
    Wn, Tn, Jn, O, Q = 2, 3, 7, 4, 12
    ins = [torch.zeros(Wn, Tn, Jn, 3, 3), torch.zeros(Wn, Tn, Jn, 3), torch.zeros(Wn, O, 3),
           torch.zeros(Wn, O, 3, 3), torch.ones(Wn, O, dtype=torch.bool),
           torch.zeros(Wn, Q, 3, Tn * Jn)]
    g = kcol._collision_cells(*ins, group) if group else kcol.collision_cells(*ins)
    (name, symbol, _, (args, _)), = calls
    assert (name, symbol) == ("collision_rows", "k4_launch")
    a = args._obj
    for f, t in zip(("shape_gens", "radius", "centers", "gens", "obs_mask", "p_all"), ins):
        assert getattr(a, f) == t.data_ptr(), f
    assert a.g == g.data_ptr() and tuple(g.shape) == (Wn, Q, Tn * Jn * O)
    for f in ("A", "d", "delta", "row", "mask", "dp_all", "dg"):
        assert getattr(a, f) is None, f
    assert (a.W, a.Q, a.C, a.R, a.TJ, a.O, a.F, a.row_ws) == (Wn, Q, 36, Tn * Jn * O, Tn * Jn,
                                                              O, 0, 0)
    assert a.G == (group or kcol.k4_group(Q)) and a.tau == 0.0


@pytest.mark.parametrize("smooth", [False, True], ids=["hard", "smooth"])
def test_k4_launcher_passes_the_rows(monkeypatch, smooth):
    """The row mode's launcher hands K4 the rows' tensors and no cells, the
    world stride of a screened row index, dg's F, the group and, smooth,
    tau; a group outside K4_GROUPS is refused."""
    kcol, calls = _k4_stubbed(monkeypatch)
    Wn, R, TJ, Q, F = 2, 50, 21, 5, 7
    ins = [torch.zeros(Wn, 3, 36, R), torch.zeros(Wn, 36, R), torch.zeros(Wn, 36, R),
           torch.zeros(Wn, R, dtype=torch.int32), torch.ones(Wn, R, dtype=torch.bool),
           torch.zeros(Wn, Q, 3, TJ), torch.zeros(Wn, Q, 3, F, TJ)]
    g, dg = kcol.collision_rows(*ins, smooth_tau=0.01 if smooth else 0.0)
    (_, _, _, (args, _)), = calls
    a = args._obj
    for f, t in zip(("A", "d", "delta", "row", "mask", "p_all", "dp_all"), ins):
        assert getattr(a, f) == t.data_ptr(), f
    for f in ("shape_gens", "radius", "centers", "gens", "obs_mask"):
        assert getattr(a, f) is None, f
    assert (a.g, a.dg) == (g.data_ptr(), dg.data_ptr())
    assert (a.W, a.Q, a.C, a.R, a.TJ, a.F, a.O, a.G, a.row_ws) == (Wn, Q, 36, R, TJ, F, 0,
                                                                   kcol.k4_group(Q), R)
    assert (a.tau > 0) == smooth
    for bad in (-1, 3, kcol.K4_MAX_G + 1):
        with pytest.raises(ValueError, match="queries a thread"):
            kcol._collision_rows(*ins, 0.0, bad)


def test_k15_launcher_passes_its_parts(monkeypatch):
    """The launcher hands K15 the links' egen / rad and u_both's three
    tensors, c0 and the friction rounded once to float32, the sizes and the
    persistent grid (k15_geometry; the kernel's C launcher forms its shared
    memory); u_coef and center_coef stay views of the inputs."""
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.pz import bpz
    from armour_tpu_torch.pz.basis import make_basis

    calls = []
    monkeypatch.setattr(reach, "launcher", _fake_launcher(calls))
    monkeypatch.setattr(reach, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(reach, "launched", lambda *a: None)
    monkeypatch.setattr(reach, "_require", lambda p, what, shape: p)
    robot, cfg, basis = kinova_gen3(), ArmourConfig(num_time_steps=4), make_basis(7, 3)
    Wn, Tn = 2, 4
    links, u_both = bpz.zeros((Wn, Tn, J, 3), basis), bpz.zeros((Wn, 2, Tn, F), basis)
    monkeypatch.setattr(reach, "_sms", lambda t: 1)
    frs, torque = reach.reach_assembly(links, u_both, robot, cfg, basis)
    (name, symbol, argtypes, (args, grid, _)), = calls
    assert (name, symbol) == ("reach_assembly", "k15_launch")
    assert argtypes[1:] == [ctypes.c_int, ctypes.c_void_p]
    a = args._obj
    assert (a.W, a.T, a.F, a.J3, a.B, a.E, a.sh0) == (Wn, Tn, F, 3 * J, B, E, 5 * 7)
    assert grid == reach.k15_geometry(Wn, Tn, F, 3 * J, B, E, 1).grid == 2
    assert (a.le, a.lr) == (links.egen.data_ptr(), links.rad.data_ptr())
    assert (a.shape_gens, a.radius) == (frs.shape_gens.data_ptr(), frs.radius.data_ptr())
    assert frs.center_coef is links.coef
    assert (a.uc, a.ue, a.ur) == (u_both.coef.data_ptr(), u_both.egen.data_ptr(),
                                  u_both.rad.data_ptr())
    assert a.torque_radius == torque.torque_radius.data_ptr()
    assert torque.u_coef.data_ptr() == u_both.coef.data_ptr()
    ub = cfg.ub
    assert a.c0 == np.float32(ub.alpha * (ub.m_max - ub.m_min) * ub.eps)
    assert list(a.friction)[:F] == [np.float32(x) for x in robot.friction[:F]]


@pytest.mark.cuda
def test_k15_matches_its_plain_version_on_the_card():
    """K15 gives reach_assembly_plain's bits on the card, for the Kinova
    and with an uncertain centre of mass (u_both from the K1 / K2 loops),
    and the same bits on a second call; u_coef and center_coef are views of
    K10's and K9's outputs.  torque_frs alone launches K15 with the FK
    chain's links and gives the same bits; reduce_links alone refuses CUDA
    tensors."""
    from armour_tpu_torch import dynamics, kinematics
    from armour_tpu_torch.jrs import build_jrs

    dev = _card()
    robot, cfg, basis, _ = _small_problem(dev)
    rng = np.random.default_rng(2)
    q = [torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 7)), dtype=torch.float32, device=dev)
         for _ in range(3)]
    for rob in (robot, dataclasses.replace(robot, com_uncertainty=0.05)):
        jrs = build_jrs(*q, rob, cfg, basis)
        links = kinematics.forward_occupancy(jrs, rob, cfg, basis)
        u_both = dynamics.rnea_pz_sets(jrs, rob, cfg, basis)
        frs, tq = reach.reach_assembly(links, u_both, rob, cfg, basis)
        frs2, tq2 = reach.reach_assembly(links, u_both, rob, cfg, basis)
        frs_p, tq_p = dynamics.reach_assembly_plain(links, u_both, rob, cfg, basis)
        t1 = dynamics.torque_frs(jrs, rob, cfg, basis)
        with pytest.raises(ValueError, match="reach_assembly"):
            kinematics.reduce_links(links, basis)
        for got in (frs, frs2):
            assert torch.equal(got.shape_gens, frs_p.shape_gens)
            assert torch.equal(got.radius, frs_p.radius)
            assert got.center_coef.data_ptr() == links.coef.data_ptr()
        for got in (tq, tq2):
            assert torch.equal(got.torque_radius, tq_p.torque_radius)
            assert got.u_coef.data_ptr() == u_both.coef.data_ptr()
        assert torch.equal(t1.torque_radius, tq_p.torque_radius)
        assert torch.equal(t1.u_coef, tq_p.u_coef)


# ---------------------------------------------------------------------------
# the grasp path: K16 (grasp_rows), K10 with the wrench and fixed joints,
# K7 / K8's grasp rows and F = 6
# ---------------------------------------------------------------------------

# the dumbbell's widths: J = 9 bodies, F = 7 factors, 3 T grasp rows
JD = 9
N_CENTRE_D, N_TG_D = 3 * T * JD, T * F + 3 * T


def test_k16_args_match_the_source():
    from armour_tpu_torch.kernels import grasp as kgrasp

    assert _ctypes_fields(kgrasp.K16Args) == _struct_fields("grasp_rows.cu", "K16Args")
    text = _source("grasp_rows.cu")
    assert _define(text, "K16_NG") == kgrasp.K16_NG
    assert _define(text, "K16_THREADS") == kgrasp.K16_THREADS == 32 * kgrasp.K16_NG
    assert _define(text, "K16_BLOCKS_PER_SM") == kgrasp.K16_BLOCKS_PER_SM
    assert _define(text, "K16_SQ") == kgrasp.K16_SQ
    assert _define(text, "K16_STAGES") == kgrasp.K16_STAGES
    assert _define(text, "K16_RANGES") == kgrasp.K16_RANGES
    assert _define(text, "K16_SLOTS") == kgrasp.K16_SLOTS == -(-kpz.MAX_B // 32)
    assert "#define K16_TAB_BYTES (4 * PZ_MAXPAIRS + 2 * (PZ_MAXB + 8))" in text
    assert '#include "pz_ops.cuh"' in text and "pz_warp_sum(" in text


@pytest.mark.parametrize("nf", [6, 7])
def test_k16_tables_and_shared_memory_fit(nf):
    """The sorted pair table lists every pair of the basis once, in
    pair-table order within a monomial; it fits pz_ops.cuh's tables, which
    K16 reads; a block's shared memory fits the opt-in's 227 KB (the
    launcher opts in always) at the basis' widths, two blocks to an SM, and
    at the tables' largest."""
    from armour_tpu_torch.kernels import grasp as kgrasp, pz as kpz
    from armour_tpu_torch.pz.basis import error_layout, make_basis, pair_segments

    basis = make_basis(nf, 3)
    Ed = error_layout(nf)["size"]
    pi, pj, seg = pair_segments(nf, 3)
    assert sorted(zip(pi.tolist(), pj.tolist())) == sorted(
        zip(basis.pair_i.tolist(), basis.pair_j.tolist()))
    m_of = {(int(i), int(j)): int(m) for i, j, m in zip(basis.pair_i, basis.pair_j,
                                                        basis.pair_m)}
    for m in range(basis.size):
        seg_pairs = list(zip(pi[seg[m]:seg[m + 1]].tolist(), pj[seg[m]:seg[m + 1]].tolist()))
        assert all(m_of[p] == m for p in seg_pairs)
        order = [next(k for k, q in enumerate(zip(basis.pair_i, basis.pair_j)) if q == p)
                 for p in seg_pairs]
        assert order == sorted(order)
    t = kpz.pz_tables(basis, Ed)
    assert (t.B, t.E, t.P) == (basis.size, Ed, len(pi))
    assert list(t.seg)[:basis.size + 1] == seg.tolist() and list(t.pi)[:len(pi)] == pi.tolist()
    assert 2 * (kgrasp.k16_smem(basis.size + Ed + 1) + 1024) <= kpz.SM_SMEM
    assert kgrasp.k16_smem(kpz.MAX_B + kpz.MAX_E + 1) <= kgrasp.K16_SMEM_MAX == BLOCK_SMEM
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in _source("grasp_rows.cu")
    # a pair's packed operand offsets fit 16 bits each; the ring's stages
    # and the interleaved coefficients start 16-byte aligned
    assert 4 * kgrasp.K16_SQ * (kpz.MAX_B - 1) < 2 ** 16
    assert kgrasp.K16_TAB_BYTES % 16 == 0 and kgrasp.k16_stage_floats(LD) % 4 == 0


@pytest.mark.parametrize("Wn", [1, 3, 8, 64])
@pytest.mark.parametrize("Tn", [128, 6, 10])
def test_k16_geometry_covers_the_elements(Wn, Tn):
    """K16's persistent grid: tiles of K16_NG steps of one world, a warp a
    step, at most as many blocks as tiles and as stay resident on an H100
    (by shared memory and by the register cap: two at the dumbbell's
    widths), its shared memory within the launcher's limit; every (world,
    time step) is walked once, also with a ragged last tile and with fewer
    blocks than tiles."""
    from armour_tpu_torch.kernels import grasp as kgrasp

    per_sm = kpz.SM_SMEM // (kgrasp.k16_smem(LD) + 1024)
    assert per_sm == 2 and kgrasp.K16_THREADS == 32 * kgrasp.K16_NG
    assert kgrasp.k16_smem(LD) <= kgrasp.K16_SMEM_MAX
    for sms in (SMS, 1):
        geo = kgrasp.k16_geometry(Wn, Tn, LD, sms)
        assert geo.tiles == Wn * -(-Tn // kgrasp.K16_NG) and geo.smem == kgrasp.k16_smem(LD)
        assert geo.grid == min(geo.tiles, sms * min(per_sm, kgrasp.K16_BLOCKS_PER_SM))
        seen = sorted(p for b in range(geo.grid) for p in geo.steps(b, Tn))
        assert seen == [(w, t) for w in range(Wn) for t in range(Tn)]


@pytest.mark.parametrize("Bn, En", [(B, E), (84, 33), (kpz.MAX_B, kpz.MAX_E)])
@pytest.mark.parametrize("Tn", [128, 6])
def test_k16_copies_cover_each_range_once(Bn, En, Tn):
    """The six ranges of every tile (grasp_rows.cu:k16_issue: coef, egen,
    rad of f, then of n, 3 entries a step) copied through ring_copy into
    their slots (_check_ring_ranges), the slots within k16_stage_floats;
    at the flagship's and the UR5's widths and the tables' largest."""
    from armour_tpu_torch.kernels import grasp as kgrasp

    text = _source("grasp_rows.cu")
    assert "return (3 * K16_NG * k16_width(r, B, E) + 3 + 3) / 4 * 4;" in text
    assert "return (6 * K16_NG * ld + 36 + 3) / 4 * 4;" in text
    assert "ring_copy(st, k16_base(a, r), e0 * width, 3 * nv * width" in text
    ld, P = Bn + En + 1, 2
    widths = (Bn, En, 1, Bn, En, 1)
    assert sum(kgrasp.k16_slot(x) for x in widths) <= kgrasp.k16_stage_floats(ld)
    for w in (0, 1, 2):
        for t0 in range(0, Tn, kgrasp.K16_NG):
            nv = min(kgrasp.K16_NG, Tn - t0)
            e0 = ((w * P + P - 1) * Tn + t0) * 3
            ranges, lo = [], 0
            for width in widths:
                ranges.append((e0 * width, 3 * nv * width, lo, lo + kgrasp.k16_slot(width)))
                lo += kgrasp.k16_slot(width)
            _check_ring_ranges(ranges)


def test_k16_wrapper_raises_on_a_misaligned_view(monkeypatch):
    """A wrench tensor that does not start 16-byte aligned is refused
    before anything launches."""
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.grasp import GraspParams
    from armour_tpu_torch.kernels import grasp as kgrasp
    from armour_tpu_torch.pz import bpz
    from armour_tpu_torch.pz.basis import make_basis

    calls = []
    monkeypatch.setattr(kgrasp, "launcher", _fake_launcher(calls))
    monkeypatch.setattr(kgrasp, "upload_tables", lambda *a: None)
    monkeypatch.setattr(kgrasp, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(kgrasp, "launched", lambda *a: None)
    monkeypatch.setattr(kgrasp, "_require", lambda p, what, shape: p)
    monkeypatch.setattr(kgrasp.torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=1))
    basis, cfg = make_basis(7, 3), ArmourConfig(num_time_steps=4)
    f, n = bpz.zeros((2, 2, 4, 3), basis), bpz.zeros((2, 2, 4, 3), basis)
    flat = torch.zeros(n.coef.numel() + 2)
    shifted = bpz.BPZ(coef=flat[2:].view(n.coef.shape), egen=n.egen, rad=n.rad)
    assert shifted.coef.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        kgrasp.grasp_rows(f, shifted, GraspParams(), cfg, basis)
    assert not calls
    kgrasp.grasp_rows(f, n, GraspParams(), cfg, basis)
    assert len(calls) == 1


def test_k16_launcher_passes_its_values(monkeypatch):
    """The launcher uploads the basis tables, then hands K16 the wrench's
    six tensors in place (the interval set: pset = P - 1), the outputs, the
    sizes, -mu^2 and -r^2 rounded once to float32, the slop and ld."""
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.grasp import GraspParams
    from armour_tpu_torch.kernels import grasp as kgrasp
    from armour_tpu_torch.pz import bpz
    from armour_tpu_torch.pz.basis import make_basis

    calls, uploads = [], []
    monkeypatch.setattr(kgrasp, "launcher", _fake_launcher(calls))
    monkeypatch.setattr(kgrasp, "upload_tables", lambda *a: uploads.append(a))
    monkeypatch.setattr(kgrasp, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(kgrasp, "launched", lambda *a: None)
    monkeypatch.setattr(kgrasp, "_require", lambda p, what, shape: p)
    monkeypatch.setattr(kgrasp.torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=1))
    basis, cfg = make_basis(7, 3), ArmourConfig(num_time_steps=4)
    params = GraspParams(mu=0.6, support_radius=0.06, normal_axis=1)
    f, n = bpz.zeros((2, 2, 4, 3), basis), bpz.zeros((2, 2, 4, 3), basis)
    out = kgrasp.grasp_rows(f, n, params, cfg, basis)
    assert uploads == [("grasp_rows", "k16_tables", basis, E, f.rad.device)]
    (name, symbol, _, (args, ld, grid, _)), = calls
    assert (name, symbol, ld) == ("grasp_rows", "k16_launch", B + E + 1)
    assert grid == kgrasp.k16_geometry(2, 4, B + E + 1, 1).grid == 2
    a = args._obj
    assert (a.W, a.T, a.P, a.pset, a.normal) == (2, 4, 2, 1, 1)
    for fld, t in zip(("fc", "fe", "fr", "nc", "ne", "nr"),
                      (f.coef, f.egen, f.rad, n.coef, n.egen, n.rad)):
        assert getattr(a, fld) == t.data_ptr(), fld
    assert (a.g_coef, a.g_rad) == (out.g_coef.data_ptr(), out.g_rad.data_ptr())
    assert tuple(out.g_coef.shape) == (2, 4, 3, B) and tuple(out.g_rad.shape) == (2, 4, 3)
    assert a.s_mu == np.float32(-0.6 ** 2) and a.s_r == np.float32(-0.06 ** 2)
    assert a.slop == np.float32(cfg.float_slop)
    with pytest.raises(ValueError, match="normal_axis"):
        kgrasp.grasp_rows(f, n, GraspParams(normal_axis=3), cfg, basis)


def test_k10_args_take_fixed_joints_and_the_wrench(monkeypatch):
    """K10's arguments for the dumbbell (J = 9, F = 7): the two fixed joints
    have no axis and rv = 0, the factor count F indexes qd; the wrench's
    joint and outputs when asked, -1 and null pointers when not; the zero
    row the fixed joints read."""
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.jrs import build_jrs
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.pz.basis import make_basis

    robot = zoo.kinova_dumbbell()
    cfg = ArmourConfig.for_robot(robot, derive_ub=False, num_time_steps=4)
    basis = make_basis(7, 3)
    jrs = build_jrs(torch.zeros(2, 7), torch.zeros(2, 7), torch.zeros(2, 7), robot, cfg, basis)
    calls = []
    monkeypatch.setattr(reach, "launcher", _fake_launcher(calls))
    monkeypatch.setattr(reach, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(reach, "launched", lambda *a: None)
    monkeypatch.setattr(reach, "_require", lambda p, what, shape: p)
    monkeypatch.setattr(reach, "upload_tables", lambda *a: None)
    monkeypatch.setattr(reach, "_sms", lambda t: SMS)
    u = reach.rnea_chain(jrs, robot, cfg, basis)
    u2, fc, nc = reach.rnea_chain(jrs, robot, cfg, basis, wrench_at=8)
    (_, _, _, (a0, *_)), (_, _, _, (a1, *_)) = calls
    a0, a1 = a0._obj, a1._obj
    assert (a0.J, a0.F, a0.P, a0.wj) == (9, 7, 2, -1) and a0.wfc is None and a0.wnr is None
    assert (a1.J, a1.F, a1.wj) == (9, 7, 8)
    assert list(a1.rv)[:9] == [1.0] * 7 + [0.0] * 2
    assert list(a1.sgn)[7:9] == [0.0, 0.0] and list(a1.ax)[7:9] == [0, 0]
    assert a1.zero == a0.zero != 0
    zero = basis.kernel_args[("k10_zero", "cpu")]
    assert zero.data_ptr() == a1.zero and bool((zero == 0).all())
    assert zero.numel() == B + E + 1
    for fld, t in zip(("wfc", "wfe", "wfr", "wnc", "wne", "wnr"),
                      (fc.coef, fc.egen, fc.rad, nc.coef, nc.egen, nc.rad)):
        assert getattr(a1, fld) == t.data_ptr(), fld
    assert tuple(u.rad.shape) == tuple(u2.rad.shape) == (2, 2, 4, 7)
    assert tuple(fc.rad.shape) == (2, 2, 4, 3)
    with pytest.raises(ValueError, match="wrench_at"):
        reach.rnea_chain(jrs, robot, cfg, basis, wrench_at=9)


def test_k10_k9_k12_caps_take_nine_joints():
    """The joint caps of K9, K10 (K10Args' arrays) and K12 / K11 (J + 1
    rotations) hold the dumbbell's nine bodies; K9's and K10's shared memory
    still fits two K9 blocks of eight warps and three K10 blocks of four
    warps an SM."""

    assert _define(_source("fk_chain.cu"), "K9_MAXJ") == reach.MAX_J == 9
    assert _define(_source("rnea_chain.cu"), "K10_MAXJ") == reach.MAX_J
    assert _define(_source("jrs_tail.cuh"), "JRS_MAXJ") == kjrs.MAXJ == 10
    assert 2 * (reach.k9_smem(LD, LDL, 8) + kpz.BLOCK_SMEM_RESERVED) <= kpz.SM_SMEM
    assert 3 * (reach.k10_smem(LD, LDL, 4) + kpz.BLOCK_SMEM_RESERVED) <= kpz.SM_SMEM


@pytest.mark.parametrize("Wn", WORLDS)
@pytest.mark.parametrize("S", SEEDS)
def test_k7_tiles_cover_the_grasp_rows_once(Wn, S):
    """At the dumbbell's widths (3 T J = 3456 centre rows, T F + 3 T =
    1280 torque and grasp rows): the tiles of step (a) cover every
    polynomial row once, the partials start at the first tile holding a
    torque row, and the rows' shared memory fits for F = 6 and 7."""
    geo = ks.k7_geometry(Wn, S, N_CENTRE_D, N_TG_D, K)
    n = N_CENTRE_D + N_TG_D
    assert geo.tiles_a * geo.R >= n > (geo.tiles_a - 1) * geo.R
    assert geo.t_first == N_CENTRE_D // geo.R
    assert geo.t_first * geo.R <= N_CENTRE_D
    for nf in (6, 7):
        Bf = 84 if nf == 6 else B
        assert (ks.k7_rows_smem(Bf, nf, S, geo.R) + ks.k7_rows_static_smem(nf, S, geo.R)
                <= ks.SMEM_LIMIT)
    g8 = ks.k8_geometry(Wn, 12, n, K)
    assert g8.tiles_a * g8.R >= n > (g8.tiles_a - 1) * g8.R
    assert ks.k8_rows_smem(B, g8.R) <= ks.SMEM_LIMIT


def test_alm_kernels_take_six_and_seven_factors():
    """K7 and K8 are instantiated for every F of kernels.solver.FACTORS: the
    UR5's 6 and the 7-DOF arms'."""
    assert ks.FACTORS == (6, 7)
    for src in ("alm_newton.cu", "alm_values.cu"):
        text = _source(src)
        for nf in ks.FACTORS:
            assert re.search(r"case %d: return k[78]_launch_nf<%d>" % (nf, nf), text), (src, nf)


def _grasp_problem(dev, W=3, T_=16, mu=1.5, r=0.5):
    """A dumbbell grasp plan on `dev` (float32, T = 16, the permissive
    contact parameters of tests/test_grasp.py), built by the port's
    planner stages."""
    import glob

    from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
    from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.worlds import load_world_csv, straight_line_waypoint

    robot = zoo.kinova_dumbbell()
    cfg = ArmourConfig.for_robot(robot, derive_ub=False,
                                 ub=derive_ultimate_bound(robot, v_max=5e-4),
                                 num_time_steps=T_, screen_k=512, grasp_constraints=True,
                                 grasp_mu=mu, grasp_support_radius=r)
    basis = make_basis(7, 3)
    ws = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:W]]
    q0 = torch.as_tensor(np.stack([w.start for w in ws]), dtype=torch.float32, device=dev)
    q_des = torch.as_tensor(np.stack([straight_line_waypoint(w.start, w.goal,
                                                             continuous=robot.continuous_joints)
                                      for w in ws]), dtype=torch.float32, device=dev)
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                         cfg.max_obstacles, cfg.dtype) for w in ws])
    obs = type(obs)(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                    mask=obs.mask.to(dev))
    z = torch.zeros_like(q0)
    return robot, cfg, basis, plan_problem(q0, z, z, q_des, obs, robot, cfg, basis)


@pytest.mark.cuda
def test_k16_matches_its_plain_version_on_the_card():
    """K16 gives grasp_rows_plain's bits on the card from K10's wrench of a
    dumbbell JRS (both contact parameter sets of tests/test_grasp.py and a
    sideways normal: pz_mul's warp-order sums, which the plain version
    repeats), and the same bits on a second call; bpz.mul refuses CUDA
    tensors."""
    from armour_tpu_torch import dynamics, grasp
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.jrs import build_jrs
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.pz import bpz
    from armour_tpu_torch.pz.basis import make_basis

    dev = _card()
    robot = zoo.kinova_dumbbell()
    cfg = ArmourConfig.for_robot(robot, derive_ub=False, num_time_steps=16)
    basis = make_basis(7, 3)
    rng = np.random.default_rng(4)
    q = [torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 7)), dtype=torch.float32, device=dev)
         for _ in range(3)]
    jrs = build_jrs(*q, robot, cfg, basis)
    _, fc, nc = dynamics.rnea_pz_sets(jrs, robot, cfg, basis, wrench_at=8)
    for mu, r, ax in ((1.5, 0.5, 2), (1e-4, 1e-4, 2), (0.6, 0.06, 0)):
        p = grasp.GraspParams(mu=mu, support_radius=r, normal_axis=ax)
        got = grasp.grasp_rows(fc, nc, p, cfg, basis)
        again = grasp.grasp_rows(fc, nc, p, cfg, basis)
        want = grasp.grasp_rows_plain(fc, nc, p, cfg, basis)
        for g in (got, again):
            assert torch.equal(g.g_coef, want.g_coef) and torch.equal(g.g_rad, want.g_rad)
    one = bpz.BPZ(coef=fc.coef[:, 1, :, 0], egen=fc.egen[:, 1, :, 0], rad=fc.rad[:, 1, :, 0])
    with pytest.raises(ValueError, match="K16"):
        bpz.mul(one, one, basis)


@pytest.mark.cuda
def test_k10_wrench_and_fixed_joints_match_plain_on_the_card():
    """K10 for the dumbbell (F < J) and the Fetch arm: u and the wrench
    after the last body within 1e-5 of the plain entry's total mass, the
    same bits on a second call, and u the same bits as without the wrench;
    K9 and K12 at J = 9 against their plain versions."""
    from armour_tpu_torch import dynamics, kinematics
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.jrs import build_jrs, build_jrs_plain
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.pz.basis import make_basis

    dev = _card()
    basis = make_basis(7, 3)
    rng = np.random.default_rng(5)
    for robot in (zoo.kinova_dumbbell(), zoo.fetch_arm()):
        cfg = ArmourConfig.for_robot(robot, derive_ub=False, num_time_steps=16)
        q = [torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 7)), dtype=torch.float32, device=dev)
             for _ in range(3)]
        jrs = build_jrs(*q, robot, cfg, basis)
        jp = build_jrs_plain(*q, robot, cfg, basis)
        for fld in ("qd", "qda", "qdda"):
            a, b = getattr(jrs, fld), getattr(jp, fld)
            assert torch.equal(a.coef, b.coef) and torch.equal(a.rad, b.rad), fld
        Jn = robot.num_joints
        assert tuple(jrs.R.rad.shape) == (3, 16, Jn + 1, 3, 3)
        assert torch.equal(jrs.R.coef[:, :, robot.num_factors:],
                           jp.R.coef[:, :, robot.num_factors:])
        got = reach.rnea_chain(jrs, robot, cfg, basis, wrench_at=Jn - 1)
        again = reach.rnea_chain(jrs, robot, cfg, basis, wrench_at=Jn - 1)
        u_only = reach.rnea_chain(jrs, robot, cfg, basis)
        ref = dynamics.rnea_pz_sets_plain(jrs, robot, cfg, basis, wrench_at=Jn - 1)
        assert torch.equal(u_only.coef, got[0].coef) and torch.equal(u_only.rad, got[0].rad)
        for g, a, r in zip(got, again, ref):
            mass = r.coef.abs().sum(-1) + r.egen.abs().sum(-1) + r.rad.abs()
            for f in ("coef", "egen", "rad"):
                assert torch.equal(getattr(g, f), getattr(a, f))
                m = mass if f == "rad" else mass[..., None]
                assert ((getattr(g, f) - getattr(r, f)).abs() <= 1e-5 * (m + 1e-6)).all(), f
        links = kinematics.forward_occupancy(jrs, robot, cfg, basis)
        lref = kinematics.forward_occupancy_plain(jrs, robot, cfg, basis)
        mass = lref.coef.abs().sum(-1) + lref.egen.abs().sum(-1) + lref.rad.abs()
        for f in ("coef", "egen", "rad"):
            m = mass if f == "rad" else mass[..., None]
            assert ((getattr(links, f) - getattr(lref, f)).abs() <= 1e-5 * (m + 1e-6)).all()


@pytest.mark.cuda
def test_k7_k8_grasp_rows_match_plain_on_the_card():
    """K8's rows c (the grasp group between the torque and the collision
    rows) within 1e-5 of their terms, its max mode's grasp maxima within
    1e-5 of the plain maxima and its state maxima bit for bit; K7's g and H
    within 1e-4 of their summed terms (a dumbbell grasp plan, T = 16)."""
    from armour_tpu_torch import nlp

    dev = _card()
    robot, cfg, basis, prob = _grasp_problem(dev)
    assert prob.grasp is not None
    rows = ks.alm_rows(prob, cfg, basis)
    Wn, Tn = prob.q_des.shape[0], cfg.num_time_steps
    TF, TG = Tn * 7, 3 * Tn
    assert rows.args.TG == TG and rows.M == 2 * TF + TG + rows.args.K + 56
    g = torch.Generator().manual_seed(1)
    kq = ((torch.rand(Wn, 6, 7, generator=g) * 2 - 1) * 0.5).to(dev)
    lam = (torch.rand(Wn, 6, rows.M, generator=g) * 3).to(dev)
    rho = torch.full((Wn, 6), 10.0, device=dev)
    seed = torch.arange(6, dtype=torch.int32, device=dev)
    _, _, _, c = ks.alm_values(rows, kq, lam, rho, seed, want_c=True)
    c0 = nlp._clip_big(nlp.constraint_stack(kq, prob, cfg, basis, with_grad=False)[0])
    phi = basis.phi(kq).abs()
    gmag = torch.matmul(phi, prob.grasp.g_coef.reshape(Wn, TG, -1).abs().transpose(1, 2)) \
        + prob.grasp.g_rad.reshape(Wn, 1, TG).abs() + 1.0
    sl = slice(2 * TF, 2 * TF + TG)
    assert ((c[..., sl] - c0[..., sl]).abs() <= 1e-5 * gmag).all()
    vt, vs, vg = ks.alm_maxima(rows, kq)
    pt, _, ps, pg = nlp.max_violations(kq, prob, cfg, basis)
    assert torch.equal(vs, ps)
    assert ((vg - pg).abs() <= 1e-5 * gmag.amax(-1)).all()
    k = kq[:, :4].contiguous()
    step, m0, feas, _, gk, Hk = ks.alm_newton(rows, k, lam[:, :4].contiguous(),
                                              rho[:, :4].contiguous(), want_system=True)
    g0, H0, cc = nlp.alm_newton_system(k, lam[:, :4], rho[:, :4], prob, cfg, basis)
    _, Jc = nlp.constraint_stack(k, prob, cfg, basis, with_grad=True)
    z0 = lam[:, :4] + rho[:, :4, None] * cc
    w = torch.where(z0 > 0, rho[:, :4, None], torch.zeros_like(cc))
    le = torch.where(z0 > 0, z0, torch.zeros_like(cc))
    Ja = Jc.abs()
    g_mag = nlp.plan_cost_grad(k, prob.traj, prob.q_des, prob.limits.continuous,
                               cfg).abs() + (Ja * le[..., None]).sum(-2)
    H_mag = torch.matmul(Ja.transpose(-1, -2) * w[..., None, :], Ja) \
        + nlp.plan_cost_hessian(prob.traj, cfg) + 1e-3
    assert ((gk - g0).abs() <= 1e-4 * (g_mag + 1e-6)).all()
    assert ((Hk - H0).abs() <= 1e-4 * (H_mag + 1e-6)).all()


@pytest.mark.cuda
def test_grasp_and_six_factor_steps_run_on_the_card():
    """A W = 3 grasp step of the dumbbell through make_batch_planner
    launches K10 and K16 once each and every feasible k passes the plain
    full-set check (v_grasp included); the tight contact parameters leave
    every world infeasible.  A UR5 (F = 6) step runs K7 / K8 on the card and
    gives the port's CPU verdicts on the same inputs; with the torque rows
    off (the JAX package's zoo test's setting) every world is feasible and
    each k passes the plain full-set check."""
    import dataclasses

    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.planner import make_batch_planner

    dev = _card()
    robot, cfg, basis, prob = _grasp_problem(dev)
    obs = prob.obs
    q0 = prob.traj.q0
    z = torch.zeros_like(q0)
    kernels.reset_counts()
    res = make_batch_planner(robot, cfg)(q0, z, z, prob.q_des, obs)
    n = kernels.counts()
    assert n["rnea_chain"] == 1 and n["grasp_rows"] == 1
    ok = res.feasible
    if bool(ok.any()):
        v = torch.stack(nlp.max_violations(res.k[:, None], prob, cfg, basis), -1)[:, 0]
        assert bool(nlp.viol_feasible(v, cfg)[ok].all())
    tight = dataclasses.replace(cfg, grasp_mu=1e-4, grasp_support_radius=1e-4)
    res_t = make_batch_planner(robot, tight)(q0, z, z, prob.q_des, obs)
    assert not bool(res_t.feasible.any()) and bool(torch.isnan(res_t.k).all())
    ur5 = zoo.ur5()
    from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
    from armour_tpu_torch.config import ArmourConfig

    ucfg = ArmourConfig.for_robot(ur5, num_time_steps=16, screen_k=512)
    uq = torch.full((3, 6), 0.1, device=dev)
    uobs = stack_obstacles([pad_obstacles(np.array([[2.5, 2.5, 2.5]]),
                                          np.stack([np.diag([0.05] * 3)]), ucfg.max_obstacles,
                                          ucfg.dtype)] * 3)
    uobs = type(uobs)(centers=uobs.centers.to(dev), generators=uobs.generators.to(dev),
                      mask=uobs.mask.to(dev))
    uz = torch.zeros_like(uq)
    kernels.reset_counts()
    ures = make_batch_planner(ur5, ucfg)(uq, uz, uz, uq + 0.02, uobs)
    assert kernels.counts()["alm_newton"] > 0 and bool(torch.isfinite(ures.cost).all())
    cpu_obs = type(uobs)(centers=uobs.centers.cpu(), generators=uobs.generators.cpu(),
                         mask=uobs.mask.cpu())
    ucpu = make_batch_planner(ur5, ucfg, device="cpu")(uq.cpu(), uz.cpu(), uz.cpu(),
                                                       uq.cpu() + 0.02, cpu_obs)
    assert torch.equal(ures.feasible.cpu(), ucpu.feasible)
    from armour_tpu_torch.collision import collision_constraints_plain
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis

    off = dataclasses.replace(ucfg, turn_off_input_constraints=True)
    kernels.reset_counts()
    roff = make_batch_planner(ur5, off)(uq, uz, uz, uq + 0.02, uobs)
    assert kernels.counts()["alm_newton"] > 0 and bool(roff.feasible.all())
    assert bool((roff.k.abs() <= 1.0 + 1e-6).all())
    b6 = make_basis(6, off.max_poly_degree)
    uprob = plan_problem(uq, uz, uz, uq + 0.02, uobs, ur5, off, b6)
    v = torch.stack(nlp.max_violations(roff.k[:, None], uprob, off, b6,
                                       collision_fn=collision_constraints_plain), -1)[:, 0]
    assert bool(nlp.viol_feasible(v, off).all())


@pytest.mark.parametrize("grasp", [False, True], ids=["no_grasp", "grasp"])
def test_alm_args_carry_the_grasp_group(monkeypatch, grasp):
    """alm_rows hands K7 / K8 the grasp rows in place (g_coef [W, 3 T, B],
    g_rad [W, 3 T]), TG = 3 T (0 without them), M = 2 T F + TG + K + 8 F,
    the stack's row count, and the grasp threshold rounded once to float32
    (a dumbbell plan on the CPU, the device check stubbed; the AlmArgs /
    K10Args field order is tests/test_torch_entry.py's)."""
    from armour_tpu_torch import nlp
    from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis

    robot = zoo.kinova_dumbbell()
    Tn = 4
    cfg = ArmourConfig.for_robot(robot, derive_ub=False, num_time_steps=Tn, max_obstacles=4,
                                 screen_k=64, grasp_constraints=grasp)
    basis = make_basis(7, 3)
    obs = stack_obstacles([pad_obstacles(np.array([[0.5, 0.4, 0.6]]),
                                         np.diag([0.05] * 3)[None], 4, torch.float32)] * 2)
    q0 = torch.full((2, 7), 0.1)
    prob = plan_problem(q0, torch.zeros_like(q0), torch.zeros_like(q0), q0 + 0.05, obs, robot,
                        cfg, basis)
    monkeypatch.setattr(ks, "_require", lambda *a, **k: None)
    rows = ks.alm_rows(prob, cfg, basis)
    a = rows.args
    TG = 3 * Tn if grasp else 0
    assert a.TG == TG and a.TF == Tn * 7 and a.TJ == Tn * 9
    assert rows.M == 2 * Tn * 7 + TG + a.K + 8 * 7 == nlp._stack_thresholds(prob, cfg).shape[0]
    assert a.thr_grasp == np.float32(cfg.grasp_violation_threshold)
    if grasp:
        assert a.g_coef == prob.grasp.g_coef.data_ptr()
        assert a.g_rad == prob.grasp.g_rad.data_ptr()
        assert tuple(rows.tensors["g_coef"].shape) == (2, TG, B)
    else:
        assert prob.grasp is None


# ---------------------------------------------------------------------------
# the smooth collision mode (cfg.smooth_obstacle_constraints): K4's screened
# rows and K7 / K8 take a log-sum-exp over the rows' candidates
# ---------------------------------------------------------------------------


def test_k4_refuses_the_smooth_mode_on_the_full_set():
    """The full-set check (a row index [R] shared by every world) stays
    exact: K4's launcher refuses smooth_tau > 0 there before it looks at a
    device."""
    from armour_tpu_torch.kernels import collision as kcol

    Wn, C, R, TJ = 2, 36, 12, 4
    A = torch.zeros(Wn, 3, C, R)
    d = torch.zeros(Wn, C, R)
    mask = torch.ones(Wn, R, dtype=torch.bool)
    p = torch.zeros(Wn, 1, 3, TJ)
    row = torch.arange(R, dtype=torch.int32) % TJ
    with pytest.raises(ValueError, match="smooth mode takes screened rows"):
        kcol.collision_rows(A, d, d, row, mask, p, smooth_tau=0.01)
    with pytest.raises(ValueError, match="CUDA"):
        kcol.collision_rows(A, d, d, row, mask, p)


@pytest.mark.parametrize("smooth", [False, True], ids=["off", "on"])
def test_alm_args_carry_the_smooth_mode(monkeypatch, smooth):
    """alm_rows sets AlmArgs.tau to cfg.smooth_tau and tau_log2c to
    collision.smooth_shift's float32 tau log(2C) in the smooth mode, both 0
    otherwise (whatever smooth_tau holds); a T = 4 Kinova plan on the CPU,
    the device check stubbed."""
    from armour_tpu_torch.collision import pad_obstacles, smooth_shift, stack_obstacles
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis

    cfg = ArmourConfig(dtype=torch.float32, num_time_steps=4, max_obstacles=4, screen_k=64,
                       smooth_obstacle_constraints=smooth, smooth_tau=0.02)
    basis = make_basis(7, 3)
    obs = stack_obstacles([pad_obstacles(np.array([[0.5, 0.4, 0.6]]),
                                         np.diag([0.05] * 3)[None], 4, torch.float32)] * 2)
    q0 = torch.full((2, 7), 0.1)
    prob = plan_problem(q0, torch.zeros_like(q0), torch.zeros_like(q0), q0 + 0.05, obs,
                        kinova_gen3(), cfg, basis)
    monkeypatch.setattr(ks, "_require", lambda *a, **k: None)
    rows = ks.alm_rows(prob, cfg, basis)
    a = rows.args
    if smooth:
        assert a.tau == np.float32(0.02)
        assert a.tau_log2c == float(smooth_shift(0.02, a.C, torch.float32))
        assert abs(a.tau_log2c - 0.02 * np.log(2 * a.C)) <= 1e-8
    else:
        assert a.tau == 0.0 and a.tau_log2c == 0.0
    assert ks._smooth_key(rows) == (("smooth", 0.02) if smooth else ())


def _smooth_problem(dev, grasp: bool):
    """_small_problem / _grasp_problem with the smooth mode on (the plan's
    sets and rows do not depend on it)."""
    robot, cfg, basis, prob = (_grasp_problem if grasp else _small_problem)(dev)
    return robot, dataclasses.replace(cfg, smooth_obstacle_constraints=True), basis, prob


@pytest.mark.cuda
def test_k4_smooth_rows_match_plain_on_the_card():
    """K4's smooth screened rows against screened_rows_plain: g within 1e-5,
    dg/dk within 1e-5 of sum_a |dp_a| on every row (no argmax to flip),
    the same bits on a second call; the full set is refused."""
    from armour_tpu_torch import collision as col
    from armour_tpu_torch.kernels import collision as kcol

    dev = _card()
    _, cfg, basis, prob = _smooth_problem(dev, False)
    sc = prob.screened
    g = torch.Generator().manual_seed(3)
    k = ((torch.rand(sc.A.shape[0], 4, 7, generator=g) * 2 - 1) * 0.8).to(dev)
    p_all = col.eval_link_polys(prob.frs, basis.phi(k)).contiguous()
    dp_all = col.eval_link_poly_grads(prob.frs, basis.dphi(k)).contiguous()
    tau = cfg.smooth_tau
    got = col.screened_rows(sc, p_all, dp_all, smooth_tau=tau)
    again = col.screened_rows(sc, p_all, dp_all, smooth_tau=tau)
    want = col.screened_rows_plain(sc, p_all, dp_all, smooth_tau=tau)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert float((got[0] - want[0]).abs().max()) <= 1e-5
    mag = col._rows_at(dp_all, sc.row).abs().sum(2).transpose(-1, -2)
    assert bool(((got[1] - want[1]).abs() <= 1e-5 * (mag + 1e-6)).all())
    hard = col.screened_rows(sc, p_all, dp_all)
    real = sc.mask[:, None].expand_as(hard[0])
    assert bool((got[0][real] >= hard[0][real] - 1e-6).all())
    with pytest.raises(ValueError, match="screened rows"):
        kcol.collision_rows(sc.A, sc.d, sc.delta, sc.row[0].contiguous(), sc.mask, p_all,
                            smooth_tau=tau)


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [False, True], ids=["hard", "smooth"])
def test_k4_rows_at_non_finite_points_match_plain_on_the_card(smooth):
    """K4's screened rows where the query point is NaN (a line-search point
    after a failed Cholesky): NaN on exactly the real rows the plain version
    gives NaN, in both modes, also on rows whose first candidate is
    degenerate (the hard mode's max must not skip the NaN ones after it);
    the finite queries beside them within 1e-5."""
    from armour_tpu_torch import collision as col

    dev = _card()
    _, cfg, basis, prob = _smooth_problem(dev, False)
    sc = prob.screened
    # a degenerate first normal on every eighth row
    A = sc.A.clone()
    A[:, :, 0, ::8] = 0.0
    sc = col.ScreenedCollision(A=A, d=sc.d, delta=sc.delta, row=sc.row, mask=sc.mask)
    g = torch.Generator().manual_seed(5)
    k = ((torch.rand(sc.A.shape[0], 3, 7, generator=g) * 2 - 1) * 0.8).to(dev)
    k[:, 1] = float("nan")
    p_all = col.eval_link_polys(prob.frs, basis.phi(k)).contiguous()
    dp_all = col.eval_link_poly_grads(prob.frs, basis.dphi(k)).contiguous()
    tau = cfg.smooth_tau if smooth else 0.0
    got = col.screened_rows(sc, p_all, dp_all, smooth_tau=tau)
    want = col.screened_rows_plain(sc, p_all, dp_all, smooth_tau=tau)
    real = sc.mask[:, None].expand_as(got[0])
    assert bool(torch.isnan(want[0][:, 1][real[:, 1]]).all())
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    fin = ~torch.isnan(want[0])
    assert float((got[0] - want[0])[fin].abs().max()) <= 1e-5
    assert bool(torch.isnan(got[1][:, 1][real[:, 1]]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("grasp", [False, True], ids=["bernstein", "grasp"])
def test_k7_k8_smooth_match_plain_on_the_card(grasp):
    """K7 / K8 in the smooth mode against alm_newton_plain / alm_values_plain
    (a Bernstein plan and a dumbbell grasp plan, T = 16): K8's merit within
    1e-4 |merit| and rows within 1e-5 of their terms, K7's m0 within 1e-4
    |m0|, g and H within 1e-4 of their summed terms; the same bits on a
    second call."""
    from armour_tpu_torch import nlp

    dev = _card()
    _, cfg, basis, prob = _smooth_problem(dev, grasp)
    rows = ks.alm_rows(prob, cfg, basis)
    assert rows.args.tau > 0
    Wn, S, A = prob.q_des.shape[0], 4, 3
    g = torch.Generator().manual_seed(2)
    kq = ((torch.rand(Wn, S * A, 7, generator=g) * 2 - 1) * 0.5).to(dev)
    lam = (torch.rand(Wn, S, rows.M, generator=g) * 3).to(dev)
    rho = torch.full((Wn, S), 10.0, device=dev)
    seed = torch.arange(S, dtype=torch.int32).repeat_interleave(A).to(dev)
    m, f, _, c = ks.alm_values(rows, kq, lam, rho, seed, True)
    m2, f2, _, c2 = ks.alm_values(rows, kq, lam, rho, seed, True)
    m0, f0, _, c0 = nlp.alm_values_plain(kq, lam, rho, seed, prob, cfg, basis, True)
    assert torch.equal(m, m2) and torch.equal(c, c2) and torch.equal(f, f2)
    assert bool(((m - m0).abs() <= 1e-4 * (m0.abs() + 1e-6)).all())
    phi = basis.phi(kq).abs()
    mag = 1.0 + c0.abs()
    t = (torch.matmul(phi, rows.tensors["u_coef"].abs().transpose(1, 2))
         + rows.tensors["u_hi"].abs()[:, None])
    mag[..., :2 * rows.args.TF] += torch.cat([t, t], dim=-1)
    if grasp:
        TF, TG = rows.args.TF, rows.args.TG
        mag[..., 2 * TF:2 * TF + TG] += (torch.matmul(phi, rows.tensors["g_coef"].abs()
                                                      .transpose(1, 2))
                                         + rows.tensors["g_rad"].abs()[:, None])
    assert bool(((c - c0).abs() <= 1e-5 * mag).all())
    near = ((c0 - nlp._stack_thresholds(prob, cfg)).abs() <= 1e-5 * mag).any(-1)
    assert bool(((f == f0) | near).all())
    k = kq[:, :S].contiguous()
    got = ks.alm_newton(rows, k, lam, rho, want_system=True)
    again = ks.alm_newton(rows, k, lam, rho, want_system=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _, m0k, _, _, gk, Hk = got
    _, m00, _, _ = nlp.alm_newton_plain(k, lam, rho, prob, cfg, basis)
    g0, H0, cc = nlp.alm_newton_system(k, lam, rho, prob, cfg, basis)
    _, Jc = nlp.constraint_stack(k, prob, cfg, basis, with_grad=True)
    z0 = lam + rho[..., None] * cc
    w = torch.where(z0 > 0, rho[..., None], torch.zeros_like(cc))
    le = torch.where(z0 > 0, z0, torch.zeros_like(cc))
    Ja = Jc.abs()
    g_mag = nlp.plan_cost_grad(k, prob.traj, prob.q_des, prob.limits.continuous,
                               cfg).abs() + (Ja * le[..., None]).sum(-2)
    H_mag = torch.matmul(Ja.transpose(-1, -2) * w[..., None, :], Ja) \
        + nlp.plan_cost_hessian(prob.traj, cfg) + 1e-3
    assert bool(((m0k - m00).abs() <= 1e-4 * (m00.abs() + 1e-6)).all())
    assert bool(((gk - g0).abs() <= 1e-4 * (g_mag + 1e-6)).all())
    assert bool(((Hk - H0).abs() <= 1e-4 * (H_mag + 1e-6)).all())


# ---------------------------------------------------------------------------
# K11 / K12's writer (csrc/jrs_tail.cuh:jrs_write_slabs): flat 16-byte stores
# ---------------------------------------------------------------------------


# A pure-Python copy of the writer's index arithmetic: the ranges, stores,
# walks and values of csrc/jrs_tail.cuh, which the tests below hold against
# the row-by-row writer K11 / K12 had before.
KINDS = ("R_coef", "R_egen", "zero", "v_coef", "v_egen")   # JRS_R_COEF .. JRS_ZERO, in order


def jrs_segments(J: int, F: int, B: int, E: int, WT: int, wt0: int, n: int) -> list:
    """The flat ranges a block writes for its slabs wt0 .. wt0 + n - 1
    (csrc/jrs_tail.cuh:jrs_write_slabs), in order: (output, first entry,
    entries, slab length, row length, kind, velocity PZ p).  Outputs: R_coef
    [W T, J+1, 3, 3, B], R_egen [.., E], R_rad [W T, J+1, 3, 3], v_coef
    [3, W T, F, B], v_egen [.., E], v_rad [3, W T, F], each flat."""
    J9 = (J + 1) * 9
    out = [("R_coef", wt0 * J9 * B, n * J9 * B, J9 * B, B, "R_coef", 0),
           ("R_egen", wt0 * J9 * E, n * J9 * E, J9 * E, E, "R_egen", 0),
           ("R_rad", wt0 * J9, n * J9, J9, 1, "zero", 0)]
    for p in range(3):
        slab = p * WT + wt0
        out += [("v_coef", slab * F * B, n * F * B, F * B, B, "v_coef", p),
                ("v_egen", slab * F * E, n * F * E, F * E, E, "v_egen", p),
                ("v_rad", slab * F, n * F, F, 1, "zero", p)]
    return out


def jrs_stores(first: int, length: int, align: int = 0) -> tuple:
    """How a block stores the range [first, first + length) of an output
    whose entry 0 lies `align` floats past a 16-byte boundary
    (jrs_write_segment): (head, float4 starts, tail) as flat entries, the
    head and tail single floats."""
    head = min(length, (4 - (align + first) % 4) % 4)
    n4 = (length - head) // 4
    body = [first + head + 4 * i for i in range(n4)]
    return (list(range(first, first + head)), body,
            list(range(first + head + 4 * n4, first + length)))


def jrs_window(kind: str, p: int, F: int, lin, e_cos: int, e_sin: int, e_vel) -> tuple:
    """The columns [lo, hi] of a row of a segment of `kind` that can hold a
    non-zero entry (csrc/jrs_tail.cuh:jrs_window)."""
    top = max([0] + [int(x) for x in lin[:F]])
    if kind in ("R_coef", "v_coef"):
        return 0, top
    if kind == "R_egen":
        return min(e_cos, e_sin), max(e_cos, e_sin) + F - 1
    return e_vel[p], e_vel[p] + F - 1


def jrs_walk(head: int, n4: int, slab_len: int, L: int, threads: int = kjrs.THREADS) -> list:
    """Each thread's float4s of a segment as jrs_write_segment steps them:
    [(float4 index, slab, row, column of its first entry)] per thread, the
    first by division, the rest by adding the block's stride with carries."""
    rows, stride = slab_len // L, 4 * threads
    dq, dc = divmod(stride, L)
    dg, dr = divmod(dq, rows)
    out = []
    for t in range(min(threads, n4)):
        g, y = divmod(head + 4 * t, slab_len)
        r, c = divmod(y, L)
        walk = []
        for i in range(t, n4, threads):
            walk.append((i, g, r, c))
            c += dc
            if c >= L:
                c, r = c - L, r + 1
            r += dr
            if r >= rows:
                r, g = r - rows, g + 1
            g += dg
        out.append(walk)
    return out


def jrs_entries(kind: str, p: int, x, slab_len: int, L: int, J: int, F: int, lin, e_cos: int,
                e_sin: int, e_vel) -> tuple:
    """What entries x (numpy, offsets in a segment) hold
    (csrc/jrs_tail.cuh:jrs_value): (slab g, row r, source), source -1 a
    zero, else R's matrix m of joint j at element e as j * 36 + m * 9 + e
    (R_coef, R_egen), or velocity PZ p's part x of factor f as 1000 + p * 24
    + x * 8 + f (v_coef, v_egen)."""
    x = np.asarray(x)
    if kind == "zero":
        return x * 0, x * 0, np.full(x.shape, -1)
    g, y = np.divmod(x, slab_len)
    r, c = np.divmod(y, L)
    src = np.full(x.shape, -1)
    lin = np.asarray(lin)
    if kind in ("R_coef", "R_egen"):
        j, e = np.divmod(r, 9)
        act = j < F
        jl = np.where(act, j, 0)
        if kind == "R_coef":
            src = np.where(c == 0, j * 36 + e, np.where(act & (c == lin[jl]), j * 36 + 9 + e, -1))
        else:
            src = np.where(act & (c == e_cos + j), j * 36 + 18 + e,
                           np.where(act & (c == e_sin + j), j * 36 + 27 + e, -1))
    elif kind == "v_coef":
        src = np.where(c == 0, 1000 + p * 24 + r, np.where(c == lin[r], 1000 + p * 24 + 8 + r, -1))
    else:
        src = np.where(c == e_vel[p] + r, 1000 + p * 24 + 16 + r, -1)
    return g, r, src


def _old_slab_writer(J_, F_, B_, E_, WT, lin, e_cos, e_sin, e_vel):
    """What the row-by-row writer of K11 / K12 before their redesign put in
    every entry, per output (flat, C order): (slab, source) as
    jrs_entries numbers the sources (-1 a zero)."""
    J1 = J_ + 1
    out = {n: np.full(shape, -1) for n, shape in (
        ("R_coef", (WT, J1 * 9, B_)), ("R_egen", (WT, J1 * 9, E_)), ("R_rad", (WT, J1 * 9)),
        ("v_coef", (3, WT, F_, B_)), ("v_egen", (3, WT, F_, E_)), ("v_rad", (3, WT, F_)))}
    slab = {n: np.zeros(x.shape, dtype=int) for n, x in out.items()}
    for wt in range(WT):
        for r in range(J1 * 9):
            j, e = divmod(r, 9)
            lj = lin[j] if j < F_ else -1
            jc, js = (e_cos + j, e_sin + j) if j < F_ else (-1, -1)
            row = out["R_coef"][wt, r]
            row[0] = j * 36 + e
            if lj >= 0:
                row[lj] = j * 36 + 9 + e
            row = out["R_egen"][wt, r]
            if jc >= 0:
                row[jc], row[js] = j * 36 + 18 + e, j * 36 + 27 + e
            for n in ("R_coef", "R_egen", "R_rad"):
                slab[n][wt, r] = wt
        for p in range(3):
            for f in range(F_):
                out["v_coef"][p, wt, f, 0] = 1000 + p * 24 + f
                out["v_coef"][p, wt, f, lin[f]] = 1000 + p * 24 + 8 + f
                out["v_egen"][p, wt, f, e_vel[p] + f] = 1000 + p * 24 + 16 + f
                for n in ("v_coef", "v_egen", "v_rad"):
                    slab[n][p, wt, f] = wt
    return {n: (slab[n].ravel(), out[n].ravel()) for n in out}


@pytest.mark.parametrize("J_, F_", [(6, 6), (7, 6), (7, 7), (9, 7), (8, 8), (9, 8)])
@pytest.mark.parametrize("WT, geo", [(15, None), (23, (3, 2)), (8192, None)],
                         ids=["ragged", "grid_stride", "flagship_grid"])
def test_jrs_writer_covers_every_entry_once(J_, F_, WT, geo):
    """K11 / K12's writer: each block's slabs, its segments
    (jrs_segments) and their stores (jrs_stores: single floats to
    the first 16-byte boundary, float4s, single floats after) cover every
    entry of R_coef, R_egen, R_rad, v_coef, v_egen and v_rad exactly once,
    every float4 on a 16-byte boundary, and each entry holds what the
    row-by-row writer put there (its slab, its source or a zero); with the
    outputs' first entries 0-3 floats past a boundary, for J + 1 <= 10,
    F = 6, 7, 8 and the ragged rows (B = 165, E = 33, 38, 43; v_egen's F E
    floats a slab).  Each thread's walk over a range (jrs_walk: its
    first float4 by division, the rest by the block's stride with carries)
    gives each float4's slab, row and column, and a float4 in one row
    outside the row's window of non-zero columns (jrs_window) holds
    zeros only."""
    from armour_tpu_torch.pz.basis import error_layout, make_basis

    basis, lay = make_basis(F_, 3), error_layout(F_)
    B_, E_ = basis.size, lay["size"]
    lin = [int(x) for x in basis.lin_idx[:F_]]
    e_cos, e_sin = lay["cosqe"].start, lay["sinqe"].start
    e_vel = (lay["qde"].start, lay["qdae"].start, lay["qddae"].start)
    G, blocks = kjrs.jrs_geometry(WT) if geo is None else geo
    assert 1 <= G <= kjrs.MAX_G and blocks * G >= min(WT, blocks * G)
    if WT == 8192:
        # the flagship: every slab's block resident at once, 16 slabs a block
        assert (G, blocks) == (16, 512) and blocks <= SMS * kjrs.BLOCKS_PER_SM
        return
    want = _old_slab_writer(J_, F_, B_, E_, WT, lin, e_cos, e_sin, e_vel)
    for align in range(4):
        count = {n: np.zeros(len(w[0]), dtype=int) for n, w in want.items()}
        slab = {n: np.full(len(w[0]), -1) for n, w in want.items()}
        src = {n: np.full(len(w[0]), -2) for n, w in want.items()}
        for b in range(blocks):
            for wt0 in range(b * G, WT, blocks * G):
                n = min(G, WT - wt0)
                for name, first, length, slab_len, L, kind, p in jrs_segments(
                        J_, F_, B_, E_, WT, wt0, n):
                    head, body, tail = jrs_stores(first, length, align)
                    assert all((align + x) % 4 == 0 for x in body)
                    body = np.asarray(body, dtype=int)
                    xs = np.concatenate([np.asarray(head, dtype=int),
                                         (body[:, None] + np.arange(4)).ravel(),
                                         np.asarray(tail, dtype=int)])
                    assert xs.size == length
                    g, _, s = jrs_entries(kind, p, xs - first, slab_len, L, J_, F_, lin,
                                               e_cos, e_sin, e_vel)
                    np.add.at(count[name], xs, 1)
                    slab[name][xs] = wt0 + g if kind != "zero" else want[name][0][xs]
                    src[name][xs] = s
        for name, (w_slab, w_src) in want.items():
            assert (count[name] == 1).all(), (name, align)
            np.testing.assert_array_equal(slab[name], w_slab, err_msg=name)
            np.testing.assert_array_equal(src[name], w_src, err_msg=name)
    # each thread's stepped (slab, row, column) is its float4's by division,
    # and a float4 in one row outside the row's window holds zeros only
    for name, first, length, slab_len, L, kind, p in jrs_segments(
            J_, F_, B_, E_, WT, 0, min(G, WT)):
        if kind == "zero":
            continue
        lo, hi = jrs_window(kind, p, F_, lin, e_cos, e_sin, e_vel)
        for align in range(4):
            head, body, _ = jrs_stores(first, length, align)
            i, g, r, c = np.array([st for walk in jrs_walk(len(head), len(body), slab_len, L)
                                   for st in walk]).T
            x = len(head) + 4 * i
            np.testing.assert_array_equal(np.stack([g, r, c]), np.stack(
                [x // slab_len, x % slab_len // L, x % L]), err_msg=name)
            zero = ((c > hi) | (c + 3 < lo)) & (c + 3 < L)
            xs = (x[zero][:, None] + np.arange(4)).ravel()
            _, _, s = jrs_entries(kind, p, xs, slab_len, L, J_, F_, lin, e_cos, e_sin, e_vel)
            assert (s == -1).all(), name


def test_jrs_writer_constants_match_the_sources():
    """JRS_MAX_G, the kinds' order, the threads and the register caps of
    K11 / K12, and their launchers' (G, blocks) parameters."""

    tail = _source("jrs_tail.cuh")
    assert _define(tail, "JRS_MAX_G") == kjrs.MAX_G
    kinds = ("JRS_R_COEF", "JRS_R_EGEN", "JRS_ZERO", "JRS_V_COEF", "JRS_V_EGEN")
    names = {"JRS_R_COEF": "R_coef", "JRS_R_EGEN": "R_egen", "JRS_V_COEF": "v_coef",
             "JRS_V_EGEN": "v_egen", "JRS_ZERO": "zero"}
    assert sorted(KINDS) == sorted(names[k] for k in kinds)
    for src, k in (("jrs_armtd.cu", "K11"), ("jrs_bernstein.cu", "K12")):
        text = _source(src)
        assert _define(text, f"{k}_THREADS") == kjrs.THREADS
        assert _define(text, f"{k}_BLOCKS_PER_SM") == kjrs.BLOCKS_PER_SM
        assert re.search(r'extern "C" int %s_launch\(const %sArgs\* args, int G, int blocks, '
                         r'void\* stream\)' % (k.lower(), k), text), src
        assert "jrs_write_slabs(o, wt0, n, sl);" in text and "sl.lin[threadIdx.x] = a.lin" in text
    # G (slabs) x (J + 1) joints: one pass of a block's threads forms them
    assert kjrs.MAX_G * 10 <= kjrs.THREADS
    # the slabs' shared memory: four blocks an SM within the H100's 228 KB
    slabs = 4 * kjrs.MAX_G * (10 * 4 * 9 + 3 * 3 * 8) + 4 * 8
    assert kjrs.BLOCKS_PER_SM * slabs <= 233472 and slabs <= 48 * 1024
