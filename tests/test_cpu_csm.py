"""CPU CSM twin (baseline/cpu_csm.py) parity with the device engine.

The CPU twin is bench.py's scan-match baseline; it must produce the same
scores and transforms so the reported speedup compares identical work."""

import numpy as np
import jax.numpy as jnp
import pytest

from nautilus_tpu.baseline.cpu_csm import csm_match_cpu, csm_match_batch_cpu
from nautilus_tpu.ingest.synthetic import make_world, raycast, scan_to_points
from nautilus_tpu.kernels.csm import CSMParams, csm_match, csm_match_batch


def _pad(c, p=1024):
    out = np.zeros((p, 2), np.float32)
    m = np.zeros(p, bool)
    out[:len(c)] = c
    m[:len(c)] = True
    return jnp.asarray(out), jnp.asarray(m)


def _scan_at(world, pose):
    return scan_to_points(raycast(world, pose, 720, max_range=10),
                          max_range=10).astype(np.float32)


@pytest.mark.parametrize("true_t", [
    np.array([0.8, -0.5, 0.25]),
    np.array([-0.4, 1.1, -0.6]),
])
def test_cpu_matches_tpu(true_t):
    world = make_world("office")
    pose_b = np.array([1.0, 2.0, 0.3])
    c, s = np.cos(pose_b[2]), np.sin(pose_b[2])
    Rb = np.array([[c, -s], [s, c]])
    ta = pose_b[:2] + Rb @ true_t[:2]
    pose_a = np.array([ta[0], ta[1], pose_b[2] + true_t[2]])
    cl_b = _scan_at(world, pose_b)
    cl_a = _scan_at(world, pose_a)
    a, ma = _pad(cl_a)
    b, mb = _pad(cl_b)
    params = CSMParams(scan_range=10.0, high_res=0.05)
    s_t, tr_t = csm_match(a, ma, b, mb, params)
    s_c, tr_c = csm_match_cpu(cl_a, cl_b, params)
    assert abs(s_c - float(s_t)) < 2e-3
    np.testing.assert_allclose(tr_c, np.asarray(tr_t), atol=2e-2)


def test_cpu_batch_matches_tpu_batch():
    world = make_world("office")
    poses = [np.array([1.0, 2.0, 0.3]), np.array([1.4, 2.2, 0.5]),
             np.array([0.6, 1.5, -0.2])]
    clouds = [_scan_at(world, p) for p in poses]
    padded = [_pad(c) for c in clouds]
    A = jnp.stack([padded[i][0] for i in (1, 2)])
    MA = jnp.stack([padded[i][1] for i in (1, 2)])
    B = jnp.stack([padded[0][0]] * 2)
    MB = jnp.stack([padded[0][1]] * 2)
    params = CSMParams(scan_range=10.0, high_res=0.05)
    s_t, tr_t = csm_match_batch(A, MA, B, MB, params)
    s_c, tr_c = csm_match_batch_cpu(
        [clouds[1], clouds[2]],
        [np.ones(len(clouds[1]), bool), np.ones(len(clouds[2]), bool)],
        [clouds[0], clouds[0]],
        [np.ones(len(clouds[0]), bool), np.ones(len(clouds[0]), bool)],
        params)
    np.testing.assert_allclose(s_c, np.asarray(s_t), atol=2e-3)
    np.testing.assert_allclose(tr_c, np.asarray(tr_t), atol=2e-2)


def test_rotation_center_cpu():
    """The CPU twin honors the seeded rotation window like the device engine."""
    world = make_world("office")
    pose_b = np.array([1.0, 2.0, 0.3])
    true_t = np.array([0.3, -0.2, np.pi * 0.95])
    c, s = np.cos(pose_b[2]), np.sin(pose_b[2])
    Rb = np.array([[c, -s], [s, c]])
    ta = pose_b[:2] + Rb @ true_t[:2]
    pose_a = np.array([ta[0], ta[1], pose_b[2] + true_t[2]])
    cl_b = _scan_at(world, pose_b)
    cl_a = _scan_at(world, pose_a)
    params = CSMParams(scan_range=10.0, high_res=0.05)
    score, tr = csm_match_cpu(cl_a, cl_b, params,
                              rotation_center=float(true_t[2]) + 0.1)
    d_th = np.arctan2(np.sin(tr[2] - true_t[2]), np.cos(tr[2] - true_t[2]))
    assert abs(d_th) < 0.06
    assert np.linalg.norm(tr[:2] - true_t[:2]) < 0.15


def test_coarse_f32_escape_hatch_parity():
    """CSMParams(coarse_f32=True) keeps the correlation operands f32
    (bf16 raster counts are exact only to 256/cell); on a
    normal scan both precisions must land on the same transform."""
    world = make_world("office")
    pose_b = np.array([1.0, 2.0, 0.3])
    pose_a = np.array([1.6, 1.7, 0.55])
    a, ma = _pad(_scan_at(world, pose_a))
    b, mb = _pad(_scan_at(world, pose_b))
    lo = CSMParams(scan_range=10.0, high_res=0.05)
    hi = CSMParams(scan_range=10.0, high_res=0.05, coarse_f32=True)
    s_lo, tr_lo = csm_match(a, ma, b, mb, lo)
    s_hi, tr_hi = csm_match(a, ma, b, mb, hi)
    np.testing.assert_allclose(np.asarray(tr_lo), np.asarray(tr_hi),
                               atol=2e-2)
    assert abs(float(s_lo) - float(s_hi)) < 2e-3


def test_coarse_f32_stage_major_engine():
    from nautilus_tpu.kernels.csm import csm_match_pairs
    world = make_world("office")
    poses = [np.array([1.0, 2.0, 0.3]), np.array([1.4, 2.2, 0.5]),
             np.array([0.6, 1.5, -0.2])]
    clouds = [_scan_at(world, p) for p in poses]
    pts = jnp.stack([_pad(c)[0] for c in clouds])
    msk = jnp.stack([_pad(c)[1] for c in clouds])
    ss, tt = np.array([1, 2]), np.array([0, 0])
    lo = CSMParams(scan_range=10.0, high_res=0.05)
    hi = CSMParams(scan_range=10.0, high_res=0.05, coarse_f32=True)
    s_lo, tr_lo = csm_match_pairs(pts, msk, ss, tt, lo, engine="stage")
    s_hi, tr_hi = csm_match_pairs(pts, msk, ss, tt, hi, engine="stage")
    np.testing.assert_allclose(np.asarray(tr_lo), np.asarray(tr_hi),
                               atol=2e-2)
