"""Batched residual factors + Gauss-Newton normal-equation assembly.

This replaces the reference's per-block Ceres autodiff cost functors
(reference src/optimization/slam_residuals.h:17-216) with fixed-shape
batched residual functions differentiated by jax.jacfwd, and replaces
Ceres' sparse problem assembly with direct scatter-add of per-factor
6x6 blocks into dense normal equations (H = J^T J, g = J^T r).

Residual semantics match the reference exactly:

- OdometryResidual (slam_residuals.h:17-61): world-frame translation delta
  plus wrapped rotation delta, scaled by translation/rotation weights.
- LIDARNormalResidual (slam_residuals.h:64-121): two signed residuals per
  correspondence — the source point transformed into the target frame,
  projected onto the *target* normal and onto the *source* normal.  Note the
  source normal is used unrotated (in its own scan frame) against a
  target-frame difference vector; that is the reference's behavior and is
  preserved for cost parity.
- LIDARPointResidual (slam_residuals.h:123-177): plain 2D point difference
  in the target frame.
- PointToLineResidual (slam_residuals.h:179-216): distance of each
  pose-transformed point to a human-drawn line segment that is itself
  transformed by a free SE(2) "line pose" parameter block.

The dof vector is x: [M, 3] with M = num_nodes + num_hitl_line_poses; the
HITL free line poses (reference data_structures.h:46) live at indices >=
num_nodes.

Parallelism: every per-correspondence OpenMP loop in the reference
(slam_residuals.h:75,134,190) is a vmapped batch dimension here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from nautilus_tpu.core import geometry as geo

HIGHEST = jax.lax.Precision.HIGHEST


class OdomFactors(NamedTuple):
    """[F] odometry-style factors (reference slam_types.h:102-120).

    Per-factor weights wt/wr carry the config's translation/rotation
    weights (reference AddOdomFactors solver.cc:346-348) and allow
    loop-closure factors with lc_translation_weight/lc_rotation_weight
    (reference solver.h:35-36) to share this factor type.
    """

    i: jnp.ndarray        # [F] int32
    j: jnp.ndarray        # [F] int32
    trans: jnp.ndarray    # [F, 2] world-frame translation i -> j
    rot: jnp.ndarray      # [F]
    mask: jnp.ndarray     # [F] bool
    wt: jnp.ndarray       # [F] translation weight
    wr: jnp.ndarray       # [F] rotation weight

    @property
    def count(self):
        return self.i.shape[0]


def make_odom_factors(i, j, trans, rot, tw=1.0, rw=1.0, dtype=jnp.float32):
    f = len(i)
    return OdomFactors(
        i=jnp.asarray(i, jnp.int32), j=jnp.asarray(j, jnp.int32),
        trans=jnp.asarray(trans, dtype), rot=jnp.asarray(rot, dtype),
        mask=jnp.ones((f,), bool),
        wt=jnp.full((f,), tw, dtype), wr=jnp.full((f,), rw, dtype))


class Correspondences(NamedTuple):
    """[Q, S] point matches between pose pairs (one row per pair).

    Replaces reference PointCorrespondences (data_structures.h:62-100).
    Source points/normals are in the source scan frame; target points/normals
    in the target scan frame; ``mask`` covers both slot validity and pair
    validity (pair outside current window => all slots masked).
    """

    src: jnp.ndarray       # [Q] int32 source node index
    tgt: jnp.ndarray       # [Q] int32 target node index
    src_pts: jnp.ndarray   # [Q, S, 2]
    tgt_pts: jnp.ndarray   # [Q, S, 2]
    src_nrm: jnp.ndarray   # [Q, S, 2]
    tgt_nrm: jnp.ndarray   # [Q, S, 2]
    mask: jnp.ndarray      # [Q, S] bool


class HitlFactors(NamedTuple):
    """[R, K] HITL colinearity participations (one row per constrained pose).

    Each row ties one node's on-line points to one free line pose.  Matching
    the reference quirk, the *line_a* segment endpoints are used for both
    line-a and line-b pose sets (solver.cc:521,528) — the colinearity merge.
    """

    node: jnp.ndarray        # [R] int32 node index
    line: jnp.ndarray        # [R] int32 dof index of the line pose (>= N)
    points: jnp.ndarray      # [R, K, 2] points in the node's scan frame
    mask: jnp.ndarray        # [R, K] bool
    seg_start: jnp.ndarray   # [R, 2] line endpoints in the line pose's frame
    seg_end: jnp.ndarray     # [R, 2]


class FactorGraph(NamedTuple):
    odom: OdomFactors
    planar: Correspondences   # -> normal residuals
    edge: Correspondences     # -> point residuals
    hitl: HitlFactors


def empty_hitl(dtype=jnp.float32) -> HitlFactors:
    z = functools.partial(jnp.zeros, dtype=dtype)
    return HitlFactors(
        node=jnp.zeros((0,), jnp.int32), line=jnp.zeros((0,), jnp.int32),
        points=z((0, 1, 2)), mask=jnp.zeros((0, 1), bool),
        seg_start=z((0, 2)), seg_end=z((0, 2)))


# ---------------------------------------------------------------------------
# Per-item residual functions.  Each takes the two involved pose vectors and
# the per-item data, returns a masked residual vector.  Masks are constants
# w.r.t. poses, so jacfwd yields correctly masked Jacobians.
# ---------------------------------------------------------------------------

def odom_residual(pose_i, pose_j, trans, rot, mask, tw, rw):
    """3 residuals (reference slam_residuals.h:19-40)."""
    et = pose_i[:2] + trans - pose_j[:2]
    dr = pose_i[2] + rot - pose_j[2]
    er = jnp.arctan2(jnp.sin(dr), jnp.cos(dr))
    m = mask.astype(pose_i.dtype)
    return jnp.stack([tw * et[0], tw * et[1], rw * er]) * m


def normal_residual(pose_s, pose_t, src_pts, tgt_pts, src_nrm, tgt_nrm, mask):
    """[S, 2] signed point-to-plane residuals (slam_residuals.h:66-88)."""
    p_t = geo.relative_pose_transform_points(pose_s, pose_t, src_pts)
    diff = p_t - tgt_pts                     # [S, 2] in target frame
    r_tgt = jnp.sum(tgt_nrm * diff, axis=-1)
    r_src = jnp.sum(src_nrm * (-diff), axis=-1)
    m = mask.astype(pose_s.dtype)
    return jnp.stack([r_tgt * m, r_src * m], axis=-1)


def point_residual(pose_s, pose_t, src_pts, tgt_pts, mask):
    """[S, 2] point-difference residuals (slam_residuals.h:125-144)."""
    p_t = geo.relative_pose_transform_points(pose_s, pose_t, src_pts)
    diff = tgt_pts - p_t
    return diff * mask[..., None].astype(pose_s.dtype)


def hitl_residual(pose_node, pose_line, points, mask, seg_start, seg_end):
    """[K] point-to-segment distances (slam_residuals.h:181-199)."""
    world = geo.pose_transform_points(pose_node, points)
    a = geo.pose_transform_points(pose_line, seg_start)
    b = geo.pose_transform_points(pose_line, seg_end)
    d = geo.distance_to_line_segment(world, a, b)
    return d * mask.astype(pose_node.dtype)


# ---------------------------------------------------------------------------
# Cost evaluation
# ---------------------------------------------------------------------------

def total_cost(x, graph: FactorGraph):
    """Ceres-convention total cost: 0.5 * sum of squared residuals."""
    acc = jnp.zeros((), x.dtype)
    od = graph.odom
    if od.count:
        r = jax.vmap(odom_residual)(
            x[od.i], x[od.j], od.trans, od.rot, od.mask, od.wt, od.wr)
        acc = acc + jnp.sum(r * r)
    for corr, fn in ((graph.planar, normal_residual),
                     (graph.edge, point_residual)):
        if corr.src.shape[0]:
            if fn is normal_residual:
                r = jax.vmap(fn)(x[corr.src], x[corr.tgt], corr.src_pts,
                                 corr.tgt_pts, corr.src_nrm, corr.tgt_nrm,
                                 corr.mask)
            else:
                r = jax.vmap(fn)(x[corr.src], x[corr.tgt], corr.src_pts,
                                 corr.tgt_pts, corr.mask)
            acc = acc + jnp.sum(r * r)
    h = graph.hitl
    if h.node.shape[0]:
        r = jax.vmap(hitl_residual)(x[h.node], x[h.line], h.points, h.mask,
                                    h.seg_start, h.seg_end)
        acc = acc + jnp.sum(r * r)
    return 0.5 * acc


# ---------------------------------------------------------------------------
# Normal-equation assembly
# ---------------------------------------------------------------------------

def _dof_cols(idx_a, idx_b):
    return jnp.concatenate(
        [3 * idx_a[:, None] + jnp.arange(3)[None, :],
         3 * idx_b[:, None] + jnp.arange(3)[None, :]], axis=1)  # [Q, 6]


def _pt_and_jacobian(pose_s, pose_t, src_pts):
    """Transformed points p_t [Q, S, 2] and A = dp_t/d(pose_s, pose_t)
    [Q, S, 2, 6] in closed form, batched over pairs.

    p_t = R(th_t)^T (R(th_s) p + t_s - t_t); the six columns are
    R_t^T e_x, R_t^T e_y, R_t^T R'(th_s) p, -R_t^T e_x, -R_t^T e_y,
    (R'(th_t))^T d — the last simplifying to [p_t.y, -p_t.x].

    Batched (not vmapped-per-item) deliberately: on an earlier
    accelerator the per-item vmap formulation compiled to a program that
    faulted at Q ~ 20000; the batched broadcast form compiles and runs
    everywhere.
    """
    c_s, s_s = jnp.cos(pose_s[:, 2])[:, None], jnp.sin(pose_s[:, 2])[:, None]
    c_t, s_t = jnp.cos(pose_t[:, 2])[:, None], jnp.sin(pose_t[:, 2])[:, None]
    px, py = src_pts[..., 0], src_pts[..., 1]                 # [Q, S]
    wx = c_s * px - s_s * py + pose_s[:, 0:1]
    wy = s_s * px + c_s * py + pose_s[:, 1:2]
    dx, dy = wx - pose_t[:, 0:1], wy - pose_t[:, 1:2]
    ptx = c_t * dx + s_t * dy
    pty = -s_t * dx + c_t * dy
    rpx = -s_s * px - c_s * py          # R'(th_s) p
    rpy = c_s * px - s_s * py
    one = jnp.ones_like(px)
    cols = [
        jnp.stack([c_t * one, -s_t * one], -1),
        jnp.stack([s_t * one, c_t * one], -1),
        jnp.stack([c_t * rpx + s_t * rpy, -s_t * rpx + c_t * rpy], -1),
        jnp.stack([-c_t * one, s_t * one], -1),
        jnp.stack([-s_t * one, -c_t * one], -1),
        jnp.stack([pty, -ptx], -1),
    ]
    return jnp.stack([ptx, pty], -1), jnp.stack(cols, axis=-1)


def _linearize_point_analytic(pose_s, pose_t, src_pts, tgt_pts, mask):
    """(r [Q, 2S], J [Q, 2S, 6]) of point_residual, closed form."""
    p_t, A = _pt_and_jacobian(pose_s, pose_t, src_pts)
    m = mask.astype(pose_s.dtype)
    r = (tgt_pts - p_t) * m[..., None]
    J = -A * m[..., None, None]
    Q, S = src_pts.shape[:2]
    return r.reshape(Q, 2 * S), J.reshape(Q, 2 * S, 6)


def _linearize_normal_analytic(pose_s, pose_t, src_pts, tgt_pts, src_nrm,
                               tgt_nrm, mask):
    """(r [Q, 2S], J [Q, 2S, 6]) of normal_residual, closed form."""
    p_t, A = _pt_and_jacobian(pose_s, pose_t, src_pts)
    m = mask.astype(pose_s.dtype)
    diff = p_t - tgt_pts
    r_tgt = jnp.sum(tgt_nrm * diff, axis=-1) * m
    r_src = -jnp.sum(src_nrm * diff, axis=-1) * m
    # Elementwise mul+sum, NOT einsum: the contraction dim is 2, and the
    # einsum formulation triggered a fused-graph kernel fault at
    # N >= 2000 on an earlier accelerator (the only analytic form that
    # used a dot; the point form never faulted).
    J_tgt = jnp.sum(tgt_nrm[..., None] * A, axis=-2) * m[..., None]
    J_src = -jnp.sum(src_nrm[..., None] * A, axis=-2) * m[..., None]
    Q, S = src_pts.shape[:2]
    r = jnp.stack([r_tgt, r_src], axis=-1).reshape(Q, 2 * S)
    J = jnp.stack([J_tgt, J_src], axis=-2).reshape(Q, 2 * S, 6)
    return r, J


def _linearize_odom_analytic(pose_i, pose_j, trans, rot, mask, tw, rw):
    """(r [Q, 3], J [Q, 3, 6]) of odom_residual, closed form."""
    r = jax.vmap(odom_residual)(pose_i, pose_j, trans, rot, mask, tw, rw)
    m = mask.astype(pose_i.dtype)
    z = jnp.zeros_like(tw)
    rows = jnp.stack([
        jnp.stack([tw, z, z, -tw, z, z], -1),
        jnp.stack([z, tw, z, z, -tw, z], -1),
        jnp.stack([z, z, rw, z, z, -rw], -1),
    ], axis=-2)                                   # [Q, 3, 6]
    return r, rows * m[:, None, None]


_ANALYTIC = {
    odom_residual: _linearize_odom_analytic,
    point_residual: _linearize_point_analytic,
    normal_residual: _linearize_normal_analytic,
}


# -- moment-form accumulation -------------------------------------------------
#
# The correspondence Jacobian A = dp_t/d(pose_s, pose_t) [Q, S, 2, 6] has
# only TWO point-dependent columns: col 2 (a3 = R_t^T R'(th_s) p) and
# col 5 (a6 = [p_t.y, -p_t.x]); cols 0/1/3/4 are per-pair rotation
# constants (+-R_t^T e_x/e_y).  So J^T J and J^T r collapse to a handful
# of per-point scalar REDUCTIONS over S ("moments") — the [Q, 2S, 6]
# Jacobian tensor never exists: the memory-bound materialize-J-then-einsum
# assembly becomes fused elementwise multiply-adds.  Exactness vs the
# J-form is pinned in tests/test_solver.py.


def _pt_geometry(pose_s, pose_t, src_pts):
    """Shared per-point geometry: transformed points and the two
    point-dependent Jacobian columns (a3, a6) of _pt_and_jacobian."""
    c_s, s_s = jnp.cos(pose_s[:, 2])[:, None], jnp.sin(pose_s[:, 2])[:, None]
    c_t, s_t = jnp.cos(pose_t[:, 2])[:, None], jnp.sin(pose_t[:, 2])[:, None]
    px, py = src_pts[..., 0], src_pts[..., 1]                 # [Q, S]
    wx = c_s * px - s_s * py + pose_s[:, 0:1]
    wy = s_s * px + c_s * py + pose_s[:, 1:2]
    dx, dy = wx - pose_t[:, 0:1], wy - pose_t[:, 1:2]
    ptx = c_t * dx + s_t * dy
    pty = -s_t * dx + c_t * dy
    rpx = -s_s * px - c_s * py          # R'(th_s) p
    rpy = c_s * px - s_s * py
    a3x = c_t * rpx + s_t * rpy
    a3y = -s_t * rpx + c_t * rpy
    return ptx, pty, a3x, a3y, c_t, s_t


def _sym6(entries):
    """[Q, 6, 6] from the upper-triangle dict {(i, j): [Q]}."""
    q = entries[(0, 0)].shape[0]
    rows = []
    for i in range(6):
        cols = [entries[(min(i, j), max(i, j))] for j in range(6)]
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2).reshape(q, 6, 6)


def _moments_point(pose_s, pose_t, src_pts, tgt_pts, mask):
    """(Hq [Q,6,6], gq [Q,6], cost) of point_residual via moments."""
    ptx, pty, a3x, a3y, c_t, s_t = _pt_geometry(pose_s, pose_t, src_pts)
    m = mask.astype(pose_s.dtype)
    a6x, a6y = pty, -ptx
    rx = (tgt_pts[..., 0] - ptx) * m    # residual r = (tgt - p_t) m
    ry = (tgt_pts[..., 1] - pty) * m
    red = lambda t: jnp.sum(t, axis=-1)
    M0 = red(m)
    S3x, S3y = red(m * a3x), red(m * a3y)
    S6x, S6y = red(m * a6x), red(m * a6y)
    s33 = red(m * (a3x * a3x + a3y * a3y))
    s36 = red(m * (a3x * a6x + a3y * a6y))
    s66 = red(m * (a6x * a6x + a6y * a6y))
    Srx, Sry = red(rx), red(ry)
    g3r = red(a3x * rx + a3y * ry)
    g6r = red(a6x * rx + a6y * ry)
    cost = 0.5 * jnp.sum(rx * rx + ry * ry)
    # a1 = R_t^T e_x = [c_t, -s_t]; a2 = R_t^T e_y = [s_t, c_t]  (per pair)
    ct, st = c_t[:, 0], s_t[:, 0]
    h13 = ct * S3x - st * S3y
    h23 = st * S3x + ct * S3y
    h16 = ct * S6x - st * S6y
    h26 = st * S6x + ct * S6y
    z = jnp.zeros_like(M0)
    Hq = _sym6({(0, 0): M0, (0, 1): z, (0, 2): h13, (0, 3): -M0,
                (0, 4): z, (0, 5): h16,
                (1, 1): M0, (1, 2): h23, (1, 3): z, (1, 4): -M0,
                (1, 5): h26,
                (2, 2): s33, (2, 3): -h13, (2, 4): -h23, (2, 5): s36,
                (3, 3): M0, (3, 4): z, (3, 5): -h16,
                (4, 4): M0, (4, 5): -h26,
                (5, 5): s66})
    # g = J^T r with J = -A m:
    g1 = -(ct * Srx - st * Sry)
    g2 = -(st * Srx + ct * Sry)
    gq = jnp.stack([g1, g2, -g3r, -g1, -g2, -g6r], axis=-1)
    return Hq, gq, cost


def _moments_normal(pose_s, pose_t, src_pts, tgt_pts, src_nrm, tgt_nrm,
                    mask):
    """(Hq, gq, cost) of normal_residual via moments.

    Each point contributes two residual rows (target and source normal);
    a row n^T A has the pattern [u, v, w, -u, -v, z] with u = n.a1,
    v = n.a2, w = n.a3, z = n.a6 — the source row's extra -1 sign cancels
    in both J^T J and J^T r."""
    ptx, pty, a3x, a3y, c_t, s_t = _pt_geometry(pose_s, pose_t, src_pts)
    m = mask.astype(pose_s.dtype)
    dx = ptx - tgt_pts[..., 0]          # diff = p_t - tgt
    dy = pty - tgt_pts[..., 1]
    sums = None
    for nrm in (tgt_nrm, src_nrm):
        nx, ny = nrm[..., 0], nrm[..., 1]
        u = nx * c_t - ny * s_t         # n . a1
        v = nx * s_t + ny * c_t         # n . a2
        w = nx * a3x + ny * a3y         # n . a3
        zc = nx * pty - ny * ptx        # n . a6
        rr = (nx * dx + ny * dy) * m    # masked residual magnitude
        terms = [m * u * u, m * u * v, m * u * w, m * u * zc,
                 m * v * v, m * v * w, m * v * zc,
                 m * w * w, m * w * zc, m * zc * zc,
                 u * rr, v * rr, w * rr, zc * rr, rr * rr]
        part = [jnp.sum(t, axis=-1) for t in terms]
        sums = part if sums is None else [a + b for a, b in zip(sums, part)]
    (uu, uv, uw, uz, vv, vw, vz, ww, wz, zz,
     ur, vr, wr, zr, rr2) = sums
    Hq = _sym6({(0, 0): uu, (0, 1): uv, (0, 2): uw, (0, 3): -uu,
                (0, 4): -uv, (0, 5): uz,
                (1, 1): vv, (1, 2): vw, (1, 3): -uv, (1, 4): -vv,
                (1, 5): vz,
                (2, 2): ww, (2, 3): -uw, (2, 4): -vw, (2, 5): wz,
                (3, 3): uu, (3, 4): uv, (3, 5): -uz,
                (4, 4): vv, (4, 5): -vz,
                (5, 5): zz})
    gq = jnp.stack([ur, vr, wr, -ur, -vr, zr], axis=-1)
    return Hq, gq, 0.5 * jnp.sum(rr2)


_MOMENTS = {
    point_residual: _moments_point,
    normal_residual: _moments_normal,
}


def linearize_two_pose(x, idx_a, idx_b, item_fn, data, analytic=True):
    """Residuals + Jacobians of a batch of two-pose factors.

    item_fn(pose_a, pose_b, *data_item) -> residual array (raveled to [m]).
    Returns (r [Q, m], J [Q, m, 6], dof [Q, 6]) or None when the factor
    list is empty.

    The hot residual types (odometry, point, normal) use closed-form
    batched Jacobians — jacfwd costs ~7 residual evaluations per factor
    where the closed form costs ~2, and linearization dominated device
    time in the LM loop in an earlier profile.  Types without an
    analytic entry (HITL's clamped point-to-segment) fall back to jacfwd;
    the jacfwd path doubles as the test oracle for the analytic forms
    (tests/test_solver.py).
    """
    if idx_a.shape[0] == 0:
        return None
    if analytic == "moments":
        # Moment-form accumulation only exists at the band-assembly level
        # (_MOMENTS consumers); a per-factor (r, J) term has no moment
        # form, so resolve the string explicitly to the closed-form J —
        # the identical linearization — rather than riding truthiness.
        # Solver._analytic_mode warns when a whole solve degrades this way.
        analytic = True
    closed_form = _ANALYTIC.get(item_fn) if analytic else None
    if closed_form is not None:
        r, J = closed_form(x[idx_a], x[idx_b], *data)
        return r, J, _dof_cols(idx_a, idx_b)
    return linearize_two_pose_jacfwd(x, idx_a, idx_b, item_fn, data)


def linearize_two_pose_jacfwd(x, idx_a, idx_b, item_fn, data):
    """jacfwd linearization (generic path + oracle for analytic forms)."""
    if idx_a.shape[0] == 0:
        return None
    p6 = jnp.concatenate([x[idx_a], x[idx_b]], axis=-1)   # [Q, 6]

    def f(p6_item, *d):
        return jnp.ravel(item_fn(p6_item[:3], p6_item[3:], *d))

    r = jax.vmap(f)(p6, *data)                       # [Q, m]
    J = jax.vmap(jax.jacfwd(f))(p6, *data)           # [Q, m, 6]
    return r, J, _dof_cols(idx_a, idx_b)


def odom_factor_spec(graph: FactorGraph):
    """(idx_a, idx_b, residual_fn, data) for the odometry factor batch."""
    od = graph.odom
    return (od.i, od.j, odom_residual, (od.trans, od.rot, od.mask, od.wt,
                                        od.wr))


def corr_factor_specs(graph: FactorGraph):
    """Factor specs for the planar/edge correspondence batches."""
    pl, ed = graph.planar, graph.edge
    return [
        (pl.src, pl.tgt, normal_residual,
         (pl.src_pts, pl.tgt_pts, pl.src_nrm, pl.tgt_nrm, pl.mask)),
        (ed.src, ed.tgt, point_residual, (ed.src_pts, ed.tgt_pts, ed.mask)),
    ]


def hitl_factor_spec(graph: FactorGraph):
    """(idx_a, idx_b, residual_fn, data) for the HITL colinearity batch."""
    ht = graph.hitl
    return (ht.node, ht.line, hitl_residual,
            (ht.points, ht.mask, ht.seg_start, ht.seg_end))


def graph_factor_specs(graph: FactorGraph):
    """Every factor type as (idx_a, idx_b, residual_fn, data) — the ONE
    enumeration all assembly paths (dense scatter, banded, band scatter,
    matrix-free) build from."""
    return [odom_factor_spec(graph)] + corr_factor_specs(graph) \
        + [hitl_factor_spec(graph)]


def _graph_factor_terms(x, graph: FactorGraph, analytic: bool = True):
    """Linearize every factor type; yields (r, J, dof) triples."""
    terms = [linearize_two_pose(x, a, b, fn, data, analytic)
             for (a, b, fn, data) in graph_factor_specs(graph)]
    return [t for t in terms if t is not None]


def _accumulate_two_pose(H, g, term):
    """Scatter one linearized factor batch into dense normal equations."""
    if term is None:
        return H, g
    r, J, dof = term
    gq = jnp.einsum("qmi,qm->qi", J, r, precision=HIGHEST)    # [Q, 6]
    Hq = jnp.einsum("qmi,qmj->qij", J, J, precision=HIGHEST)  # [Q, 6, 6]
    H = H.at[dof[:, :, None], dof[:, None, :]].add(Hq)
    g = g.at[dof].add(gq)
    return H, g


def assemble_normal_equations(x, graph: FactorGraph,
                              layout: "BandLayout" = None,
                              analytic: bool = True):
    """Build dense Gauss-Newton normal equations.

    Returns (H [3M, 3M], g [3M], cost scalar).  This is the dense device
    replacement for Ceres' block-sparse Jacobian assembly + SPARSE_SCHUR
    elimination (solver.cc:269): at pose counts up to a few thousand, one
    dense Cholesky avoids a sparse factorization's irregular memory
    access.

    With ``layout`` (static BandLayout; requires the delta-major pair
    order of correspond.make_pairs) the planar/edge correspondence blocks
    — the bulk of the factor count — accumulate into a block band via
    contiguous pad+add and the band is expanded to dense H by a
    pad/reshape/slice trick: ZERO scatters on the hot path.  An earlier
    profile showed the generic scatter-add dominating the whole LM loop;
    odometry/HITL factors (few, irregular indices) keep the scatter
    path.  Without ``layout`` every factor type
    goes through the generic scatter (order-independent).
    """
    m = x.shape[0]
    n_dof = 3 * m
    H = jnp.zeros((n_dof, n_dof), x.dtype)
    g = jnp.zeros((n_dof,), x.dtype)
    cost = jnp.zeros((), x.dtype)
    if layout is None or layout.w < 1:
        for term in _graph_factor_terms(x, graph, analytic):
            H, g = _accumulate_two_pose(H, g, term)
            cost = cost + 0.5 * jnp.sum(term[0] * term[0])
        return H, g, cost

    # Irregular factors (odometry, HITL lines): generic scatter.
    for (a, b, fn, data) in (odom_factor_spec(graph),
                             hitl_factor_spec(graph)):
        term = linearize_two_pose(x, a, b, fn, data, analytic)
        if term is not None:
            H, g = _accumulate_two_pose(H, g, term)
            cost = cost + 0.5 * jnp.sum(term[0] * term[0])

    # Correspondence factors: banded accumulation.
    corr_specs = corr_factor_specs(graph)
    if corr_specs:
        diag, band, gd, cost_c = _accumulate_banded(x, corr_specs, layout,
                                                    analytic)
        cost = cost + cost_c
        n3 = 3 * layout.n
        Hb = _band_to_dense(diag, band, layout)
        H = H.at[:n3, :n3].add(Hb)
        g = g.at[:n3].add(gd.reshape(n3))
    return H, g, cost


class BandLayout(NamedTuple):
    """Static description of the delta-major pair layout (make_pairs).

    Pairs for delta = i - j occupy rows [offsets()[d-1], offsets()[d]) of
    the correspondence arrays, with i = d..n-1 ascending and contiguous.
    ``w`` must be min(max_window, n - 1).  Hashable -> usable as a jit
    static argument.
    """

    n: int
    w: int

    def offsets(self):
        offs = [0]
        for d in range(1, self.w + 1):
            offs.append(offs[-1] + max(self.n - d, 0))
        return offs


def _accumulate_banded(x, specs, layout: BandLayout, analytic=True):
    """Linearize + accumulate correspondence factor blocks in band form.

    specs: (idx_a, idx_b, residual_fn, data) tuples (corr_factor_specs).
    Returns (diag [n,3,3], band list of w [n,3,3] arrays where band[d-1]
    holds block (i, i-d) stored at row i, gdiag [n,3], cost).  All adds
    are contiguous pads — no scatter.

    analytic: True = closed-form J + einsum J^T J; False = jacfwd;
    "moments" = moment-form accumulation (_MOMENTS) that never
    materializes J — same algebra, least HBM traffic.

    Types are linearized ONE AT A TIME with an optimization barrier
    threading x between them: the next type's Jacobian ops depend on the
    barrier output, so XLA cannot schedule both closed-form [Q, 2S, 6]
    tensors live simultaneously.  This works around a kernel fault on an
    earlier accelerator (two such tensors co-resident in the fused sweep
    at Q ~ 20000; each type alone ran clean).  Whether the H100 needs it
    is not tested yet (ROADMAP.md section 3, accelerator fault
    workarounds).
    """
    n, w = layout.n, layout.w
    offs = layout.offsets()
    dtype = x.dtype
    diag = jnp.zeros((n, 3, 3), dtype)
    band = [jnp.zeros((n, 3, 3), dtype) for _ in range(w)]
    gd = jnp.zeros((n, 3), dtype)
    cost = jnp.zeros((), dtype)
    for k, (a, b, fn, data) in enumerate(specs):
        mom = _MOMENTS.get(fn) if analytic == "moments" else None
        if mom is not None:
            if a.shape[0] == 0:
                continue
            Hq, gq, c = mom(x[a], x[b], *data)
            cost = cost + c
        else:
            term = linearize_two_pose(x, a, b, fn, data, bool(analytic))
            if term is None:
                continue
            r, J, _dof = term
            cost = cost + 0.5 * jnp.sum(r * r)
            gq = jnp.einsum("qmi,qm->qi", J, r, precision=HIGHEST)
            Hq = jnp.einsum("qmi,qmj->qij", J, J, precision=HIGHEST)
        for d in range(1, w + 1):
            cnt = n - d
            if cnt <= 0:
                break
            s = offs[d - 1]
            Hd = Hq[s:s + cnt]
            gqd = gq[s:s + cnt]
            pre, post = ((d, 0),), ((0, d),)   # rows i=d..n-1 / j=0..n-1-d
            z3 = ((0, 0), (0, 0))
            diag = diag + jnp.pad(Hd[:, :3, :3], pre + z3)
            diag = diag + jnp.pad(Hd[:, 3:, 3:], post + z3)
            band[d - 1] = band[d - 1] + jnp.pad(Hd[:, :3, 3:], pre + z3)
            gd = gd + jnp.pad(gqd[:, :3], pre + (z3[0],))
            gd = gd + jnp.pad(gqd[:, 3:], post + (z3[0],))
        if k + 1 < len(specs):
            diag, gd, cost, x, *band = jax.lax.optimization_barrier(
                (diag, gd, cost, x, *band))
    return diag, band, gd, cost


def _scatter_band_factor(lv, gd, cost, x, idx_a, idx_b, item_fn, data,
                         analytic=True):
    """Scatter one two-node factor batch into band levels lv [w+1, N, 3, 3]
    (level 0 = diagonal, level d = block (i, i-d) at row i) + gradient gd.

    Order-independent (unlike the contiguous pad+add fast path) — used for
    irregular factor lists and for shard-local slices of the pair list in
    the factor-sharded multi-chip path.  Requires |idx_a - idx_b| <= w.
    analytic="moments" uses the moment-form blocks (_MOMENTS) for types
    that have them.
    """
    mom = _MOMENTS.get(item_fn) if analytic == "moments" else None
    if mom is not None:
        if idx_a.shape[0] == 0:
            return lv, gd, cost
        Hq, gq, c = mom(x[idx_a], x[idx_b], *data)
        cost = cost + c
    else:
        term = linearize_two_pose(x, idx_a, idx_b, item_fn, data,
                                  bool(analytic))
        if term is None:
            return lv, gd, cost
        r, J, _dof = term
        cost = cost + 0.5 * jnp.sum(r * r)
        gq = jnp.einsum("qmi,qm->qi", J, r, precision=HIGHEST)
        Hq = jnp.einsum("qmi,qmj->qij", J, J, precision=HIGHEST)
    a, b = idx_a, idx_b
    lo = jnp.maximum(a, b)
    delta = jnp.abs(a - b)
    lower = jnp.where((a > b)[:, None, None], Hq[:, :3, 3:],
                      jnp.swapaxes(Hq[:, :3, 3:], 1, 2))
    lv = lv.at[0, a].add(Hq[:, :3, :3])
    lv = lv.at[0, b].add(Hq[:, 3:, 3:])
    lv = lv.at[delta, lo].add(
        jnp.where((delta > 0)[:, None, None], lower, 0.0))
    gd = gd.at[a].add(gq[:, :3]).at[b].add(gq[:, 3:])
    return lv, gd, cost


def _hitl_border(lv, gd, cost, x, graph: FactorGraph, n: int, L: int):
    """Accumulate HITL factors: node-node into the band diagonal, node-line
    into the dense border C, line-line into the block-diagonal E."""
    dtype = x.dtype
    C = jnp.zeros((n, L, 3, 3), dtype)
    E = jnp.zeros((L, 3, 3), dtype)
    gl = jnp.zeros((L, 3), dtype)
    ht = graph.hitl
    term = linearize_two_pose(x, *hitl_factor_spec(graph))
    if term is not None:
        r, J, _dof = term
        cost = cost + 0.5 * jnp.sum(r * r)
        gq = jnp.einsum("qmi,qm->qi", J, r, precision=HIGHEST)
        Hq = jnp.einsum("qmi,qmj->qij", J, J, precision=HIGHEST)
        node, line = ht.node, ht.line - n
        lv = lv.at[0, node].add(Hq[:, :3, :3])
        C = C.at[node, line].add(Hq[:, :3, 3:])
        E = E.at[line].add(Hq[:, 3:, 3:])
        gd = gd.at[node].add(gq[:, :3])
        gl = gl.at[line].add(gq[:, 3:])
    return lv, gd, cost, C, E, gl


def assemble_banded_scatter(x, graph: FactorGraph, n: int, w: int,
                            analytic=True):
    """Band-form assembly for ARBITRARY factor order (scatter into band).

    The multi-chip factor-sharded path hands each device an arbitrary
    contiguous slice of the delta-major pair list, so the contiguous
    pad+add fast path of assemble_banded_system does not apply; scatter
    into the [w+1, N, 3, 3] band instead (Q/D blocks per shard — small),
    then psum the O(N w) band rather than an O(N^2) dense H.

    Returns (BandedSystem, cost).  Requires all two-node factors in-band.
    """
    from nautilus_tpu.solve.band import BandedSystem

    dtype = x.dtype
    L = x.shape[0] - n
    lv = jnp.zeros((w + 1, n, 3, 3), dtype)
    gd = jnp.zeros((n, 3), dtype)
    cost = jnp.zeros((), dtype)
    for idx_a, idx_b, fn, data in corr_factor_specs(graph) \
            + [odom_factor_spec(graph)]:
        lv, gd, cost = _scatter_band_factor(lv, gd, cost, x, idx_a, idx_b,
                                            fn, data, analytic=analytic)
    C = E = gl = None
    if L:
        lv, gd, cost, C, E, gl = _hitl_border(lv, gd, cost, x, graph, n, L)
    return BandedSystem(diag=lv[0], band=lv[1:], g=gd, C=C, E=E, gl=gl), cost


def lowrank_factor_columns(x, lr: "OdomFactors", n: int, analytic=True):
    """(U [3n, 3K], g_lr [n, 3], cost) of long-range loop-closure factors.

    Each factor's Gauss-Newton contribution is J^T J with J [3, 6]; U
    holds the 3K columns J^T so H_lr = U U^T exactly.  K is small (one
    column triple per applied loop closure), so the band solver folds
    these in via the Woodbury identity (solve/band.py) instead of
    falling back to dense H.
    """
    term = linearize_two_pose(x, lr.i, lr.j, odom_residual,
                              (lr.trans, lr.rot, lr.mask, lr.wt, lr.wr),
                              analytic)
    if term is None:
        return None, None, jnp.zeros((), x.dtype)
    r, J, dof = term                      # [K, 3], [K, 3, 6], [K, 6]
    K = r.shape[0]
    cost = 0.5 * jnp.sum(r * r)
    gq = jnp.einsum("kmi,km->ki", J, r, precision=HIGHEST)   # [K, 6]
    g_lr = jnp.zeros((3 * n,), x.dtype).at[dof].add(gq).reshape(n, 3)
    # U[dof[k, i], 3k + m] = J[k, m, i]
    U = jnp.zeros((3 * n, 3 * K), x.dtype)
    cols = (3 * jnp.arange(K)[:, None] + jnp.arange(3)[None, :])  # [K, 3]
    U = U.at[dof[:, None, :], cols[:, :, None]].add(J)
    return U, g_lr, cost


def assemble_banded_system(x, graph: FactorGraph, layout: BandLayout,
                           analytic=True, lr: "OdomFactors" = None):
    """Assemble normal equations directly in block-band(+border) form.

    Returns (solve.band.BandedSystem, cost).  Identical algebra to
    assemble_normal_equations — the band holds blocks (i, i-d) for
    d = 1..w, HITL line poses live in the dense border — but H is never
    materialized dense: O(N w) memory, so the LM while-loop carry stays
    tiny and graphs far beyond the dense-H wall (~8000 poses) solve.

    Requires every odometry/LC factor to satisfy |i - j| <= layout.w
    (checked host-side by the Solver; violators fall back to the dense
    path).
    """
    from nautilus_tpu.solve.band import BandedSystem

    n, w = layout.n, layout.w
    L = x.shape[0] - n   # line-pose slots

    diag, band, gd, cost = _accumulate_banded(x, corr_factor_specs(graph),
                                              layout, analytic)
    lv = jnp.concatenate([diag[None], jnp.stack(band)]) if band else \
        diag[None]

    lv, gd, cost = _scatter_band_factor(lv, gd, cost, x,
                                        *odom_factor_spec(graph),
                                        analytic=analytic)

    U = None
    if lr is not None and lr.count:
        U, g_lr, cost_lr = lowrank_factor_columns(x, lr, n, analytic)
        if U is not None:
            gd = gd + g_lr
            cost = cost + cost_lr

    C = E = gl = None
    if L:
        lv, gd, cost, C, E, gl = _hitl_border(lv, gd, cost, x, graph, n, L)
    return BandedSystem(diag=lv[0], band=lv[1:], g=gd, C=C, E=E, gl=gl,
                        U=U), cost


def _band_to_dense(diag, band, layout: BandLayout):
    """Expand block band -> dense [3n, 3n] H without scatter.

    Builds S [n, w+1, 3, 3] with S[i, k] = block (i, j = i - w + k)
    (k = w - delta; k = w is the diagonal, halved).  Padding S's block-
    column axis to n+1 and flattening makes flat index i*(n+1) + k equal
    the dense block index i*n + j shifted by the constant w, so one
    static slice + reshape materializes the strictly-lower-banded block
    matrix; H = D + D^T restores symmetry (diagonal blocks of J^T J are
    symmetric, so the halved diagonal doubles back exactly).
    """
    n, w = layout.n, layout.w
    S = jnp.stack(list(reversed(band)) + [0.5 * diag], axis=1)
    S = jnp.pad(S, ((0, 0), (0, n - w), (0, 0), (0, 0)))  # [n, n+1, 3, 3]
    flat = S.reshape(n * (n + 1), 3, 3)
    D = jax.lax.slice(flat, (w, 0, 0), (w + n * n, 3, 3)).reshape(n, n, 3, 3)
    Dh = D.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)
    return Dh + Dh.T
