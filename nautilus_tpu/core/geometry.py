"""SE(2) geometry and angle utilities (JAX, batch-first, dtype-agnostic).

Functional equivalents of the reference's Eigen-based helpers:
- angle ops: reference src/util/math_util.h:51-94 (angle_mod / AngleDiff / AngleDist)
- pose <-> affine: reference src/util/slam_util.h:19-34 (PoseArrayToAffine)
- point transforms: reference src/util/slam_util.h:55-63 (TransformPointcloud)
- segment distance: reference src/util/slam_util.h:91-110 (DistanceToLineSegment)
- normal similarity: reference src/util/math_util.h:46-49 (NormalsSimilar)

All functions are pure, jit/vmap/grad-safe (no data-dependent Python control
flow, NaN-safe gradients), and operate on arrays whose leading dims batch.
A pose is a length-3 array [tx, ty, theta]; theta rotates robot->world.
"""

from __future__ import annotations

import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


def angle_mod(angle):
    """Wrap angle to [-pi, pi] (round-to-nearest multiple of 2*pi).

    Matches reference math_util::AngleMod (src/util/math_util.h:81-84):
    ``angle - 2*pi * rint(angle / 2*pi)``.
    """
    angle = jnp.asarray(angle)
    return angle - TWO_PI * jnp.round(angle / TWO_PI)


def angle_diff(a0, a1):
    """Signed smallest difference a0 - a1 (reference math_util.h:87-89)."""
    return angle_mod(jnp.asarray(a0) - jnp.asarray(a1))


def angle_dist(a0, a1):
    """Absolute smallest difference (reference math_util.h:92-94)."""
    return jnp.abs(angle_diff(a0, a1))


def normals_similar(n1, n2, max_cosine_value):
    """|n1 . n2| > max_cosine_value (reference math_util.h:46-49).

    Works on batched normals: n1, n2 of shape [..., 2].
    """
    return jnp.abs(jnp.sum(n1 * n2, axis=-1)) > max_cosine_value


def rot2d(theta):
    """2x2 rotation matrix/matrices for angle(s) theta.

    theta: shape [...] -> returns [..., 2, 2] rotating robot->world.
    """
    c, s = jnp.cos(theta), jnp.sin(theta)
    row0 = jnp.stack([c, -s], axis=-1)
    row1 = jnp.stack([s, c], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def _rot_apply(theta, points):
    """Rotate points [..., 2] by theta (broadcast).

    Written elementwise (not as a 2x2 matmul) so it runs at full f32
    precision whatever the backend's default matmul precision: a GPU may
    round f32 matmul operands to TF32 (~3 decimal digits), far too coarse
    for pose arithmetic.
    """
    c, s = jnp.cos(theta), jnp.sin(theta)
    x, y = points[..., 0], points[..., 1]
    return jnp.stack([c * x - s * y, s * x + c * y], axis=-1)


def pose_transform_points(pose, points):
    """Apply SE(2) pose [tx, ty, theta] to points [..., 2] (robot->world).

    Equivalent to reference TransformPointcloud (src/util/slam_util.h:55-63).
    pose may be batched with leading dims broadcastable against points'.
    """
    pose = jnp.asarray(pose)
    return _rot_apply(pose[..., 2], points) + pose[..., :2]


def pose_inverse_transform_points(pose, points):
    """Apply the inverse of pose to points (world->robot frame)."""
    pose = jnp.asarray(pose)
    return _rot_apply(-pose[..., 2], points - pose[..., :2])


def relative_pose_transform_points(source_pose, target_pose, points):
    """Transform points from source frame into target frame.

    Equivalent to the reference's ``target_to_world.inverse() *
    source_to_world * p`` (src/optimization/solver.cc:157-159), done as a
    single fused rotation+translation to save work under vmap.
    """
    world = pose_transform_points(source_pose, points)
    return pose_inverse_transform_points(target_pose, world)


def compose_relative(pose_i, pose_j):
    """Relative pose of j expressed as a world-frame delta from i.

    Matches the (frame-naive) subtraction the reference uses to build
    odometry factors from consecutive node poses
    (src/input/slam_type_builder.cc:31-42): translation = loc_j - loc_i in
    the WORLD frame, rotation = theta_j - theta_i.
    """
    pose_i = jnp.asarray(pose_i)
    pose_j = jnp.asarray(pose_j)
    return jnp.concatenate(
        [pose_j[..., :2] - pose_i[..., :2],
         (pose_j[..., 2] - pose_i[..., 2])[..., None]], axis=-1)


def _safe_norm(v, axis=-1, eps=1e-20):
    """Euclidean norm with NaN-free gradient at 0."""
    sq = jnp.sum(v * v, axis=axis)
    return jnp.sqrt(jnp.maximum(sq, eps))


def _is_between(val, a, b):
    """val lies in the closed interval spanned by a and b (either order).

    Reference IsBetween (src/util/slam_util.h:86-89).
    """
    return ((val >= a) & (val <= b)) | ((val >= b) & (val <= a))


def distance_to_line_segment(point, seg_start, seg_end):
    """Distance from point(s) to a 2D line segment.

    Replicates reference DistanceToLineSegment (src/util/slam_util.h:91-110):
    project the point on the infinite line; if the projection's x AND y both
    lie within the segment's coordinate spans, return the perpendicular
    distance, else the distance to the nearest endpoint.  Batched over any
    leading dims of ``point``; ``seg_start``/``seg_end`` broadcast.

    NaN-safe for degenerate (zero-length) segments and autodiff-safe.
    """
    point = jnp.asarray(point)
    seg_start = jnp.asarray(seg_start)
    seg_end = jnp.asarray(seg_end)
    d = seg_end - seg_start
    dd = jnp.sum(d * d, axis=-1)
    safe_dd = jnp.maximum(dd, 1e-20)
    t = jnp.sum((point - seg_start) * d, axis=-1) / safe_dd
    proj = seg_start + t[..., None] * d
    on_segment = (_is_between(proj[..., 0], seg_start[..., 0], seg_end[..., 0])
                  & _is_between(proj[..., 1], seg_start[..., 1], seg_end[..., 1]))
    # Perpendicular distance: |cross(d_hat, p - start)|.
    rel = point - seg_start
    cross = d[..., 0] * rel[..., 1] - d[..., 1] * rel[..., 0]
    perp = jnp.abs(cross) / _safe_norm(d)
    d_start = _safe_norm(point - seg_start)
    d_end = _safe_norm(point - seg_end)
    endpoint_dist = jnp.minimum(d_start, d_end)
    degenerate = dd < 1e-20
    return jnp.where(degenerate, d_start,
                     jnp.where(on_segment, perp, endpoint_dist))


def scatter_matrix_score(points, mask=None):
    """lambda_min / lambda_max of the 2D scatter matrix of a point set.

    Used by LOAM-style smoothness scoring (reference
    src/input/feature_extracter.cc:46-95) and by the loop-closure candidate
    filter (reference src/loop_closure/lc_candidate_filter.cc:35-51).

    points: [..., M, 2]; mask: [..., M] booleans selecting valid points.
    Returns score in [0, 1] per batch element; 0 where fewer than 2 points.
    """
    points = jnp.asarray(points)
    if mask is None:
        mask = jnp.ones(points.shape[:-1], dtype=bool)
    w = mask.astype(points.dtype)
    n = jnp.maximum(jnp.sum(w, axis=-1), 1.0)
    mean = jnp.sum(points * w[..., None], axis=-2) / n[..., None]
    centered = (points - mean[..., None, :]) * w[..., None]
    # 2x2 scatter matrix entries.
    sxx = jnp.sum(centered[..., 0] * centered[..., 0], axis=-1)
    sxy = jnp.sum(centered[..., 0] * centered[..., 1], axis=-1)
    syy = jnp.sum(centered[..., 1] * centered[..., 1], axis=-1)
    # Closed-form eigenvalues of [[sxx, sxy], [sxy, syy]].
    tr = sxx + syy
    disc = jnp.sqrt(jnp.maximum((sxx - syy) ** 2 + 4.0 * sxy * sxy, 0.0))
    lam_max = 0.5 * (tr + disc)
    lam_min = 0.5 * (tr - disc)
    score = lam_min / jnp.maximum(lam_max, 1e-20)
    valid = jnp.sum(mask, axis=-1) >= 2
    return jnp.where(valid, jnp.clip(score, 0.0, 1.0), 0.0)
