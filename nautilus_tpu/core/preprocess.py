"""Batched per-scan preprocessing: normals + LOAM-style feature extraction.

Replaces three reference components with fixed-shape batched device code:

- Normal estimation (reference src/input/normal_computation.cc:73-129, a
  randomized Hough variant of Boulch & Marlet).  Rebuilt as a *deterministic*
  local-PCA estimator: for each point, take neighbors within a radius that
  grows over a fixed schedule (reference grows by nc_neighborhood_step_size
  until >=2 neighbors, normal_computation.cc:92-96), fit a line by PCA of the
  neighborhood scatter matrix, and return its unit normal, canonicalized to
  the upper half-plane.  Downstream consumers only use normals through dot
  products / |cos| gating (solver.cc:194, slam_residuals.h:81-84) so the
  orientation convention is free; determinism is a deliberate deviation from
  the reference's rand()-driven sampler (documented in SURVEY.md §7 hard
  part (d)).

- Smoothness scoring (reference src/input/feature_extracter.cc:46-95):
  lambda_min/lambda_max of the scatter matrix of an index-window
  neighborhood.  We distance-filter both sides of the window symmetrically
  (the reference filters only the left side, feature_extracter.cc:15-35 — a
  quirk we do not preserve) and require min_neighbor_num neighbors.

- Greedy feature selection (reference feature_extracter.cc:119-165): planar
  points = lowest-score candidates below threshold, edge = highest-score
  candidates above threshold, subject to a mutual min-distance and per-type
  caps; rebuilt as a lax.scan over the sorted candidate order so it batches
  over all scans at once.  Caps/thresholds default to the reference's
  hardcoded LidarFactor call site (src/util/slam_types.h:66-67).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class FeatureParams(NamedTuple):
    """Defaults mirror the reference's hardcoded ctor args (slam_types.h:66-67)."""

    threshold: float = 0.008          # planar below, edge above
    distance_threshold: float = 2.0   # min mutual distance between kept features
    neighbors_per_side: int = 10      # index-window half-width
    max_edge: int = 10
    max_planar: int = 20
    min_neighbors: int = 10           # min window neighbors for a valid score


class NormalParams(NamedTuple):
    """Defaults mirror config/default_config.lua nc_* keys."""

    neighborhood_size: float = 0.15   # nc_neighborhood_size
    neighborhood_step: float = 0.1    # nc_neighborhood_step_size
    num_radius_steps: int = 4         # fixed growth schedule replacing the while loop
    bin_number: int = 32              # nc_bin_number (hough method)
    mean_distance: float = 0.1        # nc_mean_distance -> pair budget (hough)
    k_neighbors: int = 12             # hough neighborhood cap
    method: str = "pca"               # "pca" | "hough"


def normal_params_from_config(cfg, method: str = "pca") -> NormalParams:
    """Bind the nc_* Lua keys (reference normal_computation.h:12-17)."""
    return NormalParams(
        neighborhood_size=float(cfg.get("nc_neighborhood_size", 0.15)),
        neighborhood_step=float(cfg.get("nc_neighborhood_step_size", 0.1)),
        bin_number=int(cfg.get("nc_bin_number", 32)),
        mean_distance=float(cfg.get("nc_mean_distance", 0.1)),
        method=method)


# ---------------------------------------------------------------------------
# Normals
# ---------------------------------------------------------------------------

def _scan_normals(points, mask, params: NormalParams):
    """Normals for a single scan. points [P, 2], mask [P] -> [P, 2]."""
    p = points.shape[0]
    diff = points[:, None, :] - points[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)                      # [P, P]
    pair_valid = mask[:, None] & mask[None, :]
    d2 = jnp.where(pair_valid, d2, jnp.inf)

    radii = params.neighborhood_size + params.neighborhood_step * jnp.arange(
        params.num_radius_steps, dtype=points.dtype)
    # Neighbor counts per point per radius (self included, as in the
    # reference KD-tree radius query).
    within = d2[None, :, :] <= (radii[:, None, None] ** 2)   # [R, P, P]
    counts = jnp.sum(within, axis=-1)                        # [R, P]
    # Smallest radius with >= 2 points in the ball; else the largest radius.
    enough = counts >= 2
    first = jnp.argmax(enough, axis=0)                       # [R,P] -> [P]
    any_enough = jnp.any(enough, axis=0)
    radius_idx = jnp.where(any_enough, first, params.num_radius_steps - 1)
    nbr = jnp.take_along_axis(within, radius_idx[None, :, None], axis=0)[0]  # [P, P]

    w = nbr.astype(points.dtype)
    n = jnp.maximum(jnp.sum(w, axis=-1), 1.0)
    mean = jnp.matmul(w, points, precision="highest") / n[:, None]
    centered = points[None, :, :] - mean[:, None, :]         # [P, P, 2]
    sxx = jnp.sum(w * centered[..., 0] * centered[..., 0], axis=-1)
    sxy = jnp.sum(w * centered[..., 0] * centered[..., 1], axis=-1)
    syy = jnp.sum(w * centered[..., 1] * centered[..., 1], axis=-1)
    # Min-eigenvalue eigenvector of [[sxx, sxy], [sxy, syy]] = line normal.
    disc = jnp.sqrt(jnp.maximum((sxx - syy) ** 2 + 4.0 * sxy * sxy, 0.0))
    lam_min = 0.5 * (sxx + syy - disc)
    # Eigenvector for lam_min: rows of (S - lam_min I) are orthogonal to it;
    # pick the numerically larger row for stability.
    v1 = jnp.stack([sxy, lam_min - sxx], axis=-1)
    v2 = jnp.stack([lam_min - syy, sxy], axis=-1)
    use_v1 = jnp.sum(v1 * v1, axis=-1) >= jnp.sum(v2 * v2, axis=-1)
    v = jnp.where(use_v1[:, None], v1, v2)
    norm = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1), 1e-30))
    normal = v / norm[:, None]
    # Degenerate neighborhoods (isotropic scatter): fall back to +x axis,
    # matching the reference's angle-from-x-axis convention
    # (normal_computation.cc:34-37).
    degenerate = disc < 1e-12
    normal = jnp.where(degenerate[:, None],
                       jnp.array([1.0, 0.0], dtype=points.dtype), normal)
    # Canonical orientation: upper half-plane (ny > 0, or nx > 0 when ny == 0).
    flip = (normal[:, 1] < 0) | ((normal[:, 1] == 0) & (normal[:, 0] < 0))
    normal = jnp.where(flip[:, None], -normal, normal)
    return jnp.where(mask[:, None], normal, 0.0)


def _scan_normals_hough(points, mask, params: NormalParams):
    """Deterministic Hough-accumulator normals for one scan -> [P, 2].

    Batched rebuild of the reference's randomized estimator
    (normal_computation.cc:73-129 + CircularHoughAccumulator,
    normal_computation.h:21-64): for each point, consider its
    ``k_neighbors`` nearest neighbors within the growing-radius schedule,
    form pair lines in a fixed order capped by the reference's sample
    budget 1/(2 * mean_distance^2) (normal_computation.cc:39-41), vote
    each line-normal angle (acos convention, in [0, pi]) into
    ``bin_number`` bins around the circle, and output the winning bin's
    average angle as the normal direction.  Deterministic: all pair
    enumeration is by index order instead of rand().
    """
    p = points.shape[0]
    k = params.k_neighbors
    max_radius = (params.neighborhood_size
                  + params.neighborhood_step * (params.num_radius_steps - 1))
    diff = points[:, None, :] - points[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    pair_valid = mask[:, None] & mask[None, :]
    d2 = jnp.where(pair_valid, d2, jnp.inf)
    d2 = jnp.where(jnp.eye(p, dtype=bool), jnp.inf, d2)  # exclude self
    # K nearest neighbors per point.
    nbr_d2, nbr_idx = jax.lax.top_k(-d2, k)
    nbr_d2 = -nbr_d2                                     # [P, K]
    # Valid if inside the (final) growth radius; always keep the nearest
    # (the reference grows the radius until it has >= 2 points).
    ranks = jnp.arange(k)
    nbr_ok = (nbr_d2 <= max_radius ** 2) | (ranks[None, :] == 0)
    nbr_pts = points[nbr_idx]                            # [P, K, 2]

    # Fixed pair enumeration (i < j), capped by the sample budget.
    ii, jj = np.triu_indices(k, 1)
    limit = max(int(1.0 / (2.0 * params.mean_distance ** 2)), 1)
    ii = jnp.asarray(ii[:limit])
    jj = jnp.asarray(jj[:limit])
    pa = nbr_pts[:, ii, :]                               # [P, S, 2]
    pb = nbr_pts[:, jj, :]
    vote_ok = (nbr_ok[:, ii] & nbr_ok[:, jj])
    seg = pb - pa
    seg_len2 = jnp.sum(seg * seg, axis=-1)
    vote_ok = vote_ok & (seg_len2 > 1e-12)
    # Unit normal of the line through (pa, pb); acos(n . x_hat) in [0, pi]
    # (normal_computation.cc:115-118).
    inv_len = jax.lax.rsqrt(jnp.maximum(seg_len2, 1e-12))
    nrm = jnp.stack([-seg[..., 1], seg[..., 0]], axis=-1) * inv_len[..., None]
    angle = jnp.arccos(jnp.clip(nrm[..., 0], -1.0, 1.0))  # [P, S]
    # Circular accumulator: bins of width 2*pi/bins, bin = round(a/step)
    # (normal_computation.h:38-44).
    step = 2.0 * jnp.pi / params.bin_number
    bins = jnp.round(angle / step).astype(jnp.int32) % params.bin_number
    one_hot = (jax.nn.one_hot(bins, params.bin_number, dtype=points.dtype)
               * vote_ok[..., None].astype(points.dtype))
    votes = jnp.sum(one_hot, axis=1)                     # [P, B]
    best = jnp.argmax(votes, axis=-1)                    # [P]
    in_best = (bins == best[:, None]) & vote_ok
    wsum = jnp.sum(jnp.where(in_best, angle, 0.0), axis=-1)
    wcnt = jnp.maximum(jnp.sum(in_best, axis=-1), 1)
    avg_angle = wsum / wcnt
    normal = jnp.stack([jnp.cos(avg_angle), jnp.sin(avg_angle)], axis=-1)
    return jnp.where(mask[:, None], normal, 0.0)


@functools.partial(jax.jit, static_argnames=("params", "chunk"))
def compute_normals(points, mask, params: NormalParams = NormalParams(),
                    chunk: int = 64):
    """Normals for all scans. points [N, P, 2], mask [N, P] -> [N, P, 2].

    Processed in scan chunks to bound the [chunk, P, P] working set in HBM.
    params.method selects the deterministic PCA estimator (default) or the
    deterministic Hough-accumulator variant.
    """
    fn = _scan_normals_hough if params.method == "hough" else _scan_normals
    return jax.lax.map(lambda args: fn(args[0], args[1], params),
                       (points, mask), batch_size=chunk)


# ---------------------------------------------------------------------------
# Smoothness + feature selection
# ---------------------------------------------------------------------------

def _scan_smoothness(points, mask, params: FeatureParams):
    """Smoothness score per point for one scan -> (scores [P], valid [P])."""
    p = points.shape[0]
    nps = params.neighbors_per_side
    idx = jnp.arange(p)
    # Index-window neighbors: |i - j| <= nps, j != i, both valid, within
    # distance_threshold of the center point.
    offset = idx[None, :] - idx[:, None]
    in_window = (jnp.abs(offset) <= nps) & (offset != 0)
    pair_valid = mask[:, None] & mask[None, :]
    diff = points[:, None, :] - points[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    near = d2 <= params.distance_threshold ** 2
    nbr = in_window & pair_valid & near
    count = jnp.sum(nbr, axis=-1)
    valid = (count >= params.min_neighbors) & mask
    # Include the point itself in the scatter (reference
    # feature_extracter.cc:64 pushes the center into the neighborhood).
    nbr_self = nbr | (jnp.eye(p, dtype=bool) & mask[:, None])
    w = nbr_self.astype(points.dtype)
    n = jnp.maximum(jnp.sum(w, axis=-1), 1.0)
    mean = jnp.matmul(w, points, precision="highest") / n[:, None]
    centered = points[None, :, :] - mean[:, None, :]
    sxx = jnp.sum(centered[..., 0] ** 2 * w, axis=-1)
    sxy = jnp.sum(centered[..., 0] * centered[..., 1] * w, axis=-1)
    syy = jnp.sum(centered[..., 1] ** 2 * w, axis=-1)
    tr = sxx + syy
    disc = jnp.sqrt(jnp.maximum((sxx - syy) ** 2 + 4.0 * sxy * sxy, 0.0))
    lam_max = 0.5 * (tr + disc)
    lam_min = 0.5 * (tr - disc)
    score = lam_min / jnp.maximum(lam_max, 1e-20)
    return jnp.clip(score, 0.0, 1.0), valid


_GREEDY_CANDIDATES = 128  # scan length cap; caps are <= 20 selections


def _greedy_select(points, order, ok, max_count: int, dist_threshold: float):
    """Greedy min-distance selection following a candidate order.

    points [P, 2]; order [P] candidate indices (best first); ok [P] per-point
    eligibility.  Returns (sel_idx [K], sel_mask [K]) for K = max_count.
    Mirrors reference validFeaturePoint (feature_extracter.cc:119-142).

    Only the first _GREEDY_CANDIDATES entries of the order are scanned: the
    caps (<= 20 features) are always filled long before that, and a short
    fixed-length lax.scan keeps XLA compile time flat in P.
    """
    order = order[:min(order.shape[0], _GREEDY_CANDIDATES)]
    k = max_count
    far = jnp.full((k, 2), 1e9, dtype=points.dtype)

    def step(carry, cand):
        sel_pts, sel_idx, count = carry
        p = points[cand]
        d2 = jnp.sum((sel_pts - p[None, :]) ** 2, axis=-1)
        clear = jnp.min(d2) >= dist_threshold ** 2
        accept = ok[cand] & clear & (count < k)
        slot = jnp.where(accept, count, k - 1)
        new_pts = jax.lax.dynamic_update_index_in_dim(sel_pts, jnp.where(accept, p, sel_pts[slot]), slot, 0)
        # cand may be int64 under jax x64 mode; sel_idx stays int32.
        cand32 = cand.astype(sel_idx.dtype)
        new_idx = jax.lax.dynamic_update_index_in_dim(sel_idx, jnp.where(accept, cand32, sel_idx[slot]), slot, 0)
        return (new_pts, new_idx, count + accept.astype(count.dtype)), None

    init = (far, jnp.zeros((k,), dtype=jnp.int32), jnp.zeros((), jnp.int32))
    (sel_pts, sel_idx, count), _ = jax.lax.scan(step, init, order)
    sel_mask = jnp.arange(k) < count
    sel_idx = jnp.where(sel_mask, sel_idx, 0)
    return sel_idx, sel_mask


def _scan_features(points, mask, params: FeatureParams):
    scores, valid = _scan_smoothness(points, mask, params)
    # Planar: ascending score, require score <= threshold (reference fails
    # planar only when strictly greater, feature_extracter.cc:125).
    asc = jnp.argsort(jnp.where(valid, scores, jnp.inf))
    planar_ok = valid & (scores <= params.threshold)
    planar_idx, planar_mask = _greedy_select(
        points, asc, planar_ok, params.max_planar, params.distance_threshold)
    # Edge: descending score, require score >= threshold
    # (feature_extracter.cc:128 fails edge only when strictly less).
    desc = jnp.argsort(jnp.where(valid, -scores, jnp.inf))
    edge_ok = valid & (scores >= params.threshold)
    edge_idx, edge_mask = _greedy_select(
        points, desc, edge_ok, params.max_edge, params.distance_threshold)
    return planar_idx, planar_mask, edge_idx, edge_mask, scores


@functools.partial(jax.jit, static_argnames=("params", "chunk"))
def extract_features(points, mask, params: FeatureParams = FeatureParams(),
                     chunk: int = 64):
    """Feature selection for all scans.

    points [N, P, 2], mask [N, P] ->
      planar_idx [N, PL], planar_mask, edge_idx [N, ED], edge_mask, scores [N, P].
    """
    return jax.lax.map(lambda args: _scan_features(args[0], args[1], params),
                       (points, mask), batch_size=chunk)


def preprocess(points, mask,
               feature_params: FeatureParams = FeatureParams(),
               normal_params: NormalParams = NormalParams(),
               config=None, as_numpy: bool = True):
    """Full preprocessing: normals + features.

    When a config is given, the nc_* keys drive the normal estimator
    (reference normal_computation.h:12-17); feature params stay at the
    reference's hardcoded values (slam_types.h:66-67) either way.

    as_numpy=False returns device arrays and skips the device->host
    readback: the downstream problem build (core/problem.build_problem)
    consumes device arrays directly, so large arrays (N=50000's
    [50000, 768, 2] normals are ~300 MB) never make a round trip through
    the host.  Use the default only when the caller truly needs host
    arrays (npz ingest cache, tests).
    """
    if config is not None:
        normal_params = normal_params_from_config(
            config, method=normal_params.method)
    # Bucket the scan count to a multiple of the chunk size: with P already
    # lane-padded (multiples of 128), the set of compiled (chunk, P) shapes
    # stays tiny, so the persistent compile cache nearly always hits —
    # XLA compile latency in this environment is wildly variable, so fresh
    # shapes are expensive.
    chunk = 64
    n = points.shape[0]
    n_pad = ((n + chunk - 1) // chunk) * chunk
    pts = np.zeros((n_pad,) + points.shape[1:], np.asarray(points).dtype)
    msk = np.zeros((n_pad,) + mask.shape[1:], bool)
    pts[:n] = points
    msk[:n] = mask
    normals = compute_normals(jnp.asarray(pts), jnp.asarray(msk),
                              normal_params, chunk=chunk)
    planar_idx, planar_mask, edge_idx, edge_mask, scores = extract_features(
        jnp.asarray(pts), jnp.asarray(msk), feature_params, chunk=chunk)
    out = (normals[:n], planar_idx[:n], planar_mask[:n], edge_idx[:n],
           edge_mask[:n], scores[:n])
    if not as_numpy:
        return out
    return tuple(np.asarray(a) for a in out)
