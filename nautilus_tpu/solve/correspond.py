"""Batched correspondence search — the device replacement for KD-tree ICP/ICL.

The reference finds, per pose pair and per source point, the nearest target
point within outlier_threshold via per-point KD-tree queries
(reference src/optimization/solver.cc:132-172 GetPointToPointMatching,
src/util/kdtree.cc:254-305), plus a normal-gated variant with a growing
threshold sweep (solver.cc:177-260 GetPointToNormalMatching).  Here the same
matching runs as masked distance-matrix argmins batched over *all pose pairs
at once*:

- Pair enumeration (i, j in [i - w_max, i)) is static per dataset
  (reference BuildOptimizationOverWindow solver.cc:321-333); the growing
  window enters as a per-pair validity mask, so one compiled program serves
  every window size.
- The growing-threshold sweep of the reference is equivalent to "nearest
  point with similar normal within the max threshold" (each sweep level is
  an early-exit of the same search), which is how the gated variant is
  implemented here.
- Normals are looked up by feature index into the full-cloud normal array,
  preserving the reference's full-cloud-tree normal lookups
  (solver.cc:150-155, 67-77) without the exact-match KD query.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from nautilus_tpu.core import geometry as geo
from nautilus_tpu.core.problem import SLAMProblem
from nautilus_tpu.solve.factors import Correspondences


class PairList(NamedTuple):
    """Static (source, target) pair enumeration for a max window size."""

    src: np.ndarray  # [Q] int32, src > tgt
    tgt: np.ndarray  # [Q] int32


def make_pairs(num_nodes: int, max_window: int) -> PairList:
    """All pairs (i, j) with i - max_window <= j < i (solver.cc:324-331).

    The pair SET matches the reference enumeration; the ORDER is
    delta-major — for each delta = i - j in 1..max_window, all pairs
    (i, i - delta) with i ascending and contiguous.  Factor order is
    irrelevant to the least-squares problem, and this layout lets
    normal-equation assembly accumulate each delta's 6x6 blocks as
    contiguous slice adds into a block band instead of a scatter
    (factors.BandLayout); the scatter was the dominant device cost of
    the LM loop in an earlier profile.
    """
    src, tgt = [], []
    for d in range(1, max_window + 1):
        for i in range(d, num_nodes):
            src.append(i)
            tgt.append(i - d)
    return PairList(np.asarray(src, np.int32), np.asarray(tgt, np.int32))


def _match_pair(src_pts, src_mask, src_nrm, tgt_pts, tgt_mask, tgt_nrm,
                outlier_threshold, normal_gate_cos, pose_s, pose_t,
                use_normal_gate: bool):
    """Match one pair's source features [S, 2] against target features [T, 2].

    Returns (tgt_match [S, 2], tgt_match_nrm [S, 2], valid [S]).

    Parity oracle for `associate` (pair-at-a-time formulation; the
    production path batches with the pair dim minor — see below).
    """
    proj = geo.relative_pose_transform_points(pose_s, pose_t, src_pts)
    diff = proj[:, None, :] - tgt_pts[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)                       # [S, T]
    ok = tgt_mask[None, :]
    if use_normal_gate:
        # Reference FindClosestPointWithSimilarNormal: nearest target whose
        # normal is within 20 deg (|cos| gate) of the source normal.
        sim = jnp.abs(jnp.sum(src_nrm[:, None, :] * tgt_nrm[None, :, :],
                              axis=-1)) > normal_gate_cos
        ok = ok & sim
    d2 = jnp.where(ok, d2, jnp.inf)
    nn = jnp.argmin(d2, axis=-1)                             # [S]
    dmin = jnp.take_along_axis(d2, nn[:, None], axis=-1)[:, 0]
    valid = src_mask & (dmin < outlier_threshold ** 2)
    tgt_match = tgt_pts[nn]
    tgt_match_nrm = tgt_nrm[nn]
    return tgt_match, tgt_match_nrm, valid


@functools.partial(jax.jit, static_argnames=("feature", "use_normal_gate"))
def associate(problem: SLAMProblem, x, pair_src, pair_tgt, window,
              outlier_threshold, feature: str = "planar",
              use_normal_gate: bool = False,
              normal_gate_cos: float = 0.9396926) -> Correspondences:
    """Batched matching for all pairs at the current solution x [N, 3].

    feature: "planar" | "edge" | "all" — which per-node point set to match
    (reference PointcloudType, solver.h:67).  The window enters as a pair
    mask: pairs with src - tgt > window contribute no correspondences.

    Layout: every [S, T]-shaped intermediate is computed with the (huge)
    pair dim Q MINOR — [S, T, Q], [S, Q] — so the minor axis is long and
    dense.  The feature sets are tiny (S = T ~ 10-20 for planar/edge), and
    a [Q, S, T] layout makes the tiny T axis minor.  The layout was chosen
    on an earlier accelerator (128-wide lanes); whether it still wins on
    the H100 is not measured yet (benchmarks/assoc_ab.py runs the A/B;
    ROADMAP.md section 1, core solve layers).  Matched points are gathered by a one-hot
    sum over the tiny T axis (exact: adds zeros).  Results are bitwise
    identical to the pair-at-a-time oracle `_match_pair` (same fp ops per
    element, first-min argmin ties).
    """
    if feature == "planar":
        pts, msk = problem.planar_points, problem.planar_mask
        nrm = problem.planar_normals
    elif feature == "edge":
        pts, msk = problem.edge_points, problem.edge_mask
        nrm = problem.edge_normals
    elif feature == "all":
        pts, msk, nrm = problem.points, problem.points_mask, problem.normals
    else:
        raise ValueError(feature)

    pair_valid = (pair_src - pair_tgt) <= window             # [Q]

    proj = jax.vmap(geo.relative_pose_transform_points)(
        x[pair_src], x[pair_tgt], pts[pair_src])             # [Q, S, 2]
    projT = jnp.transpose(proj, (1, 2, 0))                   # [S, 2, Q]
    tgtT = jnp.transpose(pts[pair_tgt], (1, 2, 0))           # [T, 2, Q]
    tmskT = jnp.transpose(msk[pair_tgt], (1, 0))             # [T, Q]
    tnrmT = jnp.transpose(nrm[pair_tgt], (1, 2, 0))          # [T, 2, Q]

    diff = projT[:, None] - tgtT[None]                       # [S, T, 2, Q]
    d2 = jnp.sum(diff * diff, axis=2)                        # [S, T, Q]
    ok = tmskT[None]
    if use_normal_gate:
        snrmT = jnp.transpose(nrm[pair_src], (1, 2, 0))      # [S, 2, Q]
        sim = jnp.abs(jnp.sum(snrmT[:, None] * tnrmT[None],
                              axis=2)) > normal_gate_cos     # [S, T, Q]
        ok = ok & sim
    d2 = jnp.where(ok, d2, jnp.inf)
    nn = jnp.argmin(d2, axis=1)                              # [S, Q]
    dmin = jnp.min(d2, axis=1)                               # [S, Q]
    srcmT = jnp.transpose(msk[pair_src], (1, 0))             # [S, Q]
    valid = srcmT & (dmin < outlier_threshold ** 2) & pair_valid[None]
    onehot = (nn[:, None, :] ==
              jnp.arange(tgtT.shape[0])[None, :, None])      # [S, T, Q]
    tm = jnp.sum(jnp.where(onehot[:, :, None], tgtT[None], 0.0), axis=1)
    tn = jnp.sum(jnp.where(onehot[:, :, None], tnrmT[None], 0.0), axis=1)
    return Correspondences(
        src=pair_src, tgt=pair_tgt,
        src_pts=pts[pair_src], tgt_pts=jnp.transpose(tm, (2, 0, 1)),
        src_nrm=nrm[pair_src], tgt_nrm=jnp.transpose(tn, (2, 0, 1)),
        mask=jnp.transpose(valid, (1, 0)))


@functools.partial(jax.jit,
                   static_argnames=("feature", "use_normal_gate", "chunk"))
def _associate_mapped(problem: SLAMProblem, x, pair_src, pair_tgt, window,
                      outlier_threshold, feature: str,
                      use_normal_gate: bool, chunk: int) -> Correspondences:
    """ONE device program: lax.map over [n_chunks, chunk] pair blocks.

    The [chunk, P, P] distance-matrix working set stays bounded exactly as
    the old host-side chunk loop did, but the loop runs on device — at
    N=1000/w=10 that is 1 dispatch instead of ~156."""
    n_chunks = pair_src.shape[0] // chunk
    srcs = pair_src.reshape(n_chunks, chunk)
    tgts = pair_tgt.reshape(n_chunks, chunk)

    def body(st):
        s, t = st
        return associate(problem, x, s, t, window, outlier_threshold,
                         feature=feature, use_normal_gate=use_normal_gate)

    out = jax.lax.map(body, (srcs, tgts))
    return jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), out)


def associate_chunked(problem: SLAMProblem, x, pairs: PairList, window,
                      outlier_threshold, feature: str = "all",
                      use_normal_gate: bool = False,
                      chunk: int = 128) -> Correspondences:
    """Chunked variant for full clouds (OptimizationType::ALL): bounds the
    [chunk, P, P] distance-matrix working set in HBM; the chunk loop runs
    on device inside a single dispatch (lax.map)."""
    q = len(pairs.src)
    # Pad the pair list to a chunk multiple so every chunk shares one
    # compiled program; padded pairs are (0, 0) and masked out below.
    q_pad = ((q + chunk - 1) // chunk) * chunk
    src = np.zeros(q_pad, np.int32)
    tgt = np.zeros(q_pad, np.int32)
    src[:q] = pairs.src
    tgt[:q] = pairs.tgt
    out = _associate_mapped(
        problem, x, jnp.asarray(src), jnp.asarray(tgt), window,
        jnp.asarray(outlier_threshold, x.dtype), feature, use_normal_gate,
        chunk)
    valid_rows = jnp.arange(q_pad) < q
    return out._replace(mask=out.mask & valid_rows[:, None])
