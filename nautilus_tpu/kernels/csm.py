"""Correlative scan matching (CSM) as dense 2D correlation.

A JAX rebuild of the reference's third_party CorrelativeScanMatcher
(Olson-style multi-resolution correlative matching; constructed with
(range=30, trans_range=2, low_res=0.3, high_res=0.01) at
src/optimization/solver.h:126 / solver.cc:56,633 and called as
``GetTransformation(cloud_a, cloud_b, angle_a, angle_b,
rotation_restriction)`` -> (score, (translation, rotation))).

Design: the translation search at a fixed rotation is exactly a 2D
cross-correlation between (a) a smeared occupancy lookup table rasterized
from the target cloud and (b) a raster of the rotated source cloud.  That
correlation is a convolution, so the whole (rotation x translation) search
runs as one matrix product with rotations batched in the row dimension,
which XLA hands to the GPU's matrix library.  Two resolutions:

- coarse: low_res cells over the full +-trans_range window, rotation step
  sized so one step moves the farthest point one cell;
- fine: a refinement pyramid around the coarse argmax scored DIRECTLY
  against the K nearest target points of each source point (selected once
  at the coarse optimum).  occ(p) = clip(sum_k exp(-d_pk^2 / 2 sigma^2), 1)
  is exactly the Gaussian-smeared occupancy the reference rasterizes into
  its high-res lookup table, evaluated continuously: no 1 cm raster, no
  per-pair multi-MB tables, and the (rotation x ty x tx) sweep factors into
  two separable exponential tensors contracted in one einsum.

Scores are mean per-source-point log-occupancy, normalized by point
count — monotone with Olson's log-likelihood formulation; the absolute
scale of csm_score_threshold is recalibrated for this engine (see
DEVIATIONS.md).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


class CSMParams(NamedTuple):
    """Defaults mirror the reference ctor (solver.cc:56)."""

    scan_range: float = 30.0       # max scan extent from sensor
    trans_range: float = 2.0       # +- translation search window
    low_res: float = 0.3
    high_res: float = 0.01
    sigma: float = 0.06            # Gaussian smear of the lookup table
    rotation_restriction: float = math.pi / 2   # +- rotation window
    # Nearest target points per source point used by the fine stages.  The
    # Gaussian (sigma ~6 cm) makes anything beyond the first few neighbors
    # irrelevant; 32 leaves a wide margin for dense walls.
    fine_k: int = 32
    # Precision escape hatch for the coarse correlation operands
    # (log-odds patches + raster point counts).  Default bf16 halves the
    # stage's memory traffic and was argmax-parity-verified on the
    # benchmark distribution, but raster counts are only exact in bf16 up
    # to 256 per cell and near-tie scores can round across the argmax;
    # set True to keep both operands f32 for symmetric/degenerate scans.
    # The f32 products are pinned to Precision.HIGHEST, so the GPU does
    # not round them to TF32 (accumulation is f32 either way).
    coarse_f32: bool = False

    @property
    def table_halfwidth(self) -> float:
        return self.scan_range + self.trans_range

    def kernel_cells(self, res: float) -> int:
        return int(round(2 * self.scan_range / res))

    def offset_cells(self, res: float) -> int:
        return int(round(self.trans_range / res))

    def table_cells(self, res: float) -> int:
        # Exactly kernel + 2*offset so VALID correlation covers +-trans_range.
        return self.kernel_cells(res) + 2 * self.offset_cells(res)


def _raster(points, mask, halfwidth, res, cells):
    """Point counts per cell, [cells, cells]; row = y, col = x.

    One-hot contraction instead of scatter-add: img[y, x] =
    sum_p onehotY[p, y] * onehotX[p, x] is one matrix product with no
    write conflicts.  bf16 one-hots are exact (0/1 values, f32
    accumulation); out-of-range indices match no column, so bounds
    checks are implicit.
    """
    ij = jnp.floor((points + halfwidth) / res).astype(jnp.int32)
    cols = jnp.arange(cells, dtype=jnp.int32)
    ohx = (ij[..., 0, None] == cols).astype(jnp.bfloat16)        # [P, cells]
    ohy = ((ij[..., 1, None] == cols) & mask[..., None]).astype(jnp.bfloat16)
    return jnp.einsum("py,px->yx", ohy, ohx,
                      preferred_element_type=jnp.float32)


def _smear_log_table(raster, res, sigma):
    """Gaussian-blur occupancy -> log table, via separable conv."""
    radius = max(int(round(3 * sigma / res)), 1)
    xs = jnp.arange(-radius, radius + 1, dtype=jnp.float32) * res
    kern = jnp.exp(-0.5 * (xs / sigma) ** 2)
    img = raster[None, None]                      # NCHW
    k1 = kern[None, None, :, None]
    k2 = kern[None, None, None, :]
    pad = [(radius, radius), (0, 0)]
    img = jax.lax.conv_general_dilated(img, k1, (1, 1), pad,
                                       precision=HIGHEST)
    pad = [(0, 0), (radius, radius)]
    img = jax.lax.conv_general_dilated(img, k2, (1, 1), pad,
                                       precision=HIGHEST)
    occ = jnp.clip(img[0, 0], 0.0, 1.0)
    return jnp.log(occ + 1e-6)


def _rotate(points, theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    x, y = points[..., 0], points[..., 1]
    return jnp.stack([c * x - s * y, s * x + c * y], axis=-1)


def _correlate(table, kernels):
    """scores[r, oy, ox] = sum_xy kernels[r, x, y] * table[x+oy, y+ox].

    table [H, W]; kernels [R, h, w]; VALID correlation via conv with the
    kernel as filter (conv flips nothing here because we index directly).
    """
    inp = table[None, None]                      # [1, 1, H, W]
    filt = kernels[:, None]                      # [R, 1, h, w]
    out = jax.lax.conv_general_dilated(
        inp, filt, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return out[0]                                # [R, OH, OW]


def _correlate_matmul(table, kernels, operand_dtype=jnp.bfloat16):
    """Same contract as _correlate, as an im2col matmul.

    The offset grid is tiny (~15x15), so unrolled static slices + ONE
    [R, h*w] @ [h*w, OH*OW] dot replace a single-channel conv.
    """
    r, kh, kw = kernels.shape
    oh = table.shape[0] - kh + 1
    ow = table.shape[1] - kw + 1
    patches = jnp.stack(
        [jax.lax.dynamic_slice(table, (oy, ox), (kh, kw)).reshape(-1)
         for oy in range(oh) for ox in range(ow)], axis=1)   # [kh*kw, OH*OW]
    # bf16 operand storage, f32 accumulation: the patches tensor is the
    # engine's memory-traffic hot spot and the coarse stage only has to
    # get the argmax cell right (the fine stages rescore continuously);
    # argmax parity vs f32 verified in benchmarks/csm_coarse_probe.py
    # and the stage-vs-pair engine parity tests.  CSMParams.coarse_f32
    # switches operand_dtype to f32 for out-of-distribution scans.
    scores = jax.lax.dot(kernels.reshape(r, -1).astype(operand_dtype),
                         patches.astype(operand_dtype),
                         precision=_coarse_precision(operand_dtype),
                         preferred_element_type=jnp.float32)
    return scores.reshape(r, oh, ow)


def _coarse_precision(operand_dtype):
    """HIGHEST for f32 coarse operands (no TF32 rounding on the GPU)."""
    return HIGHEST if jnp.dtype(operand_dtype) == jnp.float32 else None


def _search_stage(table_log, src_points, src_mask, thetas, res,
                  scan_range, trans_range, operand_dtype=jnp.bfloat16):
    """Score the full (theta x translation) grid at one resolution.

    Geometry: the table spans [-hw, hw] with hw = scan_range + trans_range;
    the source raster spans [-scan_range, scan_range].  A VALID correlation
    of (table, raster) then yields offsets o in [0, 2*trans_range/res] with
    implied translation t = o*res - trans_range along each axis.

    Returns scores [R, OT, OT] with OT = 2*round(trans_range/res) + 1.
    """
    cells_k = int(round(2 * scan_range / res))
    rot = jax.vmap(lambda t: _rotate(src_points, t))(thetas)     # [R, P, 2]
    rasters = jax.vmap(
        lambda pts: _raster(pts, src_mask, scan_range, res, cells_k))(rot)
    return _correlate_matmul(table_log, rasters, operand_dtype)


def _fine_rot_count(prev_rot_step, rot_step, cap=33):
    """Odd rotation count for a refinement stage.

    The optimum can sit anywhere between two previous-stage rotation
    samples, so the stage's offsets (+-(n//2) * rot_step) must cover at
    least +- half the previous spacing.  The earlier ceil(prev/rot)|1
    under-covered by up to half a fine step — a systematic argmax miss
    caught by the exhaustive lookup oracle (tests/test_csm_oracle.py).

    cap bounds the stage tensor ([R, W, W] scores) for pathological
    resolution ratios; the standard pyramid needs at most
    low_res/(5*high_res)+2, so 33 covers ratios to ~150x before coverage
    degrades again (a config that extreme mis-sets low_res/high_res)."""
    need = 2 * int(np.ceil(prev_rot_step / (2.0 * rot_step))) + 1
    return min(max(need, 3), cap)


def _argmax3(scores):
    flat = jnp.argmax(scores)
    r = flat // (scores.shape[1] * scores.shape[2])
    rem = flat % (scores.shape[1] * scores.shape[2])
    return r, rem // scores.shape[2], rem % scores.shape[2]


def _stage_resolutions(params: CSMParams):
    mid_res = max(params.high_res * 5.0, params.high_res)
    return [params.low_res, mid_res, params.high_res]


@functools.partial(jax.jit, static_argnames=("params",))
def build_tables(cloud_b, mask_b, params: CSMParams = CSMParams()):
    """Per-target matcher state: coarse lookup table + the raw cloud.

    Only the coarse stage uses a rasterized table; the fine stages score
    continuous Gaussian distances against the target points directly, so
    the reference's per-pair high-res raster (third_party CSM; 1 cm cells
    over the full scan extent) has no equivalent here.  Amortize over many
    sources with csm_match_to_tables."""
    halfwidth = params.table_halfwidth
    res = params.low_res
    table_lo = _smear_log_table(
        _raster(cloud_b, mask_b, halfwidth, res, params.table_cells(res)),
        res, max(params.sigma, res * 0.5))
    # Masked target points are parked far away instead of carrying a mask:
    # their Gaussian contribution underflows to exactly 0.
    parked = jnp.where(mask_b[:, None], cloud_b.astype(jnp.float32), 1e3)
    return (table_lo, parked)


@functools.partial(jax.jit, static_argnames=("params",))
def csm_match_to_tables(tables, cloud_a, mask_a,
                        params: CSMParams = CSMParams(),
                        rotation_center=0.0):
    """Match one source cloud against prebuilt target tables.

    rotation_center seeds the +-rotation_restriction search window — the
    reference's GetTransformation takes both scans' solution headings and
    centers its rotation search on the solution-implied relative rotation
    (solver.cc:634-638); pass angle_a - angle_b (wrapped) here.  A traced
    scalar, so per-pair centers batch without recompiles."""
    n_valid = jnp.maximum(jnp.sum(mask_a.astype(jnp.float32)), 1.0)
    table_lo, tgt_points = tables
    rot_step_lo = params.low_res / params.scan_range
    n_rot = max(int(np.ceil(2 * params.rotation_restriction / rot_step_lo)), 1)
    thetas_lo = (rotation_center - params.rotation_restriction
                 + (jnp.arange(n_rot) + 0.5) * (2 * params.rotation_restriction
                                                / n_rot))
    offset_lo = params.offset_cells(params.low_res)
    scores_lo = _search_stage(table_lo, cloud_a, mask_a, thetas_lo,
                              params.low_res, params.scan_range,
                              params.trans_range,
                              jnp.float32 if params.coarse_f32
                              else jnp.bfloat16)
    r0, oy0, ox0 = _argmax3(scores_lo)
    theta0 = thetas_lo[r0]
    ty0 = (oy0 - offset_lo).astype(jnp.float32) * params.low_res
    tx0 = (ox0 - offset_lo).astype(jnp.float32) * params.low_res

    # ---- refinement pyramid: direct Gaussian stages around the optimum ---
    # Each stage narrows translation to +-1 previous cell and rotation to
    # +- half the previous rotation step.  All stages share one neighbor
    # set selected at the coarse optimum: the largest fine-pose displacement
    # (0.3 m translation + rotation jitter) is well inside the margin after
    # which the Gaussian (sigma ~6 cm) underflows anyway.
    _, mid_res, _ = _stage_resolutions(params)
    neighbors = _nearest_targets(
        _rotate(cloud_a, theta0) + jnp.stack([tx0, ty0]),
        tgt_points, params.fine_k)
    stages = [
        # (res, rot_step, prev_res, prev_rot_step)
        (mid_res, mid_res / params.scan_range, params.low_res, rot_step_lo),
        (params.high_res, params.high_res / params.scan_range,
         mid_res, mid_res / params.scan_range),
    ]
    theta = theta0
    tx, ty = tx0, ty0
    best = scores_lo[r0, oy0, ox0]
    for res, rot_step, prev_res, prev_rot_step in stages:
        n_rot = _fine_rot_count(prev_rot_step, rot_step)
        thetas = theta + (jnp.arange(n_rot) - n_rot // 2) * rot_step
        offset_cells = int(round(prev_res / res))
        scores, t_grid = _refine_direct(cloud_a, mask_a, neighbors, thetas,
                                        res, offset_cells, tx, ty,
                                        params.sigma)
        r1, oy1, ox1 = _argmax3(scores)
        theta = thetas[r1]
        ty = t_grid[0][oy1]
        tx = t_grid[1][ox1]
        best = scores[r1, oy1, ox1]
    return best / n_valid, jnp.stack([tx, ty, theta])


@functools.partial(jax.jit, static_argnames=("params",))
def csm_match(cloud_a, mask_a, cloud_b, mask_b,
              params: CSMParams = CSMParams(),
              rotation_center=0.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Find the rigid transform aligning cloud_a onto cloud_b.

    Returns (score, [tx, ty, theta]): applying R(theta) then translation to
    cloud_a points best overlays them on cloud_b (both in sensor frames) —
    the contract of the reference's GetTransformation
    (solver.cc:634-638).  rotation_center seeds the rotation window with
    the solution-implied relative heading angle_a - angle_b (the
    reference's angle_a/angle_b arguments); theta in the result is
    absolute, not center-relative.
    Score is mean log-occupancy per valid source point (higher = better).
    """
    return csm_match_to_tables(build_tables(cloud_b, mask_b, params),
                               cloud_a, mask_a, params, rotation_center)


@functools.partial(jax.jit, static_argnames=("params",))
def _match_many(tables, A, MA, params, centers):
    return jax.lax.map(
        lambda am: csm_match_to_tables(tables, am[0], am[1], params, am[2]),
        (A, MA, centers), batch_size=2)


def wrap_angle(a):
    """Wrap to (-pi, pi] (host or device arrays)."""
    return np.arctan2(np.sin(a), np.cos(a))


def csm_match_pairs(points, masks, src_idx, tgt_idx,
                    params: CSMParams = CSMParams(),
                    rotation_centers=None, engine: str = "stage"):
    """Arbitrary (source, target) pair list in ONE device dispatch.

    Pads the pair count to a power of two (repeating pair 0) so varying
    loop-closure workloads reuse a handful of compiled shapes.  Preferred
    over csm_match_grouped: table building is cheap since the fine stages
    went table-free, and one dispatch replaces one per target.

    rotation_centers: optional [Q] per-pair rotation-search centers
    (solution-implied relative headings); defaults to zero.

    engine: "stage" (default) = stage-major batch engine
    (csm_match_batch_sm): the per-pair small-op tail fuses across the
    pair dimension, the four pair gathers collapse into one tiny device
    program, the outputs into one packed readback, and the coarse
    patches are stored in bf16; "pair" = the pair-major lax.map engine.
    Outputs agree to 1e-5 (parity-tested).  Which engine is faster on
    the H100 is not measured yet.
    """
    src_idx = np.asarray(src_idx)
    tgt_idx = np.asarray(tgt_idx)
    q = len(src_idx)
    if q == 0:
        return np.zeros(0, np.float32), np.zeros((0, 3), np.float32)
    if rotation_centers is None:
        rotation_centers = np.zeros(q, np.float32)
    rotation_centers = np.asarray(rotation_centers, np.float32)
    g = 1
    while g < q:
        g *= 2
    pad = np.concatenate([np.arange(q), np.zeros(g - q, np.int64)])
    if engine == "stage":
        # Two device programs: a tiny N-dependent gather (compiles in
        # seconds per node-count bucket) feeding the heavy N-independent
        # stage engine, outputs packed into one readback — see
        # _gather_pairs/_match_gathered_sm for why the gathers must NOT
        # live inside the heavy program.
        a, ma, b, mb = _gather_pairs(
            jnp.asarray(points), jnp.asarray(masks),
            jnp.asarray(np.stack([src_idx[pad], tgt_idx[pad]])
                        .astype(np.int32)))
        packed = np.asarray(_match_gathered_sm(
            a, ma, b, mb, jnp.asarray(rotation_centers[pad]), params))
        return (packed[:q, 0].astype(np.float32),
                packed[:q, 1:4].astype(np.float32))
    else:
        s, tr = csm_match_batch(points[src_idx[pad]], masks[src_idx[pad]],
                                points[tgt_idx[pad]], masks[tgt_idx[pad]],
                                params,
                                rotation_centers=rotation_centers[pad])
    return np.asarray(s)[:q], np.asarray(tr)[:q]


def csm_match_grouped(points, masks, src_idx, tgt_idx,
                      params: CSMParams = CSMParams()):
    """Pair matching grouped by target: tables built once per unique target.

    points [N, P, 2], masks [N, P]; src_idx/tgt_idx are host int arrays.
    Returns (scores [Q], transforms [Q, 3]) aligned with the input pairs.
    """
    src_idx = np.asarray(src_idx)
    tgt_idx = np.asarray(tgt_idx)
    q = len(src_idx)
    scores = np.zeros(q, np.float32)
    transforms = np.zeros((q, 3), np.float32)

    for t in np.unique(tgt_idx):
        rows = np.nonzero(tgt_idx == t)[0]
        # Power-of-two group padding (repeat row 0) so group-size variety
        # doesn't churn compiled shapes.
        g = 2
        while g < len(rows):
            g *= 2
        padded = np.concatenate([rows, np.full(g - len(rows), rows[0])])
        tables = build_tables(points[int(t)], masks[int(t)], params)
        s, tr = _match_many(tables, points[src_idx[padded]],
                            masks[src_idx[padded]], params,
                            jnp.zeros(len(padded), jnp.float32))
        scores[rows] = np.asarray(s)[:len(rows)]
        transforms[rows] = np.asarray(tr)[:len(rows)]
    return scores, transforms


def _nearest_targets(coarse_aligned_src, tgt_points, k: int):
    """[P, K, 2] nearest target points per coarse-aligned source point.

    Masked targets were parked at 1e3 by build_tables, so they sort last
    and contribute zero Gaussian mass if ever selected.
    """
    d2 = jnp.sum((coarse_aligned_src[:, None, :].astype(jnp.float32)
                  - tgt_points[None, :, :]) ** 2, axis=-1)       # [P, Q]
    _, idx = jax.lax.top_k(-d2, k)                               # [P, K]
    return tgt_points[idx]                                       # [P, K, 2]


def _refine_direct(src_points, src_mask, neighbors, thetas, res,
                   offset_cells, tx0, ty0, sigma):
    """Fine stage scored directly against per-point neighbor targets.

    occ(p) = clip(sum_k exp(-||R(theta) p + t - q_pk||^2 / 2 sigma^2), 1)
    is the Gaussian-smeared occupancy the reference reads from its 1 cm
    raster, evaluated continuously.  The squared distance is separable
    ((dx+tx)^2 + (dy+ty)^2), so exp factors into per-axis tensors and the
    whole (ty x tx) window is one contraction over the neighbors.

    Returns (scores [R, W, W], (ty_grid [W], tx_grid [W])).
    """
    win = 2 * offset_cells + 1
    inv = 1.0 / (2.0 * sigma * sigma)
    steps = (jnp.arange(win) - offset_cells).astype(jnp.float32) * res
    ty = ty0 + steps                                             # [W]
    tx = tx0 + steps
    rot = jax.vmap(lambda t: _rotate(src_points, t))(thetas)     # [R, P, 2]
    dx = rot[..., 0, None] - neighbors[None, ..., 0]             # [R, P, K]
    dy = rot[..., 1, None] - neighbors[None, ..., 1]
    ex = jnp.exp(-(dx[:, None] + tx[None, :, None, None]) ** 2 * inv)
    ey = jnp.exp(-(dy[:, None] + ty[None, :, None, None]) ** 2 * inv)
    occ = jnp.einsum("rwpk,rvpk->rwvp", ey, ex,
                     precision=jax.lax.Precision.HIGHEST)        # [R,Wy,Wx,P]
    vals = jnp.log(jnp.clip(occ, 0.0, 1.0) + 1e-6)
    vals = jnp.where(src_mask[None, None, None, :], vals, 0.0)
    return jnp.sum(vals, axis=-1), (ty, tx)                      # [R, W, W]


# ---------------------------------------------------------------------------
# Stage-major batched matching: all pairs advance through each stage
# together, with the coarse rotation sweep chunked.  Compared to the
# pair-major lax.map (csm_match_batch), every small op — raster one-hots,
# refinement gathers, argmaxes — fuses across the pair dimension instead of
# running as a long tail of small per-pair programs.  Same outputs as
# csm_match (parity-tested).
# ---------------------------------------------------------------------------

def _raster_rot_batch(points, mask, thetas, halfwidth, res, cells):
    """Rasters of ``points`` under each rotation: [B, R, cells, cells].

    points [B, P, 2], mask [B, P], thetas [B, R].  One-hot contraction,
    batched over pairs AND rotations.
    """
    c = jnp.cos(thetas)[..., None]                   # [B, R, 1]
    s = jnp.sin(thetas)[..., None]
    x = points[:, None, :, 0]                        # [B, 1, P]
    y = points[:, None, :, 1]
    rx = c * x - s * y                               # [B, R, P]
    ry = s * x + c * y
    ix = jnp.floor((rx + halfwidth) / res).astype(jnp.int32)
    iy = jnp.floor((ry + halfwidth) / res).astype(jnp.int32)
    cols = jnp.arange(cells, dtype=jnp.int32)
    ohx = (ix[..., None] == cols).astype(jnp.bfloat16)          # [B,R,P,C]
    ohy = ((iy[..., None] == cols)
           & mask[:, None, :, None]).astype(jnp.bfloat16)
    return jnp.einsum("brpy,brpx->bryx", ohy, ohx,
                      preferred_element_type=jnp.float32)


def _im2col(table, kh, kw):
    """[O, kh*kw] patches of one table (O = OH*OW static)."""
    oh = table.shape[0] - kh + 1
    ow = table.shape[1] - kw + 1
    return jnp.stack(
        [jax.lax.dynamic_slice(table, (oy, ox), (kh, kw)).reshape(-1)
         for oy in range(oh) for ox in range(ow)], axis=0)


def _match_chunk_sm(cloud_a, mask_a, cloud_b, mask_b, centers,
                    params: CSMParams, rot_chunk: int):
    """Stage-major matching of one pair chunk.  All arrays carry a leading
    chunk dim; returns (scores [C], transforms [C, 3])."""
    C = cloud_a.shape[0]
    n_valid = jnp.maximum(jnp.sum(mask_a.astype(jnp.float32), axis=1), 1.0)
    tables = jax.vmap(lambda b, m: build_tables(b, m, params))(
        cloud_b, mask_b)
    table_lo, tgt_points = tables                    # [C, T, T], [C, Q, 2]

    res = params.low_res
    cells_k = params.kernel_cells(res)
    offset_lo = params.offset_cells(res)
    # bf16 patch storage: the [C, O, kh*kw] patches tensor is re-read
    # every rot-chunk scan step and dominates the engine's memory
    # traffic; bf16 halves it.  Accumulation in the correlation dot stays
    # f32.  CSMParams.coarse_f32 opts out for scans outside the verified
    # argmax-parity distribution (and pins HIGHEST precision).
    coarse_dt = jnp.float32 if params.coarse_f32 else jnp.bfloat16
    patches = jax.vmap(lambda t: _im2col(t, cells_k, cells_k))(
        table_lo).astype(coarse_dt)

    rot_step_lo = res / params.scan_range
    n_rot = max(int(np.ceil(2 * params.rotation_restriction / rot_step_lo)),
                1)
    n_rot_pad = -(-n_rot // rot_chunk) * rot_chunk
    base = (-params.rotation_restriction
            + (jnp.arange(n_rot_pad) + 0.5) * (2 * params.rotation_restriction
                                               / n_rot))
    thetas = centers[:, None] + base[None, :]        # [C, n_rot_pad]
    # Padded rotations replicate the last real angle (same argmax result).
    thetas = jnp.where(jnp.arange(n_rot_pad)[None, :] < n_rot, thetas,
                       thetas[:, n_rot - 1, None])
    thetas_c = thetas.reshape(C, -1, rot_chunk).transpose(1, 0, 2)

    n_off = 2 * offset_lo + 1

    def rot_chunk_body(carry, th_chunk):
        best, bth, boy, box = carry
        rasters = _raster_rot_batch(cloud_a, mask_a, th_chunk,
                                    params.scan_range, res, cells_k)
        scores = jnp.einsum(
            "brk,bok->bro",
            rasters.reshape(C, rot_chunk, -1).astype(coarse_dt),
            patches, precision=_coarse_precision(coarse_dt),
            preferred_element_type=jnp.float32)  # [C, rc, O]
        flat = scores.reshape(C, -1)
        k = jnp.argmax(flat, axis=1)
        v = jnp.take_along_axis(flat, k[:, None], axis=1)[:, 0]
        r = k // (n_off * n_off)
        oy = (k % (n_off * n_off)) // n_off
        ox = k % n_off
        better = v > best
        best = jnp.where(better, v, best)
        bth = jnp.where(better,
                        jnp.take_along_axis(th_chunk, r[:, None],
                                            axis=1)[:, 0], bth)
        boy = jnp.where(better, oy, boy)
        box = jnp.where(better, ox, box)
        return (best, bth, boy, box), None

    init = (jnp.full((C,), -jnp.inf, jnp.float32),
            jnp.zeros((C,), jnp.float32),
            jnp.zeros((C,), jnp.int32), jnp.zeros((C,), jnp.int32))
    (best, theta0, oy0, ox0), _ = jax.lax.scan(rot_chunk_body, init,
                                               thetas_c)
    ty0 = (oy0 - offset_lo).astype(jnp.float32) * res
    tx0 = (ox0 - offset_lo).astype(jnp.float32) * res

    # Refinement pyramid, batched over the chunk (same stages/geometry as
    # csm_match_to_tables).
    _, mid_res, _ = _stage_resolutions(params)
    aligned = jax.vmap(_rotate)(cloud_a, theta0) \
        + jnp.stack([tx0, ty0], axis=-1)[:, None, :]
    neighbors = jax.vmap(lambda a, t: _nearest_targets(a, t, params.fine_k))(
        aligned, tgt_points)                          # [C, P, K, 2]
    stages = [
        (mid_res, mid_res / params.scan_range, params.low_res, rot_step_lo),
        (params.high_res, params.high_res / params.scan_range,
         mid_res, mid_res / params.scan_range),
    ]
    theta, tx, ty = theta0, tx0, ty0
    for res_s, rot_step, prev_res, prev_rot_step in stages:
        n_rot_f = _fine_rot_count(prev_rot_step, rot_step)
        th = theta[:, None] + ((jnp.arange(n_rot_f) - n_rot_f // 2)
                               * rot_step)[None, :]   # [C, Rf]
        offs = int(round(prev_res / res_s))
        scores, grids = jax.vmap(
            lambda a, m, nb, t, x0, y0: _refine_direct(
                a, m, nb, t, res_s, offs, x0, y0, params.sigma)
        )(cloud_a, mask_a, neighbors, th, tx, ty)     # [C, Rf, W, W]
        r1, oy1, ox1 = jax.vmap(_argmax3)(scores)
        idx = jnp.arange(C)
        theta = th[idx, r1]
        ty = grids[0][idx, oy1]
        tx = grids[1][idx, ox1]
        best = scores[idx, r1, oy1, ox1]
    return best / n_valid, jnp.stack([tx, ty, theta], axis=-1)


@functools.partial(jax.jit, static_argnames=("params", "pair_chunk",
                                             "rot_chunk"))
def csm_match_batch_sm(clouds_a, masks_a, clouds_b, masks_b,
                       params: CSMParams = CSMParams(),
                       rotation_centers=None, pair_chunk: int = 4,
                       rot_chunk: int = 32):
    """Stage-major batched matching (same contract as csm_match_batch).

    Pair count must be a multiple of pair_chunk (csm_match_pairs'
    power-of-two padding guarantees it for pair_chunk in {1, 2, 4}).
    The outer jit keeps the reshapes/gathers around the lax.map in the
    same program instead of dispatching them one by one.
    """
    q = clouds_a.shape[0]
    if rotation_centers is None:
        rotation_centers = jnp.zeros(q, jnp.float32)
    pc = min(pair_chunk, q)
    nc = q // pc
    shape = lambda a: a.reshape((nc, pc) + a.shape[1:])
    s, tr = jax.lax.map(
        lambda args: _match_chunk_sm(*args, params=params,
                                     rot_chunk=rot_chunk),
        (shape(clouds_a), shape(masks_a), shape(clouds_b), shape(masks_b),
         shape(jnp.asarray(rotation_centers, jnp.float32))))
    return s.reshape(q), tr.reshape(q, 3)


@jax.jit
def _gather_pairs(points, masks, pair_idx):
    """One tiny device program for all four pair gathers.

    csm_match_pairs' production path: the four gathers (points[src],
    masks[src], points[tgt], masks[tgt]) run as one program (indices
    packed into one [2, G] upload) instead of four eager dispatches, and
    the [G, S, 2] outputs stay on device to feed the stage engine.

    Deliberately a SEPARATE program from the heavy stage-major batch: the
    gather's shape signature depends on the full node count N, so putting
    it inside the batch program would recompile the whole engine for
    every node-count bucket a session visits.  This program is
    N-dependent but trivial to compile; the engine below stays
    N-independent."""
    return (points[pair_idx[0]], masks[pair_idx[0]],
            points[pair_idx[1]], masks[pair_idx[1]])


@functools.partial(jax.jit, static_argnames=("params", "pair_chunk",
                                             "rot_chunk"))
def _match_gathered_sm(a, ma, b, mb, centers, params: CSMParams,
                       pair_chunk: int = 4, rot_chunk: int = 32):
    """Stage-major batch with (score, transform) packed into ONE [G, 4]
    readback instead of two device-to-host copies.
    Shape signature depends only on (G, S, params) — node-count
    independent, so one compile serves every problem size."""
    s, tr = csm_match_batch_sm(a, ma, b, mb, params,
                               rotation_centers=centers,
                               pair_chunk=pair_chunk, rot_chunk=rot_chunk)
    return jnp.concatenate([s[:, None], tr], axis=1)


@functools.partial(jax.jit, static_argnames=("params", "inner_batch"))
def csm_match_batch(clouds_a, masks_a, clouds_b, masks_b,
                    params: CSMParams = CSMParams(), inner_batch: int = 2,
                    rotation_centers=None):
    """Batched matching over candidate pairs (loop-closure workload).

    One jitted program (single dispatch) that maps over pairs with a small
    inner vmap width.  inner_batch=2 was chosen on an earlier accelerator
    (wider vmaps blow up the coarse one-hot raster intermediates
    [B, R, P, cells]) and has not been measured on the H100 yet; the CSM
    item of ROADMAP.md section 1 re-decides it.

    rotation_centers: optional [B] per-pair rotation-search centers.
    """
    if rotation_centers is None:
        rotation_centers = jnp.zeros(clouds_a.shape[0], jnp.float32)
    return jax.lax.map(
        lambda args: csm_match(*args[:4], params=params,
                               rotation_center=args[4]),
        (clouds_a, masks_a, clouds_b, masks_b, rotation_centers),
        batch_size=inner_batch)
