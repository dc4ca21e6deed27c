#!/usr/bin/env python
"""A/B of association formulations at compute-dominated scale (N=20000).

Question: does the [Q, S, T] distance matrix (S = T = 20 planar / 10
edge), which puts a tiny dim minor, cost more than a pair-minor layout,
and does the argmin + take_along_axis pair read it twice?  The
pair-minor layout (C) won on an earlier accelerator with 128-wide lanes;
this re-runs the A/B on the current device.

Variants (all must match the production path EXACTLY — same fp ops in
the same order per element, first-min argmin semantics):

  A  legacy layout (broadcast diff, [Q, S, T], take_along_axis) — frozen
     here inline so the A/B stays reproducible (correspond.associate
     ships the pair-minor form C)
  B  A but dmin via jnp.min (multi-output reduce fusion, no gather)
  C  pair-minor layout: everything computed as [S, T, Q] / [S, Q] with
     Q minor; matches gathered by one-hot contraction over T.
     == the shipped correspond.associate (parity-tested in
     tests/test_solver.py::test_pair_minor_layout_matches_oracle).

Run on the GPU:  python benchmarks/assoc_ab.py [--nodes 20000]
"""
import argparse
import time

import numpy as np

import _common

import jax
import jax.numpy as jnp

from nautilus_tpu.solve import correspond


def timeit(fn, reps=7):
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def assoc_a(problem, x, pair_src, pair_tgt, window, thr, feature):
    """Variant A: the legacy [Q, S, T] layout with take_along_axis gathers
    (production until round 5; frozen here for the A/B record)."""
    from nautilus_tpu.core import geometry as geo
    if feature == "planar":
        pts, msk, nrm = (problem.planar_points, problem.planar_mask,
                         problem.planar_normals)
    else:
        pts, msk, nrm = (problem.edge_points, problem.edge_mask,
                         problem.edge_normals)
    pair_valid = (pair_src - pair_tgt) <= window

    def one(s, t, pv):
        proj = geo.relative_pose_transform_points(x[s], x[t], pts[s])
        diff = proj[:, None, :] - pts[t][None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(msk[t][None, :], d2, jnp.inf)
        nn = jnp.argmin(d2, axis=-1)
        dmin = jnp.take_along_axis(d2, nn[:, None], axis=-1)[:, 0]
        valid = msk[s] & (dmin < thr ** 2) & pv
        return pts[t][nn], nrm[t][nn], valid

    return jax.vmap(one)(pair_src, pair_tgt, pair_valid)


def assoc_b(problem, x, pair_src, pair_tgt, window, thr, feature):
    """Variant B: min instead of take_along_axis for dmin."""
    from nautilus_tpu.core import geometry as geo
    if feature == "planar":
        pts, msk, nrm = (problem.planar_points, problem.planar_mask,
                         problem.planar_normals)
    else:
        pts, msk, nrm = (problem.edge_points, problem.edge_mask,
                         problem.edge_normals)
    pair_valid = (pair_src - pair_tgt) <= window

    def one(s, t, pv):
        proj = geo.relative_pose_transform_points(x[s], x[t], pts[s])
        diff = proj[:, None, :] - pts[t][None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(msk[t][None, :], d2, jnp.inf)
        nn = jnp.argmin(d2, axis=-1)
        dmin = jnp.min(d2, axis=-1)
        valid = msk[s] & (dmin < thr ** 2) & pv
        return pts[t][nn], nrm[t][nn], valid

    return jax.vmap(one)(pair_src, pair_tgt, pair_valid)


def assoc_c(problem, x, pair_src, pair_tgt, window, thr, feature):
    """Variant C: pair-minor layout — [S, T, Q] with Q on lanes."""
    from nautilus_tpu.core import geometry as geo
    if feature == "planar":
        pts, msk, nrm = (problem.planar_points, problem.planar_mask,
                         problem.planar_normals)
    else:
        pts, msk, nrm = (problem.edge_points, problem.edge_mask,
                         problem.edge_normals)
    pair_valid = (pair_src - pair_tgt) <= window          # [Q]

    # Per-pair projected source points, then transpose Q to the minor axis.
    proj = jax.vmap(geo.relative_pose_transform_points)(
        x[pair_src], x[pair_tgt], pts[pair_src])           # [Q, S, 2]
    projT = jnp.transpose(proj, (1, 2, 0))                 # [S, 2, Q]
    tgtT = jnp.transpose(pts[pair_tgt], (1, 2, 0))         # [T, 2, Q]
    tmskT = jnp.transpose(msk[pair_tgt], (1, 0))           # [T, Q]
    tnrmT = jnp.transpose(nrm[pair_tgt], (1, 2, 0))        # [T, 2, Q]

    diff = projT[:, None] - tgtT[None]                     # [S, T, 2, Q]
    d2 = jnp.sum(diff * diff, axis=2)                      # [S, T, Q]
    d2 = jnp.where(tmskT[None], d2, jnp.inf)
    nn = jnp.argmin(d2, axis=1)                            # [S, Q]
    dmin = jnp.min(d2, axis=1)                             # [S, Q]
    srm = jnp.transpose(msk[pair_src], (1, 0))             # [S, Q]
    valid = srm & (dmin < thr ** 2) & pair_valid[None]     # [S, Q]
    # Gather matched target points/normals by one-hot contraction over the
    # tiny T axis (exact: adds zeros).
    onehot = (nn[:, None, :] ==
              jnp.arange(tgtT.shape[0])[None, :, None])    # [S, T, Q]
    tm = jnp.sum(jnp.where(onehot[:, :, None], tgtT[None], 0.0), axis=1)
    tn = jnp.sum(jnp.where(onehot[:, :, None], tnrmT[None], 0.0), axis=1)
    # Back to the production [Q, S, ...] contract.
    return (jnp.transpose(tm, (2, 0, 1)), jnp.transpose(tn, (2, 0, 1)),
            jnp.transpose(valid, (1, 0)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--beams", type=int, default=360)
    ap.add_argument("--variants", default="ABC",
                    help="subset of ABC to run")
    ap.add_argument("--no-parity", action="store_true")
    args = ap.parse_args()

    state = _common.building_problem(args.nodes, args.beams)
    problem = state.problem
    n = state.num_nodes
    pairs = correspond.make_pairs(n, 10)
    ps, pt = jnp.asarray(pairs.src), jnp.asarray(pairs.tgt)
    x = jnp.asarray(state.solution[:n])
    thr = jnp.asarray(0.25, x.dtype)
    w = jnp.asarray(10, jnp.int32)
    print(f"N={n}, Q={ps.shape[0]}, planar {problem.planar_points.shape}, "
          f"edge {problem.edge_points.shape}")

    a_fn = jax.jit(lambda xx: (
        assoc_a(problem, xx, ps, pt, w, thr, "planar"),
        assoc_a(problem, xx, ps, pt, w, thr, "edge")))
    b_fn = jax.jit(lambda xx: (
        assoc_b(problem, xx, ps, pt, w, thr, "planar"),
        assoc_b(problem, xx, ps, pt, w, thr, "edge")))
    c_fn = jax.jit(lambda xx: (
        assoc_c(problem, xx, ps, pt, w, thr, "planar"),
        assoc_c(problem, xx, ps, pt, w, thr, "edge")))

    times = {}
    for tag, fn, label in (("A", a_fn, "A broadcast+take_along_axis"),
                           ("B", b_fn, "B min-fusion"),
                           ("C", c_fn, "C pair-minor layout")):
        if tag not in args.variants:
            continue
        t0 = time.perf_counter()
        times[tag] = timeit(lambda fn=fn: fn(x))
        rel = (f"  ({times['A']/times[tag]:.2f}x)"
               if "A" in times and tag != "A" else "")
        print(f"{label}: {times[tag]*1e3:7.1f} ms{rel}  "
              f"[compile+warm {time.perf_counter()-t0-7*times[tag]:.0f}s]",
              flush=True)

    if args.no_parity or "A" not in args.variants:
        return
    # Exact parity (matches + masks must be bitwise identical).
    ap_, ae_ = a_fn(x)
    checks = []
    if "B" in args.variants:
        bp, be = b_fn(x)
        checks += [("B planar", ap_, bp), ("B edge", ae_, be)]
    if "C" in args.variants:
        cp, ce = c_fn(x)
        checks += [("C planar", ap_, cp), ("C edge", ae_, ce)]
    for name, ref, var in checks:
        tm, tn, vv = (ref.tgt_pts, ref.tgt_nrm, ref.mask) \
            if hasattr(ref, "tgt_pts") else ref
        vm, vn, vvv = var
        mask = np.asarray(vv)
        np.testing.assert_array_equal(mask, np.asarray(vvv))
        np.testing.assert_array_equal(np.asarray(tm)[mask],
                                      np.asarray(vm)[mask])
        np.testing.assert_array_equal(np.asarray(tn)[mask],
                                      np.asarray(vn)[mask])
        print(f"parity {name}: exact", flush=True)


if __name__ == "__main__":
    main()
