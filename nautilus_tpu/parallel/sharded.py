"""Multi-chip scaling: factor-parallel normal-equation assembly over a Mesh.

The reference is a single-process CPU program (SURVEY.md §2c); its only
intra-solve parallelism is OpenMP loops inside residual evaluation.  The
multi-device scaling story here shards the *factor dimension* — the pose-pair
correspondence lists, odometry factors, and HITL participations — across a
``jax.sharding.Mesh`` axis:

- each device evaluates residuals + per-factor 6x6 blocks for its shard of
  factors (pure local compute, no communication),
- partial dense H/g/cost are reduced with ``psum`` over the mesh axis
  (one all-reduce riding ICI per LM iteration),
- the damped Cholesky solve and pose update run replicated (H is small —
  3M x 3M for M poses — so replicating the solve is cheaper than a
  distributed factorization at any realistic pose-graph size).

This is data-parallelism over factors, expressed with shard_map so the
collective pattern is explicit and stable under scaling.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from nautilus_tpu.solve.factors import (FactorGraph,
                                        assemble_normal_equations, total_cost)
from nautilus_tpu.solve.lm import LMParams, LMResult, lm_loop


def _pad_leading(arr, target: int):
    pad = target - arr.shape[0]
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, widths)  # zeros: padded factors are fully masked


def pad_graph(graph: FactorGraph, num_shards: int) -> FactorGraph:
    """Pad every factor list to a multiple of num_shards.

    Padded entries have mask=False (jnp.pad zero-fills bool masks) and index
    0, so they contribute exactly nothing to H/g/cost.
    """

    def pad_component(comp):
        n = comp[0].shape[0]
        target = ((n + num_shards - 1) // num_shards) * num_shards
        if n == 0:
            # Give empty factor sets one masked row per shard so shard_map
            # has a nonzero local size.
            target = num_shards
        return type(comp)(*[_pad_leading(jnp.asarray(a), target)
                            for a in comp])

    return FactorGraph(*[pad_component(c) for c in graph])


def graph_pspec(graph: FactorGraph) -> FactorGraph:
    """PartitionSpec pytree: every factor array sharded on its leading dim."""
    return jax.tree.map(lambda _: P("factors"), graph)


def make_sharded_fns(mesh: Mesh, graph: FactorGraph):
    """Returns (assemble_fn, cost_fn) with factor-sharded evaluation.

    The returned closures take the replicated dof array x and produce
    replicated (H, g, cost) via psum over the 'factors' axis.
    """
    gspec = graph_pspec(graph)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(), gspec), out_specs=(P(), P(), P()),
        check_vma=False)
    def _assemble(x, local_graph):
        H, g, cost = assemble_normal_equations(x, local_graph)
        H = jax.lax.psum(H, "factors")
        g = jax.lax.psum(g, "factors")
        cost = jax.lax.psum(cost, "factors")
        return H, g, cost

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(), gspec), out_specs=P(),
        check_vma=False)
    def _cost(x, local_graph):
        return jax.lax.psum(total_cost(x, local_graph), "factors")

    return (lambda x: _assemble(x, graph)), (lambda x: _cost(x, graph))


def sharded_lm_solve(x0, graph: FactorGraph, fixed_dof, mesh: Mesh,
                     params: LMParams = LMParams()) -> LMResult:
    """LM solve with factor-parallel assembly across the mesh.

    Drop-in equivalent of solve.lm.lm_solve for multi-chip execution; the
    full loop is jitted once, with one (H, g, cost) psum per accepted step.
    """
    num = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    graph = pad_graph(graph, num)
    # Place factor shards / replicate x explicitly so jit does not need to
    # guess layouts.
    graph = jax.device_put(
        graph, jax.tree.map(lambda s: NamedSharding(mesh, s),
                            graph_pspec(graph)))
    x0 = jax.device_put(x0, NamedSharding(mesh, P()))
    fixed_dof = jax.device_put(fixed_dof, NamedSharding(mesh, P()))
    assemble_fn, cost_fn = make_sharded_fns(mesh, graph)

    @functools.partial(jax.jit, static_argnames=())
    def run(x0, fixed_dof):
        return lm_loop(x0, assemble_fn, cost_fn, fixed_dof, params)

    return run(x0, fixed_dof)


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()[: (n_devices or len(jax.devices()))]
    return Mesh(np.asarray(devs), axis_names=("factors",))


# ---------------------------------------------------------------------------
# Fully sharded growing-window sweep: association + assembly + LM, one
# shard_map program.
# ---------------------------------------------------------------------------

def _pad_to_multiple(arr, mult: int, axis: int = 0):
    n = arr.shape[axis]
    target = ((n + mult - 1) // mult) * mult if n else mult
    if target == n:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return jnp.pad(arr, widths)


def sharded_sweep(x, problem, pair_src, pair_tgt, odom, hitl, fixed_dof,
                  outlier, w_min: int, w_max: int, mesh: Mesh,
                  lm_params: LMParams = LMParams(),
                  use_normal_gate: bool = False,
                  use_band: bool = False, lr=None, analytic=True):
    """The full OptimizeOverGrowingWindow, multi-chip.

    Everything per-factor is sharded over the 'factors' mesh axis:
    - the correspondence pair list (association runs locally per shard —
      problem arrays are replicated, gathers are local),
    - odometry + HITL factor lists,
    and each LM step all-reduces the assembled normal equations with one
    psum.  The damped solve and pose update run replicated.  Returns
    (x, initial_costs, final_costs, iterations) like solver._fused_sweep.

    use_band: assemble shard-locally into block-band form
    (factors.assemble_banded_scatter) and psum the O(N w) band instead of
    the O(N^2) dense H — at N=1000, w=10 that is ~400 KB of ICI traffic
    per accepted LM step instead of ~37 MB (~90x less) — and solve with
    the block-band Cholesky.  Requires all odometry factors in-band
    (|i - j| <= w_max; the single-chip Solver._band_eligible check).

    lr: optional long-range loop-closure OdomFactors (Solver.
    _long_range_factors()).  With use_band, these shard over the mesh
    like everything else: each device linearizes its slice into DISJOINT
    global columns of the Woodbury low-rank block U (global column
    indexing by axis index), so the psum of the placed local blocks is
    exactly the full U and applied closures keep the O(N w) band path
    instead of forcing the dense fallback.  Without use_band, fold lr
    into ``odom`` instead.
    """
    from nautilus_tpu.solve import correspond
    from nautilus_tpu.solve.factors import (FactorGraph,
                                            assemble_banded_scatter,
                                            lowrank_factor_columns)
    from nautilus_tpu.solve.lm import lm_loop_banded

    num = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    n_nodes = problem.num_nodes
    # Band half-width: clamped to the graph size (a 5-node graph with
    # w_max=10 must not build length-10 band levels), validated against
    # the actual odometry factor deltas — an out-of-band block would be
    # silently dropped by the scatter, not raised.
    w_band = min(w_max, max(n_nodes - 1, 0))
    if use_band:
        deltas = np.abs(np.asarray(odom.i) - np.asarray(odom.j))
        if deltas.size and int(deltas.max()) > w_band:
            raise ValueError(
                f"use_band=True requires all odometry factors within "
                f"|i - j| <= {w_band}; found delta {int(deltas.max())}.")
        # Caller-supplied pair lists are arbitrary (make_pairs output is
        # in-band by construction, but the public signature accepts any
        # src/tgt arrays) and an out-of-band correspondence block would
        # be silently dropped by assemble_banded_scatter's scatter.
        pd = np.abs(np.asarray(pair_src) - np.asarray(pair_tgt))
        if pd.size and int(pd.max()) > w_band:
            raise ValueError(
                f"use_band=True requires all correspondence pairs within "
                f"|src - tgt| <= {w_band}; found delta {int(pd.max())}.")
    q = pair_src.shape[0]
    pair_src_p = _pad_to_multiple(jnp.asarray(pair_src), num)
    pair_tgt_p = _pad_to_multiple(jnp.asarray(pair_tgt), num)
    # Padded pairs are (0, 0): src == tgt fails the (src - tgt) <= w window
    # test only when both are 0... mask them explicitly via a validity row.
    pair_valid = _pad_to_multiple(jnp.ones(q, bool), num) & (
        jnp.arange(pair_src_p.shape[0]) < q)
    odom_p = type(odom)(*[_pad_to_multiple(jnp.asarray(a), num)
                          for a in odom])
    hitl_p = type(hitl)(*[_pad_to_multiple(jnp.asarray(a), num)
                          for a in hitl])
    if lr is not None and not use_band:
        raise ValueError("lr factors require use_band=True (fold them into "
                         "odom for the dense path)")
    lr_p = None
    k_loc = 0
    if lr is not None:
        lr_p = type(lr)(*[_pad_to_multiple(jnp.asarray(a), num) for a in lr])
        k_loc = lr_p.i.shape[0] // num   # factors per shard

    shard = NamedSharding(mesh, P("factors"))
    repl = NamedSharding(mesh, P())
    pair_src_p = jax.device_put(pair_src_p, shard)
    pair_tgt_p = jax.device_put(pair_tgt_p, shard)
    pair_valid = jax.device_put(pair_valid, shard)
    odom_p = jax.device_put(odom_p, jax.tree.map(lambda _: shard, odom_p))
    hitl_p = jax.device_put(hitl_p, jax.tree.map(lambda _: shard, hitl_p))
    if lr_p is not None:
        lr_p = jax.device_put(lr_p, jax.tree.map(lambda _: shard, lr_p))
    x = jax.device_put(x, repl)
    fixed_dof = jax.device_put(fixed_dof, repl)
    problem = jax.device_put(problem, jax.tree.map(lambda _: repl, problem))

    n = problem.num_nodes
    n_windows = w_max - w_min + 1
    dtype = x.dtype
    outlier = jnp.asarray(outlier, dtype)

    fspec = lambda tree: jax.tree.map(lambda _: P("factors"), tree)

    def run(x, problem, psrc, ptgt, pvalid, odom_l, hitl_l, fixed, outlier,
            lr_l=None):
        def assemble_psum(graph):
            def f(xx):
                H, g, cost = assemble_normal_equations(xx, graph)
                return (jax.lax.psum(H, "factors"),
                        jax.lax.psum(g, "factors"),
                        jax.lax.psum(cost, "factors"))
            return f

        def assemble_psum_banded(graph):
            def f(xx):
                sys, cost = assemble_banded_scatter(xx, graph, n, w_band,
                                                    analytic=analytic)
                if lr_l is not None:
                    # Each shard linearizes its slice of the long-range
                    # closures into DISJOINT global columns of U (offset =
                    # shard index * local width); the psum below is then
                    # exactly the full low-rank block, and the Woodbury
                    # band solve replaces the dense fallback.
                    U_loc, g_lr, cost_lr = lowrank_factor_columns(
                        xx, lr_l, n)
                    idx = jax.lax.axis_index("factors")
                    U_glob = jnp.zeros((3 * n, 3 * k_loc * num), xx.dtype)
                    U_glob = jax.lax.dynamic_update_slice(
                        U_glob, U_loc, (0, idx * 3 * k_loc))
                    sys = sys._replace(U=U_glob, g=sys.g + g_lr)
                    cost = cost + cost_lr
                return (jax.lax.psum(sys, "factors"),
                        jax.lax.psum(cost, "factors"))
            return f

        def cost_psum(graph):
            return lambda xx: jax.lax.psum(total_cost(xx, graph), "factors")

        def window_body(k, carry):
            x, ic, fc, it = carry
            w = w_min + k
            planar = correspond.associate(problem, x[:n], psrc, ptgt, w,
                                          outlier, feature="planar",
                                          use_normal_gate=use_normal_gate)
            planar = planar._replace(mask=planar.mask & pvalid[:, None])
            edge = correspond.associate(problem, x[:n], psrc, ptgt, w,
                                        outlier, feature="edge",
                                        use_normal_gate=use_normal_gate)
            edge = edge._replace(mask=edge.mask & pvalid[:, None])
            graph = FactorGraph(odom=odom_l, planar=planar, edge=edge,
                                hitl=hitl_l)
            if use_band:
                res = lm_loop_banded(x, assemble_psum_banded(graph),
                                     fixed, lm_params)
            else:
                res = lm_loop(x, assemble_psum(graph), cost_psum(graph),
                              fixed, lm_params)
            return (res.x, ic.at[k].set(res.initial_cost),
                    fc.at[k].set(res.cost), it.at[k].set(res.iterations))

        init = (x, jnp.zeros(n_windows, dtype), jnp.zeros(n_windows, dtype),
                jnp.zeros(n_windows, jnp.int32))
        return jax.lax.fori_loop(0, n_windows, window_body, init)

    specs = [P(), jax.tree.map(lambda _: P(), problem), P("factors"),
             P("factors"), P("factors"), fspec(odom_p), fspec(hitl_p),
             P(), P()]
    args = [x, problem, pair_src_p, pair_tgt_p, pair_valid, odom_p, hitl_p,
            fixed_dof, outlier]
    if lr_p is not None:
        specs.append(fspec(lr_p))
        args.append(lr_p)
    sharded_run = shard_map(run, mesh=mesh, in_specs=tuple(specs),
                            out_specs=(P(), P(), P(), P()), check_vma=False)
    return jax.jit(sharded_run)(*args)


# ---------------------------------------------------------------------------
# Sharded correlative scan matching: the O(N^2 * image) all-pairs loop-
# closure workload (SURVEY §2c), embarrassingly parallel over the pair dim.
# ---------------------------------------------------------------------------

def csm_match_pairs_sharded(points, masks, src_idx, tgt_idx, mesh: Mesh,
                            params=None, rotation_centers=None):
    """csm_match_pairs with the pair dimension sharded across the mesh.

    Each device matches its slice of the gated pair list (clouds are
    gathered shard-locally from the replicated scan arrays — no
    communication at all until the final gather of the [Q] results), so
    auto-LC's CSM batch scales linearly with chip count.  Same contract
    as kernels.csm.csm_match_pairs.
    """
    from nautilus_tpu.kernels.csm import CSMParams, csm_match_batch

    params = params or CSMParams()
    src_idx = np.asarray(src_idx)
    tgt_idx = np.asarray(tgt_idx)
    q = len(src_idx)
    if q == 0:
        return np.zeros(0, np.float32), np.zeros((0, 3), np.float32)
    if rotation_centers is None:
        rotation_centers = np.zeros(q, np.float32)
    rotation_centers = np.asarray(rotation_centers, np.float32)
    num = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    # Pad the pair count to a multiple of the mesh size (power-of-two
    # bucketing on the per-shard count keeps compiled shapes reusable).
    per = 1
    while per * num < q:
        per *= 2
    g = per * num
    pad = np.concatenate([np.arange(q), np.zeros(g - q, np.int64)])
    A = jnp.asarray(points[src_idx[pad]])
    MA = jnp.asarray(masks[src_idx[pad]])
    B = jnp.asarray(points[tgt_idx[pad]])
    MB = jnp.asarray(masks[tgt_idx[pad]])
    C = jnp.asarray(rotation_centers[pad])

    shard = NamedSharding(mesh, P("factors"))
    A, MA, B, MB, C = (jax.device_put(v, shard) for v in (A, MA, B, MB, C))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("factors"),) * 5,
        out_specs=(P("factors"), P("factors")), check_vma=False)
    def run(a, ma, b, mb, c):
        return csm_match_batch(a, ma, b, mb, params, rotation_centers=c)

    s, tr = jax.jit(run)(A, MA, B, MB, C)
    return np.asarray(s)[:q], np.asarray(tr)[:q]
