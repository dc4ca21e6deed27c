"""Automatic loop closure orchestration.

Mirrors reference Solver::SolveAutoLC (src/optimization/solver.cc:676-700)
and COMPLETES it: in the reference snapshot the constraint application is
stubbed/commented out (AddLCConstraints solver.cc:651-660,
ResolveWithConstraints call solver.cc:699 — SURVEY.md §2d), leaving auto-LC
diagnostic-only.  Here the full closed loop is implemented:

1. candidate filter (scatter score + spacing) — candidate.py;
2. chi-square uncertainty gating over candidate pairs — matcher.py;
3. correlative scan matching per gated pair (kernels/csm.py — batched over
   pairs on the device), accepted above csm_score_threshold;
4. each accepted match becomes a weighted relative-pose factor
   (lc_translation_weight / lc_rotation_weight), derived with the
   reference's frame composition (GetRelativeTransform solver.cc:630-649);
5. re-solve.

``apply=False`` reproduces the reference's diagnostic-only behavior.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from nautilus_tpu.kernels.csm import (CSMParams, csm_match_batch,
                                      csm_match_pairs, wrap_angle)
from nautilus_tpu.loop_closure.candidate import get_lc_candidates
from nautilus_tpu.loop_closure.matcher import LCMatcher


@dataclasses.dataclass
class AutoLCReport:
    candidates: List[int]
    gated_pairs: List[Tuple[int, int]]
    csm_results: List[Tuple[int, int, float, np.ndarray]]  # (s, t, score, [tx ty th])
    accepted: List[Tuple[int, int]]
    applied: bool = False
    # Wall seconds per stage (candidates / gate / csm / resolve +
    # resolve_wait = time the final re-solve blocked on the overlapped
    # prewarm compile), so a slow auto-LC pass is attributable from the
    # bench JSON without a device profiler.
    stage_walls: dict = dataclasses.field(default_factory=dict)


def _warn_prewarm_failed(exc: Exception) -> None:
    import sys
    print(f"warning: auto-LC re-solve prewarm failed: "
          f"{type(exc).__name__}: {exc}", file=sys.stderr, flush=True)


def _start_resolve_prewarm(solver, n_gated: int):
    """Compile the post-closure re-solve program concurrently with CSM.

    The re-solve at max window is the first program in the session with
    long-range Woodbury factors, so it pays a fresh XLA compile exactly
    once per lr-bucket shape.  The
    accepted count is unknown until CSM scores the pairs, but it is
    bounded by the gated count — so hint the solver's lr bucket to cover
    ALL gated pairs (every bucket the real re-solve could need collapses
    to this one), then compile that program on a throwaway twin of the
    state (same pattern as hitl.prewarm_hitl) in a daemon thread while
    the CSM batch runs.  Returns (thread, shadow_solver) or None.
    """
    import threading
    from nautilus_tpu.core.problem import SLAMState
    from nautilus_tpu.solve.solver import Solver

    state = solver.state
    if state.num_nodes < 3:
        return None
    b = 4
    while b < n_gated:
        b *= 2
    # The REAL re-solve must pad to the same bucket the shadow compiles.
    solver._lr_bucket = max(int(getattr(solver, "_lr_bucket", 0)), b)
    twin = SLAMState(
        problem=state.problem,
        solution=state.solution.copy(),
        timestamps=state.timestamps,
        hitl_constraints=list(state.hitl_constraints),
        line_poses=state.line_poses.copy(),
        odometry_factors=state.odometry_factors,
        initial_odometry_factors=state.initial_odometry_factors,
        lc_factors=list(state.lc_factors))
    shadow = Solver(twin, solver.config,
                    lm_params=solver.lm_params,
                    linear_solver=solver.linear_solver,
                    use_normal_gate=solver.use_normal_gate,
                    fused_sweep=solver.fused_sweep,
                    staged_fused=solver.staged_fused,
                    assembly=solver.assembly,
                    mesh=solver.mesh)
    shadow._odom_bucket = getattr(solver, "_odom_bucket", 0)
    shadow._lr_bucket = solver._lr_bucket
    # One zero-residual long-range factor (relative pose implied by the
    # current solution; transform maps cloud s into cloud t's frame, the
    # relative_pose_factor convention) makes the twin's factor set
    # lr-augmented without perturbing its (discarded) solve.
    s, t = 0, state.num_nodes - 1
    sol = state.solution
    th_t = sol[t, 2]
    c, sn = np.cos(-th_t), np.sin(-th_t)
    d = sol[s, :2] - sol[t, :2]
    transform = np.array([c * d[0] - sn * d[1], sn * d[0] + c * d[1],
                          wrap_angle(sol[s, 2] - th_t)])
    wt = float(solver.config.lc_translation_weight)
    wr = float(solver.config.lc_rotation_weight)
    twin.lc_factors.append(
        relative_pose_factor(twin, s, t, transform, wt, wr))

    def run():
        try:
            shadow.solve_max_window()
        except Exception as exc:
            # The real re-solve then pays the compile itself, but a failure
            # here is a fault worth seeing, never one to pass over.
            _warn_prewarm_failed(exc)

    thread = threading.Thread(target=run, daemon=True,
                              name="auto-lc-resolve-prewarm")
    thread.start()
    return thread, shadow


def _csm_params_from_config(cfg) -> CSMParams:
    scan_range = float(cfg.max_lidar_range)
    if scan_range <= 0:
        scan_range = 30.0
    return CSMParams(scan_range=scan_range, trans_range=2.0,
                     low_res=0.3, high_res=0.01,
                     rotation_restriction=float(np.pi / 2))


def relative_pose_factor(state, s: int, t: int, transform: np.ndarray,
                         wt: float, wr: float):
    """Turn a CSM transform (cloud s -> cloud t frames) into a factor tuple.

    The CSM output maps source-scan points into the target scan frame:
    p_t = R(theta) p_s + [tx, ty].  The implied world pose of s is
    T_t o T_csm (reference GetRelativeTransform composition,
    solver.cc:640-647).  The factor stores the world-frame delta between
    that implied pose and pose min(s,t), matching the engine's odometry
    factor convention.
    """
    i, j = (s, t) if s < t else (t, s)
    pose_t = state.solution[t]
    c, sn = np.cos(pose_t[2]), np.sin(pose_t[2])
    Rt = np.array([[c, -sn], [sn, c]])
    implied_s_loc = pose_t[:2] + Rt @ transform[:2]
    implied_s_rot = pose_t[2] + transform[2]
    implied = {s: np.array([implied_s_loc[0], implied_s_loc[1],
                            implied_s_rot]),
               t: pose_t}
    trans = implied[j][:2] - implied[i][:2]
    rot = implied[j][2] - implied[i][2]
    return (i, j, trans, float(rot), wt, wr)


def _dump_pair_image(state, s: int, t: int, transform: np.ndarray,
                     score: float, debug_dir: str) -> None:
    """Debug raster of a candidate pair + aligned overlay (replaces the
    reference's CImg dumps to lc_debug_output_dir, cimg_debug.h:15-114)."""
    from pathlib import Path
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    out = Path(debug_dir)
    out.mkdir(parents=True, exist_ok=True)
    pts = np.asarray(state.problem.points)
    msk = np.asarray(state.problem.points_mask)
    pa, pb = pts[s][msk[s]], pts[t][msk[t]]
    c, sn = np.cos(transform[2]), np.sin(transform[2])
    pa_aligned = pa @ np.array([[c, sn], [-sn, c]]) + transform[:2]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 5))
    ax1.plot(pa[:, 0], pa[:, 1], ".", ms=1, label=f"scan {s}")
    ax1.plot(pb[:, 0], pb[:, 1], ".", ms=1, label=f"scan {t}")
    ax1.set_title("raw")
    ax1.legend()
    ax2.plot(pa_aligned[:, 0], pa_aligned[:, 1], ".", ms=1)
    ax2.plot(pb[:, 0], pb[:, 1], ".", ms=1)
    ax2.set_title(f"aligned (score {score:.2f})")
    for ax in (ax1, ax2):
        ax.set_aspect("equal")
    fig.savefig(out / f"lc_{s:04d}_{t:04d}.png", dpi=100,
                bbox_inches="tight")
    plt.close(fig)


def best_scan_match(state, source: int, scans, params: CSMParams = CSMParams()):
    """Best CSM match for one scan among candidates
    (reference Solver::BestScanMatch, solver.h:95-96).

    Returns (best_score, best_scan_index, transform)."""
    scans = [s for s in scans if s != source]
    if not scans:
        return float("-inf"), -1, np.zeros(3)
    pts = state.problem.points
    msk = state.problem.points_mask
    ss = np.full(len(scans), source)
    tt = np.asarray(scans)
    centers = np.asarray(
        wrap_angle(state.solution[ss, 2] - state.solution[tt, 2]),
        np.float32)
    scores, transforms = csm_match_batch(pts[ss], msk[ss], pts[tt], msk[tt],
                                         params, rotation_centers=centers)
    scores = np.asarray(scores)
    k = int(np.argmax(scores))
    return float(scores[k]), int(scans[k]), np.asarray(transforms[k])


def scorer_self_check(state, score_fn, n_probe: int = 12,
                      far_frac: float = 0.6):
    """AUC of ``score_fn`` on pairs whose label THIS map already knows.

    Near pairs: trajectory-adjacent nodes (physically near by the
    builder's capture gating).  Far pairs: nodes whose solution distance
    exceeds ``far_frac`` of the map extent — almost surely far regardless
    of drift.  Returns P(score(near) > score(far)) over up to n_probe
    pairs per class, or None when the map is too small/compact to build
    both classes.
    """
    n = state.num_nodes
    if n < 6:
        return None
    sol = np.asarray(state.solution[:n, :2])
    extent = float(np.linalg.norm(sol.max(0) - sol.min(0)))
    if extent <= 1e-6:
        return None
    rng = np.random.default_rng(0)
    # Far pairs without the O(N^2) distance matrix (3+ GB at N=20000):
    # one vectorized distance row per SOURCE node.  Sources start from
    # the bounding-box extremes — the wider-axis extreme pair is at
    # least bbox_side >= extent/sqrt(2) apart, so for far_frac <= 0.7 a
    # far pair is found deterministically whenever one exists (pure
    # rejection sampling could miss rare far pairs on thin-spur maps
    # and silently flip the descriptor-gate adjudication to None).
    span = sol.max(0) - sol.min(0)
    a = int(span[1] > span[0])
    seeds = [int(np.argmin(sol[:, a])), int(np.argmax(sol[:, a])),
             int(np.argmin(sol[:, 1 - a])), int(np.argmax(sol[:, 1 - a]))]
    seeds += [int(s) for s in rng.integers(0, n, 32)]
    far_pairs, seen_far = [], set()
    node_idx = np.arange(n)
    for s in seeds:
        if len(far_pairs) >= n_probe:
            break
        d = np.linalg.norm(sol - sol[s], axis=1)
        js = np.nonzero((d >= far_frac * extent)
                        & (np.abs(node_idx - s) >= 2))[0]
        for j in js[np.argsort(-d[js])[:4]]:
            key = (min(s, int(j)), max(s, int(j)))
            if key not in seen_far:
                seen_far.add(key)
                far_pairs.append((s, int(j)))
    far_pairs = far_pairs[:n_probe]
    if not far_pairs:
        return None
    near_i = rng.choice(n - 1, size=min(n_probe, n - 1), replace=False)
    near = np.array([float(score_fn(int(i), int(i + 1))) for i in near_i])
    far = np.array([float(score_fn(i, j)) for i, j in far_pairs])
    return float(np.mean(near[:, None] > far[None, :]))


def descriptor_gate(state, pairs, threshold: float,
                    use_learned_embedding: bool = None):
    """Optional scan-descriptor pre-gate (the reference's
    match_laser_scans service role; threshold = config lc_match_threshold).
    Returns the subset of pairs whose similarity passes the threshold.

    Scorer selection: with use_learned_embedding=True/False (config key
    lc_use_learned_embedding) the choice is forced.  On auto (None) and
    weights present, BOTH scorers run a per-map self-check
    (scorer_self_check: separation of trajectory-adjacent vs
    across-the-map pairs, labels this map already knows) and the learned
    embedding is used only when it separates at least as well — so an
    out-of-distribution map falls back to the hand descriptor instead of
    degrading the gate (worst held-out world AUC was
    0.70 on the always-embedding policy)."""
    from nautilus_tpu.loop_closure import embedding
    from nautilus_tpu.loop_closure.learned import match_score
    params = None
    if use_learned_embedding is None or use_learned_embedding:
        params = embedding.load_params()
        if params is None and use_learned_embedding:
            raise FileNotFoundError(
                f"lc_use_learned_embedding=true but no weights at "
                f"{embedding.default_weights_path()}")
    if not pairs:
        return []
    pts = state.problem.points
    msk = state.problem.points_mask
    emb_score = (lambda s, t: embedding.embedding_match_score(
        params, pts[s], msk[s], pts[t], msk[t])) if params else None
    hand_score = lambda s, t: match_score(pts[s], msk[s], pts[t], msk[t])
    score = emb_score or hand_score
    if params is not None and use_learned_embedding is None:
        # The adjudication (~2 x n_probe score evaluations) depends only
        # on the map's scans, so run it once per state and memoize on the
        # state object — repeated gate calls reuse the choice.
        choice = getattr(state, "_descriptor_gate_choice", None)
        if choice is None:
            auc_emb = scorer_self_check(state, emb_score)
            auc_hand = scorer_self_check(state, hand_score)
            choice = ("hand" if auc_emb is not None and auc_hand is not None
                      and auc_emb < auc_hand else "emb")
            try:
                state._descriptor_gate_choice = choice
            except AttributeError:   # frozen/slotted state: just recompute
                pass
        if choice == "hand":
            score = hand_score
    return [(s, t) for s, t in pairs if float(score(s, t)) >= threshold]


def solve_auto_lc(solver, apply: bool = True, verbose: bool = True,
                  csm_params: CSMParams = None,
                  use_descriptor_gate: bool = False) -> AutoLCReport:
    """Full auto-LC pass over the solver's state."""
    import time as _time
    state = solver.state
    cfg = solver.config
    report = AutoLCReport(candidates=[], gated_pairs=[], csm_results=[],
                          accepted=[])

    _t0 = _time.perf_counter()
    candidates = get_lc_candidates(state)
    if cfg.get("keyframe_local_uncertainty_filtering", False):
        # Uncertainty criterion only — NOT membership of the sequential
        # 0.5 m keyframe chain: the candidate filter already enforced its
        # own 5 m spacing, and intersecting two independent spacing
        # chains drops candidates by phase parity (see
        # keyframes.candidate_uncertainty_ok).
        from nautilus_tpu.loop_closure.keyframes import (
            candidate_uncertainty_ok)
        ok = candidate_uncertainty_ok(state, cfg, candidates)
        candidates = [c for c, o in zip(candidates, ok) if o]
    report.candidates = candidates
    report.stage_walls["candidates"] = _time.perf_counter() - _t0
    _t0 = _time.perf_counter()
    if verbose:
        print(f"Auto-LC: {len(candidates)} candidate scans.")
    if solver.visualizer is not None:
        # Reference SolveAutoLC visualizes the candidate scans
        # (solver.cc:679) and per-match covariances (solver.cc:697).
        solver.visualizer.draw_scans(state, candidates)
    if len(candidates) < 2:
        return report

    # Chi-square gating over candidate pairs (one Hessian for all; band
    # covariance engine when the factor set is band-eligible, so gating
    # scales past the dense-H memory wall).
    matcher = LCMatcher.from_solver(solver)
    # Range prefilter (config lc_base_max_range / lc_max_range_scaling:
    # "max range to consider a loop closure", growing with node-index
    # distance to admit drift — keys the reference declares,
    # default_config.lua:121-126, but never reads).  Applied before the
    # chi-square gate: pairs beyond the admissible range never pay a
    # covariance evaluation.
    base_range = float(cfg.get("lc_base_max_range", 3.5))
    range_scaling = float(cfg.get("lc_max_range_scaling", 0.01))
    pos = np.asarray(state.solution[:, :2])
    cand_arr = np.asarray(candidates, np.int64)
    cand_pos = pos[cand_arr]
    seen = set()
    for idx, s in enumerate(candidates):
        # One vectorized norm per source (not a Python-level norm per
        # ordered pair — that is millions of interpreter calls at GDC
        # candidate counts).
        d = np.linalg.norm(cand_pos - cand_pos[idx], axis=1)
        limit = base_range + range_scaling * np.abs(cand_arr - s)
        within = [int(t) for t in cand_arr[(d <= limit) & (cand_arr != s)]]
        if not within:
            continue
        for t in matcher.get_possible_matches(s, within):
            key = (min(s, t), max(s, t))
            if key not in seen:
                seen.add(key)
                report.gated_pairs.append(key)
    report.stage_walls["gate"] = _time.perf_counter() - _t0
    if verbose:
        print(f"Auto-LC: {len(report.gated_pairs)} pairs pass the "
              f"chi-square gate.")
    if solver.visualizer is not None and report.gated_pairs:
        covs = [(t, matcher.chi_square_score(s, t)[0])
                for s, t in report.gated_pairs]
        solver.visualizer.draw_covariances(covs)
    if use_descriptor_gate and report.gated_pairs:
        report.gated_pairs = descriptor_gate(
            state, report.gated_pairs,
            float(cfg.get("lc_match_threshold", 0.5)),
            use_learned_embedding=cfg.get("lc_use_learned_embedding", None))
        if verbose:
            print(f"Auto-LC: {len(report.gated_pairs)} pairs pass the "
                  f"descriptor gate.")
    if not report.gated_pairs:
        return report

    # Overlap the post-closure re-solve's compile with the CSM stage:
    # both are first-use program shapes, so compiling them concurrently
    # makes the auto-LC wall max(csm, resolve-compile) instead of their
    # sum.  Whether that pays on the H100 is not measured yet (ROADMAP.md
    # section 3, compile-hiding machinery).
    prewarm = None
    if apply and bool(cfg.get("auto_lc_prewarm", True)):
        try:
            prewarm = _start_resolve_prewarm(solver, len(report.gated_pairs))
        except Exception as exc:
            _warn_prewarm_failed(exc)

    _t0 = _time.perf_counter()
    # CSM over gated pairs: one padded device dispatch for the whole list.
    # lc_match_window_size (config default_config.lua:139, declared but
    # unread in the reference: "frames in the window around a keyframe to
    # use to ensure a valid match") expands each pair's TARGET to its
    # +-w trajectory neighbors; the pair matches against the best-scoring
    # window member.  All window members ride the same single dispatch,
    # so the policy costs batch width, not extra round trips.
    params = csm_params or _csm_params_from_config(cfg)
    pts = state.problem.points
    msk = state.problem.points_mask
    match_w = int(cfg.get("lc_match_window_size", 0))
    n_nodes = state.num_nodes
    exp_ss, exp_tt, owner = [], [], []
    for k, (s, t) in enumerate(report.gated_pairs):
        for dt in range(-match_w, match_w + 1):
            t2 = t + dt
            if 0 <= t2 < n_nodes and t2 != s:
                exp_ss.append(s)
                exp_tt.append(t2)
                owner.append(k)
    ss = np.asarray(exp_ss)
    tt = np.asarray(exp_tt)
    owner = np.asarray(owner)
    # Seed each pair's rotation search with the solution-implied relative
    # heading (the reference passes both scans' solution angles to
    # GetTransformation, solver.cc:634-638): a reverse-traversal closure
    # (relative heading ~ pi) is otherwise outside the +-90 deg window.
    centers = wrap_angle(state.solution[ss, 2] - state.solution[tt, 2])
    mesh = getattr(solver, "mesh", None)
    if mesh is not None:
        # Multi-chip: the CSM batch is embarrassingly parallel over pairs
        # (parallel.sharded.csm_match_pairs_sharded) — auto-LC's dominant
        # cost scales with chip count.
        from nautilus_tpu.parallel.sharded import csm_match_pairs_sharded
        all_scores, all_transforms = csm_match_pairs_sharded(
            pts, msk, ss, tt, mesh, params,
            rotation_centers=np.asarray(centers, np.float32))
    else:
        all_scores, all_transforms = csm_match_pairs(
            pts, msk, ss, tt, params, rotation_centers=centers)
    all_scores = np.asarray(all_scores)
    all_transforms = np.asarray(all_transforms, np.float64)
    # Best window member per original pair (window 0 = identity mapping).
    scores = np.full(len(report.gated_pairs), -np.inf)
    transforms = np.zeros((len(report.gated_pairs), 3))
    best_tt = np.array([t for _, t in report.gated_pairs])
    for j in range(len(ss)):
        k = owner[j]
        if all_scores[j] > scores[k]:
            scores[k] = all_scores[j]
            transforms[k] = all_transforms[j]
            best_tt[k] = tt[j]
    threshold = float(cfg.csm_score_threshold)
    wt = float(cfg.lc_translation_weight)
    wr = float(cfg.lc_rotation_weight)
    # Dump pair images only when the user opted in by creating the debug
    # dir (the key always has a default value, default_config.lua:142).
    from pathlib import Path as _Path
    debug_dir = cfg.get("lc_debug_output_dir", "")
    debug_dir = debug_dir if debug_dir and _Path(debug_dir).is_dir() else ""
    for k, (s, _t_orig) in enumerate(report.gated_pairs):
        t = int(best_tt[k])          # best window member (== _t_orig at w=0)
        report.csm_results.append((s, t, float(scores[k]), transforms[k]))
        if debug_dir:
            _dump_pair_image(state, s, t, transforms[k], float(scores[k]),
                             debug_dir)
        if scores[k] >= threshold:
            report.accepted.append((s, t))
            if apply:
                state.lc_factors.append(
                    relative_pose_factor(state, s, t, transforms[k], wt, wr))
    report.stage_walls["csm"] = _time.perf_counter() - _t0
    if verbose:
        print(f"Auto-LC: {len(report.accepted)} matches above CSM score "
              f"threshold ({threshold}).")
    if prewarm is not None:
        # Wait for the overlapped compile; on timeout/failure the real
        # re-solve below compiles itself (correctness unaffected).
        _t0 = _time.perf_counter()
        thread, shadow = prewarm
        thread.join(timeout=600.0)
        solver._odom_bucket = max(getattr(solver, "_odom_bucket", 0),
                                  getattr(shadow, "_odom_bucket", 0))
        report.stage_walls["resolve_wait"] = _time.perf_counter() - _t0
    if apply and report.accepted:
        # Reference ResolveWithConstraints solves once at the max window
        # after injecting LC constraints (solver.cc:662-674).
        _t0 = _time.perf_counter()
        solver.solve_max_window()
        report.stage_walls["resolve"] = _time.perf_counter() - _t0
        report.applied = True
    return report
