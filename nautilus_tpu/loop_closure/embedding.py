"""Learned loop-closure embedding — the match_laser_scans model, in JAX.

The reference farms scan-pair scoring out to an external torch process via
the ``match_laser_scans`` ROS service (src/optimization/solver.cc:58,
learning-loop-closure submodule); the service is plumbing-only in the
analyzed snapshot.  This module is the in-process JAX equivalent
(SURVEY.md §2b row 4): a small embedding network over a rotation-invariant
spectral descriptor, trained contrastively on synthetic worlds, scoring
scan pairs on the same [0, 1] surface as the hand descriptor
(loop_closure/learned.py) and the same ``lc_match_threshold`` decision.

Architecture (fixed shapes):
- polar occupancy histogram [RANGE_BINS, THETA_BINS] (shared with
  learned.scan_descriptor);
- |rFFT| over the theta axis -> rotation of the scan is a circular shift
  of theta, so the magnitude spectrum is rotation-invariant BY
  CONSTRUCTION (no augmentation needed for invariance);
- 2-layer MLP -> L2-normalized embedding; pair score = scaled cosine.

Training: NT-Xent contrastive loss; positives are scans of the same world
taken within 1 m along the trajectory, negatives are everything else in
the batch.  ``python -m nautilus_tpu.loop_closure.embedding`` retrains and
writes the default weights file.

When the weights file exists, auto_lc's descriptor gate uses this scorer
(config ``lc_use_learned_embedding`` overrides; absent file falls back to
the hand descriptor).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from nautilus_tpu.loop_closure.learned import (RANGE_BINS, THETA_BINS,
                                               scan_descriptor)

EMBED_DIM = 64
HIDDEN_DIM = 128
FEAT_DIM = RANGE_BINS * (THETA_BINS // 2 + 1)

_WEIGHTS_PATH = Path(__file__).resolve().parent / "weights" / "lc_embedding.npz"


def default_weights_path() -> Path:
    return _WEIGHTS_PATH


def spectral_features(points, mask) -> jnp.ndarray:
    """[FEAT_DIM] rotation-invariant features of one scan."""
    hist = scan_descriptor(points, mask)                   # [R, T]
    spec = jnp.abs(jnp.fft.rfft(hist, axis=1))             # [R, T//2+1]
    return spec.reshape(-1)


def init_params(seed: int = 0) -> dict:
    """He-initialized MLP parameters as a flat dict of arrays."""
    rng = np.random.default_rng(seed)

    def he(shape):
        return rng.normal(0, np.sqrt(2.0 / shape[0]), shape).astype(np.float32)

    return {
        "w1": jnp.asarray(he((FEAT_DIM, HIDDEN_DIM))),
        "b1": jnp.zeros((HIDDEN_DIM,), jnp.float32),
        "w2": jnp.asarray(he((HIDDEN_DIM, EMBED_DIM))),
        "b2": jnp.zeros((EMBED_DIM,), jnp.float32),
    }


def embed_features(params: dict, feats) -> jnp.ndarray:
    """feats [..., FEAT_DIM] -> L2-normalized embeddings [..., EMBED_DIM]."""
    h = jnp.matmul(feats, params["w1"],
                   precision=jax.lax.Precision.HIGHEST) + params["b1"]
    h = jax.nn.gelu(h)
    z = jnp.matmul(h, params["w2"],
                   precision=jax.lax.Precision.HIGHEST) + params["b2"]
    return z / jnp.maximum(jnp.linalg.norm(z, axis=-1, keepdims=True), 1e-9)


@jax.jit
def embed(params: dict, points, mask) -> jnp.ndarray:
    return embed_features(params, spectral_features(points, mask))


@jax.jit
def embedding_match_score(params: dict, points_a, mask_a,
                          points_b, mask_b) -> jnp.ndarray:
    """Pair score in [0, 1] (same surface as learned.match_score).

    The raw cosine similarity is shifted by the train-time calibration
    scalar ("calib": the near/far score midpoint measured after
    training) so the config default lc_match_threshold=0.5 sits at the
    adjudicated decision boundary regardless of where contrastive
    training parked the cosine distribution (DESCRIPTOR_GATE.md r4: an
    uncalibrated retrain pushed every score above 0.5, silently turning
    the gate into a no-op)."""
    za = embed(params, points_a, mask_a)
    zb = embed(params, points_b, mask_b)
    raw = 0.5 * (jnp.dot(za, zb, precision=jax.lax.Precision.HIGHEST)
                 + 1.0)
    calib = params.get("calib", jnp.asarray(0.5, jnp.float32))
    # Piecewise-affine monotone remap fixing three anchors: 0 -> 0,
    # calib -> 0.5, 1 -> 1 (a self-pair still scores exactly 1).
    lo = 0.5 * raw / jnp.maximum(calib, 1e-6)
    hi = 0.5 + 0.5 * (raw - calib) / jnp.maximum(1.0 - calib, 1e-6)
    return jnp.clip(jnp.where(raw < calib, lo, hi), 0.0, 1.0)


def save_params(params: dict, path=None) -> Path:
    path = Path(path) if path else _WEIGHTS_PATH
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return path


def load_params(path=None):
    """Load weights; None when the file is absent (hand-descriptor mode)."""
    path = Path(path) if path else _WEIGHTS_PATH
    if not path.exists():
        return None
    data = np.load(path)
    if not {"w1", "b1", "w2", "b2"}.issubset(set(data.files)) or \
            not set(data.files).issubset({"w1", "b1", "w2", "b2", "calib"}):
        raise ValueError(f"{path} is not an lc_embedding weights file")
    return {k: jnp.asarray(data[k]) for k in data.files}


# ---------------------------------------------------------------------------
# Contrastive training on synthetic worlds
# ---------------------------------------------------------------------------

def _training_pairs(num_worlds: int = 18, nodes_per_world: int = 40,
                    seed: int = 0):
    """(anchor_feats, positive_feats) [P, FEAT_DIM] from synthetic worlds.

    Positives: two scans of the same world <= 1 m apart on the trajectory
    (the LCCandidateFilter regime: same place, different pose).  The
    NT-Xent denominator supplies negatives (other worlds/places in batch).

    Beam count and odometry noise vary per world: deployments run
    anything from sparse 180-beam scanners to dense 720-beam ones, and
    the r3 generalization probe (benchmarks/DESCRIPTOR_GATE.md) showed
    the fixed-360-beam training mix degrading on 180-beam held-out
    worlds; mixing the sensor axis into training closes that shift.
    """
    from nautilus_tpu.ingest.synthetic import synthesize
    anchors, positives, anchors_rot = [], [], []
    for w in range(num_worlds):
        kind = ("office", "building", "room")[w % 3]
        beams = (180, 360, 720)[(w // 3) % 3]
        noise = (1.0, 2.0)[(w // 9) % 2]
        raw, gt = synthesize(num_nodes=nodes_per_world, world_kind=kind,
                             num_beams=beams, seed=seed + 17 * w,
                             odom_noise_trans=0.03 * noise,
                             odom_noise_rot=0.01 * noise)
        feats = np.asarray(jax.vmap(spectral_features)(
            jnp.asarray(raw.points), jnp.asarray(raw.points_mask)))
        # Rotated-copy features of every node (one random rotation each):
        # the spectral descriptor is rotation-invariant only up to
        # histogram re-binning, and the training loss adds an explicit
        # invariance term pinning embed(scan) == embed(rotated scan),
        # which auto-LC relies on for reverse-traversal candidates.
        local_rng = np.random.default_rng(seed + 31 * w)
        ths = local_rng.uniform(0.3, 2 * np.pi - 0.3, size=len(gt))
        c, s = np.cos(ths), np.sin(ths)
        rotm = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
        rot_pts = np.einsum("npk,nkj->npj", np.asarray(raw.points),
                            rotm.astype(raw.points.dtype))
        feats_rot = np.asarray(jax.vmap(spectral_features)(
            jnp.asarray(rot_pts), jnp.asarray(raw.points_mask)))
        d = np.linalg.norm(gt[:, None, :2] - gt[None, :, :2], axis=-1)
        n = len(gt)
        for i in range(n):
            near = np.nonzero((d[i] <= 1.0) & (np.arange(n) != i))[0]
            if len(near):
                anchors.append(feats[i])
                positives.append(feats[near[len(near) // 2]])
                anchors_rot.append(feats_rot[i])
    return np.stack(anchors), np.stack(positives), np.stack(anchors_rot)


@functools.partial(jax.jit, static_argnames=())
def _ntxent_loss(params, fa, fp, temperature=0.1):
    """NT-Xent over a batch of (anchor, positive) feature rows."""
    za = embed_features(params, fa)                        # [B, D]
    zp = embed_features(params, fp)
    sims = jnp.matmul(za, zp.T,
                      precision=jax.lax.Precision.HIGHEST) / temperature
    labels = jnp.arange(za.shape[0])
    return jnp.mean(
        -jax.nn.log_softmax(sims, axis=1)[labels, labels]
        - jax.nn.log_softmax(sims, axis=0)[labels, labels]) * 0.5


def _train_loss(params, fa, fp, fr, inv_weight=2.0):
    """NT-Xent + explicit rotation-invariance regularizer.

    The contrastive term alone ERODES rotation invariance: rotated/near-
    duplicate scans appear as in-batch negatives and get pushed apart.
    The second term pins embed(scan) to embed(rotated scan) directly —
    auto-LC's reverse-traversal candidates depend on this invariance
    (tests/test_embedding.py::test_rotation_invariance)."""
    za = embed_features(params, fa)
    zr = embed_features(params, fr)
    inv = jnp.mean(1.0 - jnp.sum(za * zr, axis=-1))
    return _ntxent_loss(params, fa, fp) + inv_weight * inv


def train(num_steps: int = 300, batch: int = 128, lr: float = 1e-3,
          seed: int = 0, verbose: bool = True):
    """Train and return params (a few seconds; runs anywhere)."""
    import optax
    fa, fp, fr = _training_pairs(seed=seed)
    if verbose:
        print(f"training pairs: {len(fa)}")
    params = init_params(seed)
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    rng = np.random.default_rng(seed)

    @jax.jit
    def step(params, opt_state, ba, bp, br):
        loss, grads = jax.value_and_grad(_train_loss)(params, ba, bp, br)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for it in range(num_steps):
        idx = rng.choice(len(fa), size=min(batch, len(fa)), replace=False)
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(fa[idx]),
                                       jnp.asarray(fp[idx]),
                                       jnp.asarray(fr[idx]))
        if verbose and (it % 50 == 0 or it == num_steps - 1):
            print(f"step {it:4d}  loss {float(loss):.4f}")

    # Score calibration: raw cosine score of near (anchor, positive) pairs
    # vs mismatched (anchor_i, positive_j) pairs.  The decision boundary
    # (maps to the config default lc_match_threshold=0.5) is the far
    # pairs' 90th percentile: a pre-gate ahead of CSM should be
    # RECALL-oriented (a false accept costs one CSM evaluation, a false
    # reject loses the closure — DESCRIPTOR_GATE.md findings), and the
    # wide gap to the near distribution (q5 ~0.94 vs far q90 ~0.66)
    # becomes margin that absorbs held-out distribution shift.
    za = np.asarray(embed_features(params, jnp.asarray(fa)))
    zp = np.asarray(embed_features(params, jnp.asarray(fp)))
    near = 0.5 * ((za * zp).sum(-1) + 1.0)
    perm = rng.permutation(len(fa))
    far = 0.5 * ((za * zp[perm]).sum(-1) + 1.0)
    far = far[perm != np.arange(len(fa))]
    calib = float(np.percentile(far, 90))
    if verbose:
        print(f"calibration: near q5 {np.percentile(near, 5):.3f}, far "
              f"q90 {np.percentile(far, 90):.3f} -> calib {calib:.3f}")
    params["calib"] = jnp.asarray(calib, jnp.float32)
    return params


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Train the loop-closure embedding and write weights.")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    params = train(num_steps=args.steps, seed=args.seed)
    path = save_params(params, args.out or None)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
