"""Preprocessing tests: deterministic normals + LOAM-style feature split."""

import numpy as np
import jax.numpy as jnp
import pytest

from nautilus_tpu.core.preprocess import (FeatureParams, NormalParams,
                                          compute_normals, extract_features)


def make_l_shape(n_per_wall=60, noise=0.0, seed=0):
    """L-shaped corner: wall along +x and wall along +y."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.05, 3.0, n_per_wall)
    wall1 = np.stack([xs, np.zeros_like(xs)], axis=-1)
    wall2 = np.stack([np.zeros_like(xs), xs], axis=-1)
    pts = np.concatenate([wall1[::-1], wall2], axis=0)
    if noise:
        pts = pts + rng.normal(scale=noise, size=pts.shape)
    return pts.astype(np.float32)


def pad(pts, p=128):
    out = np.zeros((1, p, 2), np.float32)
    mask = np.zeros((1, p), bool)
    out[0, :len(pts)] = pts
    mask[0, :len(pts)] = True
    return jnp.asarray(out), jnp.asarray(mask)


class TestNormals:
    def test_wall_normals(self):
        pts = make_l_shape()
        points, mask = pad(pts)
        normals = np.asarray(compute_normals(points, mask))
        m = np.asarray(mask[0])
        # Points along the x-wall (y == 0, away from corner) -> normal ~ (0, 1).
        on_x_wall = m & (np.abs(np.asarray(points[0])[:, 1]) < 1e-6) & (
            np.asarray(points[0])[:, 0] > 0.5)
        nx = normals[0][on_x_wall]
        assert np.all(np.abs(nx[:, 1]) > 0.99), "x-wall normals should be ~(0,1)"
        # Unit length on valid points.
        lens = np.linalg.norm(normals[0][m], axis=-1)
        np.testing.assert_allclose(lens, 1.0, atol=1e-5)
        # Zero on padded slots.
        assert np.all(normals[0][~m] == 0.0)

    def test_deterministic(self):
        pts = make_l_shape(noise=0.01)
        points, mask = pad(pts)
        n1 = np.asarray(compute_normals(points, mask))
        n2 = np.asarray(compute_normals(points, mask))
        np.testing.assert_array_equal(n1, n2)


class TestFeatures:
    def test_planar_on_walls_edge_at_corner(self):
        pts = make_l_shape()
        points, mask = pad(pts)
        params = FeatureParams(threshold=0.008, distance_threshold=0.4,
                               max_planar=20, max_edge=3, min_neighbors=5)
        planar_idx, planar_mask, edge_idx, edge_mask, scores = extract_features(
            points, mask, params)
        planar_idx = np.asarray(planar_idx[0])[np.asarray(planar_mask[0])]
        assert len(planar_idx) >= 4, "should find several planar points on walls"
        pp = np.asarray(points[0])[planar_idx]
        # Planar points sit on one of the two walls.
        on_wall = (np.abs(pp[:, 0]) < 1e-5) | (np.abs(pp[:, 1]) < 1e-5)
        assert np.all(on_wall)
        # Mutual min distance respected.
        if len(pp) > 1:
            d = np.linalg.norm(pp[:, None] - pp[None, :], axis=-1)
            np.fill_diagonal(d, np.inf)
            assert d.min() >= 0.4 - 1e-5
        # Edge points (high score) cluster near the corner at the origin.
        eidx = np.asarray(edge_idx[0])[np.asarray(edge_mask[0])]
        if len(eidx):
            ep = np.asarray(points[0])[eidx]
            assert np.min(np.linalg.norm(ep, axis=-1)) < 0.6

    def test_caps_respected(self):
        pts = make_l_shape()
        points, mask = pad(pts)
        params = FeatureParams(distance_threshold=0.05, max_planar=5, max_edge=2,
                               min_neighbors=3)
        _, planar_mask, _, edge_mask, _ = extract_features(points, mask, params)
        assert np.asarray(planar_mask).sum() <= 5
        assert np.asarray(edge_mask).sum() <= 2

    def test_empty_scan(self):
        points = jnp.zeros((1, 128, 2))
        mask = jnp.zeros((1, 128), bool)
        _, planar_mask, _, edge_mask, _ = extract_features(points, mask)
        assert np.asarray(planar_mask).sum() == 0
        assert np.asarray(edge_mask).sum() == 0


class TestHoughNormals:
    def test_wall_normals_hough(self):
        from nautilus_tpu.core.preprocess import NormalParams
        pts = make_l_shape()
        points, mask = pad(pts)
        params = NormalParams(method="hough")
        normals = np.asarray(compute_normals(points, mask, params))
        m = np.asarray(mask[0])
        on_x_wall = m & (np.abs(np.asarray(points[0])[:, 1]) < 1e-6) & (
            np.asarray(points[0])[:, 0] > 0.5)
        nx = normals[0][on_x_wall]
        # Wall along x -> normal ~ (0, +-1); hough bin average within a bin
        # width (2*pi/32 ~ 0.2 rad) of vertical.
        assert np.all(np.abs(nx[:, 1]) > 0.98), nx[:5]
        lens = np.linalg.norm(normals[0][m], axis=-1)
        np.testing.assert_allclose(lens, 1.0, atol=1e-5)

    def test_hough_agrees_with_pca_on_walls(self):
        from nautilus_tpu.core.preprocess import NormalParams
        pts = make_l_shape(noise=0.003, seed=2)
        points, mask = pad(pts)
        n_pca = np.asarray(compute_normals(points, mask))
        n_hough = np.asarray(compute_normals(points, mask,
                                             NormalParams(method="hough")))
        m = np.asarray(mask[0])
        # |cos| similarity between the two estimates (orientation-free).
        dots = np.abs(np.sum(n_pca[0][m] * n_hough[0][m], axis=-1))
        assert np.median(dots) > 0.97

    def test_config_binding(self):
        from nautilus_tpu.core.luaconf import load_config
        from nautilus_tpu.core.preprocess import normal_params_from_config
        from pathlib import Path
        cfg = load_config(Path(__file__).parent.parent /
                          "config/default_config.lua")
        p = normal_params_from_config(cfg, method="hough")
        assert p.bin_number == 32
        assert p.mean_distance == 0.1
        assert p.neighborhood_size == 0.15


def test_device_and_numpy_paths_agree():
    """preprocess(as_numpy=False) returns the same values as the default
    host path (the device path exists to skip large device->host
    readbacks; it must not change results)."""
    import numpy as np
    from nautilus_tpu.ingest.synthetic import synthesize
    from nautilus_tpu.core.preprocess import preprocess

    raw, _ = synthesize(num_nodes=6, world_kind="room", num_beams=180,
                        seed=4)
    host = preprocess(raw.points, raw.points_mask)
    dev = preprocess(raw.points, raw.points_mask, as_numpy=False)
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h, np.asarray(d))
