"""Full bag-to-map end-to-end through the REAL CLI path.

The reference's primary workload is a rosbag replay (main.cc:46-129 ->
solve -> pose/map output).  These tests drive this repo's equivalent on a
generated multi-chunk bag: native reader -> ingest cache -> preprocess ->
growing-window solve -> pose write -> map vectorization, for both chunk
compressions — then pin that the CLI plumbing is data-transparent by
solving the same bag through the direct in-memory path (pure-Python
reader, no cache) and asserting final-cost parity.

The default-suite bags are moderate (fast on the CPU backend); the
GDC-scale (1000-pose, 720-beam) lane runs ingest here and the full solve
in bench.py's ingest extras, where wall time is accounted for.
"""

import numpy as np
import pytest

from nautilus_tpu.core.luaconf import load_config
from nautilus_tpu.ingest.synthetic import write_synthetic_bag


def _write_cfg(tmp_path, bag, nodes, extra=""):
    out = tmp_path / "cfg.lua"
    out.write_text(f"""
bag_path="{bag}"
lidar_topic="/scan"
odom_topic="/odom"
differential_odom=false
pose_number={nodes}
max_lidar_range=30
rotation_change_for_lidar=0.25
translation_change_for_lidar=0.25
translation_weight=1
rotation_weight=1
lidar_constraint_amount_min=1
lidar_constraint_amount_max=3
outlier_threshold=0.25
pose_output_file="{tmp_path}/poses.txt"
map_output_file="{tmp_path}/map.csv"
hitl_line_width=0.05
hitl_pose_point_threshold=10
{extra}
""")
    return out


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    from nautilus_tpu.ingest import cache as cache_mod
    cdir = tmp_path / "ingest_cache"
    cdir.mkdir()
    monkeypatch.setattr(cache_mod, "cache_dir", lambda: cdir)
    yield cdir


@pytest.mark.parametrize("compression", ["lz4", "bz2"])
def test_cli_bag_to_map_e2e(tmp_path, compression, _isolated_cache):
    from nautilus_tpu import cli
    from nautilus_tpu.io.poses import read_pose_file

    bag = tmp_path / f"world_{compression}.bag"
    write_synthetic_bag(bag, num_nodes=40, world_kind="office",
                        num_beams=360, seed=4, substeps=2,
                        odom_noise_trans=0.01, odom_noise_rot=0.004)
    # write_bag compresses chunks when asked; rewrite with the requested
    # chunk compression to exercise both decoders through the CLI.
    from nautilus_tpu.ingest import rosbag as rb
    msgs = [(m.topic, m.time, m.msg) for m in rb.read_bag(bag)]
    rb.write_bag(bag, msgs, compression=compression)

    cfg_file = _write_cfg(tmp_path, bag, nodes=40)
    rc = cli.main(["--config_file", str(cfg_file), "--write", "--vectorize",
                   "--quiet"])
    assert rc in (0, None)

    poses = read_pose_file(tmp_path / "poses.txt")
    assert 20 <= len(poses) <= 40
    map_rows = (tmp_path / "map.csv").read_text().strip().splitlines()
    assert len(map_rows) >= 4  # an office yields at least a few walls

    # Second run hits the ingest cache (same digest) and must agree.
    caches = list(_isolated_cache.glob("*.npz"))
    assert len(caches) == 1
    rc2 = cli.main(["--config_file", str(cfg_file), "--write", "--quiet"])
    assert rc2 in (0, None)
    poses2 = read_pose_file(tmp_path / "poses.txt")
    assert len(poses2) == len(poses)


def test_cli_path_matches_inmemory_path(tmp_path, monkeypatch):
    """CLI plumbing (native reader + npz cache) is data-transparent:
    the direct path (pure-Python reader, no cache) lands on the same
    final cost for the same bag + config."""
    import jax.numpy as jnp
    from nautilus_tpu import cli
    from nautilus_tpu.core.preprocess import preprocess
    from nautilus_tpu.core.problem import SLAMState, build_problem
    from nautilus_tpu.ingest.builder import process_bag_file
    from nautilus_tpu.solve.solver import Solver

    bag = tmp_path / "parity.bag"
    write_synthetic_bag(bag, num_nodes=24, world_kind="office",
                        num_beams=360, seed=9, substeps=2,
                        odom_noise_trans=0.01, odom_noise_rot=0.004)
    cfg_file = _write_cfg(tmp_path, bag, nodes=24)
    cfg = load_config(str(cfg_file))

    # CLI path (native reader preferred, cache enabled).
    class _Args:
        synthetic = ""
        synthetic_seed = 0
    state_cli = cli.build_state(cfg, _Args(), verbose=False)
    stats_cli = Solver(state_cli, cfg).solve_slam()

    # In-memory path: force the pure-Python reader, skip the cache.
    import nautilus_tpu.ingest.native as native_mod
    monkeypatch.setattr(native_mod, "get_lib", lambda: None)
    raw = process_bag_file(bag, cfg, verbose=False)
    normals, pi_, pm, ei, em, _ = preprocess(raw.points, raw.points_mask,
                                             config=cfg, as_numpy=False)
    problem = build_problem(raw, normals, pi_, pm, ei, em,
                            dtype=jnp.float32)
    state_mem = SLAMState.from_problem(problem, raw.timestamps)
    stats_mem = Solver(state_mem, cfg).solve_slam()

    assert state_cli.num_nodes == state_mem.num_nodes
    np.testing.assert_allclose(stats_cli.final_cost, stats_mem.final_cost,
                               rtol=1e-5)
    np.testing.assert_allclose(state_cli.solution, state_mem.solution,
                               rtol=1e-4, atol=1e-5)


def test_gdc_scale_ingest(tmp_path):
    """GDC-scale bag (1000 poses, 720 beams, lz4 chunks) ingests through
    the native reader within bounds; the full solve at this scale runs in
    bench.py (wall-time accounted).  This pins the ingest side: node
    count from builder gating, finite clouds, monotone timestamps."""
    from nautilus_tpu.ingest.builder import process_bag_file

    bag = tmp_path / "gdc_scale.bag"
    write_synthetic_bag(bag, num_nodes=1000, world_kind="building",
                        num_beams=720, seed=1, substeps=2,
                        odom_noise_trans=0.02, odom_noise_rot=0.008)
    from nautilus_tpu.ingest import rosbag as rb
    msgs = [(m.topic, m.time, m.msg) for m in rb.read_bag(bag)]
    rb.write_bag(bag, msgs, compression="lz4")
    assert bag.stat().st_size > 1_000_000

    cfg = load_config(str(_write_cfg(tmp_path, bag, nodes=1000)))
    raw = process_bag_file(bag, cfg, verbose=False)
    n = raw.points.shape[0]
    assert 700 <= n <= 1000, n
    assert np.all(np.isfinite(raw.points[raw.points_mask]))
    assert np.all(np.diff(raw.timestamps) > 0)
    assert raw.odom_i.shape[0] == n - 1
