"""End-to-end CLI tests (in-process, CPU)."""

import numpy as np
import pytest

from nautilus_tpu import cli
from nautilus_tpu.ingest.synthetic import write_synthetic_bag

BASE = """
pose_number={n}
differential_odom=false
max_lidar_range=30
rotation_change_for_lidar=math.pi / 18
translation_change_for_lidar=0.25
lidar_topic="/scan"
odom_topic="/odom"
translation_weight=1
rotation_weight=1
lidar_constraint_amount_min=1
lidar_constraint_amount_max=2
outlier_threshold=0.25
hitl_line_width=0.3
hitl_pose_point_threshold=10
pose_output_file="{poses}"
map_output_file="{map}"
bag_path="{bag}"
"""


def _write_cfg(tmp_path, n=8, bag=""):
    cfg = tmp_path / "run.lua"
    cfg.write_text(BASE.format(n=n, poses=tmp_path / "poses.txt",
                               map=tmp_path / "map.txt", bag=bag))
    return cfg


def test_synthetic_solve_write_vectorize(tmp_path):
    cfg = _write_cfg(tmp_path, n=8)
    rc = cli.main(["--config_file", str(cfg), "--synthetic", "room",
                   "--write", "--vectorize", "--quiet"])
    assert rc == 0
    poses = (tmp_path / "poses.txt").read_text().strip().splitlines()
    assert len(poses) == 8
    assert (tmp_path / "map.txt").exists()


def test_bag_solve_with_hitl_replay(tmp_path):
    bag = tmp_path / "run.bag"
    write_synthetic_bag(bag, num_nodes=8, world_kind="room", num_beams=360,
                        seed=3)
    cfg = _write_cfg(tmp_path, n=8, bag=bag)
    replay = tmp_path / "hitl.txt"
    # A line pair over the room's south wall (y=-5).
    replay.write_text("# comment line\n-4.5 -5.0 4.5 -5.0 -4.5 -4.7 4.5 -4.7\n")
    rc = cli.main(["--config_file", str(cfg), "--hitl_replay", str(replay),
                   "--write", "--quiet"])
    assert rc == 0
    assert (tmp_path / "poses.txt").exists()


def test_solution_poses_resume(tmp_path):
    cfg = _write_cfg(tmp_path, n=6)
    rc = cli.main(["--config_file", str(cfg), "--synthetic", "room",
                   "--write", "--quiet"])
    assert rc == 0
    first = (tmp_path / "poses.txt").read_text()
    # Resume from the written solution; solve converges immediately and the
    # rewritten poses match.
    rc = cli.main(["--config_file", str(cfg), "--synthetic", "room",
                   "--solution_poses", str(tmp_path / "poses.txt"),
                   "--write", "--quiet"])
    assert rc == 0
    second = (tmp_path / "poses.txt").read_text()
    a = np.array([[float(v) for v in l.split()] for l in first.splitlines()])
    b = np.array([[float(v) for v in l.split()] for l in second.splitlines()])
    np.testing.assert_allclose(a, b, atol=0.02)


def test_missing_config_keys_fail_fast(tmp_path):
    cfg = tmp_path / "bad.lua"
    cfg.write_text("pose_number=5\n")
    from nautilus_tpu.core.luaconf import LuaConfigError
    with pytest.raises(LuaConfigError):
        cli.main(["--config_file", str(cfg), "--synthetic", "room",
                  "--quiet"])


def test_multichip_devices_flag_matches_single_device(tmp_path):
    """--devices 8 routes the solve through the factor-sharded sweep on
    the virtual CPU mesh and produces the same poses as single-device
    (multi-device reachable from the product surface)."""
    cfg = _write_cfg(tmp_path, n=8)
    rc = cli.main(["--config_file", str(cfg), "--synthetic", "room",
                   "--write", "--quiet"])
    assert rc == 0
    single = (tmp_path / "poses.txt").read_text()
    rc = cli.main(["--config_file", str(cfg), "--synthetic", "room",
                   "--devices", "8", "--write", "--quiet"])
    assert rc == 0
    sharded = (tmp_path / "poses.txt").read_text()
    a = np.array([[float(v) for v in l.split()] for l in single.splitlines()])
    b = np.array([[float(v) for v in l.split()]
                  for l in sharded.splitlines()])
    np.testing.assert_allclose(b, a, atol=2e-3)


def test_multichip_config_key_and_overask(tmp_path):
    """mesh_devices config key selects the mesh; asking for more devices
    than visible fails fast."""
    cfg = tmp_path / "run.lua"
    cfg.write_text(BASE.format(n=6, poses=tmp_path / "poses.txt",
                               map=tmp_path / "map.txt", bag="")
                   + "mesh_devices=8\n")
    rc = cli.main(["--config_file", str(cfg), "--synthetic", "room",
                   "--write", "--quiet"])
    assert rc == 0
    assert (tmp_path / "poses.txt").exists()
    rc = cli.main(["--config_file", str(cfg), "--synthetic", "room",
                   "--devices", "4096", "--quiet"])
    assert rc == 1
