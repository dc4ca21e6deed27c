"""Lua config front-end tests against the shipped config/*.lua surface."""

import math
from pathlib import Path

import pytest

from nautilus_tpu.core.luaconf import (Config, LuaConfigError, load_config,
                                       load_config_text)

CONFIG_DIR = Path(__file__).resolve().parent.parent / "config"


def test_default_config_keys():
    cfg = load_config(CONFIG_DIR / "default_config.lua")
    assert cfg.pose_number == 30
    assert cfg.translation_weight == 1
    assert cfg.rotation_change_for_lidar == pytest.approx(math.pi / 18)
    assert cfg.differential_odom is False
    assert cfg.pose_output_file == "poses.txt"
    assert cfg.outlier_threshold == 0.25
    assert cfg.get_int("lidar_constraint_amount_max") == 10
    assert cfg.nc_bin_number == 32
    assert cfg.hitl_lc_topic == "/hitl_slam_input"
    # -3.5 = measured operating point on the engine score scale (DEVIATIONS §3)
    assert cfg.csm_score_threshold == -3.5
    # Derived keys use earlier variables and math.pi.
    expected_tsd = (1 / 10.0) * 0.25 + (1 / 20.0) * (math.pi / 18)
    assert cfg.translation_standard_deviation == pytest.approx(expected_tsd)


def test_dofile_include_and_override():
    cfg = load_config(CONFIG_DIR / "gdc_2020_config.lua")
    assert cfg.pose_number == 1000
    assert cfg.differential_odom is True
    assert cfg.translation_weight == 2
    assert cfg.max_lidar_range == 8.5
    # Inherited from the default file.
    assert cfg.outlier_threshold == 0.25
    assert cfg.lidar_topic == "/Cobot/Laser"


def test_dofile_absolute_path(tmp_path):
    """A config outside config/ can include the defaults by absolute path
    (chip_smoke.py writes its run config next to its bag)."""
    cfg_file = tmp_path / "run.lua"
    cfg_file.write_text(
        f'dofile("{CONFIG_DIR / "default_config.lua"}")\n'
        'pose_number=1000\n'
        'auto_lc=true\n')
    cfg = load_config(cfg_file)
    assert cfg.pose_number == 1000
    assert cfg.auto_lc is True
    assert cfg.outlier_threshold == 0.25


def test_require_include():
    cfg = load_config(CONFIG_DIR / "turtlebot_config.lua")
    assert cfg.pose_number == 1000
    assert cfg.lidar_constraint_amount_min == 4
    assert cfg.rotation_change_for_lidar == pytest.approx(math.pi / 30)
    # Re-derived standard deviations pick up the overridden scalings.
    expected = (1 / 50.0) * 0.15 + (1 / 50.0) * (math.pi / 30)
    assert cfg.translation_standard_deviation == pytest.approx(expected)


def test_all_shipped_configs_load():
    for f in CONFIG_DIR.glob("*.lua"):
        cfg = load_config(f)
        assert "pose_number" in cfg, f.name


def test_expressions():
    cfg = load_config_text("""
a = 2 + 3 * 4
b = (2 + 3) * 4
c = math.pi / 2
d = -a
e = "hello"
f = true
g = 2^10
h = a / 2
""")
    assert cfg.a == 14
    assert cfg.b == 20
    assert cfg.c == pytest.approx(math.pi / 2)
    assert cfg.d == -14
    assert cfg.e == "hello"
    assert cfg.f is True
    assert cfg.g == 1024
    assert cfg.h == 7


def test_comments_stripped():
    cfg = load_config_text("""
--[[ block
comment ]]--
x = 1 -- trailing
-- whole line
y = "with -- inside"
""")
    assert cfg.x == 1
    assert cfg.y == "with -- inside"


def test_unknown_identifier_raises():
    with pytest.raises(LuaConfigError):
        load_config_text("x = not_defined + 1")


def test_replace_returns_new_config():
    cfg = load_config_text("x = 1")
    cfg2 = cfg.replace(x=5.0)
    assert cfg.x == 1 and cfg2.x == 5.0
