"""chip_smoke.py's host-side helpers (its GPU phases run only on a card).

The main-path phase checks ATE against the synthetic ground truth and
places its HITL edits in the map frame; both rest on how
write_synthetic_bag stamps scans and on the map frame starting at the
first captured node, which these tests pin on a small bag.
"""

import os
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
import chip_smoke as cs  # noqa: E402

from nautilus_tpu.core.luaconf import load_config  # noqa: E402
from nautilus_tpu.ingest.builder import process_bag_file  # noqa: E402
from nautilus_tpu.utils.metrics import ate  # noqa: E402


def _to_frame(poses, first):
    c, s = np.cos(first[2]), np.sin(first[2])
    d = poses[:, :2] - first[:2]
    th = np.arctan2(np.sin(poses[:, 2] - first[2]),
                    np.cos(poses[:, 2] - first[2]))
    return np.stack([c * d[:, 0] + s * d[:, 1],
                     -s * d[:, 0] + c * d[:, 1], th], axis=1)


def test_bag_ground_truth_is_the_map_frame_truth(tmp_path):
    nodes = 40
    bag = str(tmp_path / "b.bag")
    cs.write_bag(bag, nodes)
    cfg = load_config(cs.write_config(str(tmp_path), bag, nodes))
    raw = process_bag_file(bag, cfg, verbose=False)
    gt = cs.bag_ground_truth(raw.timestamps, nodes)
    assert gt.shape == (len(raw.timestamps), 3)
    # Odometry integrates from the first captured node at the origin, so
    # the truth moved into that node's frame matches it WITHOUT alignment,
    # up to the odometry's drift (a wrong frame or stamp mapping is off by
    # metres).
    np.testing.assert_allclose(raw.initial_poses[0], 0.0, atol=1e-9)
    err = ate(raw.initial_poses, _to_frame(gt, gt[0]), align=False)
    assert err["trans_rmse"] < 0.3, err


def test_edits_in_map_frame(monkeypatch):
    monkeypatch.setattr(cs, "HITL_EDITS_WORLD",
                        ((1, 2, 1, 3, 0, 2, 1, 2),))
    (line,) = cs.edits_in_map_frame(np.array([1.0, 2.0, np.pi / 2]))
    vals = np.array([float(v) for v in line.split()]).reshape(4, 2)
    # The first pose maps to the origin; one unit along its heading
    # (world +y) maps to +x; one unit to its left (world -x) to +y.
    np.testing.assert_allclose(vals, [[0, 0], [1, 0], [0, 1], [0, 0]],
                               atol=1e-4)
    assert pytest.approx(np.hypot(*vals[1])) == 1.0
