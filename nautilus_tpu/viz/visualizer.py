"""Visualization backends for solver progress.

The reference publishes 7 rviz topics every LM iteration
(/nautilus/{all_points, all_poses, edge_points, planar_points,
correspondences, auto_lc_scans, covariances} — reference
src/visualization/solver_vis_ros.cc:114-127, redrawn from a
ceres::IterationCallback, solver_vis.h:18-22).  Per-iteration host
callbacks would serialize the device loop, so this engine snapshots at window
granularity (documented deviation; the data content matches the topics):

- ``SolverVisualizer``: abstract interface (mirrors solver_vis.h:12-43).
- ``SnapshotVisualizer``: records pose/cloud snapshots in memory and
  optionally to npz files — the headless "topic" stream.
- ``MatplotlibVisualizer``: renders the transformed map to PNG per draw
  (replaces the CImg debug rasterizer, cimg_debug.h:15-114).
- ``RosBridgeVisualizer``: republishes through rospy when available (kept
  off the hot path; import-gated so the library never requires ROS).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np

from nautilus_tpu.core import geometry as geo


def transformed_clouds(state, subset: str = "all") -> np.ndarray:
    """All clouds in world frame at the current solution, concatenated."""
    problem = state.problem
    if subset == "all":
        pts = np.asarray(problem.points, np.float64)
        mask = np.asarray(problem.points_mask)
    elif subset == "planar":
        pts = np.asarray(problem.planar_points, np.float64)
        mask = np.asarray(problem.planar_mask)
    elif subset == "edge":
        pts = np.asarray(problem.edge_points, np.float64)
        mask = np.asarray(problem.edge_mask)
    else:
        raise ValueError(subset)
    out = []
    for i in range(state.num_nodes):
        p = pts[i][mask[i]]
        th = state.solution[i, 2]
        c, s = np.cos(th), np.sin(th)
        out.append(p @ np.array([[c, s], [-s, c]]) + state.solution[i, :2])
    return np.concatenate(out, axis=0) if out else np.zeros((0, 2))


class SolverVisualizer:
    """Abstract visualizer (reference solver_vis.h:12-43)."""

    def draw_solution(self, state, window: Optional[int] = None) -> None:
        pass

    def draw_correspondence(self, correspondences) -> None:
        pass

    def draw_scans(self, state, scan_indices: List[int]) -> None:
        pass

    def draw_covariances(self, covariances) -> None:
        pass


@dataclasses.dataclass
class Snapshot:
    window: Optional[int]
    poses: np.ndarray
    all_points: Optional[np.ndarray] = None
    planar_points: Optional[np.ndarray] = None
    edge_points: Optional[np.ndarray] = None


class SnapshotVisualizer(SolverVisualizer):
    """Records per-draw snapshots; optionally persists them as npz."""

    def __init__(self, output_dir=None, record_clouds: bool = True):
        self.output_dir = Path(output_dir) if output_dir else None
        self.record_clouds = record_clouds
        self.snapshots: List[Snapshot] = []
        self.lc_scans: List[List[int]] = []
        self.covariances: list = []
        self.correspondences: list = []
        if self.output_dir:
            self.output_dir.mkdir(parents=True, exist_ok=True)

    def draw_correspondence(self, correspondences) -> None:
        """Record match endpoints (the /nautilus/correspondences line-list
        content, solver_vis_ros.cc:140-164): masked (source, target) point
        pairs with their node indices, in sensor frames."""
        mask = np.asarray(correspondences.mask)
        if mask.size == 0:
            return
        q, s = np.nonzero(mask)
        self.correspondences.append(dict(
            src_node=np.asarray(correspondences.src)[q],
            tgt_node=np.asarray(correspondences.tgt)[q],
            src_pts=np.asarray(correspondences.src_pts)[q, s],
            tgt_pts=np.asarray(correspondences.tgt_pts)[q, s]))

    def draw_solution(self, state, window: Optional[int] = None) -> None:
        snap = Snapshot(window=window, poses=state.solution.copy())
        if self.record_clouds:
            snap.all_points = transformed_clouds(state, "all")
            snap.planar_points = transformed_clouds(state, "planar")
            snap.edge_points = transformed_clouds(state, "edge")
        self.snapshots.append(snap)
        if self.output_dir:
            idx = len(self.snapshots) - 1
            np.savez_compressed(
                self.output_dir / f"snapshot_{idx:04d}.npz",
                window=-1 if window is None else window,
                poses=snap.poses,
                **{k: v for k, v in (("all_points", snap.all_points),
                                     ("planar_points", snap.planar_points),
                                     ("edge_points", snap.edge_points))
                   if v is not None})

    def draw_scans(self, state, scan_indices: List[int]) -> None:
        self.lc_scans.append(list(scan_indices))

    def draw_covariances(self, covariances) -> None:
        self.covariances.append(covariances)


class MatplotlibVisualizer(SolverVisualizer):
    """Render the current map to PNG on each draw (off the hot path)."""

    def __init__(self, output_dir, dpi: int = 120):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.dpi = dpi
        self.count = 0

    def draw_solution(self, state, window: Optional[int] = None) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        cloud = transformed_clouds(state, "all")
        fig, ax = plt.subplots(figsize=(8, 8))
        if len(cloud):
            ax.plot(cloud[:, 0], cloud[:, 1], ".", ms=0.5, color="#333333")
        ax.plot(state.solution[:, 0], state.solution[:, 1], "-", lw=0.8,
                color="tab:red")
        ax.set_aspect("equal")
        tag = "init" if window is None else f"w{window}"
        ax.set_title(f"nautilus_tpu map ({tag})")
        fig.savefig(self.output_dir / f"map_{self.count:04d}_{tag}.png",
                    dpi=self.dpi, bbox_inches="tight")
        plt.close(fig)
        self.count += 1


def correspondence_world_endpoints(state, correspondences):
    """Masked match endpoints transformed to world frame — the content of
    the /nautilus/correspondences LINE_LIST (solver_vis_ros.cc:140-164)."""
    mask = np.asarray(correspondences.mask)
    if mask.size == 0 or not mask.any():
        return np.zeros((0, 2)), np.zeros((0, 2))
    q, s = np.nonzero(mask)
    src_n = np.asarray(correspondences.src)[q]
    tgt_n = np.asarray(correspondences.tgt)[q]
    src_p = np.asarray(correspondences.src_pts, np.float64)[q, s]
    tgt_p = np.asarray(correspondences.tgt_pts, np.float64)[q, s]
    sol = state.solution

    def to_world(nodes, pts):
        th = sol[nodes, 2]
        c, sn = np.cos(th), np.sin(th)
        x = c * pts[:, 0] - sn * pts[:, 1] + sol[nodes, 0]
        y = sn * pts[:, 0] + c * pts[:, 1] + sol[nodes, 1]
        return np.stack([x, y], axis=1)

    return to_world(src_n, src_p), to_world(tgt_n, tgt_p)


class RosBridgeVisualizer(SolverVisualizer):
    """Publish the reference's full 7-topic surface via rospy when present
    (solver_vis_ros.cc:114-127) plus the vectorize /debug_lines marker
    (solver.cc:597-604)."""

    def __init__(self, topic_prefix: str = "/nautilus"):
        self.topic_prefix = topic_prefix
        self._pubs = {}
        self._marker_id = 0
        self._cov_seq = 0
        self._last_state = None
        try:
            import rospy
            from geometry_msgs.msg import (PoseArray,
                                           PoseWithCovarianceStamped)
            from sensor_msgs.msg import PointCloud2
            from visualization_msgs.msg import Marker
            self._available = True
            # Publishers are created once: per-call registration would be
            # garbage-collected before subscriber handshakes complete.
            self._pubs["all_poses"] = rospy.Publisher(
                f"{topic_prefix}/all_poses", PoseArray, queue_size=1,
                latch=True)
            for topic in ("all_points", "planar_points", "edge_points",
                          "auto_lc_scans"):
                self._pubs[topic] = rospy.Publisher(
                    f"{topic_prefix}/{topic}", PointCloud2, queue_size=1,
                    latch=True)
            self._pubs["correspondences"] = rospy.Publisher(
                f"{topic_prefix}/correspondences", Marker, queue_size=10)
            self._pubs["covariances"] = rospy.Publisher(
                f"{topic_prefix}/covariances", PoseWithCovarianceStamped,
                queue_size=10)
            # Vectorize marker; reference advertises it at global scope
            # (solver.cc:597-598).
            self._pubs["debug_lines"] = rospy.Publisher(
                "/debug_lines", Marker, queue_size=1, latch=True)
        except ImportError:
            self._available = False

    @property
    def available(self) -> bool:
        return self._available

    # -- dict -> rospy message copies ---------------------------------------

    def _publish_cloud(self, topic: str, points) -> None:
        from sensor_msgs.msg import PointCloud2, PointField
        from nautilus_tpu.viz.ros_encode import encode_pointcloud2
        enc = encode_pointcloud2(points)
        pc = PointCloud2()
        pc.header.frame_id = enc["frame_id"]
        pc.height = enc["height"]
        pc.width = enc["width"]
        pc.fields = [PointField(name=f["name"], offset=f["offset"],
                                datatype=f["datatype"], count=f["count"])
                     for f in enc["fields"]]
        pc.is_bigendian = enc["is_bigendian"]
        pc.point_step = enc["point_step"]
        pc.row_step = enc["row_step"]
        pc.is_dense = enc["is_dense"]
        pc.data = enc["data"]
        self._pubs[topic].publish(pc)

    def _publish_marker(self, topic: str, enc: dict) -> None:
        from geometry_msgs.msg import Point
        from std_msgs.msg import ColorRGBA
        from visualization_msgs.msg import Marker
        m = Marker()
        m.header.frame_id = enc["frame_id"]
        m.id = enc["id"]
        m.type = enc["type"]
        m.action = enc["action"]
        m.pose.orientation.w = enc["pose"]["qw"]
        m.scale.x = enc["scale_x"]
        m.color = ColorRGBA(**enc["color"])
        m.points = [Point(**p) for p in enc["points"]]
        m.colors = [ColorRGBA(**c) for c in enc["colors"]]
        self._pubs[topic].publish(m)

    # -- the 7 topics --------------------------------------------------------

    def draw_solution(self, state, window: Optional[int] = None) -> None:
        if not self._available:
            return
        self._last_state = state
        from geometry_msgs.msg import PoseArray, Pose
        from nautilus_tpu.viz.ros_encode import encode_pose_array
        enc = encode_pose_array(state.solution)
        msg = PoseArray()
        msg.header.frame_id = enc["frame_id"]
        for d in enc["poses"]:
            p = Pose()
            p.position.x, p.position.y = d["x"], d["y"]
            p.orientation.z, p.orientation.w = d["qz"], d["qw"]
            msg.poses.append(p)
        self._pubs["all_poses"].publish(msg)
        for subset, topic in (("all", "all_points"),
                              ("planar", "planar_points"),
                              ("edge", "edge_points")):
            self._publish_cloud(topic, transformed_clouds(state, subset))

    def draw_correspondence(self, correspondences) -> None:
        if not self._available or self._last_state is None:
            return
        from nautilus_tpu.viz.ros_encode import encode_marker_line_list
        starts, ends = correspondence_world_endpoints(
            self._last_state, correspondences)
        if not len(starts):
            return   # reference skips empty correspondences (cc:143-146)
        enc = encode_marker_line_list(starts, ends,
                                      marker_id=self._marker_id)
        self._marker_id += 1
        self._publish_marker("correspondences", enc)

    def draw_scans(self, state, scan_indices: List[int]) -> None:
        if not self._available:
            return
        pts = np.asarray(state.problem.points, np.float64)
        mask = np.asarray(state.problem.points_mask)
        out = []
        for i in scan_indices:
            p = pts[i][mask[i]]
            th = state.solution[i, 2]
            c, s = np.cos(th), np.sin(th)
            out.append(p @ np.array([[c, s], [-s, c]])
                       + state.solution[i, :2])
        cloud = np.concatenate(out, axis=0) if out else np.zeros((0, 2))
        self._publish_cloud("auto_lc_scans", cloud)

    def draw_covariances(self, covariances) -> None:
        """covariances: [(node_idx, cov)] pairs, published one
        PoseWithCovarianceStamped each (solver_vis_ros.cc:178-204)."""
        if not self._available or self._last_state is None:
            return
        from geometry_msgs.msg import PoseWithCovarianceStamped
        from nautilus_tpu.viz.ros_encode import encode_pose_with_covariance
        for node_idx, cov in covariances:
            enc = encode_pose_with_covariance(
                self._last_state.solution[node_idx], cov, seq=self._cov_seq)
            self._cov_seq += 1
            msg = PoseWithCovarianceStamped()
            msg.header.frame_id = enc["frame_id"]
            msg.header.seq = enc["seq"]
            msg.pose.pose.position.x = enc["pose"]["x"]
            msg.pose.pose.position.y = enc["pose"]["y"]
            msg.pose.pose.orientation.z = enc["pose"]["qz"]
            msg.pose.pose.orientation.w = enc["pose"]["qw"]
            msg.pose.covariance = enc["covariance"]
            self._pubs["covariances"].publish(msg)

    def publish_debug_lines(self, segments) -> None:
        """Vectorize output marker: white LINE_LIST on /debug_lines
        (solver.cc:593-604,620-623)."""
        if not self._available or not segments:
            return
        from nautilus_tpu.viz.ros_encode import (COLOR_WHITE,
                                                 encode_marker_line_list)
        starts = np.asarray([s for s, _ in segments])
        ends = np.asarray([e for _, e in segments])
        enc = encode_marker_line_list(starts, ends, color=COLOR_WHITE,
                                      marker_id=self._marker_id)
        self._marker_id += 1
        self._publish_marker("debug_lines", enc)
