"""SE(3) / Euler-angle geometry and KITTI error primitives (host-side numpy).

The port's copy of ``ode_vio_tpu/utils/geometry.py``, line for line, so
that both packages score and read KITTI files with the same arithmetic.
It provides the capability surface of the reference's geometry utilities
(its ``src/data/utils.py:10-298``): Euler<->rotation-matrix
conversion with gimbal-lock handling, relative-pose extraction, pose
composition, trajectory accumulation, rotation/translation error metrics
and pose/time file I/O.

Conventions (matching the reference):
  * a 6-DoF relative pose is ``[rx, ry, rz, tx, ty, tz]`` where the
    rotation matrix is ``R = Rz(rz) @ Ry(ry) @ Rx(rx)``
    (utils.py:94-120 ``eulerAnglesToRotationMatrix``),
  * absolute poses are 4x4 homogeneous camera-to-world matrices in the
    KITTI left-camera frame.
"""

from __future__ import annotations

import numpy as np

_EPS = np.finfo(np.float64).eps * 4.0


# ---------------------------------------------------------------------------
# Rotations
# ---------------------------------------------------------------------------

def is_rotation_matrix(R: np.ndarray, tol: float = 1e-6) -> bool:
    """True iff ``R`` is orthonormal with unit determinant."""
    R = np.asarray(R, dtype=np.float64)
    return (
        np.linalg.norm(R.T @ R - np.eye(3)) < tol
        and abs(np.linalg.det(R) - 1.0) < tol * 10
    )


def euler_to_matrix(theta) -> np.ndarray:
    """Rotation matrix ``Rz(rz) @ Ry(ry) @ Rx(rx)`` from Euler angles.

    Parity: utils.py:94-120 (eulerAnglesToRotationMatrix).
    """
    rx, ry, rz = float(theta[0]), float(theta[1]), float(theta[2])
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    return np.array(
        [
            [cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz],
            [cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz],
            [-sy, sx * cy, cx * cy],
        ]
    )


def matrix_to_euler(M) -> np.ndarray:
    """Euler angles ``[rx, ry, rz]`` of a rotation matrix, with the same
    gimbal-lock branches as the reference (utils.py:24-40).

    Inverse of :func:`euler_to_matrix` away from ``|ry| = pi/2``.
    """
    M = np.asarray(M, dtype=np.float64)[:3, :3]
    cy = np.hypot(M[0, 0], M[1, 0])
    ry = np.arctan2(-M[2, 0], cy)
    if abs(ry + np.pi / 2) < _EPS:       # pitch = -90 deg
        rx = 0.0
        rz = np.arctan2(-M[1, 2], -M[0, 2])
    elif abs(ry - np.pi / 2) < _EPS:     # pitch = +90 deg
        rx = 0.0
        rz = np.arctan2(M[1, 2], M[0, 2])
    else:
        rx = np.arctan2(M[2, 1], M[2, 2])
        rz = np.arctan2(M[1, 0], M[0, 0])
    return np.array([rx, ry, rz])


def normalize_angle(angle: float) -> float:
    """Wrap an angle into ``(-pi, pi]`` (utils.py:124-131)."""
    return float((angle + np.pi) % (2.0 * np.pi) - np.pi)


# ---------------------------------------------------------------------------
# SE(3) poses
# ---------------------------------------------------------------------------

def pose6dof_to_matrix(pose) -> np.ndarray:
    """4x4 homogeneous matrix from a ``[rx,ry,rz,tx,ty,tz]`` pose
    (utils.py:134-142)."""
    T = np.eye(4)
    T[:3, :3] = euler_to_matrix(pose[:3])
    T[:3, 3] = np.asarray(pose[3:6], dtype=np.float64)
    return T


def matrix_to_pose6dof(T) -> np.ndarray:
    """``[rx,ry,rz,tx,ty,tz]`` from a 4x4 homogeneous matrix."""
    T = np.asarray(T, dtype=np.float64)
    return np.concatenate([matrix_to_euler(T[:3, :3]), T[:3, 3]])


def relative_pose(T1, T2) -> np.ndarray:
    """``T1^{-1} @ T2`` (utils.py:43-49)."""
    return np.linalg.inv(np.asarray(T1, dtype=np.float64)) @ np.asarray(
        T2, dtype=np.float64
    )


def relative_pose6dof(T1, T2) -> np.ndarray:
    """Relative 6-DoF pose between two absolute poses (utils.py:52-68)."""
    return matrix_to_pose6dof(relative_pose(T1, T2))


def compose_pose_changes(pose1, pose2) -> np.ndarray:
    """Compose two consecutive relative 6-DoF poses into one
    (frame-dropout support; utils.py:163-191)."""
    return matrix_to_pose6dof(pose6dof_to_matrix(pose1) @ pose6dof_to_matrix(pose2))


def accumulate_path(rel_poses) -> list[np.ndarray]:
    """Integrate relative 6-DoF poses into a global trajectory starting at
    identity; returns N+1 4x4 matrices (utils.py:145-161 ``path_accu``)."""
    rel_poses = np.asarray(rel_poses, dtype=np.float64)
    out = [np.eye(4)]
    for k in range(rel_poses.shape[0]):
        out.append(out[-1] @ pose6dof_to_matrix(rel_poses[k]))
    return out


# ---------------------------------------------------------------------------
# Error metrics
# ---------------------------------------------------------------------------

def rotation_error(T1, T2) -> float:
    """Geodesic rotation angle between two poses (utils.py:71-80)."""
    E = relative_pose(T1, T2)
    d = 0.5 * (np.trace(E[:3, :3]) - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def translation_error(T1, T2) -> float:
    """Euclidean translation distance between two poses (utils.py:83-91)."""
    return float(np.linalg.norm(relative_pose(T1, T2)[:3, 3]))


def rmse_6dof(pose_est, pose_gt) -> tuple[float, float]:
    """(t_rmse, r_rmse) over relative 6-DoF pose arrays (utils.py:198-204)."""
    pose_est = np.asarray(pose_est, dtype=np.float64)
    pose_gt = np.asarray(pose_gt, dtype=np.float64)
    t_rmse = np.sqrt(np.mean(np.sum((pose_est[:, 3:] - pose_gt[:, 3:]) ** 2, -1)))
    r_rmse = np.sqrt(np.mean(np.sum((pose_est[:, :3] - pose_gt[:, :3]) ** 2, -1)))
    return float(t_rmse), float(r_rmse)


def trajectory_distances(poses) -> tuple[np.ndarray, np.ndarray]:
    """Cumulative distance and per-frame speed (at 10 Hz) along a
    trajectory of 4x4 poses (utils.py:207-223)."""
    xyz = np.asarray([P[:3, 3] for P in poses])
    step = np.linalg.norm(np.diff(xyz, axis=0), axis=1)
    dist = np.concatenate([[0.0], np.cumsum(step)])
    speed = np.concatenate([[0.0], step * 10.0])
    return dist, speed


def last_frame_from_segment_length(dist, first_frame: int, length: float) -> int:
    """First index whose cumulative distance exceeds
    ``dist[first_frame] + length``, or -1 (utils.py:226-230)."""
    later = np.nonzero(dist[first_frame:] > dist[first_frame] + length)[0]
    return int(later[0] + first_frame) if later.size else -1


# ---------------------------------------------------------------------------
# File I/O (KITTI formats)
# ---------------------------------------------------------------------------

def read_pose_file(path) -> tuple[np.ndarray, np.ndarray]:
    """Read a KITTI pose txt (N rows of 12 floats) into absolute 4x4 poses
    and relative 6-DoF pose changes (utils.py:265-279)."""
    table = np.loadtxt(path).reshape(-1, 3, 4)
    n = table.shape[0]
    abs_poses = np.tile(np.eye(4), (n, 1, 1))
    abs_poses[:, :3, :] = table
    rel = np.stack(
        [relative_pose6dof(abs_poses[i], abs_poses[i + 1]) for i in range(n - 1)]
    ) if n > 1 else np.zeros((0, 6))
    return abs_poses, rel


def read_time_file(path) -> np.ndarray:
    """Read a KITTI times.txt; asserts strictly ascending timestamps
    (utils.py:282-290)."""
    ts = np.loadtxt(path).reshape(-1)
    if not np.all(np.diff(ts) > 0):
        raise ValueError(f"timestamps in {path} are not strictly ascending")
    return ts


def save_trajectory(poses, path) -> None:
    """Write 4x4 poses as KITTI 12-float rows (utils.py:293-298)."""
    rows = np.asarray([np.asarray(P)[:3, :4].reshape(-1) for P in poses])
    np.savetxt(path, rows, fmt="%.9g")
