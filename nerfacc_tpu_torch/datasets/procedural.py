"""Camera poses for the procedural scene (port of
``nerfacc_tpu/datasets/procedural.py:93``; the scene itself is not ported)."""

from __future__ import annotations

import numpy as np


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Blender-style look-at-origin camera pose (OpenGL convention), 4x4."""
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rot_phi = np.eye(4, dtype=np.float32)
    rot_phi[1, 1] = np.cos(phi)
    rot_phi[1, 2] = -np.sin(phi)
    rot_phi[2, 1] = np.sin(phi)
    rot_phi[2, 2] = np.cos(phi)
    rot_theta = np.eye(4, dtype=np.float32)
    rot_theta[0, 0] = np.cos(theta)
    rot_theta[0, 2] = -np.sin(theta)
    rot_theta[2, 0] = np.sin(theta)
    rot_theta[2, 2] = np.cos(theta)
    return rot_theta @ rot_phi @ trans
