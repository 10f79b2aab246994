"""Counterpart of solve_keyframe_pose_graph_tpu/utils/colors.py, the same code.

Deterministic diagnostic colors (FalseColors analog, matplotlib-free).

Mirrors the reference's two facilities (utils/FalseColors.h):
  * false_color(v): COLORMAP_HOT-style mapping of a scalar in [0,1] to RGB —
    used to color loop edges by residual weight / switch value
    (FalseColors.h:29-59, VizPoseGraph.cpp:378-445).
  * world_color(rng): deterministic per-world color via HSV hue
    (5458 / (rng+1)) % 255 (FalseColors.h:75-105) — used for per-world
    trajectory strips (Composer.cpp:318-332).
"""

from __future__ import annotations

import colorsys


def false_color(v: float) -> tuple[float, float, float]:
    """Scalar in [0,1] -> (r,g,b) in [0,1], black->red->yellow->white ramp
    (OpenCV COLORMAP_HOT shape)."""
    v = min(max(float(v), 0.0), 1.0)
    r = min(1.0, 3.0 * v)
    g = min(1.0, max(0.0, 3.0 * v - 1.0))
    b = min(1.0, max(0.0, 3.0 * v - 2.0))
    return (r, g, b)


def world_color(world_id: int) -> tuple[float, float, float]:
    """Deterministic per-world RGB (FalseColors::randomColor semantics:
    hue = (5458 / (id+1)) % 255 over the OpenCV 0-255 hue wheel)."""
    if world_id < 0:
        return (0.5, 0.5, 0.5)   # dead-zone grey
    hue255 = (5458.0 / (world_id + 1.0)) % 255.0
    r, g, b = colorsys.hsv_to_rgb(hue255 / 255.0, 0.85, 0.95)
    return (r, g, b)
