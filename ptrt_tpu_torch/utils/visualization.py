"""Debug-geometry generators — a numpy copy of
``ptrt_tpu/utils/visualization.py``: cylinders, cones, arrows with LOD,
lines, camera frustum wireframes, image planes and debug-ray meshes, as
triangle soups (T, 3, 3) feeding the normal mesh path (the wireframe
render itself is ``Scene.render_wireframe``).  The camera-based generators
read a camera's ``origin``, ``u``, ``v``, ``w`` (and ``fov``) as floats.
"""

from __future__ import annotations

import numpy as np

from ptrt_tpu_torch.geometry.mesh import Mesh


def generate_cylinder(radius: float, height: float,
                      segments: int = 8) -> np.ndarray:
    """Triangle soup (T, 3, 3) for a y-axis cylinder from 0..height
    (``visualization.cu:43-83``)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    nxt = np.roll(np.arange(segments), -1)
    x, z = radius * np.cos(ang), radius * np.sin(ang)
    lo = np.stack([x, np.zeros(segments), z], -1)
    hi = lo + np.array([0, height, 0])
    tris = []
    for i in range(segments):
        j = nxt[i]
        tris.append([lo[i], hi[i], lo[j]])
        tris.append([lo[j], hi[i], hi[j]])
        # caps
        tris.append([[0, 0, 0], lo[j], lo[i]])
        tris.append([[0, height, 0], hi[i], hi[j]])
    return np.asarray(tris, np.float32)


def generate_cone(radius: float, height: float,
                  segments: int = 8) -> np.ndarray:
    """y-axis cone, apex at height (``visualization.cu:85-142``)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    nxt = np.roll(np.arange(segments), -1)
    x, z = radius * np.cos(ang), radius * np.sin(ang)
    base = np.stack([x, np.zeros(segments), z], -1)
    apex = np.array([0, height, 0], np.float32)
    tris = []
    for i in range(segments):
        j = nxt[i]
        tris.append([base[i], apex, base[j]])
        tris.append([[0, 0, 0], base[j], base[i]])
    return np.asarray(tris, np.float32)


def _frame_from_dir(d: np.ndarray):
    d = d / max(np.linalg.norm(d), 1e-12)
    up = np.array([0, 1, 0.0]) if abs(d[1]) < 0.999 else np.array([1, 0, 0.0])
    t = np.cross(up, d)
    t /= max(np.linalg.norm(t), 1e-12)
    b = np.cross(d, t)
    return t, b, d


def _orient(tris: np.ndarray, origin, direction) -> np.ndarray:
    """Map y-axis-aligned soup onto ``direction`` at ``origin``."""
    t, b, d = _frame_from_dir(np.asarray(direction, np.float64))
    m = np.stack([t, d, b], axis=1)  # local y -> direction
    return (tris @ m.T + np.asarray(origin)).astype(np.float32)


def generate_arrow(origin, direction, length: float,
                   shaft_radius: float = 0.02, lod: int = 1) -> np.ndarray:
    """Cylinder shaft + cone head with LOD segment counts
    (``visualization.cu:144-216``)."""
    segments = {0: 4, 1: 8, 2: 16}.get(lod, 8)
    shaft_len = length * 0.75
    head_len = length * 0.25
    head_radius = shaft_radius * 3.0
    shaft = generate_cylinder(shaft_radius, shaft_len, segments)
    cone = generate_cone(head_radius, head_len, segments)
    cone = cone + np.array([0, shaft_len, 0], np.float32)
    return _orient(np.concatenate([shaft, cone]), origin, direction)


def generate_line(a, b, thickness: float = 0.01,
                  segments: int = 4) -> np.ndarray:
    """Thin cylinder between two points (``visualization.cu:275`` usage)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    length = float(np.linalg.norm(b - a))
    cyl = generate_cylinder(thickness, length, segments)
    return _orient(cyl, a, b - a)


def generate_frustum_wireframe(camera, aspect: float, far_dist: float = 5.0,
                               thickness: float = 0.01,
                               fov: float | None = None) -> np.ndarray:
    """Camera frustum as 12 wireframe line cylinders
    (``visualization.cu:218-313``).  ``fov`` (degrees): the camera's
    ``fov`` where it has one, else read back from its projection matrix
    (the port's ``Camera`` keeps its fov only there)."""
    import math

    if fov is None:
        fov = getattr(camera, "fov", None)
    if fov is None:
        fov = math.degrees(2.0 * math.atan(1.0 / float(camera.proj[1, 1])))

    origin = np.array([float(camera.origin.x), float(camera.origin.y),
                       float(camera.origin.z)])
    fwd = -np.array([float(camera.w.x), float(camera.w.y), float(camera.w.z)])
    u = np.array([float(camera.u.x), float(camera.u.y), float(camera.u.z)])
    v = np.array([float(camera.v.x), float(camera.v.y), float(camera.v.z)])
    fov = math.radians(float(fov))
    hh = math.tan(fov / 2) * far_dist
    hw = hh * aspect
    center = origin + fwd * far_dist
    corners = [center + u * sx * hw + v * sy * hh
               for sx, sy in [(-1, -1), (1, -1), (1, 1), (-1, 1)]]
    tris = []
    for c in corners:
        tris.append(generate_line(origin, c, thickness))
    for i in range(4):
        tris.append(generate_line(corners[i], corners[(i + 1) % 4], thickness))
    return np.concatenate(tris)


def generate_image_plane(width: float, height: float, distance: float,
                         camera=None) -> np.ndarray:
    """Quad facing the camera at ``distance`` (``visualization.cu:316+``)."""
    hw, hh = width / 2, height / 2
    quad = np.array([
        [[-hw, -hh, 0], [hw, hh, 0], [hw, -hh, 0]],
        [[-hw, -hh, 0], [-hw, hh, 0], [hw, hh, 0]],
    ], np.float32)
    if camera is None:
        return quad + np.array([0, 0, -distance], np.float32)
    origin = np.array([float(camera.origin.x), float(camera.origin.y),
                       float(camera.origin.z)])
    fwd = -np.array([float(camera.w.x), float(camera.w.y), float(camera.w.z)])
    u = np.array([float(camera.u.x), float(camera.u.y), float(camera.u.z)])
    v = np.array([float(camera.v.x), float(camera.v.y), float(camera.v.z)])
    m = np.stack([u, v, fwd], axis=1)
    return (quad @ m.T + (origin + fwd * distance)).astype(np.float32)


def debug_ray_mesh(origin, direction, length: float = 5.0,
                   thickness: float = 0.01) -> Mesh:
    """A single debug-ray arrow as a Mesh (hook for the V/P hotkeys of the
    reference's VisualizationController)."""
    return Mesh.from_triangles(
        generate_arrow(origin, direction, length, thickness))
