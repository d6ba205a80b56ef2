"""The tiled frame: ``trace_frame(tile=...)`` of ptrt_tpu_torch.

A tile renders a (height, width) window of a full_h x full_w frame with
global pixel coordinates for the camera uv, the blue-noise lookup and the
TAA jitter, on its slice of the whole frame's PCG state, so tiles put
together are the whole frame bit for bit.

* A 48x32 frame (1 spp, depth 2, unsplit and split) cut into four uneven
  tiles (11 or 21 rows by 17 or 31 columns) equals the whole frame bit for
  bit: colour, the split channels, the G-buffer, the new PCG state, and
  ``rays_traced`` summed.
* One 24x16 tile at (8, 20) of that frame against the reference's jitted
  ``trace_frame(..., tile=...)`` on the same tables and state (carried
  across by ``tables.from_reference``), held at ``test_torch_slice.py``'s
  bounds: the PCG state after the frame and object ids exact, depth and
  normal within rtol 1e-5, rays within 0.5%, energy within 1% a channel,
  at least 97% of pixels within 1e-3 relative.  The scene has 136
  triangles, so the reference intersects by brute force and its program
  compiles in seconds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.render import pipeline as ref_pipeline
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import Materials as RefMaterials
from ptrt_tpu.scene.pt_scene import Scene as RefScene

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import pipeline
from test_torch_shading import torch_one_thread  # noqa: F401
from test_torch_slice import ref_np

W, H = 48, 32
CPU = torch.device("cpu")
# the uneven cut: row and column edges
ROWS, COLS = (0, 11, 32), (0, 17, 48)
# the tile held to the reference: (y0, x0, height, width)
TILE = (8, 20, 16, 24)


@pytest.fixture(scope="module")
def scene():
    """The reference scene (floor, two spheres, a glass cube, a spot and a
    point light, the gradient sky) and the port's copy of its tables."""
    sc = RefScene(W, H)
    sc.add_plane_xz(-1.0, 10.0, RefMaterial.make((0.8, 0.8, 0.8), 0.7))
    sc.add_sphere(6, RefMaterials.Chrome()).transform.set_position(
        -0.9, -0.3, 4.0)
    sc.add_sphere(5, RefMaterials.PlasticRed()).transform.set_position(
        0.2, -0.5, 5.2)
    sc.add_cube(RefMaterials.Glass()).transform.set_position(1.0, -0.5, 3.8)
    sc.add_spot_light((-1.5, 3.0, 2.0), (0.4, -1.0, 0.6), (1, 1, 1), 6.0)
    sc.add_point_light((1.5, 2.0, 3.0), (0.9, 0.8, 1.0), 3.0, radius=0.2)
    sc.set_camera((0.0, 0.6, 0.0), (0.0, -0.2, 4.5), fov=60)
    sc._ensure_device_state()
    assert sc._use_brute()
    port = tables.from_reference(
        device=CPU, geometry=ref_np(sc._geom),
        materials=ref_np(sc._mat_table), lights=ref_np(sc._light_table),
        sky=ref_np(sc._sky()), camera=ref_np(sc.camera),
        rng_state=np.asarray(sc._rng_state),
        blue_noise=np.asarray(sc._blue_noise))
    return sc, port


def trace(port, n_lights, state, height, width, split, tile=None, spp=1,
          depth=2):
    return pipeline.trace_frame(
        port["geometry"], port["materials"], port["lights"], n_lights,
        port["sky"], port["camera"], state, 0, width, height, spp, depth,
        port["blue_noise"], split=split, tile=tile)


FIELDS = ("color", "diffuse", "specular", "emission", "normal", "depth",
          "object_id", "roughness", "transmission")


def planes(bufs, name):
    v = getattr(bufs, name)
    if v is None:
        return []
    return [v.x, v.y, v.z] if isinstance(v, Vec3) else [v]


@pytest.mark.parametrize("split", [False, True])
def test_tiles_equal_the_whole_frame(scene, split):
    sc, port = scene
    n_lights = len(sc.lights)
    state = port["rng_state"]
    whole_state, whole = trace(port, n_lights, state, H, W, split)
    got = {name: [torch.full_like(p, float("nan")) if p.is_floating_point()
                  else torch.full_like(p, -7) for p in planes(whole, name)]
           for name in FIELDS}
    got_state = torch.zeros_like(whole_state)
    rays = 0
    for y0, y1 in zip(ROWS, ROWS[1:]):
        for x0, x1 in zip(COLS, COLS[1:]):
            st, part = trace(port, n_lights, state[y0:y1, x0:x1].clone(),
                             y1 - y0, x1 - x0, split,
                             tile=(y0, x0, H, W))
            got_state[y0:y1, x0:x1] = st
            rays += int(part.rays_traced)
            for name in FIELDS:
                for dst, src in zip(got[name], planes(part, name)):
                    dst[y0:y1, x0:x1] = src
    assert torch.equal(got_state, whole_state)
    assert rays == int(whole.rays_traced)
    for name in FIELDS:
        want = planes(whole, name)
        assert (len(want) == 0) == (name in ("diffuse", "specular",
                                             "emission") and not split)
        for g, w in zip(got[name], want):
            # bit for bit: the same float bits, NaN where the whole frame
            # has NaN (a sky pixel's normal)
            assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                               else g,
                               w.view(torch.int32) if w.is_floating_point()
                               else w), name


def test_tile_outside_its_frame_raises(scene):
    sc, port = scene
    with pytest.raises(ValueError, match="outside"):
        trace(port, len(sc.lights), port["rng_state"][:16, :24].clone(), 16,
              24, False, tile=(20, 30, H, W))


@pytest.fixture(scope="module")
def tile_pair(scene):
    """(reference FrameBuffers, port FrameBuffers, both new states) of
    TILE, 2 spp, depth 3."""
    sc, port = scene
    y0, x0, h, w = TILE
    n_lights = len(sc.lights)
    st = sc._rng_state[y0:y0 + h, x0:x0 + w]
    fn = jax.jit(lambda g, m, l, s, c, st, bn: ref_pipeline.trace_frame(
        g, m, l, n_lights, s, c, st, jnp.int32(0), w, h, 2, 3, split=False,
        use_brute=True, blue_noise_tbl=bn, tile=(y0, x0, H, W)))
    ref_state, ref = fn(sc._geom, sc._mat_table, sc._light_table, sc._sky(),
                        sc.camera, st, sc._blue_noise)
    state, got = trace(port, n_lights,
                       port["rng_state"][y0:y0 + h, x0:x0 + w].clone(), h, w,
                       False, tile=(y0, x0, H, W), spp=2, depth=3)
    return ref, got, np.asarray(ref_state), state.numpy()


def _v(v):
    return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)])


def test_tile_matches_the_reference_tile(tile_pair):
    ref, got, ref_state, state = tile_pair
    assert np.array_equal(ref_state, state.astype(np.uint32))
    oid = got.object_id.numpy()
    assert np.array_equal(oid, np.asarray(ref.object_id))
    assert len(np.unique(oid)) >= 3
    hit = oid >= 0
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               rtol=1e-5)
    np.testing.assert_allclose(_v(got.normal)[:, hit], _v(ref.normal)[:, hit],
                               rtol=1e-5, atol=1e-6)
    r, g = float(ref.rays_traced), int(got.rays_traced)
    assert abs(g - r) <= 0.005 * r, (g, r)
    rc, gc = _v(ref.color), _v(got.color)
    assert np.isfinite(gc).all()
    np.testing.assert_allclose(gc.sum(axis=(1, 2)), rc.sum(axis=(1, 2)),
                               rtol=0.01)
    close = np.isclose(gc, rc, rtol=1e-3, atol=1e-6).all(axis=0)
    assert close.mean() >= 0.97, close.mean()


def test_tile_is_not_the_whole_frame_crop(scene):
    """The same window traced as a frame of its own differs: a tile's rays
    depend on its place in the frame."""
    sc, port = scene
    y0, x0, h, w = TILE
    st = port["rng_state"][y0:y0 + h, x0:x0 + w].clone()
    _, own = trace(port, len(sc.lights), st, h, w, False)
    _, tile = trace(port, len(sc.lights), st, h, w, False,
                    tile=(y0, x0, H, W))
    assert not torch.equal(own.depth, tile.depth)
