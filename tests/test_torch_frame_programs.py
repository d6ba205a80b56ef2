"""The frame programs (``graphs.Program``) on the CPU.

``Scene.render_frame_device`` runs each frame as a program kept per
configuration (the reference's ``_frame_program``; above 16 spp its chunk
and post programs), ``bench.trace_only`` the trace-only frame and
``RTScene.render_frame_device`` the RT frame.  On the card a program is a
CUDA graph; on the CPU it calls the same body on the same buffers, with
the same key, host-value staging and copy-in, which is what is held here:

* a program per key: a camera move, a light edit, a material edit and an
  HDRI rotation keep one; a preset switch, a resolution scale, a light
  added and a mesh added each make a new one;
* the program path equals the eager body (``render_world``) bit for bit
  over 6 frames (RGB8, PCG state, denoiser history, progressive sum and
  count, ``prev_view_proj``), for each way a frame's inputs change: new
  objects (the camera orbiting; a material, a light and an HDRI rotation
  edited), the merged instance set's tables written in place (K5 refits
  with transform edits, also after the set was merged again with the
  same shapes), the progressive average (the camera still, then
  moved; a reset), the denoiser history (a reset), the fast and chunked
  (32 spp) frames;
* a camera put back (A, B, A) renders as itself and is not written;
* the programs stay bounded: a mesh added and removed again and again
  keeps one, and past ``graphs.PROGRAMS_KEPT`` the least recent goes;
* the RGB8 a frame returns is its own after the next frame; ``warmup()``
  then a frame equals an unwarmed frame;
* the trace-only program equals ``trace_frame``;
* the counted walks (K1, K2 on a device count) take the first
  ``scale * count`` rays; the RT frame with the device count (its plain
  path) equals the frame with the host's count bit for bit and the
  reference's ``RTScene.render_frame`` on a small glass scene.
~60 s.
"""

import numpy as np
import pytest
import torch

import jax
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import Materials as RefMaterials
from ptrt_tpu.scene.rt_scene import RTScene as RefRTScene

from ptrt_tpu_torch import bench, graphs
from ptrt_tpu_torch.app.bench_scene import heightfield_to_triangles
from ptrt_tpu_torch.app.hdri import synthetic_env
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import pipeline, traverse
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.pt_scene import Scene
from ptrt_tpu_torch.scene.rt_scene import RTScene
from test_torch_shading import torch_one_thread  # noqa: F401

W, H = 32, 24
FRAMES = 6


def _scene(preset: str = "fast", w: int = W, h: int = H) -> Scene:
    sc = Scene(w, h, device="cpu")
    sc.add_plane_xz(-1.0, 10.0, Material.make((0.8, 0.8, 0.8), 0.7))
    sc.add_sphere(8, Materials.PlasticRed()).transform.set_position(
        0.0, -0.5, 4.0)
    sc.add_point_light((2.0, 4.0, 2.0), (1.0, 1.0, 1.0), 6.0, radius=0.2)
    sc.set_camera((0.0, 0.5, 0.0), (0.0, 0.0, 4.0), fov=60)
    sc.set_performance_preset(preset)
    sc.perf.resolution_scale = 1.0
    return sc


def _surface(frame: int) -> np.ndarray:
    xs = np.linspace(-1.0, 1.0, 6)
    h = 0.15 * np.sin(3.0 * xs[None, :] + 2.0 * xs[:, None] + 0.7 * frame)
    return heightfield_to_triangles(h.astype(np.float32), 2.0)


def _dynamic(preset: str = "fast") -> Scene:
    """Two dynamic cubes and a dynamic heightfield beside the static
    floor and sphere (a merged instance set, refit in place)."""
    sc = _scene(preset)
    parts = []
    for k, m in enumerate((Materials.PlasticBlue(), Materials.Gold())):
        c = sc.add_cube(m)
        c.is_dynamic = True
        c.transform.set_position(0.4 + 0.9 * k, -0.5, 3.8 + 0.6 * k)
        parts.append(c)
    surf = sc.add_triangles(_surface(0), Materials.PlasticGreen())
    surf.is_dynamic = True
    surf.transform.set_position(-0.4, -0.9, 3.0)
    sc.parts = (*parts, surf)
    return sc


def _animate(sc: Scene, frame: int) -> None:
    """Transform edits on the cubes and a refill of the heightfield (the
    same triangle count: a K5 refit of the merged set in place)."""
    a, b, surf = sc.parts
    a.transform.set_position(0.4 + 0.1 * frame, -0.5, 3.8)
    a.transform.set_rotation(0.0, 0.3 * frame, 0.0)
    b.transform.set_scale(1.0, 1.0 + 0.2 * frame, 1.0)
    surf.set_triangles(_surface(frame))
    sc.commit_object_changes()


def _orbit(sc: Scene, k: int) -> None:
    a = np.deg2rad(0.5 * k)
    sc.set_camera((4.0 * np.sin(a), 0.5, 4.0 - 4.0 * np.cos(a)),
                  (0.0, 0.0, 4.0), fov=60)


def _eager(sc: Scene) -> torch.Tensor:
    """A frame as the eager body runs it (``render_world``)."""
    sc._ensure_device_state()
    img = sc.render_world(sc._geom, sc.camera, sc.frame_count,
                          sc.prev_view_proj,
                          bool(sc.perf.progressive_accumulation))
    sc.frame_count += 1
    sc.prev_view_proj = sc.camera.get_view_proj()
    return img


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    la, lb = graphs.tree_leaves(a), graphs.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _state(sc: Scene) -> dict:
    return {"rng": sc._rng_state, "den": sc._denoiser_state,
            "accum": sc._accum, "accum_vp": sc._accum_view_proj,
            "prev_vp": sc.prev_view_proj, "frame": sc.frame_count}


def _lockstep(make, edit=None, frames: int = FRAMES) -> list:
    """Two scenes from ``make()``: frames through the programs and through
    the eager body, ``edit(scene, k)`` before frame k on both; returns each
    frame's differences (empty where all are equal)."""
    prog, eager = make(), make()
    bad = []
    for k in range(frames):
        if edit is not None:
            edit(prog, k)
            edit(eager, k)
        a, b = prog.render_frame_device(), _eager(eager)
        sa, sb = _state(prog), _state(eager)
        diff = [n for n in sa if not (_same(sa[n], sb[n]) if n != "frame"
                                      else sa[n] == sb[n])]
        if not torch.equal(a, b):
            diff.append("rgb8")
        if not _same(prog.last_frame.color, eager.last_frame.color):
            diff.append("last_frame")
        if diff:
            bad.append((k, diff))
    assert prog._programs, "no program ran"
    return bad


def _remerge(sc: Scene, k: int) -> None:
    """``_animate``, and at frame 2 a cube taken out and put back: the
    merged set made again with the same shapes (a new object the program
    copies in), which the later refits then write in place."""
    if k == 2:
        i = sc.meshes.index(sc.parts[0])
        mat = sc.mesh_materials[i]
        sc.remove_mesh(sc.parts[0])
        sc.add_mesh(sc.parts[0], mat)
    _animate(sc, k)


def _hdri(sc: Scene) -> Scene:
    sc.set_environment_map(synthetic_env(16, 32, seed=3), 0.4)
    return sc


def _edits(sc: Scene, k: int) -> None:
    if k == 2:
        sc.set_material(sc.meshes[1], Materials.Gold())
    if k == 3:
        sc.lights[0].intensity = 3.0
        sc.lights[0].position = (1.0, 3.0, 1.0)
        sc.commit_light_changes()
    if k == 4:
        sc.set_environment_map(sc.env_map, 1.3)  # a rotation of the same map


CASES = {
    "fast": (lambda: _scene("fast"), None),
    "balanced orbit": (lambda: _scene("balanced"), _orbit),
    "progressive still then moved": (
        lambda: _scene("fast"), lambda sc, k: k == 3 and _orbit(sc, 2)),
    "progressive reset": (
        lambda: _scene("fast"),
        lambda sc, k: k == 3 and sc.reset_accumulation()),
    "denoiser reset": (
        lambda: _scene("balanced"),
        lambda sc, k: k == 3 and sc.reset_denoiser_history()),
    "material light hdri edits": (lambda: _hdri(_scene("balanced")), _edits),
    "dynamic refits": (lambda: _dynamic("fast"), _animate),
    "dynamic re-merge": (lambda: _dynamic("fast"), _remerge),
    "dynamic balanced": (lambda: _dynamic("balanced"), _animate),
}


@pytest.mark.parametrize("case", list(CASES))
def test_program_equals_eager_body(case):
    make, edit = CASES[case]
    assert _lockstep(make, edit) == []


def _chunked() -> Scene:
    sc = _scene("fast", 16, 12)
    sc.perf.samples_per_pixel, sc.perf.max_bounce_depth = 32, 1
    sc.perf.enable_bloom = True
    return sc


def test_chunked_program_equals_eager_body():
    """32 spp: two replays of the 16-spp chunk program and one of the post
    program, bit for bit the eager chunk loop; the camera moved at frame
    3."""
    assert _lockstep(_chunked, lambda sc, k: k == 3 and _orbit(sc, 3)) == []
    sc = _chunked()
    sc.render_frame_device()
    assert sorted(k[0] for k in sc._programs) == ["chunk", "post"]


def _keys(sc: Scene) -> int:
    """The programs made once a frame has run."""
    sc.render_frame_device()
    return sc._programs.made


def test_programs_are_kept_per_key():
    sc = _hdri(_scene("balanced"))
    assert _keys(sc) == 1
    _orbit(sc, 4)  # a camera move
    assert _keys(sc) == 1
    sc.lights[0].intensity = 2.0  # a light edit
    sc.commit_light_changes()
    assert _keys(sc) == 1
    sc.set_material(sc.meshes[0], Materials.Chrome())  # a material edit
    assert _keys(sc) == 1
    sc.set_environment_map(sc.env_map, 2.0)  # an HDRI rotation
    assert _keys(sc) == 1
    sc.set_performance_preset("performance")  # a preset switch
    assert _keys(sc) == 2
    sc.set_resolution_scale(0.5)  # a resolution scale
    assert _keys(sc) == 3
    assert len(sc._programs) == 3
    # a light or a mesh added: the programs of the world that is gone are
    # dropped
    sc.add_point_light((-2.0, 3.0, 1.0), (1.0, 0.5, 0.5), 2.0)  # a light
    assert _keys(sc) == 4 and len(sc._programs) == 1
    sc.add_cube(Materials.Silver())  # a mesh
    assert _keys(sc) == 5 and len(sc._programs) == 1
    sc.set_performance_preset("balanced")
    sc.perf.resolution_scale = 1.0
    assert _keys(sc) == 6  # the world has another shape than at frame 1
    assert len(sc._programs) == 2


def _put_back(sc: Scene, k: int) -> None:
    """Camera A, then B, then A again (the same object), B, A."""
    if k == 0:
        sc.cam_a = sc.camera
        sc.cam_a_copy = graphs.clone_tree(sc.camera)
    elif k in (1, 3):
        _orbit(sc, 12)
    else:
        sc.camera = sc.cam_a


@pytest.mark.parametrize("preset", ("fast", "balanced"))
def test_camera_put_back_renders_its_frame(preset):
    """A camera the caller held earlier and puts back renders as itself
    (the program copies it in: its buffers are its own), bit for bit the
    eager body's frame, and its tensors are left as they were."""
    prog, eager = _scene(preset), _scene(preset)
    for k in range(5):
        _put_back(prog, k)
        _put_back(eager, k)
        assert torch.equal(prog.render_frame_device(), _eager(eager)), k
        assert _same(_state(prog)["rng"], _state(eager)["rng"]), k
        assert _same(prog.camera, eager.camera), k
    assert _same(prog.cam_a, prog.cam_a_copy)


def test_programs_stay_bounded():
    """A mesh added and removed again and again keeps one program (the
    old world's are dropped and freed), and configurations past
    ``graphs.PROGRAMS_KEPT`` drop the one run least recently."""
    import gc
    import weakref

    sc = _scene("fast", 16, 12)
    sc.render_frame_device()
    dropped = []
    for _ in range(3):
        dropped += [weakref.ref(p) for p in sc._programs.values()]
        cube = sc.add_cube(Materials.Silver())
        sc.render_frame_device()
        assert len(sc._programs) == 1
        sc.remove_mesh(cube)
        sc.render_frame_device()
        assert len(sc._programs) == 1
    gc.collect()
    assert all(r() is None for r in dropped)
    assert sc._programs.made == 7
    for depth in range(1, graphs.PROGRAMS_KEPT + 3):
        sc.perf.max_bounce_depth = depth
        sc.render_frame_device()
        assert len(sc._programs) <= graphs.PROGRAMS_KEPT
    keys = list(sc._programs)
    assert keys[-1][1].depth == graphs.PROGRAMS_KEPT + 2
    assert keys[0][1].depth == 3  # depths 1 and 2 dropped


def test_returned_rgb8_is_its_own():
    sc = _scene("balanced")
    first = sc.render_frame_device()
    kept = first.clone()
    _orbit(sc, 8)
    second = sc.render_frame_device()
    assert torch.equal(first, kept) and not torch.equal(first, second)


@pytest.mark.parametrize("preset", ("fast", "balanced"))
def test_warmup_then_frame_equals_unwarmed(preset):
    warm, cold = _scene(preset), _scene(preset)
    warm.render_frame_device()  # state to restore, a program made
    cold.render_frame_device()
    warm.perf.max_bounce_depth = cold.perf.max_bounce_depth = 3
    warm.warmup()
    assert len(warm._programs) == 2
    for _ in range(2):
        a, b = warm.render_frame_device(), cold.render_frame_device()
        assert torch.equal(a, b)
        assert _same(_state(warm)["rng"], _state(cold)["rng"])
        assert _same(warm._denoiser_state, cold._denoiser_state)
        assert _same(warm._accum, cold._accum)


def test_trace_only_program_equals_trace_frame():
    sc = _scene("fast")
    bench.configure(sc, 2, 2)
    sc._ensure_device_state()
    state = sc._rng_state.clone()
    for i in range(3):
        got = bench.trace_only(sc, i, 2, 2)
        state, want = pipeline.trace_frame(
            sc._geom, sc._mat_table, sc._light_table, len(sc.lights),
            sc.sky(), sc.camera, state, i, W, H, 2, 2, sc._blue_noise)
        assert _same(got, want) and torch.equal(sc._rng_state, state)
    assert len(sc._programs) == 1


def test_counted_walks_take_the_first_rays():
    sc = _scene("fast")
    sc._ensure_device_state()
    g = sc._geom
    gen = np.random.default_rng(5)
    n = 96
    o = Vec3(*[torch.from_numpy(gen.uniform(-1, 1, n).astype(np.float32))
               for _ in range(3)])
    d = Vec3(*[torch.from_numpy(gen.normal(size=n).astype(np.float32))
               for _ in range(3)])
    d = d * (1.0 / d.length())
    d = Vec3(d.x, -d.y.abs(), d.z.abs())  # down and ahead: some hit
    t = torch.full((n,), traverse.T_MAX)
    for count, scale in ((0, 2), (7, 2), (17, 3), (60, 2)):
        c = torch.tensor([count], dtype=torch.int32)
        m = min(n, count * scale)
        got = traverse.closest_hit(g, o, d, t, c, scale)
        want = traverse.closest_hit(g, o.map(lambda v: v[:m]),
                                    d.map(lambda v: v[:m]), t[:m])
        for a, b in zip(got, want):
            assert a.shape == (n,) and torch.equal(a[:m], b)
        occ = traverse.any_hit(g, o, d, t, c, scale)
        assert torch.equal(occ[:m], traverse.any_hit(
            g, o.map(lambda v: v[:m]), d.map(lambda v: v[:m]), t[:m]))
    with pytest.raises(TypeError):
        traverse.closest_hit(g, o, d, t, torch.tensor([1]), 1)  # int64


def _glass(sc, mat, mats):
    sc.add_plane_xz(-1.0, 8.0, mat.make((0.7, 0.7, 0.7), 0.6))
    sc.add_sphere(8, mats.Glass()).transform.set_position(0.0, 0.0, 3.0)
    sc.add_cube(mats.PlasticRed()).transform.set_position(0.6, -0.5, 4.5)
    sc.add_point_light((2.0, 3.0, 1.0), (1.0, 1.0, 1.0), 5.0)
    sc.add_directional_light((-0.3, -1.0, 0.2), (1.0, 0.9, 0.8), 0.8)
    sc.set_camera((0.0, 0.4, 0.0), (0.0, 0.0, 3.0), fov=55)
    return sc


def test_rt_program_with_device_count_equals_host_count_and_reference():
    sc = _glass(RTScene(W, H, device="cpu"), Material, Materials)
    img = sc.render_frame_device()
    raw = sc.frame_records
    g = int(raw.glass.count[0])
    # the plain versions keep the records at G (the card's are at 2N)
    assert raw.glass.o.x.shape == (2 * g,)
    eager = sc.render_eager()  # the glass count read to the host
    assert g == eager.glass.lanes.shape[0] > 0
    assert torch.equal(img, eager.rgb8)
    # the records cut to G are the host count's, bit for bit
    fr = sc.last_frame
    for a, b in ((fr.glass, eager.glass), (fr.sec_k1, eager.sec_k1),
                 (fr.sec_hit, eager.sec_hit),
                 (fr.sec_shadow, eager.sec_shadow),
                 (fr.sec_occluded, eager.sec_occluded),
                 (fr.sec_color, eager.sec_color)):
        assert _same(a, b)
    assert torch.equal(sc.render_frame_device(), img)
    assert len(sc._programs) == 1

    ref = _glass(RefRTScene(W, H), RefMaterial, RefMaterials)
    with jax.disable_jit():  # brute force: a quick eager frame
        want = np.asarray(ref.render_frame())
    diff = np.abs(img.numpy().astype(int) - want.astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()


def test_rt_program_without_glass_lanes():
    """Glass in the scene, none in view: the device count is 0, the glass
    pass's launches do nothing, and the frame is the host count's."""
    sc = _glass(RTScene(W, H, device="cpu"), Material, Materials)
    sc.set_camera((0.0, 4.0, -6.0), (0.0, 1.0, -10.0), fov=60)
    img = sc.render_frame_device()
    assert int(sc.frame_records.glass.count[0]) == 0
    assert sc.last_frame.sec_k1 is None
    assert torch.equal(img, sc.render_eager().rgb8)
