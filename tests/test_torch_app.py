"""The app layer of ptrt_tpu_torch against the JAX reference's, on the CPU.

* ``parse_arguments``, ``CameraController`` (a scripted sequence of
  keys and mouse moves, the camera it sets) and ``VisualizationController``
  (the debug meshes a key sequence adds and removes) equal the
  reference's on the same inputs: the controllers' state exactly, the
  cameras within rtol 1e-6, the debug meshes' vertices within 1e-6.
* ``demo.main(["--cpu", ...])`` for both backends writes a PPM and a PNG
  equal to the same scene's ``render_frame()`` after as many frames;
  without a card and without ``--cpu`` it raises, as ``Scene`` does.
* ``HttpViewer`` serves its page, a frame and takes input;
  ``run_interactive`` runs N frames with a scripted viewer (as
  ``tests/test_viewer.py`` does for the reference), presenting every frame
  once, each equal to the frame the scene rendered.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

from ptrt_tpu.app import app_utils as ref_app_utils
from ptrt_tpu.app.viz_controller import VisualizationController as RefViz
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.pt_scene import Scene as RefScene

from ptrt_tpu_torch.app import app_utils, demo, demo_scenes, rt_demo_scenes
from ptrt_tpu_torch.app.viewer import HttpViewer, run_interactive
from ptrt_tpu_torch.app.viz_controller import VisualizationController
from ptrt_tpu_torch.scene.materials import Material
from ptrt_tpu_torch.scene.pt_scene import Scene
from ptrt_tpu_torch.utils.imageio import load_ppm
from test_torch_shading import torch_one_thread  # noqa: F401

ARGVS = [[], ["-s", "3", "-w", "320", "--height", "200", "-o", "x"],
         ["--scene", "10", "--width", "64", "-h", "48"], ["--help"],
         ["-s", "2", "--bogus"], ["-w"]]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_arguments(argv):
    assert (vars(app_utils.parse_arguments(list(argv)))
            == vars(ref_app_utils.parse_arguments(list(argv))))


def tiny(scene_cls, material, **kw):
    sc = scene_cls(64, 36, **kw)
    sc.add_sphere(8, material.make((1.0, 0.2, 0.2)))
    sc.meshes[-1].transform.set_position(0, 0, 3)
    sc.add_plane_xz(-0.5, 10.0)
    sc.add_point_light((0, 3, 2), (1, 1, 1), 5.0)
    sc.set_camera((0, 0.5, -1), (0, 0, 3), fov=50)
    sc.perf.enable_denoiser = False
    sc.perf.enable_bloom = False
    sc.perf.samples_per_pixel = 1
    sc.perf.max_bounce_depth = 2
    return sc


def _cam(c):
    return np.array([[float(getattr(v, k)) for k in "xyz"]
                     for v in (c.origin, c.lower_left_corner, c.horizontal,
                               c.vertical, c.u, c.v, c.w)])


INPUTS = [({"w"}, 3.0, -1.0), ({"w", "shift"}, 0.0, 0.0), ({"a", "space"},
          -12.0, 4.0), ({"c"}, 5.0, 5.0), ({"c"}, 7.0, 1.0), (set(), 2.0,
          0.0), ({"c", "d", "ctrl"}, -3.0, 200.0), ({"s"}, 0.0, -900.0)]


def test_camera_controller_matches_reference():
    ref_sc, sc = tiny(RefScene, RefMaterial), tiny(Scene, Material,
                                                   device="cpu")
    ref_ctl, ctl = ref_app_utils.CameraController(), \
        app_utils.CameraController()
    ref_ctl.init_from_scene(ref_sc)
    ctl.init_from_scene(sc)
    assert (ctl.pos, ctl.yaw, ctl.pitch) == pytest.approx(
        (ref_ctl.pos, ref_ctl.yaw, ref_ctl.pitch), rel=1e-6, abs=1e-6)
    for keys, dx, dy in INPUTS:
        ref_ctl.update(ref_sc, ref_app_utils.InputState(set(keys), dx, dy),
                       1 / 30)
        ctl.update(sc, app_utils.InputState(set(keys), dx, dy), 1 / 30)
        assert ctl.capture_mouse == ref_ctl.capture_mouse
        np.testing.assert_allclose(ctl.pos, ref_ctl.pos, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose((ctl.yaw, ctl.pitch),
                                   (ref_ctl.yaw, ref_ctl.pitch), rtol=1e-6)
        np.testing.assert_allclose(_cam(sc.camera), _cam(ref_sc.camera),
                                   rtol=1e-5, atol=1e-5)
        assert float(sc.camera.fov) == float(ref_sc.camera.fov)


KEYS = [{"f"}, set(), {"p"}, {"p"}, {"+"}, set(), {"v"}, set(), {"-"},
        {"f"}, set(), {"p"}, {"h"}]


def test_visualization_controller_matches_reference(capsys):
    ref_sc, sc = tiny(RefScene, RefMaterial), tiny(Scene, Material,
                                                   device="cpu")
    ref_viz, viz = RefViz(ref_sc), VisualizationController(sc)
    ref_viz.add_debug_ray((0, 0.5, -1), (0, 0, 1))
    viz.add_debug_ray((0, 0.5, -1), (0, 0, 1))
    for keys in KEYS:
        ref_viz.handle_keys(set(keys))
        viz.handle_keys(set(keys))
        assert len(sc.meshes) == len(ref_sc.meshes)
        assert viz.ray_length == ref_viz.ray_length
        for a, b in zip(sc.meshes, ref_sc.meshes):
            np.testing.assert_allclose(a.vertices, b.vertices, rtol=1e-6,
                                       atol=1e-6)
            assert np.array_equal(a.faces, b.faces)
        for a, b in zip(sc.mesh_materials, ref_sc.mesh_materials):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert "Visualization hotkeys" in capsys.readouterr().out
    img = sc.render_frame()
    assert img.shape == (36, 64, 3) and img.max() > 32


@pytest.mark.parametrize("backend", ["pt", "rt"])
def test_demo_main_writes_the_scene_frame(tmp_path, backend):
    w, h, frames, sid = 24, 16, 2, (0 if backend == "pt" else 5)
    out = str(tmp_path / f"demo_{backend}")
    assert demo.main(["--cpu", "--backend", backend, "--frames",
                      str(frames), "-s", str(sid), "-w", str(w), "-h",
                      str(h), "-o", out]) == 0
    mod = demo_scenes if backend == "pt" else rt_demo_scenes
    sc, _ = mod.build_scene_by_id(sid, w, h, device="cpu")
    for _ in range(frames):
        want = sc.render_frame()
    assert want.shape == (h, w, 3) and want.std() > 1.0
    assert np.array_equal(load_ppm(out + ".ppm"), want)
    from PIL import Image

    assert np.array_equal(np.asarray(Image.open(out + ".png")), want)


def test_demo_needs_a_card_or_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("pt", "rt"):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            demo.main(["--backend", backend, "--frames", "1", "-w", "8",
                       "-h", "8", "-o", str(tmp_path / "x")])
    assert demo.main(["--help"]) == 0
    assert "ptrt_tpu_torch.app.demo" in capsys.readouterr().out


def test_http_viewer_serves_a_frame():
    v = HttpViewer(64, 36, port=0)  # a free port
    port = v._server.server_address[1]
    try:
        v.present(np.zeros((36, 64, 3), np.uint8))
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                      timeout=5).read()
        assert b"viewer" in page
        jpg = urllib.request.urlopen(f"http://127.0.0.1:{port}/frame.jpg",
                                     timeout=5).read()
        assert jpg[:2] == b"\xff\xd8"  # JPEG magic
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/input",
            data=json.dumps({"keys": ["w", "f"], "dx": 3.0,
                             "dy": -1.0}).encode(), method="POST")
        urllib.request.urlopen(req, timeout=5)
        inp = v.poll()
        assert inp.keys == {"w", "f"} and inp.mouse_dx == 3.0
        assert inp.mouse_dy == -1.0
    finally:
        v.close()


def test_run_interactive_with_a_scripted_viewer():
    sc = tiny(Scene, Material, device="cpu")
    rendered = []
    render = sc.render_frame_device

    def tracked():
        img = render()
        rendered.append(img.clone())
        return img

    sc.render_frame_device = tracked

    class Scripted:
        def __init__(self):
            self.frames, self.n, self.closed = [], 0, False

        def poll(self):
            self.n += 1
            if self.n > 4:
                return None
            inp = app_utils.InputState()
            if self.n == 2:
                inp.keys = {"w"}
            if self.n == 3:
                inp.keys = {"f"}
            return inp

        def present(self, img):
            self.frames.append(np.array(img))

        def close(self):
            self.closed = True

    v = Scripted()
    steps = []
    n = run_interactive(sc, viewer=v,
                        on_frame=lambda s, k, dt: steps.append(k))
    assert n == 4 and steps == [0, 1, 2, 3] and v.closed
    assert len(v.frames) == 4
    for got, want in zip(v.frames, rendered):
        assert np.array_equal(got, want.numpy())
    assert not np.array_equal(v.frames[0], v.frames[1])  # the camera moved
