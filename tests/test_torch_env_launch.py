"""How ``shade_nee`` cuts a wavefront into blocks (``shade.nee_launch``):
the HDRI kernel lists each block's live lanes from bounce 1 on, four lanes
a thread, and every other launch takes 512 lanes a block; the tables are
staged only when they fit together.  The Python constants are held to the
kernel source they describe (``csrc/shade.cu``), which no test here can
compile.  And the copy of an HDRI the kernels read (``SkyConfig.env_quads``,
each texel's bilinear quad): the map's texels, made once a map and only
where the kernels run, none under a gradient sky, and read by the frame
programs where it lies."""

import os
import re

import numpy as np
import pytest
import torch

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.hdri import synthetic_env
from ptrt_tpu_torch.render import shade
from ptrt_tpu_torch.render import sky as sky_mod
from ptrt_tpu_torch.render.sky import SkyConfig
from ptrt_tpu_torch.scene.lights import Light, LightTable
from ptrt_tpu_torch.scene.pt_scene import Scene
from ptrt_tpu_torch.scene.materials import Material, MaterialTable

SHADE_CU = os.path.join(os.path.dirname(shade.__file__), os.pardir, "csrc",
                        "shade.cu")


def _materials(rows: int) -> MaterialTable:
    return MaterialTable.from_materials(
        [Material.make((0.5, 0.5, 0.5)) for _ in range(rows)], "cpu")


def _lights(rows: int) -> LightTable:
    return LightTable.from_lights(
        [Light.point((0.0, 4.0, 0.0), (1.0, 1.0, 1.0), 5.0, 20.0)] * rows,
        "cpu")


def _nbytes(t) -> int:
    return t.packed.numel() * t.packed.element_size()


@pytest.mark.parametrize("hdri", [False, True], ids=["gradient", "hdri"])
@pytest.mark.parametrize("bounce", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 255, 1024, 16_421, 2_073_600])
def test_nee_blocks_take_every_lane_once(n, bounce, hdri):
    launch = shade.nee_launch(n, _materials(17), _lights(4), 4, bounce, hdri)
    listed = hdri and bounce > 0
    assert launch.threads == shade.NEE_THREADS
    assert launch.chunk == (shade.NEE_THREADS * shade.ENV_NEE_LANES
                            if listed else shade.NEE_CHUNK)
    taken = np.zeros(n, np.int32)
    for b in range(launch.blocks):
        r = launch.block_lanes(b, n)
        assert 0 < len(r) <= launch.chunk
        taken[r.start:r.stop] += 1
    assert (taken == 1).all()


@pytest.mark.parametrize("bounce", [0, 2])
@pytest.mark.parametrize("hdri", [False, True], ids=["gradient", "hdri"])
def test_nee_stages_both_tables_only_when_they_fit(bounce, hdri):
    mats, lights = _materials(17), _lights(4)
    plan = lambda m, l, n_lights: shade.nee_launch(
        4096, m, l, n_lights, bounce, hdri).staged_bytes
    assert plan(mats, lights, 4) == _nbytes(mats) + _nbytes(lights)
    # without a light to sample the light table is not read
    assert plan(mats, lights, 0) == _nbytes(mats)
    # chip_smoke.py's 400-row table: both read from global memory
    big = _materials(400)
    assert _nbytes(big) > shade.MAX_STAGED_BYTES
    assert plan(big, lights, 4) == 0
    # a material table that fits alone but not with the lights
    rows = shade.MAX_STAGED_BYTES // (mats.packed.shape[1] * 4)
    near = _materials(rows)
    assert _nbytes(near) <= shade.MAX_STAGED_BYTES
    assert _nbytes(near) + _nbytes(lights) > shade.MAX_STAGED_BYTES
    assert plan(near, lights, 4) == 0
    assert plan(near, lights, 0) == _nbytes(near)


def _constant(name: str) -> int:
    """A ``constexpr int`` of csrc/shade.cu, as the kernels are built."""
    src = open(SHADE_CU).read()
    m = re.search(rf"\b{name}\s*=\s*([^,;]+)[,;]", src)
    assert m, name
    expr = m.group(1).strip()
    for other in re.findall(r"\bk[A-Z]\w*", expr):
        expr = expr.replace(other, str(_constant(other)))
    return int(eval(expr, {}))  # products of integer literals


@pytest.mark.parametrize("python,cuda", [
    ("NEE_THREADS", "kNeeThreads"), ("NEE_CHUNK", "kNeeChunk"),
    ("ENV_NEE_LANES", "kEnvNeeLanes"),
    ("SCATTER_THREADS", "kScatterThreads"),
    ("SCATTER_LANES", "kScatterLanes"),
    ("MAX_STAGED_BYTES", "kMaxStagedBytes")])
def test_launch_constants_are_the_kernels(python, cuda):
    assert getattr(shade, python) == _constant(cuda)


def test_hdri_list_chunk_is_the_kernels():
    assert _constant("kEnvNeeChunk") == (shade.nee_launch(
        1, _materials(1), _lights(1), 1, 1, True).chunk)


def _function(src: str, head: str) -> str:
    """The body of the function of csrc/shade.cu that starts with head."""
    body = src[src.index(head):]
    return body[:body.index("\n}\n")]


def test_k3_launches_raise_the_shared_cap():
    """From bounce 1 a K3 block keeps lists in static shared memory
    (shade_scatter's lanes and states, the HDRI shade_nee's lanes, slots
    and states), which with the staged tables pass the default cap of 48
    KB.  So every K3 launch, and the launch query, goes through
    allow_tables, which lets the kernel take MAX_STAGED_BYTES of dynamic
    shared memory beside its lists."""
    src = open(SHADE_CU).read()
    scatter_list = _constant("kScatterThreads") * _constant(
        "kScatterLanes") * 8
    nee_list = _constant("kEnvNeeChunk") * 12
    assert shade.MAX_STAGED_BYTES + min(scatter_list, nee_list) > 48 * 1024
    # a 360-row material table and four lights are staged past that sum
    staged = shade.nee_launch(4096, _materials(360), _lights(4), 4, 1,
                              True).staged_bytes
    assert 48 * 1024 - nee_list < staged <= shade.MAX_STAGED_BYTES
    allow = _function(src, "cudaError_t allow_tables(")
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in allow
    assert "kMaxStagedBytes" in allow
    for head in ("int launch_k3(", 'extern "C" int ptrt_shade_info('):
        assert "allow_tables(kernel, index)" in _function(src, head), head
    assert src.count("<<<") == 1  # the one launch, in launch_k3


@pytest.mark.parametrize("hw", [(1, 1), (8, 16), (33, 70)])
def test_env_quads_are_each_texels_bilinear_quad(hw):
    env = synthetic_env(*hw, seed=3)
    q = sky_mod.bilinear_quads(torch.from_numpy(env))
    h, w = hw
    assert q.dtype == torch.float32 and q.shape == (h, w, 4, 4)
    assert q.is_contiguous()  # 64 bytes a texel
    want = np.zeros((h, w, 4, 4), np.float32)
    for y in range(h):
        for x in range(w):
            for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                # the bilinear corners: x wraps, y clamps to the last row
                want[y, x, k, :3] = env[min(y + dy, h - 1), (x + dx) % w]
    assert np.array_equal(q.numpy(), want)
    # a sky on the CPU, where only the plain stages run, makes none
    assert SkyConfig.hdri(env, 0.7, device="cpu").env_quads is None


@pytest.fixture
def quads_here(monkeypatch):
    """Skies on the CPU make their quads as skies on the card do."""
    monkeypatch.setattr(sky_mod, "_kernels_read", lambda env: True)


def test_scene_makes_quads_once_a_map_and_a_gradient_has_none(quads_here):
    sc = Scene(16, 12, device="cpu")
    assert sc.sky().env_quads is None
    env = synthetic_env(16, 32, seed=4)
    sc.set_environment_map(env, 0.5)
    first = sc.sky().env_quads
    assert first is not None and sc.sky().env_quads is first
    # a rotation or the switch keeps the map's quads
    sc.set_environment_map(sc.env_map, -3.0)
    assert sc.sky().env_quads is first
    assert float(sc.sky().env_rotation) == -3.0
    sc.set_sky_enabled(False)
    assert sc.sky().env_quads is first
    # a new map, new quads
    sc.set_environment_map(synthetic_env(16, 32, seed=5), -3.0)
    assert sc.sky().env_quads is not first
    assert torch.equal(sc.sky().env_quads.tensor[:, :, 0, :3],
                       sc.sky().env)


def test_a_sky_from_reference_fields_makes_its_quads(quads_here):
    """``tables.from_reference``'s sky (the reference's fields as numpy)
    makes its quads too."""
    env = synthetic_env(8, 16, seed=6)
    sky = SkyConfig.hdri(env, 0.2, device="cpu")
    as_np = lambda v: v.numpy() if torch.is_tensor(v) else v
    fields = {"top": tuple(as_np(c) for c in (sky.top.x, sky.top.y,
                                              sky.top.z)),
              "bottom": tuple(as_np(c) for c in (sky.bottom.x, sky.bottom.y,
                                                 sky.bottom.z)),
              **{f: as_np(getattr(sky, f)) for f in (
                  "use_sky", "env", "env_rotation", "env_alias", "env_pdf",
                  "env_sample_hw")}}
    got = tables._sky(fields, "cpu")
    assert torch.equal(got.env_quads.tensor, sky.env_quads.tensor)


def test_frame_programs_share_the_quads(quads_here):
    """A frame program reads the sky's quads where they lie (no copy of
    its own), keeps running across a rotation, and a new map makes the
    programs anew; a program refuses a run with other quads."""
    sc = Scene(16, 12, device="cpu")
    sc.add_plane_xz(-1.0, 10.0, Material.make((0.8, 0.8, 0.8), 0.7))
    sc.set_performance_preset("fast")
    sc.set_environment_map(synthetic_env(16, 32, seed=7), 0.4)
    sc.render_frame_device()
    (prog,) = sc._programs.values()
    quads = sc.sky().env_quads
    assert prog.reads["sky"].env_quads is quads
    assert prog.reads["sky"].env is not sc.sky().env  # copied as before
    sc.set_environment_map(sc.env_map, 2.0)  # a rotation
    sc.render_frame_device()
    assert sc._programs.made == 1
    reads = dict(prog.reads, sky=SkyConfig.hdri(
        synthetic_env(16, 32, seed=8), 0.4, device="cpu"))
    with pytest.raises(ValueError, match="Shared"):
        prog.run(reads, None, None)
    sc.set_environment_map(synthetic_env(16, 32, seed=8), 2.0)  # a new map
    sc.render_frame_device()
    assert sc._programs.made == 2 and len(sc._programs) == 1
    (prog,) = sc._programs.values()
    assert prog.reads["sky"].env_quads is sc.sky().env_quads is not quads
