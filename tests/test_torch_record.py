"""The contract of the record between the two K3 stages
(``ptrt_tpu_torch/render/shade.py``): only ``do_nee``, ``shadow_t``,
``env_t`` (with env NEE) and ``hit.hit`` hold on every lane.  The hit
point, normal and front flag are unspecified where the lane is dead after
``shade_nee``; the shadow origin, L, pdf and contribution, and the env
sample's origin, direction, pdf, MIS weight and contribution, where
``do_nee`` is false.  The ``shade_nee`` kernel
never writes those values, so whatever reads the record must not depend on
them.  Here the plain stages and the plain shadow walk, which the kernels
are held to on the card, are fed a record poisoned exactly there (NaN in the
float planes, the opposite flag in ``front_face``) and must give what the
clean record gives, bit for bit: per bounce and for a whole frame.

With dynamic meshes K4 adds the ``inst`` plane to K1's record; ``shade_nee``
reads it only where K1's slot holds a hit, so it is poisoned with other
instance ids everywhere else, and the scene's dead lanes must still come
back from K1 and K4 as misses.
"""

import numpy as np
import pytest
import torch

from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.app.hdri import synthetic_env
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import integrator, pipeline, shade, traverse
from test_torch_shading import torch_one_thread  # noqa: F401

DEPTH = 4


def poisoned(nee: shade.NeeRecord, alive_after) -> shade.NeeRecord:
    """``nee`` with every value the contract leaves unspecified replaced:
    NaN (floats) or the opposite flag where the lane is dead after the
    stage (hit record) or casts no shadow ray (shadow record)."""
    dead, off = ~alive_after, ~nee.do_nee
    nan = float("nan")
    bad = lambda v, m: (None if v is None else v.map(lambda c: bad(c, m))
                        if isinstance(v, Vec3) else torch.where(m, nan, v))
    hit = nee.hit
    hit = traverse.Hit(hit=hit.hit, t=hit.t, point=bad(hit.point, dead),
                       normal=bad(hit.normal, dead),
                       front_face=hit.front_face ^ dead,
                       mesh_index=hit.mesh_index, u=hit.u, v=hit.v)
    return nee._replace(
        hit=hit, shadow_o=bad(nee.shadow_o, off),
        shadow_d=bad(nee.shadow_d, off), pdf=bad(nee.pdf, off),
        contrib=bad(nee.contrib, off), contrib_s=bad(nee.contrib_s, off),
        **{k: bad(getattr(nee, k), off) for k in (
            "env_o", "env_d", "env_pdf", "env_w", "env_c", "env_cs")})


def hdri(sc):
    """The scene lit by a seeded 32x64 HDRI besides its four lights."""
    sc.set_environment_map(synthetic_env(32, 64, seed=2), rotation=0.7)
    return sc


@pytest.fixture(scope="module")
def scene():
    sc = build_bench_scene(40, 28, target_tris=600, device="cpu")
    sc._ensure_device_state()
    return sc


def dynamic(sc):
    """The scene with two dynamic meshes in view, one of them refilled."""
    from ptrt_tpu_torch.scene.materials import Materials

    cube = sc.add_cube(Materials.Glass())
    cube.is_dynamic = True
    cube.transform.set_position(0.2, -0.5, 2.6).set_rotation(0.0, 0.5, 0.0)
    ball = sc.add_sphere(6, Materials.Copper())
    ball.is_dynamic = True
    ball.transform.set_position(-0.9, -0.4, 3.0)
    sc._ensure_device_state()
    ball.set_triangles(np.stack(ball.triangle_arrays(world=False), 1)
                       * np.float32(1.2))
    sc.commit_object_changes()
    sc._ensure_device_state()
    assert sc.stats_device_refits == 1 and sc._geom.iset.count == 2
    return sc


def poisoned_inst(k1: traverse.Closest, seed: int = 0) -> traverse.Closest:
    """K1 / K4's record with another instance id wherever it holds no hit."""
    g = torch.Generator().manual_seed(seed)
    other = torch.randint(0, 2, k1.inst.shape, generator=g,
                          dtype=torch.int32)
    return k1._replace(inst=torch.where(k1.slot >= 0, k1.inst, other))


@pytest.fixture(scope="module")
def dynamic_scene():
    return dynamic(build_bench_scene(40, 28, target_tris=600, device="cpu"))


@pytest.fixture(scope="module")
def dynamic_chains(dynamic_scene):
    return _chains(dynamic_scene)


@pytest.fixture(scope="module")
def hdri_scene():
    sc = hdri(build_bench_scene(40, 28, target_tris=600, device="cpu"))
    sc._ensure_device_state()
    return sc


def walks(g, nee):
    """The light and env shadow walks' answers (None where absent)."""
    occl = (None if nee.shadow_t is None else
            traverse.any_hit(g, nee.shadow_o, nee.shadow_d, nee.shadow_t))
    env = (None if nee.env_t is None else
           traverse.any_hit(g, nee.env_o, nee.env_d, nee.env_t))
    return occl, env


def _chains(sc):
    """{split: [(state before the bounce, K1's answer)] for bounces 0-3} of
    sample 0 of the scene's camera, through the plain stages."""
    g, sky = sc._geom, sc.sky()
    out = {}
    for split in (False, True):
        st, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                       sc._blue_noise)
        ps = shade.PathState.start(ray, st, split,
                                   env_nee=sky.has_env_sampling)
        steps = []
        for bounce in range(DEPTH):
            k1 = traverse.closest_hit_live(g, ps.o, ps.d, ps.alive)
            steps.append((ps.clone(), k1))
            nee = shade.shade_nee(ps, g, k1, sc._mat_table, sc._light_table,
                                  len(sc.lights), sky, bounce)
            occl, env = walks(g, nee)
            shade.shade_scatter(ps, nee, occl, sc._mat_table, bounce, True, 1,
                                env_shadow=env)
        out[split] = steps
    return out


@pytest.fixture(scope="module")
def chains(scene):
    return _chains(scene)


@pytest.fixture(scope="module")
def hdri_chains(hdri_scene):
    return _chains(hdri_scene)


def _equal(a, b, lanes=None):
    comps = (lambda v: [v.x, v.y, v.z]) if isinstance(a, Vec3) else (
        lambda v: [v])
    pick = (lambda c: c) if lanes is None else (lambda c: c[lanes])
    return all(torch.equal(pick(x), pick(y))
               for x, y in zip(comps(a), comps(b)))


def _check_bounce(sc, chains, split, bounce):
    g, sky = sc._geom, sc.sky()
    pre, k1 = chains[split][bounce]
    clean_state = pre.clone()
    nee = shade.shade_nee(clean_state, g, k1, sc._mat_table, sc._light_table,
                          len(sc.lights), sky, bounce)
    bad = poisoned(nee, clean_state.alive)
    # there is something to poison, and something left to shade
    assert bool((~clean_state.alive).any()) and bool((~nee.do_nee).any())
    assert bool(torch.isnan(bad.hit.point.x).any())
    assert bool(torch.isnan(bad.pdf).any())
    if bounce < DEPTH - 1:
        assert bool(nee.do_nee.any())

    # the shadow walks: a ray with t_max < 0 is skipped whatever it holds
    occl, env = walks(g, nee)
    occl_bad, env_bad = walks(g, bad)
    assert torch.equal(occl, occl_bad)
    assert torch.equal(nee.shadow_t < 0, ~nee.do_nee)
    if sky.has_env_sampling:
        assert bool(torch.isnan(bad.env_pdf).any())
        assert torch.equal(env, env_bad)
        assert torch.equal(nee.env_t < 0, ~nee.do_nee)
        assert bool((nee.env_t[nee.do_nee] == 1e28).all())
    else:
        assert nee.env_t is None

    bad_state = clean_state.clone()
    shade.shade_scatter(clean_state, nee, occl, sc._mat_table, bounce, True,
                        1, env_shadow=env)
    shade.shade_scatter(bad_state, bad, occl_bad, sc._mat_table, bounce, True,
                        1, env_shadow=env_bad)
    for name in ("alive", "rng", "ray_spec", "prev_was_specular",
                 "path_still_specular", "accum", "diffuse", "specular",
                 "emission", "prev_did_nee"):
        a, b = getattr(clean_state, name), getattr(bad_state, name)
        if a is not None:
            assert _equal(a, b), name
            assert not isinstance(a, Vec3) or bool(torch.isfinite(b.x).all())
    # the next ray (and the env MIS carries), where there is one
    live = clean_state.alive
    for name in ("o", "d", "throughput", "prev_pdf"):
        if getattr(clean_state, name) is not None:
            assert _equal(getattr(clean_state, name),
                          getattr(bad_state, name), live), name
    # rays traced: this bounce's shadow rays and the next bounce's rays
    assert int(nee.do_nee.sum()) == int(bad.do_nee.sum())
    assert int(clean_state.alive.sum()) == int(bad_state.alive.sum())


@pytest.mark.parametrize("bounce", range(DEPTH))
@pytest.mark.parametrize("split", [False, True])
def test_unspecified_record_values_are_never_read(scene, chains, split,
                                                  bounce):
    _check_bounce(scene, chains, split, bounce)


@pytest.mark.parametrize("bounce", range(DEPTH))
@pytest.mark.parametrize("split", [False, True])
def test_unspecified_env_record_values_are_never_read(hdri_scene,
                                                      hdri_chains, split,
                                                      bounce):
    """The same with an HDRI and env NEE: the env sample's fields poisoned
    where ``do_nee`` is false, the env walk fed the poisoned rays."""
    _check_bounce(hdri_scene, hdri_chains, split, bounce)


@pytest.mark.parametrize("bounce", range(DEPTH))
@pytest.mark.parametrize("split", [False, True])
def test_unspecified_record_values_are_never_read_with_instances(
        dynamic_scene, dynamic_chains, split, bounce):
    """The same on a scene whose walks run K4 after K1 and K2."""
    _check_bounce(dynamic_scene, dynamic_chains, split, bounce)


@pytest.mark.parametrize("bounce", range(DEPTH))
@pytest.mark.parametrize("split", [False, True])
def test_instance_plane_is_read_only_where_hit(dynamic_scene, dynamic_chains,
                                               split, bounce):
    """``shade_nee`` fed K4's record with ``inst`` poisoned wherever K1's
    slot holds no hit gives the clean record and state bit for bit; dead
    lanes came back as misses of every instance."""
    sc = dynamic_scene
    pre, k1 = dynamic_chains[split][bounce]
    if bounce:
        dead = ~pre.alive
        assert dead.any()
        assert (k1.slot[dead] == -1).all() and (k1.inst[dead] == -1).all()
    assert (k1.inst >= 0).any() and (k1.slot < 0).any()
    out = []
    for rec in (k1, poisoned_inst(k1, bounce)):
        ps = pre.clone()
        nee = shade.shade_nee(ps, sc._geom, rec, sc._mat_table,
                              sc._light_table, len(sc.lights), sc.sky(),
                              bounce)
        out.append((ps, nee))
    (ps_a, a), (ps_b, b) = out
    for name in ("hit", "point", "normal", "front_face", "t"):
        assert _equal(getattr(a.hit, name), getattr(b.hit, name)), name
    for name in ("do_nee", "shadow_o", "shadow_d", "shadow_t", "pdf",
                 "contrib"):
        assert _equal(getattr(a, name), getattr(b, name)), name
    for name in ("alive", "rng", "accum", "throughput", "first_normal",
                 "first_object_id"):
        assert _equal(getattr(ps_a, name), getattr(ps_b, name)), name


@pytest.mark.parametrize("preset", ["bench", "balanced", "hdri", "dynamic"])
def test_frame_with_poisoned_records_is_the_same_frame(monkeypatch, preset):
    """A 64x48 frame (2 spp, depth 4; the balanced preset with its split
    trace and post stack, the bare bench settings, those lit by an HDRI
    with env NEE, or the bench settings with two dynamic meshes, K4's
    ``inst`` plane poisoned too) whose every record is poisoned between the
    stages equals the normal frame: image, radiance and rays traced."""

    def render(poison: bool):
        sc = build_bench_scene(64, 48, target_tris=800, device="cpu")
        if preset == "hdri":
            hdri(sc)
        if preset == "dynamic":
            dynamic(sc)
        if preset == "balanced":
            sc.set_performance_preset("balanced")
        else:
            sc.perf.enable_denoiser = sc.perf.enable_bloom = False
            sc.perf.enable_motion_vectors = False
        sc.perf.samples_per_pixel, sc.perf.max_bounce_depth = 2, DEPTH
        calls = []
        if poison:
            real = shade.shade_nee

            def shade_nee(ps, geom, k1, *args):
                if k1.inst is not None:
                    k1 = poisoned_inst(k1, len(calls))
                nee = real(ps, geom, k1, *args)
                calls.append(1)
                return poisoned(nee, ps.alive)

            monkeypatch.setattr(integrator, "shade_nee", shade_nee)
        img = sc.render_frame()
        monkeypatch.undo()
        return img, sc.last_frame, len(calls)

    img, frame, _ = render(False)
    img_bad, frame_bad, calls = render(True)
    assert calls == 2 * DEPTH
    assert np.array_equal(img, img_bad)
    assert int(frame.rays_traced) == int(frame_bad.rays_traced)
    for name in ("color", "diffuse", "specular", "emission"):
        a, b = getattr(frame, name), getattr(frame_bad, name)
        if a is not None:
            assert _equal(a, b), name
            assert bool(torch.isfinite(b.x).all()), name
    assert img.std() > 1.0
