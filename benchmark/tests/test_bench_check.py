"""The check that decides ``correct``, driven through a whole run on the CPU
at a tiny size (the port's plain versions stand in for its kernels): a
sound run is correct, the control (the reference in bfloat16 in the
program's place) is not, and neither is a run whose timed path is broken
underneath in any of the ways a cell can break: the frame's state left
unchanged (the PCG stream, the SVGF history, the previous view-projection)
or restarted on every frame (the SVGF history marked as a first frame),
half the frame left out, one answer altered where it is produced.  A cell runs on one card, so there is
no exchange between cards to leave out."""

import dataclasses
import time

import pytest
import torch

from benchmark import cells, check, session

SMALL = {"width": 24, "height": 16, "target_tris": 1000, "env_hw": [32, 64]}
SEED = 2 ** 31 + 977


def small_cell(name):
    cell = cells.load(name, SMALL)
    cell.traffic["check"].update(frame_after=2, frame_before=3,
                                 pixels=SMALL["width"] * SMALL["height"])
    cell.traffic["warm_frames"] = 1
    return cell


def run(name, control=False):
    return session.run(small_cell(name), SEED, 0.01, False, "cpu",
                       time.perf_counter(), control=control)


@pytest.mark.parametrize("name", ["bench_scene.trace_4spp",
                                  "hdri_scene.balanced_orbit"])
def test_sound_run_is_correct_and_the_control_is_not(name):
    out = run(name, control=True)
    assert out["correct"], out["checked"]
    frame = [m["name"] for m in small_cell(name).end_to_end
             if m["name"].startswith("frame_ms")]
    assert frame and all(out["metrics"][f]["value"] > 0 for f in frame)
    limits = small_cell(name).limits["limits"]
    ok, _ = check.verdict(out["control"], limits)
    assert not ok, out["control"]


def _fault(monkeypatch, fault):
    from ptrt_tpu_torch.render import pipeline
    from ptrt_tpu_torch.scene import pt_scene

    if fault == "pcg_unchanged":
        real = pipeline.sample_sums

        def sums(sums_, ps, sample, spp, rng_state):
            out, state = real(sums_, ps, sample, spp, rng_state)
            return out, (None if state is None else rng_state.clone())
        monkeypatch.setattr(pipeline, "sample_sums", sums)
    elif fault == "history_unchanged":
        real = pt_scene.denoise_frame

        def denoise(bufs, mv, state, *a, **kw):
            out, _ = real(bufs, mv, state, *a, **kw)
            return out, state
        monkeypatch.setattr(pt_scene, "denoise_frame", denoise)
    elif fault == "history_restarted":
        # a camera move that marks the history as a first frame: the frame
        # and the reference then start from the same restarted history
        real = pt_scene.Scene.set_camera

        def set_camera(self, *a, **kw):
            real(self, *a, **kw)
            st = self._denoiser_state
            if st is not None:
                self._denoiser_state = dataclasses.replace(
                    st, first_frame=torch.ones_like(st.first_frame))
        monkeypatch.setattr(pt_scene.Scene, "set_camera", set_camera)
    elif fault == "prev_view_proj_unchanged":
        real = pt_scene._frame_body

        def frame_body(cfg):
            body = real(cfg)

            def stale(reads, st, values):
                out, new = body(reads, st, values)
                return out, dict(new, prev_vp=st["prev_vp"])
            return stale
        monkeypatch.setattr(pt_scene, "_frame_body", frame_body)
    elif fault == "half_left_out":
        real = pipeline.trace_frame

        def trace_frame(*a, **kw):
            state, bufs = real(*a, **kw)
            h = bufs.depth.shape[0] // 2
            cut = lambda v: None if v is None else v.map(
                lambda c: torch.cat([c[:h], torch.zeros_like(c[h:])]))
            return state, bufs._replace(
                color=cut(bufs.color), diffuse=cut(bufs.diffuse),
                specular=cut(bufs.specular), emission=cut(bufs.emission))
        monkeypatch.setattr(pipeline, "trace_frame", trace_frame)
    elif fault == "answer_altered":
        real = pipeline.tonemap_rgb8

        def tonemap(*a, **kw):
            out = real(*a, **kw).clone()
            out[3, 5, 1] ^= 0x40
            return out
        monkeypatch.setattr(pipeline, "tonemap_rgb8", tonemap)


@pytest.mark.parametrize("name, fault", [
    ("bench_scene.trace_4spp", "pcg_unchanged"),
    ("bench_scene.trace_4spp", "half_left_out"),
    ("bench_scene.trace_4spp", "answer_altered"),
    ("bench_scene.balanced_orbit", "history_unchanged"),
    ("bench_scene.balanced_orbit", "history_restarted"),
    ("bench_scene.balanced_orbit", "prev_view_proj_unchanged"),
    ("bench_scene.balanced_orbit", "half_left_out"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _fault(monkeypatch, fault)
    out = run(name)
    assert not out["correct"], out["checked"]


def _hist(lengths, first=False, depth=1.0):
    from benchmark.reference.denoiser import ChannelHistory, DenoiserState
    from benchmark.reference.vec import Vec3

    z = torch.zeros_like(lengths)
    zero = Vec3(z, z, z)
    ch = ChannelHistory(zero, zero, lengths)
    return DenoiserState(ch, ch, Vec3(torch.ones_like(z), z, z),
                         torch.full_like(z, depth), z.int(),
                         torch.tensor(first))


def test_history_restarted():
    lengths = torch.tensor([[1.0, 2.0, 7.0, 8.0], [9.0, 15.0, 16.0, 3.0]])
    # a history of 16 frames is half of the 32 the diffuse channel keeps
    assert check.history_restarted(_hist(lengths), 40) == 0.0
    assert check.history_restarted(_hist(lengths.clamp(max=15)), 40) == 1.0
    # after 4 frames a history of 2 has grown to half of what it can have
    assert check.history_restarted(_hist(lengths.clamp(max=2)), 4) == 0.0
    assert check.history_restarted(_hist(lengths.clamp(max=1)), 4) == 1.0
    assert check.history_restarted(_hist(lengths, first=True), 40) == 1.0
    # sky pixels are not judged; a history of sky alone is restarted
    sky = _hist(lengths, depth=1e30)
    assert check.history_restarted(sky, 40) == 1.0
    sky.depth[1, 2] = 1.0
    assert check.history_restarted(sky, 40) == 0.0


def test_verdict_needs_every_number_and_limit():
    assert check.verdict({"a": 1.0}, {"a": 1.0})[0]
    assert not check.verdict({"a": 1.5}, {"a": 1.0})[0]
    assert not check.verdict({"a": 1.0}, {"a": 1.0, "b": 0.0})[0]
    assert not check.verdict({"a": 1.0, "b": 0.0}, {"a": 1.0})[0]
