"""``ptrt_tpu_torch.entry``: the product frame as one function, against the
reference's same composition.

``entry()``'s ``fn(rng_state, den_state, frame_idx)`` runs on the CPU at
48x32 on the bench scene of ~2,000 triangles (above the reference's
brute-force threshold, so both walk a BVH) for two frames, the denoiser
history and PCG state carried, the frame index a 0-d int32 tensor.  The
reference runs ``__graft_entry__.entry``'s composition on its own scene
(its own ``build_bench_scene``) at the same size: its jitted ``trace_frame``
(split, 2 spp, depth 4), then ``motion_vectors``, ``denoise_frame``,
``apply_bloom`` and ``tonemap_to_rgb8`` called eagerly (the jitted whole
frame compiles for minutes).  Bounds, those of the balanced-frame
cross-reference in ``test_torch_split.py``: the uint8 image within 1 LSB
on at least 99% of pixels in each frame; the PCG state bit for bit.
``capture`` on the CPU returns ``fn`` itself.  80-120 s, nearly all of
it the reference compiling (its split trace ~50 s cold, its eager post
ops ~45 s).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.app.bench_scene import build_bench_scene as ref_bench_scene
from ptrt_tpu.render import bloom as ref_bloom
from ptrt_tpu.render import denoiser as ref_den
from ptrt_tpu.render import motion as ref_motion
from ptrt_tpu.render import pipeline as ref_pipeline

from ptrt_tpu_torch import entry as port_entry
from test_torch_shading import torch_one_thread  # noqa: F401

W, H, TRIS, FRAMES = 48, 32, 2000, 2


def _reference_frames():
    """The reference's entry composition at W x H, FRAMES frames: (rgb8,
    PCG state) a frame."""
    sc = ref_bench_scene(W, H, target_tris=TRIS)
    sc.perf.enable_denoiser = False
    sc.perf.enable_bloom = False
    sc.perf.resolution_scale = 1.0
    sc._ensure_device_state()
    assert not sc._use_brute()
    n_lights = len(sc.lights)
    camera = sc.camera
    prev_vp = camera.get_view_proj()
    trace = jax.jit(lambda g, m, l, s, c, st, f, bn: ref_pipeline.trace_frame(
        g, m, l, n_lights, s, c, st, f, W, H, port_entry.SPP,
        port_entry.DEPTH, split=True, use_brute=False, blue_noise_tbl=bn))
    rng_state, den = sc._rng_state, ref_den.init_denoiser_state(H, W)
    out = []
    for i in range(FRAMES):
        fidx = jnp.int32(i)
        rng_state, bufs = trace(sc._geom, sc._mat_table, sc._light_table,
                                sc._sky(), camera, rng_state, fidx,
                                sc._blue_noise)
        mv = ref_motion.motion_vectors(bufs.depth, camera, prev_vp, W, H)
        color, den = ref_den.denoise_frame(bufs, mv, den, camera, fidx)
        rgb8 = ref_pipeline.tonemap_to_rgb8(ref_bloom.apply_bloom(color))
        out.append((np.asarray(rgb8), np.asarray(rng_state)))
    return out


def test_entry_fn_matches_reference_composition():
    fn, (rng_state, den, fidx) = port_entry.entry(W, H, TRIS, device="cpu")
    assert fidx.dtype == torch.int32 and fidx.dim() == 0
    assert port_entry.capture(fn, (rng_state, den, fidx)) is fn
    want = _reference_frames()
    for i in range(FRAMES):
        rgb8, rng_state, den = fn(rng_state, den,
                                  torch.tensor(i, dtype=torch.int32))
        ref_rgb8, ref_state = want[i]
        assert rgb8.shape == (H, W, 3) and rgb8.dtype == torch.uint8
        assert np.array_equal(rng_state.numpy().astype(np.uint32),
                              ref_state), i
        diff = np.abs(rgb8.numpy().astype(int) - ref_rgb8.astype(int))
        share = (diff.max(-1) <= 1).mean()
        assert share >= 0.99, (i, share)
        assert rgb8.numpy().std() > 1.0


def test_entry_fn_int_and_tensor_index_agree():
    """The frame with the index as a Python int and as a tensor: the same
    bits (the graph's device index against the eager host index)."""
    fn, (rng_state, den, _) = port_entry.entry(24, 16, TRIS, device="cpu")
    a = fn(rng_state, den, 5)
    b = fn(rng_state, den, torch.tensor(5, dtype=torch.int32))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
