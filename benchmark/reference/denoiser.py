"""SVGF-style spatiotemporal denoiser — counterpart of
``ptrt_tpu/render/denoiser.py``.

Per channel (diffuse, specular): firefly suppression, temporal accumulation
(motion-vector reprojection, edge-aware bilinear history fetch,
depth/normal/object-id rejection, neighbourhood soft clamp,
variance-adaptive alpha), variance estimation, then five (diffuse) or two
(specular) à-trous iterations; the channels recombine with emission.

A frozen copy of ``ptrt_tpu_torch/render/denoiser.py``'s plain versions
(``<name>_plain``), which the benchmark's reference runs on every device;
each stage's entry runs its plain version (the pairs, each channel alone).

Border rules, as in the reference: the 3x3 windows of the temporal and
variance stages clamp coordinates to the image (``_shift_clamp``), the
à-trous window zero-pads and masks (``_shift``/``_shift_mask``), the
bilinear fetch clips its corner indices after ``floor``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference.vec import (Vec3, fmax, fmin, sdiv, vmax, vmin,
                                     where)

SKY_DEPTH_THRESHOLD = 1e9


@dataclass(frozen=True)
class ChannelSettings:
    tau: float
    min_alpha: float
    max_history: float
    sigma_luminance: float
    sigma_normal: float
    sigma_depth: float
    atrous_iterations: int
    clamp_scale: float
    firefly_threshold: float


@dataclass(frozen=True)
class DenoiserSettings:
    diffuse: ChannelSettings = ChannelSettings(
        tau=0.06, min_alpha=0.05, max_history=32.0, sigma_luminance=4.0,
        sigma_normal=64.0, sigma_depth=0.5, atrous_iterations=5,
        clamp_scale=1.2, firefly_threshold=3.0)
    specular: ChannelSettings = ChannelSettings(
        tau=0.12, min_alpha=0.2, max_history=6.0, sigma_luminance=1.0,
        sigma_normal=128.0, sigma_depth=0.2, atrous_iterations=2,
        clamp_scale=2.0, firefly_threshold=8.0)
    depth_reject_absolute: float = 0.1
    depth_reject_relative: float = 0.005
    normal_reject_threshold: float = 0.95
    sky_depth_threshold: float = 1e9
    edge_depth_threshold: float = 0.01
    edge_normal_threshold: float = 0.95
    use_edge_aware_sampling: bool = True
    use_object_ids: bool = True
    enable_firefly_suppression: bool = True
    enable_split_denoising: bool = True
    # specular history cap from the roughness/transmission G-buffers: the
    # cap shrinks toward 1 as roughness -> 0, transmissive pixels are capped
    # at transmissive_history_cap; diffuse history is untouched
    spec_roughness_history: bool = True
    spec_roughness_ref: float = 0.35
    transmissive_history_cap: float = 2.0


DEFAULT_SETTINGS = DenoiserSettings()


@dataclass(frozen=True)
class ChannelHistory:
    mean: Vec3
    m2: Vec3
    length: torch.Tensor


@dataclass(frozen=True)
class DenoiserState:
    diffuse: ChannelHistory
    specular: ChannelHistory
    normal: Vec3
    depth: torch.Tensor
    object_id: torch.Tensor
    first_frame: torch.Tensor  # 0-d bool on the state's device


# -- image helpers -----------------------------------------------------------


def _is_sky(depth, normal: Vec3, threshold):
    return (depth > threshold) | (normal.dot(normal) < 0.1)


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shifted copy, zero-padded.  A shift past the image is all zeros."""
    h, w = a.shape[-2], a.shape[-1]
    out = torch.zeros_like(a)
    ys0, ys1 = max(0, dy), min(h, h + dy)
    xs0, xs1 = max(0, dx), min(w, w + dx)
    if ys0 >= ys1 or xs0 >= xs1:
        return out
    out[..., ys0:ys1, xs0:xs1] = a[..., ys0 - dy:ys1 - dy, xs0 - dx:xs1 - dx]
    return out


def _shift_mask(shape, dy: int, dx: int, device) -> torch.Tensor:
    h, w = shape
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    ys0, ys1 = max(0, dy), min(h, h + dy)
    xs0, xs1 = max(0, dx), min(w, w + dx)
    if ys0 < ys1 and xs0 < xs1:
        m[ys0:ys1, xs0:xs1] = True
    return m


def _shift3(v: Vec3, dy: int, dx: int) -> Vec3:
    return v.map(lambda c: _shift(c, dy, dx))


def _shift_clamp(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped shift: out[y, x] = a[clamp(y - dy), clamp(x - dx)]."""
    h, w = a.shape[-2], a.shape[-1]
    rows = (torch.arange(h, device=a.device) - dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=a.device) - dx).clamp(0, w - 1)
    return a.index_select(-2, rows).index_select(-1, cols)


def _shift3_clamp(v: Vec3, dy: int, dx: int) -> Vec3:
    return v.map(lambda c: _shift_clamp(c, dy, dx))


def _edge_discontinuity(d0, d1, n0: Vec3, n1: Vec3, o0, o1, depth_thr,
                        normal_thr, use_obj: bool):
    edge = torch.zeros_like(d0, dtype=torch.bool)
    if use_obj:
        edge = edge | ((o0 != o1) & (o0 >= 0) & (o1 >= 0))
    max_d = torch.maximum(d0, d1)
    edge = edge | ((max_d > 1e-6)
                   & (torch.abs(d0 - d1) / fmax(max_d, 1e-6) > depth_thr))
    return edge | (n0.dot(n1) < normal_thr)


def _gather2d(a: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor):
    return torch.take(a, yi * a.shape[-1] + xi)


def _gather3(v: Vec3, yi, xi) -> Vec3:
    return v.map(lambda c: _gather2d(c, yi, xi))


def _clip_index(f: torch.Tensor, n: int) -> torch.Tensor:
    """``clip(int(f), 0, n - 1)`` for an integer-valued float tensor."""
    return f.clamp(0, n - 1).nan_to_num(0.0).to(torch.int64)


# -- stages ------------------------------------------------------------------


def firefly_suppression_plain(img: Vec3, depth, normal: Vec3, threshold,
                              sky_threshold) -> Vec3:
    """Plain version of ``svgf_firefly`` (``denoiser.firefly_suppression``).
    Clamp each pixel to 1.25x its 8-neighbourhood maximum (zero-padded)
    and to 10; sky pixels pass through.  ``threshold`` is unused, as in the
    reference."""
    max_n = Vec3.zeros(img.x.shape, img.x.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            max_n = vmax(max_n, _shift3(img, dy, dx))
    clamped = vmin(img, max_n * 1.25)
    clamped = vmin(clamped, Vec3.full(10.0))
    return where(_is_sky(depth, normal, sky_threshold), img, clamped)


def _edge_aware_bilinear(bufs, prev_depth, prev_normal: Vec3, prev_obj, px,
                         py, center_d, center_n: Vec3, center_obj,
                         cfg: DenoiserSettings):
    """Edge-aware bilinear history fetch at (px, py) in pixel units; falls
    back to the nearest pixel where every corner is rejected.  ``bufs`` is a
    list of Vec3 or (H, W) tensors; returns the fetched values in order."""
    h, w = prev_depth.shape
    fx = px - 0.5
    fy = py - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    sx = fx - x0
    sy = fy - y0
    x0c, y0c = _clip_index(x0, w), _clip_index(y0, h)
    x1c, y1c = _clip_index(x0 + 1.0, w), _clip_index(y0 + 1.0, h)

    corners = [(y0c, x0c, (1 - sx) * (1 - sy)), (y0c, x1c, sx * (1 - sy)),
               (y1c, x0c, (1 - sx) * sy), (y1c, x1c, sx * sy)]
    weights = []
    for yy, xx, wgt in corners:
        invalid = _edge_discontinuity(
            center_d, _gather2d(prev_depth, yy, xx), center_n,
            _gather3(prev_normal, yy, xx), center_obj,
            _gather2d(prev_obj, yy, xx) if cfg.use_object_ids else None,
            cfg.edge_depth_threshold, cfg.edge_normal_threshold,
            cfg.use_object_ids)
        weights.append(torch.where(invalid, 0.0, wgt))

    total_w = weights[0] + weights[1] + weights[2] + weights[3]
    fallback = total_w < 1e-6
    nx = _clip_index(torch.floor(px), w)
    ny = _clip_index(torch.floor(py), h)
    inv_w = sdiv(1.0, fmax(total_w, 1e-6))

    out = []
    for buf in bufs:
        g = _gather3 if isinstance(buf, Vec3) else _gather2d
        acc = None
        for (yy, xx, _), wgt in zip(corners, weights):
            term = g(buf, yy, xx) * wgt
            acc = term if acc is None else acc + term
        blended = acc * inv_w
        near = g(buf, ny, nx)
        out.append(where(fallback, near, blended) if isinstance(buf, Vec3)
                   else torch.where(fallback, near, blended))
    return out


def _first_frame_history(src: Vec3, hist: ChannelHistory, first):
    """History of the first frame is the current frame."""
    return ChannelHistory(mean=where(first, src, hist.mean),
                          m2=where(first, src * src, hist.m2),
                          length=torch.where(first, 1.0, hist.length))


def temporal_accumulation_plain(cur: Vec3, hist: ChannelHistory, mvx, mvy,
                                depth, normal: Vec3, obj_id,
                                state: DenoiserState, ch: ChannelSettings,
                                cfg: DenoiserSettings,
                                hist_cap=None) -> ChannelHistory:
    """Plain version of ``svgf_temporal``
    (``denoiser.temporal_accumulation``)."""
    h, w = depth.shape
    dev = depth.device

    # 3x3 neighbourhood statistics of the current frame, same surface only
    n_mean = Vec3.zeros((h, w), dev)
    n_m2 = Vec3.zeros((h, w), dev)
    n_cnt = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nc = _shift3_clamp(cur, dy, dx)
            same = ~_edge_discontinuity(
                depth, _shift_clamp(depth, dy, dx), normal,
                _shift3_clamp(normal, dy, dx), obj_id,
                _shift_clamp(obj_id, dy, dx) if cfg.use_object_ids else None,
                cfg.edge_depth_threshold, cfg.edge_normal_threshold,
                cfg.use_object_ids)
            wgt = torch.where(same, 1.0, 0.0)
            n_mean = n_mean + nc * wgt
            n_m2 = n_m2 + nc * nc * wgt
            n_cnt = n_cnt + wgt

    empty = n_cnt == 0
    inv = sdiv(1.0, fmax(n_cnt, 1.0))
    n_mean = where(empty, cur, n_mean * inv)
    n_m2 = where(empty, cur * cur, n_m2 * inv)
    n_std = vmax(n_m2 - n_mean * n_mean, Vec3.full(0.0)).sqrt()
    soft_min = n_mean - n_std * ch.clamp_scale
    soft_max = n_mean + n_std * ch.clamp_scale

    # reproject
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    prev_u = (xs + 0.5 - mvx * w).expand(h, w)
    prev_v = (ys + 0.5 - mvy * h).expand(h, w)
    in_bounds = ((prev_u >= 0.5) & (prev_v >= 0.5) & (prev_u < w - 0.5)
                 & (prev_v < h - 0.5))

    hist_mean, hist_m2, hist_len, hist_d = _edge_aware_bilinear(
        [hist.mean, hist.m2, hist.length, state.depth], state.depth,
        state.normal, state.object_id, prev_u, prev_v, depth, normal, obj_id,
        cfg)

    nxp = _clip_index(torch.floor(prev_u), w)
    nyp = _clip_index(torch.floor(prev_v), h)
    valid = in_bounds
    if cfg.use_object_ids:
        valid = valid & (_gather2d(state.object_id, nyp, nxp) == obj_id)
    dd = torch.abs(depth - hist_d)
    valid = valid & ~((dd > cfg.depth_reject_absolute)
                      | (dd > cfg.depth_reject_relative * fmax(depth, 1e-6)))
    hist_n = _gather3(state.normal, nyp, nxp)
    valid = valid & (normal.dot(hist_n) >= cfg.normal_reject_threshold)

    hist_mean = where(valid, vmin(vmax(hist_mean, soft_min), soft_max),
                      hist_mean)

    # variance-adaptive alpha; the cap clamps the length before the alpha
    cap = ch.max_history if hist_cap is None else hist_cap
    hist_len = fmin(hist_len, cap)
    var = vmax(hist_m2 - hist_mean * hist_mean, Vec3.full(0.0))
    std_approx = (torch.sqrt(var.x) + torch.sqrt(var.y)
                  + torch.sqrt(var.z)) / 3.0
    variance_alpha = std_approx / (std_approx + ch.tau)
    history_alpha = sdiv(1.0, hist_len + 1.0)
    alpha = torch.clamp(torch.maximum(variance_alpha, history_alpha),
                        ch.min_alpha, 1.0)
    alpha = torch.where(valid, alpha, 1.0)
    new_len = torch.where(valid, fmin(hist_len + 1.0, cap), 1.0)

    out_mean = hist_mean * (1.0 - alpha) + cur * alpha
    out_m2 = hist_m2 * (1.0 - alpha) + cur * cur * alpha

    sky = _is_sky(depth, normal, cfg.sky_depth_threshold)
    return ChannelHistory(mean=where(sky, cur, out_mean),
                          m2=where(sky, cur * cur, out_m2),
                          length=torch.where(sky, 1.0, new_len))


def estimate_variance_plain(hist: ChannelHistory, depth, normal: Vec3,
                            obj_id, cfg: DenoiserSettings) -> torch.Tensor:
    """Plain version of ``svgf_variance`` (``denoiser.estimate_variance``).
    Temporal variance boosted for short histories, floored by the 3x3
    same-object spatial variance; luminance of the result, 0 on sky."""
    c = hist.mean
    var = vmax(hist.m2 - c * c, Vec3.full(0.0))
    reliability = fmin(hist.length * 0.25, 1.0)
    boost = 1.0 + (1.0 - reliability) * 3.0

    dev = depth.device
    sp_mean = Vec3.zeros(depth.shape, dev)
    sp_m2 = Vec3.zeros(depth.shape, dev)
    cnt = torch.zeros(depth.shape, dtype=torch.float32, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nc = _shift3_clamp(c, dy, dx)
            if cfg.use_object_ids:
                keep = _shift_clamp(obj_id, dy, dx) == obj_id
            else:
                keep = torch.ones(depth.shape, dtype=torch.bool, device=dev)
            wgt = torch.where(keep, 1.0, 0.0)
            sp_mean = sp_mean + nc * wgt
            sp_m2 = sp_m2 + nc * nc * wgt
            cnt = cnt + wgt
    inv = sdiv(1.0, fmax(cnt, 1.0))
    sp_mean = sp_mean * inv
    sp_m2 = sp_m2 * inv
    sp_var = vmax(sp_m2 - sp_mean * sp_mean, Vec3.full(0.0))

    out = vmax(var * boost, sp_var).luminance()
    return torch.where(_is_sky(depth, normal, cfg.sky_depth_threshold), 0.0,
                       out)


_ATROUS_W = [1.0 / 256, 4.0 / 256, 6.0 / 256, 4.0 / 256, 1.0 / 256]


def atrous_iteration_plain(img: Vec3, variance, depth, normal: Vec3, obj_id,
                           step: int, ch: ChannelSettings,
                           cfg: DenoiserSettings):
    """Plain version of ``svgf_atrous``: one 5x5 B-spline pass at dilation
    ``step`` with luminance, depth, normal, object-id and sky edge stops.
    Returns (image, variance)."""
    shape = depth.shape
    dev = depth.device
    center_lum = img.luminance()
    var_scale = torch.sqrt(fmax(variance, 1e-6))
    adaptive_sigma = ch.sigma_luminance * (1.0 + var_scale * 2.0)
    inv_sigma_sq = sdiv(1.0, 2.0 * adaptive_sigma * adaptive_sigma + 1e-6)

    acc = Vec3.zeros(shape, dev)
    acc_var = torch.zeros(shape, dtype=torch.float32, device=dev)
    total_w = torch.zeros(shape, dtype=torch.float32, device=dev)
    sky_c = _is_sky(depth, normal, cfg.sky_depth_threshold)

    for dy in (-2, -1, 0, 1, 2):
        for dx in (-2, -1, 0, 1, 2):
            k_w = _ATROUS_W[dy + 2] * _ATROUS_W[dx + 2] * 256.0
            sy, sx = dy * step, dx * step
            n_c = _shift3(img, sy, sx)
            n_var = _shift(variance, sy, sx)
            n_d = _shift(depth, sy, sx)
            n_n = _shift3(normal, sy, sx)

            keep = _shift_mask(shape, sy, sx, dev)
            if cfg.use_object_ids:
                n_o = _shift(obj_id, sy, sx)
                keep = keep & ~((obj_id != n_o) & (obj_id >= 0) & (n_o >= 0))
            max_d = torch.maximum(depth, n_d)
            keep = keep & ~((max_d > 1e-6)
                            & (torch.abs(depth - n_d) / fmax(max_d, 1e-6)
                               > cfg.edge_depth_threshold))
            keep = keep & (normal.dot(n_n) >= cfg.edge_normal_threshold)
            keep = keep & ~_is_sky(n_d, n_n, cfg.sky_depth_threshold)

            lum_diff = torch.abs(center_lum - n_c.luminance())
            w_l = torch.exp(-lum_diff * lum_diff * inv_sigma_sq)
            wgt = torch.where(keep, k_w * w_l, 0.0)

            acc = acc + n_c * wgt
            acc_var = acc_var + n_var * wgt
            total_w = total_w + wgt

    ok = (total_w >= 1e-6) & ~sky_c
    inv_w = sdiv(1.0, fmax(total_w, 1e-6))
    return (where(ok, acc * inv_w, img),
            torch.where(ok, acc_var * inv_w, variance))


# -- the stages ----------------------------------------------------------------

def temporal_accumulation(cur: Vec3, hist: ChannelHistory, mvx, mvy, depth,
                          normal: Vec3, obj_id, state: DenoiserState,
                          ch: ChannelSettings, cfg: DenoiserSettings,
                          hist_cap=None, first=None) -> ChannelHistory:
    """One channel's temporal stage.  ``first`` (optional 0-d bool tensor):
    where true, the history is the current frame (mean ``cur``, second
    moment ``cur**2``, length 1), as on the first frame.  ``hist_cap`` is
    an optional per-pixel history-length cap; by default the channel's
    ``max_history``."""
    if first is not None:
        hist = _first_frame_history(cur, hist, first)
    return temporal_accumulation_plain(cur, hist, mvx, mvy, depth, normal,
                                       obj_id, state, ch, cfg, hist_cap)


def temporal_accumulation_pair(channels, mvx, mvy, depth, normal: Vec3,
                               obj_id, state: DenoiserState,
                               cfg: DenoiserSettings, first=None) -> tuple:
    """The temporal stage of two channels, each alone."""
    return tuple(temporal_accumulation(cur, hist, mvx, mvy, depth, normal,
                                       obj_id, state, ch, cfg,
                                       hist_cap=cap, first=first)
                 for cur, hist, ch, cap in channels)


def atrous_iteration(img: Vec3, variance, depth, normal: Vec3, obj_id,
                     step: int, ch: ChannelSettings, cfg: DenoiserSettings):
    """One à-trous pass: (image, variance)."""
    return atrous_iteration_plain(img, variance, depth, normal, obj_id, step,
                                  ch, cfg)


def firefly_suppression(img: Vec3, depth, normal: Vec3, threshold,
                        sky_threshold) -> Vec3:
    """Clamp each pixel to 1.25x its 8-neighbourhood maximum (zero-padded)
    and to 10; sky pixels pass through.  ``threshold`` is unused."""
    return firefly_suppression_plain(img, depth, normal, threshold,
                                     sky_threshold)


def firefly_suppression_pair(images, depth, normal: Vec3,
                             sky_threshold) -> tuple:
    """The firefly clamp of two channels, each alone."""
    return tuple(firefly_suppression_plain(img, depth, normal, None,
                                           sky_threshold) for img in images)


def estimate_variance(hist: ChannelHistory, depth, normal: Vec3, obj_id,
                      cfg: DenoiserSettings) -> torch.Tensor:
    """Temporal variance boosted for short histories, floored by the 3x3
    same-object spatial variance; luminance of the result, 0 on sky."""
    return estimate_variance_plain(hist, depth, normal, obj_id, cfg)


def estimate_variance_pair(hists, depth, normal: Vec3, obj_id,
                           cfg: DenoiserSettings) -> tuple:
    """The variance estimate of two channels, each alone."""
    return tuple(estimate_variance_plain(hist, depth, normal, obj_id, cfg)
                 for hist in hists)


# -- the channel and the frame -----------------------------------------------

ATROUS_STEPS = (1, 2, 4, 8, 16)


def denoise_channel(src: Vec3, hist: ChannelHistory, mvx, mvy, depth,
                    normal: Vec3, obj_id, state: DenoiserState,
                    ch: ChannelSettings, cfg: DenoiserSettings,
                    hist_cap=None):
    """Firefly clamp, temporal stage (history := current on the first
    frame), variance, à-trous passes.  Returns (image, new history)."""
    src = _firefly(src, depth, normal, ch, cfg)
    new_hist = temporal_accumulation(src, hist, mvx, mvy, depth, normal,
                                     obj_id, state, ch, cfg,
                                     hist_cap=hist_cap,
                                     first=state.first_frame)
    return _filter(new_hist, depth, normal, obj_id, ch, cfg), new_hist


def _firefly(src: Vec3, depth, normal: Vec3, ch: ChannelSettings,
             cfg: DenoiserSettings) -> Vec3:
    if not cfg.enable_firefly_suppression:
        return src
    return firefly_suppression(src, depth, normal, ch.firefly_threshold,
                               cfg.sky_depth_threshold)


def _filter(hist: ChannelHistory, depth, normal: Vec3, obj_id,
            ch: ChannelSettings, cfg: DenoiserSettings) -> Vec3:
    """The variance estimate and the channel's à-trous passes."""
    variance = estimate_variance(hist, depth, normal, obj_id, cfg)
    return _atrous(hist.mean, variance, depth, normal, obj_id, ch, cfg)


def _atrous(img: Vec3, variance, depth, normal: Vec3, obj_id,
            ch: ChannelSettings, cfg: DenoiserSettings) -> Vec3:
    """The channel's à-trous passes from its mean and variance."""
    for step in ATROUS_STEPS[:min(ch.atrous_iterations, 5)]:
        img, variance = atrous_iteration(img, variance, depth, normal, obj_id,
                                         step, ch, cfg)
    return img


def specular_history_cap(roughness, transmission,
                         settings: DenoiserSettings = DEFAULT_SETTINGS):
    """Per-pixel specular history cap from the roughness and transmission
    G-buffers: 1 at roughness 0, the channel's ``max_history`` from
    ``spec_roughness_ref`` up, at most ``transmissive_history_cap`` on
    transmissive pixels.  None when ``spec_roughness_history`` is off."""
    if not settings.spec_roughness_history:
        return None
    rf = torch.clamp(roughness / max(settings.spec_roughness_ref, 1e-3), 0.0,
                     1.0)
    cap = 1.0 + rf * (settings.specular.max_history - 1.0)
    return torch.where(transmission > 0.5,
                       fmin(cap, settings.transmissive_history_cap), cap)


def denoise_frame(bufs, mv, state: DenoiserState, camera=None,
                  frame_idx=None, settings: DenoiserSettings = DEFAULT_SETTINGS):
    """Split-channel denoise and recombine with emission.  ``mv`` is the
    (mx, my) pair of ``motion.motion_vectors``; ``camera`` and
    ``frame_idx`` are unused, as in the reference.  Returns
    (color, new state)."""
    mvx, mvy = mv
    depth, normal, obj_id = bufs.depth, bufs.normal, bufs.object_id
    spec_cap = specular_history_cap(bufs.roughness, bufs.transmission,
                                    settings)
    if settings.enable_split_denoising:
        # the reference runs the channels one after the other; here each
        # stage takes both channels in one launch, then each channel's
        # à-trous passes run (no channel reads the other's: the numbers
        # are the same)
        src_d, src_s = bufs.diffuse, bufs.specular
        if settings.enable_firefly_suppression:
            src_d, src_s = firefly_suppression_pair(
                (src_d, src_s), depth, normal, settings.sky_depth_threshold)
        hist_d, hist_s = temporal_accumulation_pair(
            ((src_d, state.diffuse, settings.diffuse, None),
             (src_s, state.specular, settings.specular, spec_cap)),
            mvx, mvy, depth, normal, obj_id, state, settings,
            first=state.first_frame)
        var_d, var_s = estimate_variance_pair((hist_d, hist_s), depth, normal,
                                              obj_id, settings)
        out_d = _atrous(hist_d.mean, var_d, depth, normal, obj_id,
                        settings.diffuse, settings)
        out_s = _atrous(hist_s.mean, var_s, depth, normal, obj_id,
                        settings.specular, settings)
        out = out_d + out_s + bufs.emission
    else:
        out, hist_d = denoise_channel(
            bufs.color, state.diffuse, mvx, mvy, depth, normal, obj_id,
            state, settings.diffuse, settings)
        hist_s = state.specular

    new_state = DenoiserState(
        diffuse=hist_d, specular=hist_s, normal=normal, depth=depth,
        object_id=obj_id,
        # a device fill, not a host copy: the frame never synchronises
        first_frame=torch.zeros((), dtype=torch.bool, device=depth.device))
    return out, new_state
