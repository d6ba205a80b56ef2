"""Sky radiance for escaping rays: the vertical gradient, or an
equirectangular HDRI with its importance sampler — counterpart of
``ptrt_tpu/render/sky.py``.

The HDRI is an (H, W, 3) float32 map fetched bilinearly (wrap in u, clamp in
v).  ``build_env_sampling`` (numpy, copied from the reference so the tables
are the same bit for bit) builds an alias-method sampler over the map's
luminance x sin(theta) at up to 512x256 texels, so NEE draws an env
direction with two table reads and knows its exact solid-angle pdf for MIS
(``sample_env``, ``env_pdf_dir``).  Whether a sky has an env map is fixed
per trace: the plain versions here and the kernels' HDRI instantiation
(``csrc/shade.cu``) follow the same float order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.vec import PI, TWO_PI, Vec3, fmax, lerp

# importance-map resolution cap (the alias build is O(H*W) on the host)
ENV_SAMPLE_W = 512
ENV_SAMPLE_H = 256


@dataclass(frozen=True)
class SkyConfig:
    top: Vec3  # components: 0-d float32 tensors
    bottom: Vec3
    use_sky: torch.Tensor  # 0-d float 0/1 multiplier
    env: Optional[torch.Tensor] = None  # (H, W, 3) linear HDR
    env_rotation: Optional[torch.Tensor] = None  # 0-d, radians, yaw about +y
    # alias-method sampler over an (SH, SW) importance map:
    # env_alias (SH*SW, 2): [keep probability, alias index as a float value]
    # env_pdf   (SH*SW,):   solid-angle pdf of each importance texel
    env_alias: Optional[torch.Tensor] = None
    env_pdf: Optional[torch.Tensor] = None
    env_sample_hw: tuple = (0, 0)  # (SH, SW)

    def __post_init__(self):
        # an HDRI is always importance-sampled: the trace runs env NEE
        # exactly where the sky is an HDRI
        if (self.env is None) != (self.env_alias is None) or (
                (self.env_alias is None) != (self.env_pdf is None)):
            raise ValueError("an HDRI sky needs its sampling tables "
                             "(env_alias, env_pdf), and only it has them")

    @staticmethod
    def gradient(top=(0.5, 0.7, 1.0), bottom=(1.0, 1.0, 1.0),
                 use_sky: bool = True, *, device) -> "SkyConfig":
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return SkyConfig(top=Vec3(*[f32(c) for c in top]),
                         bottom=Vec3(*[f32(c) for c in bottom]),
                         use_sky=f32(1.0 if use_sky else 0.0))

    @staticmethod
    def off(*, device) -> "SkyConfig":
        """No sky: black, switched off."""
        return SkyConfig.gradient((0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                                  use_sky=False, device=device)

    @staticmethod
    def hdri(env_map, rotation: float = 0.0, use_sky: bool = True, *,
             device) -> "SkyConfig":
        """An HDRI sky from an (H, W, 3) array, with its sampling tables."""
        env = np.ascontiguousarray(env_map, np.float32)
        alias, pdf, shw = build_env_sampling(env)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        black = Vec3(*[f32(0.0)] * 3)
        return SkyConfig(top=black, bottom=black,
                         use_sky=f32(1.0 if use_sky else 0.0),
                         env=torch.from_numpy(env).to(device),
                         env_rotation=f32(rotation),
                         env_alias=torch.from_numpy(alias).to(device),
                         env_pdf=torch.from_numpy(pdf).to(device),
                         env_sample_hw=shw)

    @property
    def has_env_sampling(self) -> bool:
        return self.env_alias is not None


def build_env_sampling(env: np.ndarray,
                       max_h: int = ENV_SAMPLE_H,
                       max_w: int = ENV_SAMPLE_W):
    """Host-side alias-table build (Vose's method) over the luminance x
    sin(theta) importance of a (possibly downsampled) copy of the env map.

    Returns (alias (S, 2) f32 [prob | alias index as a float value], pdf_sa
    (S,) f32 in 1/steradian, (SH, SW)).  The pdf is exact for the sampling
    procedure (uniform within the chosen importance texel), so MIS stays
    unbiased though the importance map is coarser than the radiance map.
    """
    h, w = env.shape[0], env.shape[1]
    sh, sw = min(h, max_h), min(w, max_w)
    # box-downsample luminance to the importance resolution
    lum = (0.2126 * env[..., 0] + 0.7152 * env[..., 1]
           + 0.0722 * env[..., 2]).astype(np.float64)
    if (sh, sw) != (h, w):
        ys = (np.arange(h) * sh // h)
        xs = (np.arange(w) * sw // w)
        ds = np.zeros((sh, sw))
        cnt = np.zeros((sh, sw))
        np.add.at(ds, (ys[:, None], xs[None, :]), lum)
        np.add.at(cnt, (ys[:, None], xs[None, :]), 1.0)
        lum = ds / np.maximum(cnt, 1.0)
    # blur the importance by one texel (3x3 box, wrap in x / clamp in y) so
    # the pdf covers the bilinear radiance footprint
    lum = np.maximum(lum, 0.0)
    lx = (lum + np.roll(lum, 1, axis=1) + np.roll(lum, -1, axis=1)) / 3.0
    pad = np.pad(lx, ((1, 1), (0, 0)), mode="edge")
    lum = (pad[:-2] + pad[1:-1] + pad[2:]) / 3.0

    # solid-angle weight: equirect texel dOmega = (2pi/SW)(pi/SH) sin(theta)
    theta = (np.arange(sh) + 0.5) * (np.pi / sh)
    sin_t = np.sin(theta)
    p = lum * sin_t[:, None]
    total = p.sum()
    if total <= 0.0:
        p = np.ones_like(p)
        total = p.sum()
    p = (p / total).reshape(-1)
    n = p.size

    # Vose alias method, O(n)
    scaled = p * n
    alias = np.arange(n, dtype=np.int64)
    prob = np.ones(n, dtype=np.float64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)

    d_omega = (2.0 * np.pi / sw) * (np.pi / sh) * sin_t
    pdf_sa = (p.reshape(sh, sw) /
              np.maximum(d_omega[:, None], 1e-12)).reshape(-1)

    if n >= (1 << 24):
        raise ValueError(
            f"env map has {n} texels; alias indices are float-encoded and "
            f"must stay < 2^24 — downsample the importance resolution")
    packed = np.empty((n, 2), np.float32)
    packed[:, 0] = prob.astype(np.float32)
    # the alias index as an exact small-float value, not a bit pattern
    packed[:, 1] = alias.astype(np.float32)
    return packed, pdf_sa.astype(np.float32), (sh, sw)


def _env_uv(dir: Vec3, sky: SkyConfig):
    """(u, v) of a direction on the rotated equirect map, u in [0, 1]."""
    phi = torch.atan2(dir.z, dir.x) + sky.env_rotation
    theta = torch.arccos(torch.clamp(dir.y, -1.0, 1.0))
    u = torch.remainder((phi + PI) * (1.0 / TWO_PI), 1.0)
    return u, theta * (1.0 / PI)


def sample_env(state, sky: SkyConfig):
    """Draw an env direction through the alias table (four uniforms: the
    texel pick, the alias test and the jitter in u and v).  Returns
    (state, l, pdf_sa, radiance).

    The direction is uniform within the chosen importance texel in (u, v),
    so its solid-angle pdf varies within the texel as 1/sin(theta): the
    tabulated texel-centre pdf is scaled by sin(theta_c) / sin(theta), as
    ``env_pdf_dir`` does."""
    sh, sw = sky.env_sample_hw
    n = sh * sw
    state, u1 = prng.uniform(state)
    state, u2 = prng.uniform(state)
    state, ju = prng.uniform(state)
    state, jv = prng.uniform(state)

    k = torch.clamp_max((u1 * n).to(torch.int64), n - 1)
    row = sky.env_alias[k]
    keep = u2 < row[..., 0]
    j = torch.where(keep, k, row[..., 1].to(torch.int64))

    ty = torch.div(j, sw, rounding_mode="floor")
    tx = j - ty * sw
    # jittered direction inside the texel
    v = (ty.to(torch.float32) + jv) * (1.0 / sh)
    u = (tx.to(torch.float32) + ju) * (1.0 / sw)
    theta = v * PI
    phi = u * TWO_PI - PI - sky.env_rotation
    sin_t = torch.sin(theta)
    l = Vec3(sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi))

    # the texel-centre sin (the tabulated pdf's normalisation)
    sin_c = torch.sin((ty.to(torch.float32) + 0.5) * (PI / sh))
    pdf = sky.env_pdf[j] * sin_c / fmax(sin_t, 1e-6)
    return state, l, pdf, sample_sky(l, sky)


def env_pdf_dir(sky: SkyConfig, dir: Vec3) -> torch.Tensor:
    """Solid-angle pdf the env sampler gives direction ``dir`` (to
    MIS-weight BSDF-sampled sky hits)."""
    sh, sw = sky.env_sample_hw
    ty, tx = _pdf_texel(sky, dir)
    # the same within-texel 1/sin(theta) correction as sample_env
    sin_c = torch.sin((ty.to(torch.float32) + 0.5) * (PI / sh))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - dir.y * dir.y, 0.0))
    return sky.env_pdf[ty * sw + tx] * sin_c / fmax(sin_t, 1e-6)


def _pdf_texel(sky: SkyConfig, dir: Vec3):
    """(row, column) of the importance texel that holds ``dir``."""
    sh, sw = sky.env_sample_hw
    u, v = _env_uv(dir, sky)
    return (torch.clamp((v * sh).to(torch.int64), 0, sh - 1),
            torch.clamp((u * sw).to(torch.int64), 0, sw - 1))


def _bilinear(dir: Vec3, sky: SkyConfig):
    """The bilinear fetch of ``dir`` on the map, wrapping in u and clamped
    in v: its rows y0, y1, its columns x0, x1 and its weights tx, ty."""
    h, w = sky.env.shape[0], sky.env.shape[1]
    u, v = _env_uv(dir, sky)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    return (y0i, torch.clamp(y0i + 1, 0, h - 1), x0i,
            torch.remainder(x0i + 1, w), fx - x0, fy - y0)


def env_texels(sky: SkyConfig, dir: Vec3):
    """The texels each direction's lookups read (measurement only): the
    flat indices (row * W + column) of the four map texels of its fetch, an
    (..., 4) tensor, and of the importance texel that holds it (row * SW +
    column)."""
    w = sky.env.shape[1]
    y0, y1, x0, x1, _, _ = _bilinear(dir, sky)
    ty, tx = _pdf_texel(sky, dir)
    return (torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1],
                        -1), ty * sky.env_sample_hw[1] + tx)


def sample_sky(dir: Vec3, sky: SkyConfig) -> Vec3:
    """Radiance for rays escaping to the environment."""
    if sky.env is None:
        t = 0.5 * (dir.y + 1.0)
        return lerp(sky.bottom, sky.top, t) * sky.use_sky

    y0i, y1i, x0i, x1i, tx, ty = _bilinear(dir, sky)

    def fetch(yy, xx):
        c = sky.env[yy, xx]
        return Vec3(c[..., 0], c[..., 1], c[..., 2])

    top_row = lerp(fetch(y0i, x0i), fetch(y0i, x1i), tx)
    bot_row = lerp(fetch(y1i, x0i), fetch(y1i, x1i), tx)
    return lerp(top_row, bot_row, ty) * sky.use_sky
