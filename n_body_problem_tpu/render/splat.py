"""Device-side splat renderer.

The device-side replacement for the reference's CUDA-GL interop render path
(``kernel.cu:1164-1176, 1245-1262``): instead of handing the position
buffer to OpenGL for point-sprite rasterization with additive blending,
the frame is produced on-device in three steps, all inside one ``jit``:

1. **Project** — scale by ``1 / (scale_factors + 1)``, apply the orbit
   camera's view-projection, perspective-divide, viewport transform
   (matching ``vertex_shader.glsl`` + ``kernel.cu:1247-1258``).
2. **Scatter** — bilinear-deposit a unit impulse per body into one weight
   plane per point-size class (15 px for mass > 0.02, 10 px otherwise).
   ``.at[].add(mode="drop")`` gives GL-style clipping for free; padding
   bodies are masked (only ``real_body_nums`` drawn, ``kernel.cu:1261``).
3. **Convolve** — the precomputed ``intensity * alpha`` footprints,
   unrolled into static shift-and-add taps. Additive blending is linear,
   so scatter+convolve is mathematically identical to rasterizing every
   sprite, without a per-sprite scatter.

The result is a float32 luminance accumulation times the golden sprite
color — the same image GL produces, without a host round-trip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from n_body_problem_tpu.render.camera import OrbitCamera
from n_body_problem_tpu.render.sprites import (
    GOLDEN_COLOR,
    MASS_THRESHOLD,
    stacked_footprints,
)
from n_body_problem_tpu.state import SimState


def project_to_screen(
    pos: jax.Array,               # (N, 3)
    view_projection: jax.Array,   # (4, 4)
    scale_factors: jax.Array,     # (3,)
    width: int,
    height: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Returns (px, py, visible): window coords (y down) + frustum mask."""
    p = pos / (scale_factors + 1.0)
    ones = jnp.ones((p.shape[0], 1), p.dtype)
    clip = jnp.concatenate([p, ones], axis=1) @ view_projection.T   # (N, 4)
    w = clip[:, 3]
    safe_w = jnp.where(jnp.abs(w) < 1e-9, 1e-9, w)
    ndc = clip[:, :3] / safe_w[:, None]
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * height
    visible = (
        (w > 0)
        & (ndc[:, 0] >= -1.1) & (ndc[:, 0] <= 1.1)
        & (ndc[:, 1] >= -1.1) & (ndc[:, 1] <= 1.1)
        & (ndc[:, 2] >= -1.0) & (ndc[:, 2] <= 1.0)
    )
    return px, py, visible


def _bilinear_scatter(
    px: jax.Array,
    py: jax.Array,
    weights: jax.Array,   # (C, N) per-class deposit weights
    height: int,
    width: int,
    chunk: int = 2048,
) -> jax.Array:
    """Deposit per-class weights at (px, py) over 4 neighbouring pixels,
    returning (C, H, W).

    Formulated as matrix products instead of a scatter-add (SURVEY.md's
    "hard part (a)"; a float scatter-add would also change the last bits
    from run to run). Bilinear splatting is separable: each body's
    footprint is the outer product of a two-tap row vector and a two-tap
    column vector, so

        IMG_c = R_c^T @ Col,   R_c[b, r] = w_cb * bilin_y(b, r),
                               Col[b, x] = bilin_x(b, x)

    and the entire scatter becomes one (H, B) @ (B, W) matrix product per
    class per body chunk. Out-of-frame taps get zero row/col vectors,
    reproducing scatter-drop clipping. Precision: the default, which on a
    GPU may run as TF32 (~3 decimal digits in the bilinear weights). That
    is deliberate: the products only spread brightness over pixels, and
    no physics reads the image.
    """
    n = px.shape[0]
    n_c = weights.shape[0]
    f32 = jnp.float32
    pad = (-n) % chunk
    if pad:
        px = jnp.pad(px, (0, pad))
        py = jnp.pad(py, (0, pad), constant_values=-10.0)  # off-frame
        weights = jnp.pad(weights, ((0, 0), (0, pad)))
    n_pad = px.shape[0]

    x0 = jnp.floor(px - 0.5)
    y0 = jnp.floor(py - 0.5)
    fx = (px - 0.5) - x0
    fy = (py - 0.5) - y0
    ix0 = x0.astype(jnp.int32)
    iy0 = y0.astype(jnp.int32)

    rows_iota = jax.lax.broadcasted_iota(jnp.int32, (1, height), 1)
    cols_iota = jax.lax.broadcasted_iota(jnp.int32, (1, width), 1)

    def body(img, args):
        ix, iy, fxc, fyc, w = args                        # (B,) each, (C, B)
        # Two-tap one-hot row/column factors (off-frame taps are all-zero).
        ry = (
            jnp.where(rows_iota == iy[:, None], (1.0 - fyc)[:, None], 0.0)
            + jnp.where(rows_iota == iy[:, None] + 1, fyc[:, None], 0.0)
        )                                                  # (B, H)
        cx = (
            jnp.where(cols_iota == ix[:, None], (1.0 - fxc)[:, None], 0.0)
            + jnp.where(cols_iota == ix[:, None] + 1, fxc[:, None], 0.0)
        )                                                  # (B, W)
        # One matrix product per class: (H, B) @ (B, W) (default
        # precision; TF32 on the GPU is fine for brightness, see above).
        per_class = jnp.stack(
            [
                jnp.dot((w[c][:, None] * ry).T, cx, preferred_element_type=f32)
                for c in range(n_c)
            ]
        )
        return img + per_class, None

    chunks = n_pad // chunk
    args = (
        ix0.reshape(chunks, chunk),
        iy0.reshape(chunks, chunk),
        fx.reshape(chunks, chunk),
        fy.reshape(chunks, chunk),
        weights.reshape(n_c, chunks, chunk).transpose(1, 0, 2),
    )
    img0 = jnp.zeros((n_c, height, width), dtype=f32)
    img, _ = lax.scan(body, img0, args)
    return img


@functools.partial(jax.jit, static_argnames=("width", "height"))
def splat_frame(
    pos: jax.Array,
    mass: jax.Array,
    real_mask: jax.Array,
    view_projection: jax.Array,
    scale_factors: jax.Array,
    *,
    width: int = 1024,
    height: int = 768,
) -> jax.Array:
    """(H, W, 3) float32 additive frame (unclamped luminance * color)."""
    px, py, visible = project_to_screen(pos, view_projection, scale_factors, width, height)
    draw = (visible & real_mask).astype(jnp.float32)

    large = (mass > MASS_THRESHOLD).astype(jnp.float32)
    weights = jnp.stack([draw * large, draw * (1.0 - large)])   # (2, N)
    planes = _bilinear_scatter(px, py, weights, height, width)  # (2, H, W)

    lum = _conv_sprites(planes, height, width)
    color = jnp.asarray(GOLDEN_COLOR)
    return lum[:, :, None] * color[None, None, :]


def _conv_sprites(planes: jax.Array, height: int, width: int) -> jax.Array:
    """Convolve the impulse planes with the sprite footprints.

    The footprints are small host-side constants, so the convolution is
    unrolled into static shift-and-fma terms — zero taps (the discarded
    sprite corners, ~40% of the square) disappear at trace time and XLA
    fuses the rest into a few elementwise loops (a batch-1, 2-channel
    ``lax.conv`` is a poor fit for convolution libraries).
    """
    kernels = stacked_footprints()                      # host numpy (2, S, S)
    s = kernels.shape[-1]
    pad = s // 2
    padded = jnp.pad(planes, ((0, 0), (pad, pad), (pad, pad)))
    lum = jnp.zeros((height, width), dtype=planes.dtype)
    for c in range(kernels.shape[0]):
        k = kernels[c]
        for dy in range(s):
            for dx in range(s):
                w = float(k[dy, dx])
                if w != 0.0:
                    lum = lum + w * lax.slice(
                        padded[c], (dy, dx), (dy + height, dx + width)
                    )
    return lum


def render_state(
    state: SimState,
    camera: OrbitCamera,
    scale_factors=(0.0, 0.0, 0.0),
    *,
    width: int = 1024,
    height: int = 768,
) -> jax.Array:
    """Convenience wrapper: render a SimState with an OrbitCamera."""
    return splat_frame(
        state.pos,
        state.mass,
        state.real_mask(),
        jnp.asarray(camera.view_projection()),
        jnp.asarray(np.asarray(scale_factors, np.float32)),
        width=width,
        height=height,
    )
