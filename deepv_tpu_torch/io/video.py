"""Video export: mp4/gif writing, disparity colorization, controller overlay.

Capability parity with ref run.py:186-348 (``save_video``, ``colorize_depth``,
``add_controler_on_image``). Controller icons are loaded from an assets
directory when one is available (ref run.py:199-212 loads
``assets/icons/*.png`` and recolors the active ones to yellow through the
alpha mask) and otherwise rendered procedurally with PIL (simple
arrow/rotation glyphs) with the same placement grid and the same yellow
active-highlight semantics.

A copy of deepv_tpu's ``io/video.py``: host-only numpy/PIL code that
``run.main`` imports when it writes a video.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image, ImageDraw

ACTIVE = (244, 234, 42, 255)   # ref run.py:192
IDLE = (255, 255, 255, 180)


def colorize_depth(depth: np.ndarray, min_depth: float, max_depth: float,
                   cmap: str = "Spectral") -> np.ndarray:
    """(ref run.py:306-309)"""
    import matplotlib
    cm = matplotlib.colormaps[cmap]
    depth = np.clip((depth - min_depth) / (max_depth - min_depth), 0, 1)
    return cm(depth, bytes=False)[..., 0:3]


def _arrow_icon(size: int, angle_deg: float, color) -> Image.Image:
    """A triangular direction glyph pointing 'up' then rotated."""
    img = Image.new("RGBA", (size, size), (0, 0, 0, 0))
    d = ImageDraw.Draw(img)
    s = size
    d.polygon([(s * 0.5, s * 0.08), (s * 0.88, s * 0.85), (s * 0.5, s * 0.62),
               (s * 0.12, s * 0.85)], fill=color)
    return img.rotate(-angle_deg, resample=Image.BILINEAR)


def _rotation_icon(size: int, clockwise: bool, color) -> Image.Image:
    """A circular-arrow glyph for clockwise / counterclockwise rotation."""
    img = Image.new("RGBA", (size, size), (0, 0, 0, 0))
    d = ImageDraw.Draw(img)
    pad = size * 0.18
    box = [pad, pad, size - pad, size - pad]
    start, end = (300, 210) if clockwise else (330, 240)
    d.arc(box, start=end, end=start, fill=color, width=max(2, size // 10))
    # arrow head
    cx = size * (0.78 if clockwise else 0.22)
    cy = size * 0.28
    dx = size * 0.1 * (1 if clockwise else -1)
    d.polygon([(cx, cy), (cx - dx, cy - size * 0.12), (cx - dx, cy + size * 0.12)],
              fill=color)
    return img


def disparity_quantile_range(disp: np.ndarray):
    """1%/99% disparity quantiles for colorization, over the reference's
    mask ``(1/disparity) < inf`` (ref run.py:324-326) — exact zeros map to
    +inf and are excluded; post-mapped frames routinely contain exact zeros
    (clip then square), so including them would shift the normalisation."""
    with np.errstate(divide="ignore"):
        mask = (1.0 / disp) < np.inf
    vals = disp[mask] if mask.any() else disp.ravel()
    return np.quantile(vals, 0.01), np.quantile(vals, 0.99)


def _default_icon_dir() -> Optional[str]:
    """The reference's hard-coded ``./assets/icons`` (ref run.py:199), taken
    only when it actually holds the glyphs; overridable via
    ``DEEPV_ICON_ASSETS``. An EXPLICIT override that lacks the glyphs is an
    error — silently falling back to procedural icons would let a typo'd
    path masquerade as the reference-pixel output."""
    d = os.environ.get("DEEPV_ICON_ASSETS")
    if d is not None:
        if not os.path.isfile(os.path.join(d, "forward.png")):
            raise FileNotFoundError(
                f"DEEPV_ICON_ASSETS={d!r} does not contain the icon glyphs "
                f"(expected e.g. {os.path.join(d, 'forward.png')}); unset it "
                f"to use the procedural fallback icons")
        return d
    d = os.path.join("assets", "icons")
    return d if os.path.isfile(os.path.join(d, "forward.png")) else None


def _asset_icon(assets_dir: str, name: str, size: int, active: bool) -> Image.Image:
    """Load + resize a glyph; active icons are recolored to the highlight
    yellow through their alpha mask (ref run.py:193-198 ``trans_color``)."""
    img = Image.open(os.path.join(assets_dir, f"{name}.png")
                     ).convert("RGBA").resize((size, size))
    if active:
        x = np.array(img)
        mask = x[:, :, -1] > 0
        x[:, :, :3][mask] = np.array(ACTIVE[:3], dtype=x.dtype)
        img = Image.fromarray(x)
    return img


def add_controller_on_image(frame: Image.Image, prompt: str,
                            assets_dir: Optional[str] = None) -> Image.Image:
    """Overlay the controller pad; icons matching the motion sentence turn
    yellow (ref run.py:186-245, same substring matching + grid). With an
    assets dir (explicit, ``DEEPV_ICON_ASSETS``, or ``./assets/icons``) the
    reference's PNG glyphs are pasted pixel-identically; otherwise
    procedural glyphs keep the same geometry."""
    icon = 29  # ref run.py:200
    assets_dir = assets_dir or _default_icon_dir()

    def is_active(*substrings):
        return any(s in prompt for s in substrings)

    def color_for(*substrings):
        return ACTIVE if is_active(*substrings) else IDLE

    on = {
        "forward": is_active("forward", "front left", "front right"),
        "backward": is_active("backward", "rear left", "rear right"),
        "left": is_active("the left", "front left", "rear left"),
        "right": is_active("the right", "front right", "rear right"),
        "counterclock": is_active("counterclockwise"),
        "clock": is_active(" clockwise"),
    }
    if assets_dir is not None:
        forward, backward, left, right, counterclock, clock = (
            _asset_icon(assets_dir, name, icon, active)
            for name, active in on.items())
    else:
        forward = _arrow_icon(icon, 0, color_for("forward", "front left", "front right"))
        backward = _arrow_icon(icon, 180, color_for("backward", "rear left", "rear right"))
        left = _arrow_icon(icon, 270, color_for("the left", "front left", "rear left"))
        right = _arrow_icon(icon, 90, color_for("the right", "front right", "rear right"))
        counterclock = _rotation_icon(icon, False, color_for("counterclockwise"))
        clock = _rotation_icon(icon, True, color_for(" clockwise"))

    W, H = frame.size
    W = W // 3
    for img, pos in [
        (forward, (W // 2 - 2 * icon, H - 2 * icon)),
        (backward, (W // 2 - 2 * icon, H - icon)),
        (left, (W // 2 - 3 * icon, H - icon)),
        (right, (W // 2 - icon, H - icon)),
        (counterclock, (W // 2, H - icon // 2 - icon)),
        (clock, (W // 2 + icon, H - icon // 2 - icon)),
    ]:
        frame.paste(img, pos, img)
    return frame


def save_video(output: Dict, output_path: str, fps: int = 20,
               add_controler: bool = False, add_depth: bool = False,
               icon_assets: Optional[str] = None) -> str:
    """Write the generation result as mp4 (gif fallback), optionally with a
    side-by-side colorized disparity panel and controller overlay
    (ref run.py:303-348). Returns the path actually written."""
    d = os.path.dirname(output_path)
    if d and not os.path.exists(d):
        os.makedirs(d)

    video = np.asarray(output["pred_img"], dtype=np.float32)[0]       # [3,T,H,W]
    video = np.transpose(video, (1, 2, 3, 0))
    video_np = (np.clip((video + 1) / 2.0, 0, 1) * 255).astype(np.uint8)

    if add_depth:
        disparity = np.asarray(output["pred_disparity"], dtype=np.float32)[0].mean(axis=0)
        panels = []
        for i in range(video_np.shape[0]):
            disp = disparity[i]
            min_d, max_d = disparity_quantile_range(disp)
            dn = 1 - np.clip((disp - min_d) / (max_d - min_d + 1e-12), 0, 1)
            panels.append((colorize_depth(dn, 0, 1) * 255).astype(np.uint8))
        video_np = np.concatenate([video_np, np.stack(panels)], axis=2)

    frames = [Image.fromarray(f) for f in video_np]

    if add_controler:
        prompts = np.concatenate(output["motion_prompt_list"])
        for i, frame in enumerate(frames):
            frames[i] = add_controller_on_image(
                frame, str(prompts[int((i - 1) // 8 + 1)]),
                assets_dir=icon_assets)

    try:
        import imageio
        imageio.mimsave(output_path, [np.asarray(f) for f in frames], fps=fps,
                        quality=8, codec="libx264")
        return output_path
    except Exception:
        pass
    try:
        import cv2
        h, w = np.asarray(frames[0]).shape[:2]
        vw = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        ok = vw.isOpened()
        for f in frames:
            vw.write(cv2.cvtColor(np.asarray(f), cv2.COLOR_RGB2BGR))
        vw.release()
        if ok and os.path.exists(output_path) and os.path.getsize(output_path) > 0:
            return output_path
    except Exception:
        pass
    gif_path = os.path.splitext(output_path)[0] + ".gif"
    frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return gif_path
