"""Writes the full-width WebP fixtures with PIL and records PIL's RGB array of every WebP fixture.

The files whose encoder settings PIL cannot choose come from
``webp_recipes.cpp`` (built against libwebp; see its header). This script
writes the rest — lossy at quality 75 and 90, lossless, lossy with alpha and
a three-frame animation, each 500×375 — and then ``pil_webp_sha256.json``:
for each ``*.webp`` here, the shape and SHA-256 of
``np.asarray(Image.open(f).convert("RGB"))``, which the port's decode must
match exactly (``tests/test_torch_webp.py`` on the CPU, ``chip_smoke.py``
on the card, where PIL is not installed). Run from the repository root:

    python tests/data/torch_formats/webp_fixtures.py
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
WIDTH, HEIGHT = 500, 375


def scene(seed: int, width: int = WIDTH, height: int = HEIGHT) -> np.ndarray:
    """(height, width, 4) uint8: colour gradients, sharp discs, a texture, mild noise; alpha a ramp with a
    transparent band."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:height, :width].astype(np.float64)
    rgb = np.stack([255 * x / (width - 1), 255 * y / (height - 1), 128 + 100 * np.sin((x + 2 * y) / 37)], -1)
    for _ in range(6):
        cx, cy, r = rng.uniform(0, width), rng.uniform(0, height), rng.uniform(15, 70)
        rgb[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.integers(0, 256, 3)
    rgb += ((x // 4 + y // 6) % 5)[..., None] * 6 + rng.normal(0, 2.5, rgb.shape)
    alpha = np.where(y < height / 6, 0, 255 * x / (width - 1))
    return np.dstack([rgb, alpha]).round().clip(0, 255).astype(np.uint8)


def write_pil_fixtures() -> None:
    rgba = scene(0)
    save = {
        f"webp_lossy_q75_{WIDTH}x{HEIGHT}.webp": (rgba[..., :3], {"quality": 75}),
        f"webp_lossy_q90_{WIDTH}x{HEIGHT}.webp": (rgba[..., :3], {"quality": 90, "method": 6}),
        f"webp_lossless_{WIDTH}x{HEIGHT}.webp": (rgba[..., :3], {"lossless": True, "quality": 60}),
        f"webp_lossy_alpha_{WIDTH}x{HEIGHT}.webp": (rgba, {"quality": 80, "alpha_quality": 90}),
    }
    for name, (array, kwargs) in save.items():
        Image.fromarray(array).save(HERE / name, "WEBP", **kwargs)
    frames = [Image.fromarray(scene(seed)[..., :3]) for seed in (1, 2, 3)]
    frames[0].save(HERE / f"webp_anim_{WIDTH}x{HEIGHT}.webp", "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, quality=70)


def write_references() -> None:
    refs = {}
    for path in sorted(HERE.glob("*.webp")):
        array = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(path.read_bytes())).convert("RGB")))
        refs[path.name] = {"shape": list(array.shape), "sha256": hashlib.sha256(array.tobytes()).hexdigest()}
    (HERE / "pil_webp_sha256.json").write_text(json.dumps(refs, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    write_pil_fixtures()
    write_references()
