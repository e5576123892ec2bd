"""Directory-of-images dataset, decoded on the card.

Counterpart of ``semanticlens_tpu.data.image_folder.ImageFolder`` for
ImageNet-style layouts (``root/class_x/img.jpeg``). The sample list,
``class_to_idx``, the labels and ``name`` are the JAX package's, so caches
keyed by dataset index agree between the packages.

Each image decodes at full resolution to PIL's RGB array
(:mod:`~semanticlens_tpu_torch.data.image_decode`, the format chosen by the
file's content as PIL chooses it: JPEG on nvJPEG on the card and the port's
libjpeg shim on the CPU; PNG, BMP and WebP parsed and entropy-decoded on the
host and converted on the dataset's device) and is then resized and cropped as the JAX package's PIL
path does (``_pil_decode``, the reference's torchvision path): shorter side to
``image_size`` (Python's ``round``), bicubic with antialias (PIL's a=-0.5),
center crop at ``(w - S) // 2``, rounding to uint8 after each of the two
passes as PIL does.

On the card ``get_batch`` returns a uint8 (B, S, S, 3) tensor that never
leaves the device, and :meth:`ImageFolder.iter_batches` decodes on a worker
thread with its own nvJPEG handle and CUDA stream, ahead of the consumer,
which waits on each batch's event (``dataset.device_prefetch_batches``).

The device decides the decoder: nvJPEG on the card, libjpeg on the CPU. A
file PIL does not read (another format, or a corrupt, truncated or
oversized file) raises
:class:`~semanticlens_tpu_torch.data.raw.DecodeError` (a ``ValueError``)
naming the file.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from semanticlens_tpu_torch.data import image_decode, native_decoder
from semanticlens_tpu_torch.data.dataset import assemble_batches, prefetch_batches
from semanticlens_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def resize_crop(image: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W, 3) uint8 → (size, size, 3) uint8 on the image's device: the JAX package's ``_pil_decode``.

    Shorter side to ``size`` (each side ``max(1, round(side · size / shorter))``),
    bicubic with antialias, then the central window. PIL resamples the width
    and then the height, rounding to uint8 after each pass; so does this, in
    float32, which keeps it within one level of PIL on the CPU and the card
    alike (tests/test_torch_image_folder.py).
    """
    h, w = image.shape[:2]
    scale = size / min(w, h)
    new_w, new_h = max(1, round(w * scale)), max(1, round(h * scale))
    x = image.permute(2, 0, 1)[None]
    if (new_h, new_w) != (h, w):
        x = x.float()
        for pass_size in ((h, new_w), (new_h, new_w)):
            if pass_size != tuple(x.shape[2:]):
                x = F.interpolate(x, size=pass_size, mode="bicubic", antialias=True, align_corners=False)
                x = x.round_().clamp_(0, 255)
        x = x.to(torch.uint8)
    left, top = (new_w - size) // 2, (new_h - size) // 2
    return x[0, :, top : top + size, left : left + size].permute(1, 2, 0)


class ImageFolder:
    """Class-per-subdirectory image dataset yielding (uint8 HWC, label).

    Parameters
    ----------
    root : dataset root; subdirectories define classes (sorted order), flat
        directories get label 0.
    image_size : output size (shorter side resized, center-cropped).
    name : cache identity; defaults to the root directory's name.
    device : ``None`` → the CUDA card (raises without one), or ``"cpu"``.
    """

    def __init__(self, root, image_size: int = 224, name: str | None = None, device=None):
        self.root = Path(root)
        if not self.root.is_dir():
            raise FileNotFoundError(f"Dataset root not found: {self.root}")
        self.image_size = image_size
        self.name = name or self.root.name
        self.device = resolve_device(device)
        self._local = threading.local()  # one nvJPEG decoder per thread that decodes

        classes = sorted(p.name for p in self.root.iterdir() if p.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[Path, int]] = []
        if classes:
            for c in classes:
                for f in sorted((self.root / c).iterdir()):
                    if f.suffix.lower() in _EXTENSIONS:
                        self.samples.append((f, self.class_to_idx[c]))
        else:
            for f in sorted(self.root.iterdir()):
                if f.suffix.lower() in _EXTENSIONS:
                    self.samples.append((f, 0))
        if not self.samples:
            raise ValueError(f"No images found under {self.root}")
        logger.info(f"ImageFolder: {len(self.samples)} images, {max(1, len(classes))} classes")

    def __len__(self):
        return len(self.samples)

    def _decode(self, path: Path) -> torch.Tensor:
        """One file → (S, S, 3) uint8 on the dataset's device."""
        decoder = None
        if self.device.type == "cuda":
            decoder = getattr(self._local, "decoder", None)
            if decoder is None:
                decoder = self._local.decoder = native_decoder.NvJpegDecoder(self.device)
        image = image_decode.decode(path.read_bytes(), str(path), self.device, nvjpeg=decoder)
        return resize_crop(image, self.image_size)

    def __getitem__(self, idx: int):
        """(image (S, S, 3) uint8 numpy, label)."""
        path, label = self.samples[idx]
        return self._decode(path).cpu().numpy(), label

    def get_batch(self, start: int, stop: int) -> torch.Tensor:
        """Samples [start, stop) as one (B, S, S, 3) uint8 tensor on the dataset's device.

        On the card it is made on the caller's current stream and not waited for.
        """
        entries = self.samples[start:stop]
        block = torch.empty((len(entries), self.image_size, self.image_size, 3), dtype=torch.uint8,
                            device=self.device)
        for i, (path, _) in enumerate(entries):
            block[i] = self._decode(path)
        return block

    def iter_batches(self, batch_size: int, pad_last: bool = True, start_index: int = 0,
                     part: tuple[int, int] = (0, 1)):
        """Fixed-shape batches (``dataset.iter_batches``), decoded on a worker thread ahead of the consumer.

        On the card the worker decodes on a CUDA stream of its own and each
        batch carries an event recorded after its last kernel. With
        ``part=(rank, world)`` only that rank's rows of each batch are
        decoded (the data-parallel split of ``dataset.iter_batches``).
        """

        def decode():
            if self.device.type == "cpu":
                yield from assemble_batches(self, batch_size, start_index=start_index, part=part)
                return
            with torch.cuda.stream(torch.cuda.Stream(self.device)):
                yield from assemble_batches(self, batch_size, start_index=start_index, part=part)

        return prefetch_batches(decode())

    def __repr__(self):
        return f"ImageFolder(root='{self.root}', n={len(self.samples)}, image_size={self.image_size})"
