"""Image files to RGB for the port, the format chosen by content.

Counterpart of what PIL does for the JAX package in ``ImageFolder``
(``Image.open(f).convert("RGB")``, ``semanticlens_tpu/data/image_folder.py``
``_pil_decode``) and in the server's upload (``semanticlens_tpu/serve.py``):
PIL picks the format from the file's first bytes, never from its name, so a
PNG stored under a ``.JPEG`` name (ImageNet holds one) decodes as a PNG.

:func:`sniff` reads the magic bytes and :func:`decode` hands the bytes to
that format's decoder, before any decoder runs; nothing tries one decoder and
then another:

- JPEG (gray, YCbCr, RGB-coded, CMYK and YCCK):
  :mod:`~semanticlens_tpu_torch.data.native_decoder`, nvJPEG on the card and
  the libjpeg shim on the CPU;
- PNG: :mod:`~semanticlens_tpu_torch.data.png`;
- BMP: :mod:`~semanticlens_tpu_torch.data.bmp`;
- WebP (lossless, lossy, with alpha, extended, the first frame of an
  animation): :mod:`~semanticlens_tpu_torch.data.webp`.

Anything else is refused.

Every refusal, and PIL's limit on the pixel count, raises
:class:`~semanticlens_tpu_torch.data.raw.DecodeError` naming the file.
"""

from __future__ import annotations

import torch

from semanticlens_tpu_torch.data import bmp, native_decoder, png, webp
from semanticlens_tpu_torch.data.raw import DecodeError, check_size

__all__ = ["DecodeError", "decode", "sniff"]


def sniff(data: bytes) -> str | None:
    """``"jpeg"``, ``"png"``, ``"bmp"`` or ``"webp"`` from the first bytes of a file, else ``None``."""
    if data.startswith(b"\xff\xd8\xff"):  # PIL's test: a marker follows the start of image
        return "jpeg"
    if data.startswith(png.SIGNATURE):
        return "png"
    if data.startswith(b"BM"):
        return "bmp"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    return None


def decode(data: bytes, name: str, device, nvjpeg: native_decoder.NvJpegDecoder | None = None) -> torch.Tensor:
    """Image bytes → (H, W, 3) uint8 RGB on ``device`` at full resolution: PIL's array for the same file.

    ``nvjpeg`` is the calling thread's decoder for JPEGs on the card (one is
    made for this call if it is ``None``). PNG, BMP and WebP are parsed on the
    host and reach ``device`` in one upload.
    """
    device = torch.device(device)
    kind = sniff(data)
    if kind == "jpeg":
        header = native_decoder.read_header(data, name)
        check_size(header.width, header.height, name)
        if device.type == "cpu":
            return native_decoder.decode_cpu(data, name)
        return (nvjpeg or native_decoder.NvJpegDecoder(device)).decode(data, name)
    if kind == "png":
        return png.decode(data, name, device)
    if kind == "bmp":
        return bmp.decode(data, name, device)
    if kind == "webp":
        return webp.decode(data, name, device)
    raise DecodeError(f"{name}: not a JPEG, PNG, BMP or WebP file (first bytes {data[:8]!r})")
