"""What the port's image decoders share: their error, PIL's pixel limit, and sample unpacking.

PNG and BMP store samples of 1, 2, 4, 8 or 16 bits packed into rows of
bytes. Their parsers (:mod:`~semanticlens_tpu_torch.data.png`,
:mod:`~semanticlens_tpu_torch.data.bmp`) run on the host and hand over the
packed rows as one uint8 tensor; :func:`unpack_samples` and the colour
tables of :func:`palette_table` then serve torch ops on whatever device
holds it, the card or the CPU.
"""

from __future__ import annotations

import torch

# PIL's Image.MAX_IMAGE_PIXELS (1024 · 1024 · 1024 // 4 // 3). PIL refuses an
# image of more than twice as many pixels when it opens it (a decompression
# bomb), whatever the format.
MAX_IMAGE_PIXELS = 89_478_485


class DecodeError(ValueError):
    """Bytes no decoder of the port turns into RGB: an unknown or unsupported format, or a
    corrupt, truncated or oversized file. The message names the file."""


def check_size(width: int, height: int, name: str) -> None:
    """Raise :class:`DecodeError` for the images PIL refuses to open for their size, before any allocation."""
    if width * height > 2 * MAX_IMAGE_PIXELS:
        raise DecodeError(f"{name}: {width}x{height} = {width * height} pixels exceeds twice PIL's limit of "
                          f"{MAX_IMAGE_PIXELS} (a decompression bomb)")


def unpack_samples(rows: torch.Tensor, count: int, bits: int) -> torch.Tensor:
    """(H, stride) uint8 packed rows → (H, count) int32 samples of ``bits`` ∈ {1, 2, 4, 8, 16} bits each.

    Samples are packed from the most significant bit of each byte, 16-bit
    samples big-endian (PNG's order).
    """
    h = rows.shape[0]
    if bits == 16:
        pairs = rows[:, : 2 * count].to(torch.int32).view(h, count, 2)
        return pairs[..., 0] << 8 | pairs[..., 1]
    if bits == 8:
        return rows[:, :count].to(torch.int32)
    per_byte = 8 // bits
    shifts = torch.arange(8 - bits, -1, -bits, device=rows.device, dtype=torch.int32)
    nbytes = -(-count // per_byte)
    expanded = (rows[:, :nbytes, None].to(torch.int32) >> shifts) & ((1 << bits) - 1)
    return expanded.reshape(h, nbytes * per_byte)[:, :count]


def palette_table(entries: bytes, stride: int, order: tuple[int, int, int], device) -> torch.Tensor:
    """A file's colour table as PIL holds it: 256 (R, G, B) entries, black past the file's own.

    ``entries`` packs one colour every ``stride`` bytes, its red, green and
    blue at the byte offsets ``order``.
    """
    table = torch.zeros(256, 3, dtype=torch.uint8)
    n = min(256, len(entries) // stride)
    if n:
        raw = torch.frombuffer(bytearray(entries[: n * stride]), dtype=torch.uint8).view(n, stride)
        table[:n] = raw[:, list(order)]
    return table.to(device)
