"""JPEG decoding for the port: nvJPEG on the card, libjpeg on the CPU.

Counterpart of ``semanticlens_tpu.data.native_decoder``, which decodes on the
host with libjpeg (DCT prescaling, bilinear resize). The port decodes at full
resolution and leaves resizing to the dataset. Both of its decoders stop at
the image's component planes, each at its own subsampling: Y, Cb, Cr; one
gray plane; R, G, B of an RGB-coded file; or the four planes of a CMYK or
YCCK file (Adobe's APP14 marker says which):

- :class:`NvJpegDecoder` wraps ``csrc/jpeg_nvjpeg.cu``: one nvJPEG handle and
  decode state, for one thread at a time, writing the planes into tensors on
  the card on the caller's current stream. It can also encode (JPEG files on
  a machine without PIL);
- :func:`decode_cpu` wraps ``csrc/jpeg_cpu.cpp``, the port's own copy of the
  libjpeg decode, into CPU tensors.

:func:`planes_to_rgb` then does what libjpeg does by default, and PIL with
it, on either device: "fancy" (triangle) chroma upsampling and the
fixed-point YCbCr → RGB conversion, in int32. A four-plane file goes to RGB
as PIL takes it: libjpeg's YCCK → CMYK where the file is YCCK, PIL's
``CMYK;I`` unpacking (Adobe's inverted CMYK, assumed for every CMYK JPEG)
and its integer ``cmyk2rgb``. On the CPU the result equals PIL's decode
exactly; on the card it differs only by nvJPEG's IDCT. (nvJPEG's own RGB
output replicates chroma samples and is up to ~100 levels off at colour
edges.)

:func:`read_header` reads what the choice of decode needs from the markers
before the first scan (size, components, colour space), as libjpeg reads it.

Both libraries build at first use (``utils.cuda_build``; ``-lnvjpeg`` and
``-ljpeg``). Nothing falls back: a failed build or launch raises, and data a
decoder refuses raises :class:`JpegError` naming the file.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import weakref
from dataclasses import dataclass

import torch

from semanticlens_tpu_torch.data.raw import DecodeError
from semanticlens_tpu_torch.utils import cuda_build

_MSG_LEN = 256
_NVJPEG_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG", 4: "JPEG_NOT_SUPPORTED",
                  5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
                  9: "IMPLEMENTATION_NOT_SUPPORTED", 10: "INCOMPLETE_BITSTREAM", -1: "CUDA_ERROR"}
_DATA_STATUSES = {2, 3, 4, 10}  # what nvJPEG answers to bytes it refuses; the others are faults of the card
_LIB_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_P, _I, _SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_IP, _SZP, _PP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_void_p)
# libjpeg's J_COLOR_SPACE values → the port's names
_LIBJPEG_SPACES = {1: "gray", 2: "rgb", 3: "ycc", 4: "cmyk", 5: "ycck"}
_COMPONENTS = {"gray": 1, "rgb": 3, "ycc": 3, "cmyk": 4, "ycck": 4}
# nvjpegOutputFormat_t: the planes as stored (UNCHANGED), YUV planes, the Y plane alone
_NVJPEG_UNCHANGED, _NVJPEG_YUV, _NVJPEG_Y = 0, 1, 2
_SOF_MARKERS = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


class JpegError(DecodeError):
    """JPEG bytes a decoder refuses: not a JPEG, corrupt, truncated, or of a layout PIL does not read."""


@dataclass(frozen=True)
class JpegHeader:
    width: int
    height: int
    colour: str  # "gray", "ycc", "rgb", "cmyk" or "ycck"


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>`` (built at first use), each named function given its
    argument types and an ``int`` result."""
    with _LIB_LOCK:
        if name not in _LIBS:
            lib = cuda_build.load(name)
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


def _cpu_lib() -> ctypes.CDLL:
    return library("jpeg_cpu", {
        "sl_jpeg_info": [ctypes.c_char_p, ctypes.c_ulong, _IP, _IP, _IP, _IP, ctypes.c_char_p, _I],
        "sl_jpeg_decode_planes": [ctypes.c_char_p, ctypes.c_ulong, _PP, ctypes.c_char_p, _I],
    })


def _nvjpeg_lib() -> ctypes.CDLL:
    return library("jpeg_nvjpeg", {
        "sl_nvjpeg_create": [_PP],
        "sl_nvjpeg_destroy": [_P],
        "sl_nvjpeg_info": [_P, ctypes.c_char_p, _SZ, _IP, _IP, _IP, _IP],
        "sl_nvjpeg_decode_planes": [_P, ctypes.c_char_p, _SZ, _I, _I, _PP, _IP, _P],
        "sl_nvjpeg_encode": [_P, _P, _I, _I, _I, _P, _SZP],
        "sl_nvjpeg_encoded": [_P, _P, _SZP, _P],
    })


# --------------------------------------------------------------------------- #
# Planes → RGB, as libjpeg's defaults (jdsample.c fancy upsampling, jdcolor.c)
# --------------------------------------------------------------------------- #
def _shift(x, offset: int, dim: int):
    """``x`` moved by one along ``dim`` with the edge repeated: offset -1 gives each element its
    predecessor, +1 its successor."""
    n = x.shape[dim]
    if offset < 0:
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)


def _interleave(even, odd, dim: int):
    """Alternate the entries of ``even`` and ``odd`` along ``dim`` (twice the length)."""
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)


def _upsample_chroma(c: torch.Tensor, h_ratio: int, v_ratio: int) -> torch.Tensor:
    """One int32 chroma plane up by (v_ratio, h_ratio): libjpeg's fancy upsampling where it has one.

    2×2 and 2×1 (when the plane is wider than 2) and 1×2 interpolate with
    libjpeg's weights (3:1 per axis) and rounding biases; other ratios
    replicate samples (libjpeg's ``int_upsample``).
    """
    if (h_ratio, v_ratio) == (2, 2) and c.shape[1] > 2:
        rows = _interleave(3 * c + _shift(c, -1, 0), 3 * c + _shift(c, 1, 0), 0)  # column sums, 2H rows
        return _interleave((3 * rows + _shift(rows, -1, 1) + 8) >> 4, (3 * rows + _shift(rows, 1, 1) + 7) >> 4, 1)
    if (h_ratio, v_ratio) == (2, 1) and c.shape[1] > 2:
        return _interleave((3 * c + _shift(c, -1, 1) + 1) >> 2, (3 * c + _shift(c, 1, 1) + 2) >> 2, 1)
    if (h_ratio, v_ratio) == (1, 2):
        return _interleave((3 * c + _shift(c, -1, 0) + 1) >> 2, (3 * c + _shift(c, 1, 0) + 2) >> 2, 0)
    return c.repeat_interleave(v_ratio, dim=0).repeat_interleave(h_ratio, dim=1)


def _ycc_to_rgb(y, cb, cr) -> torch.Tensor:
    """int32 Y, Cb, Cr planes at full size → (H, W, 3) int32 RGB in [0, 255], libjpeg's fixed point (jdcolor.c)."""
    cb, cr = cb - 128, cr - 128
    one_half, bits = 1 << 15, 16  # SCALEBITS 16, FIX(x) = round(x · 2^16)
    r = y + ((91881 * cr + one_half) >> bits)  # FIX(1.40200)
    g = y + ((-22554 * cb + one_half - 46802 * cr) >> bits)  # FIX(0.34414), FIX(0.71414)
    b = y + ((116130 * cb + one_half) >> bits)  # FIX(1.77200)
    return torch.stack([r, g, b], dim=-1).clamp_(0, 255)


def planes_to_rgb(planes: list[torch.Tensor], colour: str = "ycc") -> torch.Tensor:
    """Decoded JPEG planes (uint8, each at its own subsampling) → (H, W, 3) uint8 RGB on their device,
    as libjpeg converts them by default and PIL takes the result.

    ``colour`` is the file's colour space (:class:`JpegHeader`). Gray repeats
    into the three channels (PIL's ``convert("RGB")``). CMYK and YCCK end in
    PIL's ``CMYK;I`` unpacking and ``cmyk2rgb``: with the stored K as
    ``nk``, each channel is ``nk - nk · (255 - stored) / 255`` in PIL's
    integer rounding.
    """
    if colour == "gray":
        y = planes[0]
        return y[:, :, None].expand(*y.shape, 3)
    h, w = max(p.shape[0] for p in planes), max(p.shape[1] for p in planes)
    full = []
    for p in planes:
        ph, pw = p.shape
        plane = p.to(torch.int32)
        if (ph, pw) != (h, w):
            plane = _upsample_chroma(plane, -(-w // pw), -(-h // ph))[:h, :w]
        full.append(plane)
    if colour == "ycc":
        return _ycc_to_rgb(*full).to(torch.uint8)
    if colour == "rgb":
        return torch.stack(full, dim=-1).to(torch.uint8)
    # CMYK as stored, or YCCK → CMYK as libjpeg's ycck_cmyk_convert (255 - RGB of the YCC, K kept)
    cmy = 255 - _ycc_to_rgb(*full[:3]) if colour == "ycck" else torch.stack(full[:3], dim=-1)
    nk = full[3][..., None]  # 255 - K after PIL's CMYK;I inversion
    t = (255 - cmy) * nk + 128  # PIL's MULDIV255(inverted C, M or Y; nk)
    return (nk - (((t >> 8) + t) >> 8)).clamp_(0, 255).to(torch.uint8)


# --------------------------------------------------------------------------- #
# Decoders
# --------------------------------------------------------------------------- #
def read_header(data: bytes, name: str = "<bytes>") -> JpegHeader:
    """Size and colour space of a JPEG from its markers before the first scan; raises :class:`JpegError`.

    The segments before the first scan are walked by their lengths, which
    skips APPn payloads (an EXIF thumbnail is a whole JPEG, EOI included).
    The colour space is libjpeg's reading of the markers
    (``default_decompress_parms``): a JFIF marker means YCbCr; otherwise
    Adobe's APP14 transform (0: RGB or CMYK, else YCbCr or YCCK); otherwise
    three components with ids 'R', 'G', 'B' are RGB. PIL refuses other
    precisions than 8 bits and other component counts than 1, 3 and 4.
    """
    if data[:2] != b"\xff\xd8":
        raise JpegError(f"{name}: not a JPEG (no start-of-image marker)")
    pos, frame, jfif, transform = 2, None, False, None
    while True:
        if pos + 4 > len(data):
            raise JpegError(f"{name}: corrupt or truncated JPEG header")
        marker = data[pos + 1]
        if data[pos] != 0xFF or marker == 0xFF:  # junk before a marker (PIL skips it), or a fill byte
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:  # TEM, RSTn: no length
            pos += 2
            continue
        if marker == 0xDA:
            break
        length = int.from_bytes(data[pos + 2 : pos + 4], "big")
        body = data[pos + 4 : pos + 2 + length]
        if marker in _SOF_MARKERS:
            frame = body
        elif marker == 0xE0 and len(body) >= 14 and body.startswith(b"JFIF\x00"):
            jfif = True
        elif marker == 0xEE and len(body) >= 12 and body.startswith(b"Adobe"):
            transform = body[11]
        pos += 2 + length
    if frame is None or len(frame) < 6:
        raise JpegError(f"{name}: JPEG without a frame header")
    precision, height, width, n = struct.unpack(">BHHB", frame[:6])
    if precision != 8 or n not in (1, 3, 4) or len(frame) < 6 + 3 * n:
        raise JpegError(f"{name}: a {precision}-bit JPEG of {n} components has no RGB decode here or in PIL")
    if n == 1:
        colour = "gray"
    elif n == 3:
        ids = tuple(frame[6 + 3 * c] for c in range(3))
        if jfif:
            colour = "ycc"
        elif transform is not None:
            colour = "rgb" if transform == 0 else "ycc"
        else:
            colour = "rgb" if ids == (82, 71, 66) else "ycc"
    else:
        colour = "cmyk" if transform in (None, 0) else "ycck"
    return JpegHeader(width, height, colour)


def check_complete(data: bytes, name: str = "<bytes>") -> JpegHeader:
    """:func:`read_header`, and raise :class:`JpegError` unless the last scan ends in an end-of-image marker.

    nvJPEG decodes a truncated file where libjpeg and PIL refuse it, so the
    card checks first. Byte stuffing keeps the SOS and EOI markers out of
    entropy-coded data, so from the first scan on EOI must follow the last SOS.
    """
    header = read_header(data, name)
    if data.find(b"\xff\xd9", data.rfind(b"\xff\xda")) < 0:
        raise JpegError(f"{name}: truncated JPEG (no end-of-image marker after the last scan)")
    return header


def decode_cpu(data: bytes, name: str = "<bytes>") -> torch.Tensor:
    """JPEG bytes → (H, W, 3) uint8 RGB CPU tensor at full resolution, equal to PIL's decode.

    libjpeg decodes the component planes and names the colour space;
    :func:`planes_to_rgb` converts them. Raises :class:`JpegError` naming
    ``name`` for data libjpeg refuses (corrupt or truncated) and for layouts
    PIL does not read either.
    """
    header = read_header(data, name)
    lib = _cpu_lib()
    widths, heights, n, space = (ctypes.c_int * 4)(), (ctypes.c_int * 4)(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    status = lib.sl_jpeg_info(data, len(data), widths, heights, ctypes.byref(n), ctypes.byref(space), msg,
                              _MSG_LEN)
    if status == 0:
        colour = _LIBJPEG_SPACES[space.value]
        if colour != header.colour:  # the card decides from read_header alone: the two must agree
            raise RuntimeError(f"{name}: libjpeg reads colour space {colour}, read_header {header.colour}")
        planes = [torch.empty((heights[c], widths[c]), dtype=torch.uint8) for c in range(n.value)]
        pointers = (ctypes.c_void_p * n.value)(*[p.data_ptr() for p in planes])
        status = lib.sl_jpeg_decode_planes(data, len(data), pointers, msg, _MSG_LEN)
        if status == 0:
            return planes_to_rgb(planes, colour)
    raise JpegError(f"{name}: libjpeg cannot decode it as RGB: {msg.value.decode(errors='replace')}")


class NvJpegDecoder:
    """One nvJPEG handle and decode state on the card; use it from one thread.

    :meth:`decode` runs on the caller's current CUDA stream and returns
    without waiting for it. Create one per thread that decodes (creating a
    handle costs milliseconds; reuse it across batches).
    """

    def __init__(self, device=None):
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type != "cuda":
            raise ValueError(f"nvJPEG decodes on a CUDA device, got {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lib = _nvjpeg_lib()
        ctx = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            self._check(self._lib.sl_nvjpeg_create(ctypes.byref(ctx)), "nvjpegCreateSimple")
        self._ctx = ctx
        self._finalizer = weakref.finalize(self, self._lib.sl_nvjpeg_destroy, ctx)
        self._finalizer.atexit = False  # the process's exit releases the card's state

    @staticmethod
    def _check(status: int, what: str, data: bool = False):
        """Raise for a failed call: :class:`JpegError` where ``data`` and nvJPEG refused the bytes,
        else ``RuntimeError``."""
        if status != 0:
            error = JpegError if data and status in _DATA_STATUSES else RuntimeError
            raise error(f"{what}: NVJPEG_STATUS_{_NVJPEG_STATUS.get(status, status)}")

    def close(self):
        """Release the handle and state (also done when the decoder is collected)."""
        self._finalizer()

    def decode(self, data: bytes, name: str = "<bytes>") -> torch.Tensor:
        """JPEG bytes → (H, W, 3) uint8 RGB on the card, at full resolution.

        nvJPEG decodes the component planes (Y alone for gray, the YUV
        planes for YCbCr, the planes as stored otherwise);
        :func:`planes_to_rgb` converts them in the colour space
        :func:`read_header` gives. Bytes that are not a whole JPEG
        (:func:`check_complete`) or that nvJPEG refuses raise
        :class:`JpegError`.
        """
        header = check_complete(data, name)
        widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        n, css = ctypes.c_int(), ctypes.c_int()
        status = self._lib.sl_nvjpeg_info(self._ctx, data, len(data), widths, heights, ctypes.byref(n),
                                          ctypes.byref(css))
        self._check(status, f"{name}: nvjpegGetImageInfo", data=True)
        if n.value != _COMPONENTS[header.colour]:
            raise JpegError(f"{name}: nvJPEG reads {n.value} components, the frame header "
                            f"{_COMPONENTS[header.colour]}")
        output = {"gray": _NVJPEG_Y, "ycc": _NVJPEG_YUV}.get(header.colour, _NVJPEG_UNCHANGED)
        shapes = [(heights[c], widths[c]) for c in range(n.value)]
        if output == _NVJPEG_UNCHANGED:
            # Planes at the components' own sizes, each backed by a buffer of the full image's size so that
            # no write of nvJPEG's can run past it.
            full = max(h for h, _ in shapes) * max(w for _, w in shapes)
            planes = [torch.empty(full, dtype=torch.uint8, device=self.device)[: h * w].view(h, w) for h, w in shapes]
        else:
            planes = [torch.empty(shape, dtype=torch.uint8, device=self.device) for shape in shapes]
        pointers = (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])
        pitches = (ctypes.c_int * len(planes))(*[p.stride(0) for p in planes])
        stream = torch.cuda.current_stream(self.device).cuda_stream
        status = self._lib.sl_nvjpeg_decode_planes(self._ctx, data, len(data), len(planes), output, pointers,
                                                   pitches, stream)
        self._check(status, f"{name}: nvjpegDecode", data=True)
        return planes_to_rgb(planes, header.colour)

    def encode(self, image: torch.Tensor, quality: int = 90) -> bytes:
        """(H, W, 3) uint8 RGB on the card → baseline JPEG bytes, 4:2:0 chroma.

        Waits for the current stream.
        """
        if image.device != self.device or image.dtype != torch.uint8 or image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"encode takes (H, W, 3) uint8 on {self.device}, got {tuple(image.shape)} "
                             f"{image.dtype} on {image.device}")
        image = image.contiguous()
        h, w, _ = image.shape
        stream = torch.cuda.current_stream(self.device).cuda_stream
        length = ctypes.c_size_t()
        self._check(self._lib.sl_nvjpeg_encode(self._ctx, image.data_ptr(), w, h, quality, stream,
                                               ctypes.byref(length)), "nvjpegEncodeImage")
        out = ctypes.create_string_buffer(length.value)
        self._check(self._lib.sl_nvjpeg_encoded(self._ctx, out, ctypes.byref(length), stream),
                    "nvjpegEncodeRetrieveBitstream")
        return out.raw[: length.value]
