"""Where the time of the port's JPEG decode goes, on one CUDA card.

    python3 profile_decode.py

Makes ``chip_smoke.py``'s folder (2048 synthetic 500×375 images, quality 90,
4:2:0, encoded with nvJPEG from a seed) and reports what its ``[folder]``
phase does not (that phase times the decode alone once, inside the full
smoke run):

1. images/s of ``ImageFolder(image_size=224)`` three ways: its own
   ``iter_batches`` (decode on a worker thread with its own stream), twice,
   and ``get_batch`` on the main thread;
2. per image, host-clock medians over 200 images, each ended by a device
   synchronize: the whole decode (nvJPEG's planes + ``planes_to_rgb``),
   ``planes_to_rgb`` alone on planes of the same shapes, and the
   resize-and-crop, with the CUDA kernel launches each makes (a
   ``torch.profiler`` trace);
3. (1) again after ``chip_smoke.py``'s quickstart phase has run in the same
   process, to show whether earlier work slows the decode.

Prints JSON lines, the card's name and power limit; exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.dont_write_bytecode = True

import torch  # noqa: E402


def rates(ds) -> dict:
    out = {}
    for key in ("worker_thread_1", "worker_thread_2"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for batch in ds.iter_batches(256):
            batch.ready.synchronize()
        out[key] = len(ds) / (time.perf_counter() - t)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for start in range(0, len(ds), 256):
        ds.get_batch(start, min(start + 256, len(ds)))
    torch.cuda.synchronize()
    out["main_thread"] = len(ds) / (time.perf_counter() - t)
    return out


def per_image(fn, files) -> dict:
    """Median host ms of ``fn(data)`` over ``files`` (each synchronized), and its kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    times = []
    for data in files:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(data)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(files[0])
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    times.sort()
    return {"median_ms": times[len(times) // 2], "kernels": kernels}


def main():
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from semanticlens_tpu_torch.data import ImageFolder
    from semanticlens_tpu_torch.data.image_folder import resize_crop
    from semanticlens_tpu_torch.data.native_decoder import NvJpegDecoder, planes_to_rgb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "jpegs"
        print(json.dumps({"folder": cs.make_jpeg_folder(dev, root)}), flush=True)
        ds = ImageFolder(root, image_size=224, device=dev)
        print(json.dumps({"images_per_s_fresh": rates(ds)}), flush=True)

        files = [path.read_bytes() for path, _ in ds.samples[:200]]
        decoder = NvJpegDecoder(dev)
        image = decoder.decode(files[0])
        h, w = image.shape[:2]
        planes = [torch.randint(0, 256, shape, dtype=torch.uint8, device=dev)
                  for shape in ((h, w), ((h + 1) // 2, (w + 1) // 2), ((h + 1) // 2, (w + 1) // 2))]
        stages = {
            "decode_nvjpeg_and_planes_to_rgb": per_image(decoder.decode, files),
            "planes_to_rgb_alone": per_image(lambda _: planes_to_rgb(planes), files),
            "resize_crop_224": per_image(lambda _: resize_crop(image, 224), files),
        }
        stages["nvjpeg_alone_ms_by_difference"] = (stages["decode_nvjpeg_and_planes_to_rgb"]["median_ms"]
                                                   - stages["planes_to_rgb_alone"]["median_ms"])
        print(json.dumps({"per_image": stages, "size": [w, h]}), flush=True)

        cs.phase_quickstart(dev)
        print(json.dumps({"images_per_s_after_quickstart": rates(ds)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
