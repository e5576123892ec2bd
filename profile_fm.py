"""Where the time of the port's image towers goes, on one CUDA card.

    python3 profile_fm.py

Per batch of 256 synthetic uint8 images, bf16, random weights from seed 0
at the published widths, on device-resident preprocessed input: the subject
ViT-B/16 (``blocks.11.mlp.fc1`` and ``blocks.11.attn.heads`` tapped, as in
BASELINE config 3), SigLIP2's ViT-B/16 image tower, MobileCLIP-S2's image
tower (256²) and CLIP ViT-B/32's. For each: the device time by CUDA events,
the ViTs' achieved bf16 rate from the FLOPs of their dense layers and
attention, and a ``torch.profiler`` trace of one call (device time by
kernel category, launches, top kernels); for MobileCLIP also the split of
its conv sites into depthwise (groups = channels) and the rest, with the
depthwise convs' achieved memory rate (each input read once, each output
written once) beside the card's 3.35 TB/s.

Prints JSON lines; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys

sys.dont_write_bytecode = True

import torch  # noqa: E402

from semanticlens_tpu_torch.utils.flops import H100_SXM  # noqa: E402

PEAK_BF16_FLOPS = H100_SXM["bf16"]  # H100 SXM data sheet, dense
PEAK_BYTES_PER_S = H100_SXM["hbm_bytes_per_s"]


def _vit_flops(tokens: int, width: int, depth: int, patch: int) -> float:
    """Dense-layer and attention FLOPs of one image through a ViT (qkv, proj, MLP ×4, QKᵀ and AV)."""
    per_block = 2 * tokens * (12 * width * width) + 4 * tokens * tokens * width
    return depth * per_block + 2 * tokens * 3 * patch * patch * width


def _conv_sites(fm, x) -> dict:
    """Device ms of MobileCLIP's depthwise (groups = channels) and other conv sites in one forward, each
    timed by CUDA events around the site (the conv and its bias add), and the depthwise sites' rate from
    the bytes a conv must move (input read once, output written once)."""
    from semanticlens_tpu_torch.foundation_models import mobileclip as mc

    real, sites = mc.conv2d, []

    def timed(inp, weight, bias=None, **kwargs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(inp, weight, bias, **kwargs)
        stop.record()
        depthwise = kwargs.get("groups", 1) == inp.shape[1] > 1
        sites.append((depthwise, inp.element_size() * (inp.numel() + out.numel()), start, stop))
        return out

    mc.conv2d = timed
    try:
        fm.encode_image(x)
    finally:
        mc.conv2d = real
    torch.cuda.synchronize()
    out = {"depthwise_ms": 0.0, "depthwise_sites": 0, "depthwise_bytes": 0.0, "other_conv_ms": 0.0,
           "other_conv_sites": 0}
    for depthwise, nbytes, start, stop in sites:
        key = "depthwise" if depthwise else "other_conv"
        out[f"{key}_ms"] += start.elapsed_time(stop)
        out[f"{key}_sites"] += 1
        out["depthwise_bytes"] += nbytes if depthwise else 0
    out["depthwise_bytes_per_s"] = out["depthwise_bytes"] / (out["depthwise_ms"] / 1e3)
    out["depthwise_share_of_hbm_rate"] = out["depthwise_bytes_per_s"] / PEAK_BYTES_PER_S
    return out


def main():
    if not torch.cuda.is_available():
        print("profile_fm: no CUDA device is available", file=sys.stderr)
        return 2
    from profile_port import _category
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from semanticlens_tpu_torch.foundation_models import ClipMobile, OpenClip, SigLipV2
    from semanticlens_tpu_torch.models import VisionTransformer
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    dev = torch.device("cuda")
    batch = 256
    vit = VisionTransformer(dtype=torch.bfloat16, device=dev)
    vit_params = vit.init(seed=0)
    siglip = SigLipV2(dtype=torch.bfloat16, device=dev, seed=0)
    mobile = ClipMobile("s2", dtype=torch.bfloat16, device=dev, seed=0)
    clip32 = OpenClip("ViT-B-32", dtype=torch.bfloat16, device=dev, seed=0)
    raw224 = torch.from_numpy(cs._make_images(batch, seed=0, size=224)).to(dev)
    raw256 = torch.from_numpy(cs._make_images(batch, seed=0, size=256)).to(dev)
    taps = tuple(cs.CONFIG3["components"])
    with torch.inference_mode():
        x_vit, x_sig, x_mob, x_32 = (make_preprocess_fn(size=224)(raw224), siglip.preprocess(raw224),
                                     mobile.preprocess(raw256), clip32.preprocess(raw224))
        towers = {
            "subject_vit_b16_with_taps": (lambda: vit.apply(vit_params, x_vit, taps), _vit_flops(197, 768, 12, 16)),
            "siglip2_image_tower": (lambda: siglip.encode_image(x_sig), _vit_flops(196, 768, 12, 16)),
            "mobileclip_s2_image_tower": (lambda: mobile.encode_image(x_mob), None),
            "clip_vit_b32_image_tower": (lambda: clip32.encode_image(x_32), _vit_flops(50, 768, 12, 32)),
        }
        for name, (fn, flops) in towers.items():
            ms = cs.time_ms(fn, iters=10, warmup=3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            by_cat: dict[str, float] = {}
            for e in kernels:
                cat = _category(e.key)
                by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
            row = {"tower": name, "batch": batch, "ms_per_batch": ms,
                   "device_kernel_ms": sum(by_cat.values()), "kernel_launches": sum(e.count for e in kernels),
                   "ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
                   "top_kernels": [{"name": e.key[:90], "calls": e.count, "ms": e.self_device_time_total / 1e3}
                                   for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]]}
            if flops:
                row["tflops_per_s"] = batch * flops / (ms / 1e3) / 1e12
                row["share_of_bf16_peak"] = batch * flops / (ms / 1e3) / PEAK_BF16_FLOPS
            if "mobileclip" in name:
                row["conv_sites"] = _conv_sites(mobile, x_mob)
            print(json.dumps(row), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
