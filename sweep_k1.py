"""The measurements behind K1's launch plan, on one CUDA card.

    python3 sweep_k1.py

``semanticlens_tpu_torch/ops/cosine.plan_launch`` picks K1's streaming or
tiled kernel, and the tiled kernel's tile, from the shape. This script times
the alternatives it chooses between, at D=512, each as the device time of one
launch (CUDA events around the replay of a CUDA graph of 20 launches on the
same inputs, ``chip_smoke.graph_ms``):

1. both kernels over M ∈ {8, 16, 24, 32} (the streaming kernel is compiled
   for M ≤ 32) and N ∈ {1024, 2048, 8192, 32768}, beside the planned one:
   the threshold ``STREAMING_MAX_M`` / ``STREAMING_MAX_MN``;
2. the tiled kernel's tiles at 1024×1024, 2048×2048 and 4096×8192, beside the
   planned one.

Each launch goes through the wrapper's launchers with a plan built by hand,
so it runs the kernel the plan would not pick. Prints JSON lines; exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys

sys.dont_write_bytecode = True

import torch  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("sweep_k1: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from semanticlens_tpu_torch.ops import cosine as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)

    def forced_ms(plan, x, y):
        """Device time of the kernel of ``plan``, checked against the plain version first."""
        xk, yk = x.unsqueeze(0), y.unsqueeze(0)

        def launch(xk, yk):
            out = torch.empty(1, xk.shape[1], yk.shape[1], device=dev)
            k1._LAUNCH[plan.variant](xk, yk, out, plan, torch.cuda.current_stream().cuda_stream)
            return out

        err = float((launch(xk, yk)[0] - k1.cosine_similarity_matrix_plain(x, y)).abs().max())
        if not err <= cs.ATOL:
            raise AssertionError(f"K1 {plan} at {tuple(x.shape)} x {tuple(y.shape)}: max abs err {err:.3g}")
        return cs.graph_ms(launch, [(xk, yk)])

    for n in (1024, 2048, 8192, 32768):
        y = randn(n, 512)
        for m in (8, 16, 24, 32):
            x = randn(m, 512)
            tiled = k1.LaunchPlan("tiled", 512, config=k1._tiled_config(m, n, num_sms))
            row = {"M": m, "N": n, "D": 512,
                   "streaming_ms": forced_ms(k1.LaunchPlan("streaming", 512), x, y),
                   "tiled_ms": forced_ms(tiled, x, y),
                   "planned": k1.plan_launch(1, m, n, 512, num_sms).variant}
            print(f"[threshold] {json.dumps(row)}", flush=True)

    for m, n in ((1024, 1024), (2048, 2048), (4096, 8192)):
        x, y = randn(m, 512), randn(n, 512)
        row = {"M": m, "N": n, "D": 512,
               **{f"tile {bm}x{bn} ms": forced_ms(k1.LaunchPlan("tiled", 512, config=c), x, y)
                  for c, (bm, bn) in k1.TILE_CONFIGS.items()},
               "planned": "{}x{}".format(*k1.TILE_CONFIGS[k1.plan_launch(1, m, n, 512, num_sms).config])}
        print(f"[tiles] {json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
