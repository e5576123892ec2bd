"""What ``torch._int_mm`` (cuBLASLt's int8 GEMM) takes on one CUDA card, and its time beside bf16.

    python3 probe_int_mm.py

For row counts 1–12,800, K in {36, 40, 64, 768, 3072} and N in {4, 8, 16,
768, 2304}: whether ``_int_mm(a, b)`` runs with B given as ``w.t()`` of a
contiguous (N, K) ``w`` (column-major, what ``ops/quant.int_mm`` passes) and
as a contiguous (K, N) tensor, and whether its int32 result equals the
CPU's. Then, at ViT-B/32's linears at batch 256 (12,800 rows), the device
time of ``_int_mm`` and of the bf16 ``F.linear`` of the same shape (CUDA
events over 50 launches after 5 warm-up launches). ``ops/quant.py``'s
padding rules (rows > 16, K and N multiples of 8) come from this table.

Prints one JSON line; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch


def _ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_int_mm: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = []
    for m in (1, 5, 16, 17, 24, 32, 12800):
        for k in (36, 40, 64, 768, 3072):
            for n in (4, 8, 16, 768, 2304):
                a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
                w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
                ref = a.int() @ w.int().t()
                for layout in ("nk_transposed", "kn_contiguous"):
                    b = w.t() if layout == "nk_transposed" else w.t().contiguous()
                    try:
                        out = torch._int_mm(a.to(dev), b.to(dev))
                        status = "equal" if torch.equal(out.cpu(), ref) else "WRONG"
                    except RuntimeError as e:
                        status = str(e).splitlines()[0][:160]
                    rows.append([m, k, n, layout, status])
    timing = {}
    m = 256 * 50
    for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev)
        xb = torch.randn(m, k, device=dev, dtype=torch.bfloat16)
        wb = torch.randn(n, k, device=dev, dtype=torch.bfloat16)
        timing[f"{m}x{k}->{n}"] = {"int_mm_ms": _ms(lambda: torch._int_mm(a, w.t())),
                                   "bf16_linear_ms": _ms(lambda: torch.nn.functional.linear(xb, wb))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda, "card": smi, "rows": rows,
                      "timing": timing}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
