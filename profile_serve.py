"""Where the time of one request to the port's search server goes, on one CUDA card.

    python3 profile_serve.py

Builds ``chip_smoke.py``'s serve configuration (OpenCLIP ViT-B/32 bf16 with
random weights from seed 0 and the hash tokenizer, one prompt template, an
aggregated DB of 1024 + 2048 random 512-d concepts) and reports what
``chip_smoke.py``'s ``[serve]`` phase does not (that phase times whole
requests: HTTP, in-process ``text_search``, ``/label``), as host-clock
medians over 50 calls, each ended by a device synchronize:

1. the stages of a text query: tokenize, text tower, K1 + stable top-k of
   both layers;
2. the text tower on a thread that has not run PyTorch work before (what a
   fresh request thread of the HTTP server would pay without the service's
   device thread);
3. a ``torch.profiler`` trace of 5 queries: device time per query and the
   host time the kernel launches take.

Prints JSON lines; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

sys.dont_write_bytecode = True

import numpy as np  # noqa: E402
import torch  # noqa: E402


def median_ms(fn, n: int = 50) -> dict:
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return {"p50_ms": float(np.median(times)), "min_ms": float(min(times)), "max_ms": float(max(times))}


def main():
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.serve import SearchService

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fm = OpenClip("ViT-B-32", dtype=torch.bfloat16, device=dev, seed=0)
    rng = np.random.default_rng(0)
    db = {"layer3": rng.normal(size=(1024, 512)).astype(np.float32),
          "layer4": rng.normal(size=(2048, 512)).astype(np.float32)}
    service = SearchService(fm, db, templates=["a photo of a {}"])
    prompt = "a photo of a word {}".format

    stages = {"tokenize": median_ms(lambda i: fm.tokenize([prompt(i)]))}
    with torch.inference_mode():
        stages["text_tower"] = median_ms(lambda i: fm.encode_text(fm.tokenize([prompt(i)])))
        q = fm.encode_text(fm.tokenize([prompt(0)])).float()
        stages["k1_and_topk_2_layers"] = median_ms(lambda i: service._bank_topk(q, 5))

    def tower_on_fresh_thread(i):
        def run():
            with torch.inference_mode():
                fm.encode_text(fm.tokenize([prompt(i)]))

        th = threading.Thread(target=run)
        th.start()
        th.join()

    stages["text_tower_on_a_fresh_thread"] = median_ms(tower_on_fresh_thread, n=20)
    print(json.dumps({"serve_stages": stages}), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            service.text_search(f"profiled {i}", 5)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    launch = [e for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx", "cuLaunchKernel")]
    print(json.dumps({"per_query": {
        "device_ms": device_us / 5e3,
        "kernel_launches": sum(e.count for e in launch) / 5,
        "launch_host_ms": sum(e.self_cpu_time_total for e in launch) / 5e3,
    }}), flush=True)
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15), flush=True)
    service.close()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
