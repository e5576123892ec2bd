"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failing check raises; the exit code is then non-zero):

1. build — compile every hand-written CUDA kernel of the main path with nvcc
   (``semanticlens_tpu_torch/csrc/*.cu``), all sources at once;
2. kernels — call each kernel's wrapper on the card at the shapes the main
   path gives it, plus ragged, zero-row, near-duplicate, wide-norm and
   threshold cases, and hold the result against its plain PyTorch version
   (atol 3e-5); time kernel, plain version, and one PyTorch library call
   computing the same function (device time from the replay of a CUDA graph
   of 20 launches, with the inputs warm in L2 and with them cold, and the
   host-loop time beside it); compute each kernel's bounds from the card's
   data-sheet rates;
3. reference — the slice at full model width on 16 images in float32 on the
   card, held against the same code on the CPU (plain kernel versions);
4. quickstart — the README quickstart through the port's entry points at
   full width: ResNet-50 bf16 tapping layer3/layer4, OpenCLIP ViT-B/32 bf16,
   both with random weights from seed 0, 2048 synthetic 256×256 uint8 images
   at batch 256: the fused Collect+Embed pass, the concept DB, text probing,
   clarity, redundancy and polysemanticity. Kernel launch counts are set to
   0 just before and read just after; every kernel of the path must have
   launched (K1: both its streaming and its tiled kernel).

Prints the kernels' JSON line and the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits non-zero before printing any result. The quickstart's cache goes to a
temporary directory; the kernel build goes to the package's ignored
``csrc/build`` directory.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.dont_write_bytecode = True

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM data-sheet rates (dense): fp32 outside the tensor cores, TF32 on
# the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
ATOL = 3e-5
GRAPH_LAUNCHES = 20


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back host calls, by CUDA events.

    Host enqueue time is inside this number wherever it exceeds the work on
    the card (small shapes); :func:`graph_ms` is the device time.
    """
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, inputs: list, launches: int = GRAPH_LAUNCHES, replays: int = 5) -> float:
    """Device time of one ``fn(*args)``: CUDA events around replays of a graph of
    at least ``launches`` calls, the i-th on ``inputs[i % len(inputs)]``."""
    launches = max(launches, len(inputs))
    fn(*inputs[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*inputs[0])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (launches * replays)


def cold_l2_inputs(x, y) -> list:
    """Copies of (x, y) that together hold twice the L2, so that a graph cycling
    through them finds each launch's inputs evicted: they come from HBM."""
    per_copy = 4 * (x.numel() + (0 if y is x else y.numel()))
    copies = []
    for _ in range(math.ceil(2 * L2_BYTES / per_copy)):
        xc = x.clone()
        copies.append((xc, xc if y is x else y.clone()))
    return copies


def phase_build():
    from semanticlens_tpu_torch.utils import cuda_build

    names = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        for fut in [ex.submit(cuda_build.build, n) for n in names]:
            fut.result()
    for name in names:
        entry = cuda_build.BUILD_LOG[name]
        log(f"[build] {name}.cu: {entry['seconds']:.2f} s")
        for line in entry["compiler_output"].splitlines():
            log(f"[build]   {line}")
        # ptxas C7518: wgmma serialized (a branch touches its accumulators in the K loop)
        if "C7518" in entry["compiler_output"]:
            raise AssertionError(f"{name}.cu: ptxas serializes wgmma (C7518); see the [build] lines")
    log(f"[build] all kernels: {time.perf_counter() - t0:.2f} s")


def cosine_bounds_ms(batch, m, n, d) -> dict:
    """K1's three bounds on this card, by name (ms).

    - tf32x3_tensor_core: the dot as three TF32 products (the tiled kernel's
      arithmetic, as precise as fp32) at 495 TFLOP/s;
    - fp32_cuda_core: the dot and both norms in fp32 FMA (the streaming
      kernel's arithmetic) at 67 TFLOP/s;
    - hbm_bytes: each input read once and the output written once at 3.35 TB/s.
    """
    dots = 2.0 * batch * m * n * d
    return {
        "tf32x3_tensor_core": 1e3 * 3 * dots / PEAK_TF32_FLOPS,
        "fp32_cuda_core": 1e3 * (dots + 2.0 * batch * (m + n) * d) / PEAK_FP32_FLOPS,
        "hbm_bytes": 1e3 * 4.0 * batch * (m * d + n * d + m * n) / PEAK_BYTES_PER_S,
    }


def named_bound(variant, bounds) -> tuple[float, str]:
    """The bound of the kernel that ran: its arithmetic's time or the bytes', whichever is larger."""
    ops = bounds["tf32x3_tensor_core" if variant == "tiled" else "fp32_cuda_core"]
    return (ops, "operations") if ops >= bounds["hbm_bytes"] else (bounds["hbm_bytes"], "bytes")


def library_cosine(x, y):
    """One PyTorch formulation of the same function (cuBLAS fp32 matmul + rescale); timed, never used."""
    return torch.matmul(x, y.transpose(-1, -2)) * (
        torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12).reciprocal()
        * torch.linalg.vector_norm(y, dim=-1).clamp_min(1e-12).reciprocal().unsqueeze(-2)
    )


def phase_kernels(dev):
    """K1 against its plain version at the main path's shapes and edge cases; times and bounds."""
    from semanticlens_tpu_torch.ops import cosine as k1

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)

    def near_duplicate_bank(m, d):  # rows in pairs y, y + 1e-3·noise: redundancy takes its max there
        base = randn(m // 2, d)
        return torch.cat([base, base + 1e-3 * randn(m // 2, d)])

    def wide_norms(m, n, d):  # row norms spread over 1e-3 .. 1e3
        def scale(rows):
            return 10.0 ** (6.0 * torch.rand(rows, 1, generator=gen, device=dev) - 3.0)

        return randn(m, d) * scale(m), randn(n, d) * scale(n)

    def with_zero_rows(m, n, d):
        x, y = randn(m, d), randn(n, d)
        x[::7] = 0.0
        y[::5] = 0.0
        return x, y

    t = k1.STREAMING_MAX_M
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bank = near_duplicate_bank(2048, 512)
    cases = {
        "probe 8x1024x512": (randn(8, 512), randn(1024, 512)),
        "probe 8x2048x512": (randn(8, 512), randn(2048, 512)),
        "redundancy 1024x1024x512": (randn(1024, 512),) * 2,
        "redundancy 2048x2048x512": (randn(2048, 512),) * 2,
        "audit 4096x8192x512": (randn(4096, 512), randn(8192, 512)),
        f"threshold M={t} {t}x2048x512": (randn(t, 512), randn(2048, 512)),
        f"past threshold M={t + 1} {t + 1}x1024x512": (randn(t + 1, 512), randn(1024, 512)),
        f"past threshold M*N {t}x2049x512": (randn(t, 512), randn(2049, 512)),
        "near-duplicates 2048x2048x512": (near_duplicate_bank(2048, 512),) * 2,
        # near-parallel rows at large D: the tiled kernel's accumulation must not drift with D
        "near-duplicates D=1280 1024x1024x1280": (near_duplicate_bank(1024, 1280),) * 2,
        "near-duplicates D=4096 1024x1024x4096": (near_duplicate_bank(1024, 4096),) * 2,
        "near-duplicates probe 8x2048x512": (bank[:8] + 1e-3 * randn(8, 512), bank),
        "wide norms 1024x1024x512": wide_norms(1024, 1024, 512),
        "wide norms probe 16x2048x512": wide_norms(16, 2048, 512),
        "zero rows 300x200x512": with_zero_rows(300, 200, 512),
        "zero rows 2x3x32": (torch.zeros(2, 32, device=dev), torch.ones(3, 32, device=dev)),
        "ragged 300x513x130": (randn(300, 130), randn(513, 130)),
        "D=33 probe 5x700x33": (randn(5, 33), randn(700, 33)),
        "D=130 probe 12x513x130": (randn(12, 130), randn(513, 130)),
        "D=513 200x300x513": (randn(200, 513), randn(300, 513)),
        "D=513 probe 8x1000x513": (randn(8, 513), randn(1000, 513)),
        "batched 3x70x90x33": (randn(3, 70, 33), randn(3, 90, 33)),
        "ragged batch 2x130x130x64": (randn(2, 130, 64), randn(2, 130, 64)),
    }
    timed = ("probe 8x1024x512", "probe 8x2048x512", "redundancy 1024x1024x512",
             "redundancy 2048x2048x512", "audit 4096x8192x512")
    rows, max_err = [], {"streaming": 0.0, "tiled": 0.0}
    for label, (x, y) in cases.items():
        batch = x.shape[0] if x.ndim == 3 else 1
        m, d = x.shape[-2:]
        n = y.shape[-2]
        variant = k1.plan_launch(batch, m, n, d, num_sms).variant
        out = k1.cosine_similarity_matrix(x, y)
        torch.cuda.synchronize()
        ref = k1.cosine_similarity_matrix_plain(x, y)
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"K1 {label}: shape {tuple(out.shape)} / non-finite output")
        err = float((out - ref).abs().max())
        if not err <= ATOL:
            raise AssertionError(f"K1 {label} ({variant}): max abs err {err:.3g} > {ATOL}")
        max_err[variant] = max(max_err[variant], err)
        row = {"shape": label, "variant": variant, "max_abs_err": err}
        if label in timed:
            bounds = cosine_bounds_ms(batch, m, n, d)
            bound, bound_by = named_bound(variant, bounds)
            warm, cold = [(x, y)], cold_l2_inputs(x, y)
            row.update(
                ms=time_ms(lambda x=x, y=y: k1.cosine_similarity_matrix(x, y)),
                plain_ms=time_ms(lambda x=x, y=y: k1.cosine_similarity_matrix_plain(x, y)),
                library_ms=time_ms(lambda x=x, y=y: library_cosine(x, y)),
                device_ms=graph_ms(k1.cosine_similarity_matrix, warm),
                plain_device_ms=graph_ms(k1.cosine_similarity_matrix_plain, warm),
                library_device_ms=graph_ms(library_cosine, warm),
                device_ms_cold_l2=graph_ms(k1.cosine_similarity_matrix, cold),
                library_device_ms_cold_l2=graph_ms(library_cosine, cold),
                device_ms_again=graph_ms(k1.cosine_similarity_matrix, warm),
                bounds_ms=bounds, bound_ms=bound, bound_by=bound_by,
            )
            del cold
            # A bytes bound reads each input once from HBM, as the cold-L2 launches
            # do; an operations bound holds at any cache level.
            row["share_of_bound_cold_l2"] = bound / row["device_ms_cold_l2"]
            if bound_by == "operations":
                row["share_of_bound"] = bound / row["device_ms"]
            y_bytes = 4.0 * batch * n * d
            if y_bytes < L2_BYTES:
                row["note"] = (f"y ({y_bytes / 1e6:.1f} MB) fits in the 50 MB L2: device_ms reads it "
                               "from L2, device_ms_cold_l2 from HBM")
        rows.append(row)
        log(f"[kernels] K1 {json.dumps(row)}")

    # Error against float64 by D on near-parallel rows: the tiled kernel's
    # accumulation must not drift with D.
    for d in (512, 1024, 2048, 4096, 8192):
        bank = near_duplicate_bank(1024, d)
        b64 = bank.double()
        ref = (b64 @ b64.T) / (b64.norm(dim=1, keepdim=True) * b64.norm(dim=1))
        errs = {name: float((fn(bank, bank).double() - ref).abs().max())
                for name, fn in (("kernel", k1.cosine_similarity_matrix),
                                 ("plain", k1.cosine_similarity_matrix_plain))}
        if not errs["kernel"] <= ATOL:
            raise AssertionError(f"K1 near-duplicates D={d}: {errs['kernel']:.3g} from float64 > {ATOL}")
        log(f"[kernels] K1 max abs err vs float64, near-duplicates 1024x1024x{d}: {json.dumps(errs)}")

    return rows, max_err


def _make_images(n, seed=0, size=256):
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


def run_slice(device, dtype, images, num_samples, batch_size, cache_dir):
    """The README quickstart (steps 1–4) through the port's entry points."""
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    times = {}
    t0 = time.perf_counter()
    model = ResNet(depth=50, dtype=dtype, device=device)
    model.params = model.init(seed=0)
    model.name = "resnet50"
    fm = OpenClip("ViT-B-32", dtype=dtype, device=device, seed=0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    times["weights_s"] = time.perf_counter() - t0

    dataset = ArrayDataset(images, name="synthetic-uint8")
    cv = ActivationComponentVisualizer(
        model=model,
        dataset_model=dataset,
        dataset_fm=dataset,
        layer_names=["layer3", "layer4"],
        num_samples=num_samples,
        aggregate_fn=aggregate_conv_mean,
        model_preprocess=make_preprocess_fn(size=224),
        cache_dir=cache_dir,
    )
    lens = Lens(fm)

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        times[key] = time.perf_counter() - t
        return out

    concept_db = timed("collect_embed_s", lambda: lens.compute_concept_db(cv, batch_size=batch_size))
    agg_db = {k: v.mean(1) for k, v in concept_db.items()}
    queries = ["dog", "cat", "car", "tree", "bird", "house", "person", "boat"]
    hits = timed("text_probing_s", lambda: lens.text_probing(queries, agg_db, templates=["a photo of a {}"]))
    clarity = timed("clarity_s", lambda: lens.eval_clarity(concept_db))
    redundancy = timed("redundancy_s", lambda: lens.eval_redundancy(agg_db))
    poly = timed("polysemanticity_s", lambda: lens.eval_polysemanticity(concept_db))
    return {
        "cv": cv,
        "fm": fm,
        "lens": lens,
        "queries": queries,
        "concept_db": concept_db,
        "ids": {k: cv.get_max_reference(k) for k in concept_db},
        "values": {k: cv.actmax_cache[k].activations.float().numpy() for k in concept_db},
        "hits": hits,
        "clarity": {k: v.cpu().numpy() for k, v in clarity.items()},
        "redundancy": {k: float(v) for k, v in redundancy.items()},
        "poly": {k: v.cpu().numpy() for k, v in poly.items()},
        "times": times,
    }


def check_outputs(res, n_images, num_samples, label):
    expect = {"layer3": 1024, "layer4": 2048}
    for layer, c in expect.items():
        db = res["concept_db"][layer]
        if db.shape != (c, num_samples, 512):
            raise AssertionError(f"{label}: concept DB {layer} shape {db.shape}")
        if not np.isfinite(db).all():
            raise AssertionError(f"{label}: concept DB {layer} has non-finite values")
        ids = res["ids"][layer]
        if ids.shape != (c, num_samples) or ids.min() < -1 or ids.max() >= n_images:
            raise AssertionError(f"{label}: ids of {layer} out of range [{ids.min()}, {ids.max()}]")
        if res["hits"][layer].shape != (8, c) or not np.isfinite(res["hits"][layer]).all():
            raise AssertionError(f"{label}: probe scores of {layer}")
        for key in ("clarity", "poly"):
            v = res[key][layer]
            if v.shape != (c,) or not np.isfinite(v).all():
                raise AssertionError(f"{label}: {key} of {layer}")
        if not np.isfinite(res["redundancy"][layer]):
            raise AssertionError(f"{label}: redundancy of {layer}")


def phase_reference(dev):
    """float32 slice on 16 images: the card against the CPU (plain kernel versions).

    Collect+Embed: top-k ids and values and the full embedding table. Analyze:
    the card's scores on the CPU run's concept DB, i.e. on identical inputs
    (a near-tie that orders one top-k slot differently must not look like a
    scoring error). Polysemanticity draws k-means starts from per-device
    random streams, so it is checked for shape and finiteness only.
    """
    images = _make_images(16, seed=1)
    results = {}
    for device in (dev, torch.device("cpu")):
        with tempfile.TemporaryDirectory() as tmp:
            results[device.type] = run_slice(device, torch.float32, images, 5, 8, tmp)
        check_outputs(results[device.type], 16, 5, f"reference[{device.type}]")
    gpu, cpu = results["cuda"], results["cpu"]
    np.testing.assert_allclose(gpu["cv"].embedding_table, cpu["cv"].embedding_table, rtol=1e-3, atol=1e-4)
    cpu_db = cpu["concept_db"]
    cpu_agg = {k: v.mean(1) for k, v in cpu_db.items()}
    lens = gpu["lens"]
    hits = lens.text_probing(gpu["queries"], cpu_agg, templates=["a photo of a {}"])
    clarity = lens.eval_clarity(cpu_db)
    redundancy = lens.eval_redundancy(cpu_agg)
    report = {}
    for layer in ("layer3", "layer4"):
        np.testing.assert_allclose(gpu["values"][layer], cpu["values"][layer], rtol=2**-7, atol=1e-3)
        id_match = float((gpu["ids"][layer] == cpu["ids"][layer]).mean())
        if id_match < 0.98:
            raise AssertionError(f"reference: only {id_match:.3f} of {layer} ids agree with the CPU")
        np.testing.assert_allclose(hits[layer], cpu["hits"][layer], atol=1e-4)
        np.testing.assert_allclose(clarity[layer].cpu().numpy(), cpu["clarity"][layer], atol=1e-5)
        np.testing.assert_allclose(float(redundancy[layer]), cpu["redundancy"][layer], atol=1e-5)
        report[layer] = {"id_match": id_match,
                         "max_probe_diff": float(np.abs(hits[layer] - cpu["hits"][layer]).max())}
    log(f"[reference] cuda vs cpu float32, 16 images: {json.dumps(report)}")


def phase_quickstart(dev):
    from semanticlens_tpu_torch.ops import cosine as k1

    n_images, batch = 2048, 256
    images = _make_images(n_images, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        k1.reset_launch_counts()
        res = run_slice(dev, torch.bfloat16, images, 25, batch, tmp)
        launches = k1.launch_counts()
        check_outputs(res, n_images, 25, "quickstart")
        # probe (8 prompts → streaming) and redundancy (→ tiled) of two layers
        if launches["total"] < 4 or launches["streaming"] < 1 or launches["tiled"] < 1:
            raise AssertionError(f"K1 launches on the main path: {launches}")
        # Steady-state rate of the fused pass, with everything warm (not counted).
        cv, fm = res["cv"], res["fm"]

        def embed_fn(raw):
            return fm.encode_image(fm.preprocess(raw))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv.engine.run_fused(cv.params, cv.dataset, batch, embed_fn)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    times = res["times"]
    summary = {
        "images": n_images,
        "batch": batch,
        "images_per_s_first_pass": n_images / times["collect_embed_s"],
        "images_per_s_warm_pass": n_images / warm_s,
        "k1_launches": launches,
        **{k: round(v, 4) for k, v in times.items()},
        "redundancy": res["redundancy"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"[quickstart] {json.dumps(summary)}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_start = time.perf_counter()

    phase_build()
    rows, max_err = phase_kernels(dev)
    phase_reference(dev)
    launches = phase_quickstart(dev)

    def entry(variant, shape):
        row = next(r for r in rows if r["shape"] == shape)
        if row["variant"] != variant:
            raise AssertionError(f"K1 {shape} ran the {row['variant']} kernel, not {variant}")
        return {
            "name": f"cosine_similarity_matrix[{variant}]",
            "route": "cuda",
            "source": "semanticlens_tpu_torch/csrc/cosine.cu",
            "replaces": "semanticlens_tpu/ops/pallas_ops.py:72",
            "launches": launches[variant],
            "launches_k1_total": launches["total"],
            "max_abs_err": max_err[variant],
            **{key: row[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",  # ms: host loop of 20 calls
                "device_ms", "plain_device_ms", "library_device_ms",  # CUDA-graph replay, inputs warm in L2
                "device_ms_cold_l2", "library_device_ms_cold_l2", "share_of_bound_cold_l2", "bounds_ms")},
            "shape": shape,
        }

    kernels = {"kernels": [entry("tiled", "redundancy 2048x2048x512"),
                           entry("streaming", "probe 8x2048x512")]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
