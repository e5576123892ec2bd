"""Package-level contracts of the port, plus the kernel tests that need the card.

- No module of ``semanticlens_tpu_torch``, and none of the scripts that run
  it on the card, imports JAX, the JAX package, or the libraries the card
  machine lacks (checked on the source, by AST).
- Entry points default to the CUDA card and raise, never fall back, when
  there is none.
- Tests marked ``cuda`` run the hand-written kernel on an NVIDIA card and
  skip elsewhere (``python -m pytest tests/test_torch_package.py -m cuda``
  on the card machine).
"""

import ast
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from semanticlens_tpu_torch.ops.cosine import cosine_similarity_matrix, cosine_similarity_matrix_plain, launch_counts

torch.set_num_threads(2)

PKG = Path(__file__).resolve().parent.parent / "semanticlens_tpu_torch"
FIXTURES = Path(__file__).resolve().parent / "data" / "torch_jpeg"
FORBIDDEN = {"jax", "jaxlib", "flax", "semanticlens_tpu", "safetensors", "ml_dtypes", "PIL",
             "transformers", "sklearn", "matplotlib", "optax", "grain"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_no_jax_or_missing_libraries():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20 and PKG / "serve.py" in files
    for module in ("models/torch_adapter.py", "data/native_decoder.py", "data/image_folder.py",
                   "foundation_models/clip.py", "utils/helper.py", "collect/activation_based.py",
                   "collect/relevance_based.py", "relevance/attribution.py", "utils/render.py", "models/vit.py",
                   "foundation_models/siglip.py", "foundation_models/sentencepiece.py", "foundation_models/assets.py",
                   "foundation_models/reparam.py", "foundation_models/mobileclip.py", "foundation_models/dissect.py",
                   "sae.py", "collect/sae_based.py", "train_sae.py", "causal.py", "causal_audit.py", "featviz.py",
                   "collect/synthesis_based.py", "full_audit.py", "utils/profiling.py", "utils/log_setup.py",
                   "models/gpt.py", "models/llama.py", "models/gemma.py", "models/phi.py", "collect/text_based.py",
                   "relevance/text.py", "lm_audit.py", "models/zoo.py", "models/vgg.py", "models/densenet.py",
                   "models/convnext.py", "models/efficientnet.py", "models/mobilenet.py", "models/mnasnet.py",
                   "models/regnet.py", "core/mesh.py", "parallel/multihost.py", "parallel/tensor_parallel.py",
                   "parallel/launch.py", "ops/quant.py", "utils/flops.py", "data/grain_adapter.py",
                   "data/image_decode.py", "data/png.py", "data/bmp.py", "data/raw.py", "data/webp.py"):
        assert PKG / module in files
    files += [PKG.parent / script for script in ("chip_smoke.py", "profile_port.py", "profile_serve.py", "profile_decode.py",
                                                  "profile_lrp.py", "profile_fm.py", "profile_sae.py", "sweep_k1.py",
                                                  "precision_float32.py", "profile_zoo.py",
                                                  "precision_heatmaps.py", "probe_int_mm.py")]
    bad = [f"{f.relative_to(PKG.parent)}:{line} imports {root}"
           for f in files for root, line in _imported_roots(f) if root in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_webp_decoders_link_no_image_library():
    """WebP is decoded by the port's own C++: no csrc source includes a libwebp (or other image library)
    header, and the WebP sources link nothing."""
    from semanticlens_tpu_torch.utils import cuda_build

    sources = sorted(p for p in cuda_build.CSRC.iterdir() if p.suffix in (".cpp", ".cu", ".h", ".cuh"))
    assert {"webp_lossless.cpp", "webp_lossy.cpp"} <= {p.name for p in sources}
    includes = [(p.name, line) for p in sources for line in p.read_text().splitlines()
                if line.lstrip().startswith("#include")]
    assert not [x for x in includes if "webp/" in x[1] or "png.h" in x[1]]
    assert not [x for x in includes if x[0].startswith("webp_") and "<" not in x[1]]  # standard headers only
    flags = [flag for link in cuda_build.LINK_FLAGS.values() for flag in link]
    assert not [f for f in flags if "webp" in f] and "webp_lossless" not in cuda_build.LINK_FLAGS
    assert "webp_lossy" not in cuda_build.LINK_FLAGS


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_gpu(monkeypatch):
    from semanticlens_tpu_torch.data import ImageFolder
    from semanticlens_tpu_torch.foundation_models import ClipMobile, OpenClip, SigLipV2, create
    from semanticlens_tpu_torch.models import (
        GPT2,
        VGG,
        ConvNeXt,
        DenseNet,
        EfficientNet,
        EfficientNetV2,
        Llama,
        MNASNet,
        MobileNetV2,
        MobileNetV3,
        Phi3,
        RegNet,
        ResNet,
        TorchSubjectModel,
        VisionTransformer,
    )
    from semanticlens_tpu_torch.ops.topk import init_topk
    from semanticlens_tpu_torch.utils import resolve_device

    from semanticlens_tpu_torch import convert, sae

    cfg = sae.SAEConfig(d_in=4, n_latents=8, batch_rows=2)
    rows = np.zeros((4, 4), np.float32)
    _no_cuda(monkeypatch)
    for make in (lambda: sae.init_sae(torch.Generator(), cfg), lambda: sae.init_stats(cfg),
                 lambda: sae.train_sae_from_rows(rows, cfg, steps=1), lambda: convert.sae_params_from_jax({"k": 1}),
                 lambda: sae.load_gemma_scope_params({n: rows for n in ("W_enc", "b_enc", "W_dec", "b_dec",
                                                                         "threshold")}),
                 resolve_device, lambda: ResNet(depth=18), lambda: VisionTransformer(depth=1),
                 lambda: OpenClip("ViT-B-32"), lambda: OpenClip("RN50"), SigLipV2, lambda: ClipMobile("s2"),
                 lambda: create("siglip2"), lambda: create("mobileclip-s1"),
                 lambda: TorchSubjectModel(torch.nn.Linear(2, 2)), lambda: ImageFolder(FIXTURES),
                 lambda: init_topk(3, 2), lambda: resolve_device("cuda"), lambda: GPT2(depth=1),
                 lambda: Llama.from_name("llama-3.2-1b"), lambda: Phi3.from_name("phi-3-mini-4k"),
                 lambda: ResNet(depth=50, variant="d"), VGG, DenseNet, ConvNeXt, lambda: ConvNeXt.from_name("convnext_tiny"),
                 EfficientNet, EfficientNetV2, MobileNetV2, MobileNetV3, MNASNet, RegNet):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_scores_on_numpy_default_to_the_card(monkeypatch):
    from semanticlens_tpu_torch import scores

    _no_cuda(monkeypatch)
    x = np.ones((3, 4), np.float32)
    for score in (scores.redundancy_score, lambda v: scores.topk_cosine_search(v, v, 1),
                  lambda v: scores.match_components(v, v), lambda v: scores.fastcav(v, v)):
        with pytest.raises(RuntimeError, match="CUDA"):
            score(x)
    assert scores.redundancy_score(torch.from_numpy(x)).device.type == "cpu"  # a tensor keeps its device


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m, n, d", [(8, 2048, 512), (300, 513, 130), (1, 1, 1), (65, 64, 17),
                                     (32, 2048, 512), (33, 1024, 512), (32, 2049, 512),
                                     (70, 90, 33), (8, 700, 33), (12, 513, 130), (200, 300, 513),
                                     (8, 1000, 513), (2048, 2048, 512)])
def test_cuda_kernel_matches_plain_version(cuda_device, m, n, d):
    """atol 3e-5: the streaming kernel's fp32 FMA and the tiled kernel's 3×TF32 against
    the fp32 (non-TF32) matmul of the plain version, at and past the streaming/tiled
    threshold and at D that is not a multiple of 4."""
    g = torch.Generator(device=cuda_device).manual_seed(m * n + d)
    x = torch.randn(m, d, generator=g, device=cuda_device)
    y = torch.randn(n, d, generator=g, device=cuda_device)
    before = launch_counts()["total"]
    out = cosine_similarity_matrix(x, y)
    torch.cuda.synchronize()
    assert launch_counts()["total"] == before + 1
    torch.testing.assert_close(out, cosine_similarity_matrix_plain(x, y), atol=3e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_zero_rows_and_batch(cuda_device):
    z = cosine_similarity_matrix(torch.zeros(2, 32, device=cuda_device), torch.ones(3, 32, device=cuda_device))
    assert torch.equal(z, torch.zeros_like(z))
    x = torch.randn(3, 70, 33, device=cuda_device)
    y = torch.randn(3, 90, 33, device=cuda_device)
    torch.testing.assert_close(cosine_similarity_matrix(x, y), cosine_similarity_matrix_plain(x, y),
                               atol=3e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_ragged_batch_and_near_duplicates(cuda_device):
    from semanticlens_tpu_torch.ops import cosine as k1

    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(2, 130, 64, generator=g, device=cuda_device)
    y = torch.randn(2, 130, 64, generator=g, device=cuda_device)
    torch.testing.assert_close(cosine_similarity_matrix(x, y), cosine_similarity_matrix_plain(x, y),
                               atol=3e-5, rtol=0)
    for d in (512, 4096):  # near-parallel rows: the tiled kernel's accumulation must not drift with D
        base = torch.randn(512, d, generator=g, device=cuda_device)
        bank = torch.cat([base, base + 1e-3 * torch.randn(512, d, generator=g, device=cuda_device)])
        for probe in (bank[:8], bank):  # streaming, tiled
            torch.testing.assert_close(cosine_similarity_matrix(probe, bank),
                                       cosine_similarity_matrix_plain(probe, bank), atol=3e-5, rtol=0)
    k1.reset_launch_counts()
    cosine_similarity_matrix(bank[:8], bank)
    cosine_similarity_matrix(bank, bank)
    torch.cuda.synchronize()
    assert k1.launch_counts() == {"streaming": 1, "tiled": 1, "total": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("q, n, d, k", [(40, 300, 64, 7), (129, 777, 24, 32), (2048, 1000, 512, 5),
                                        (200, 3000, 513, 32), (33, 70_001, 512, 1)])
def test_cuda_k1b_equals_the_chunked_search_bitwise(cuda_device, q, n, d, k):
    """K1b (the top-k in K1's epilogue) against the chunked path on the same K1 arithmetic: values bitwise,
    indices equal, with duplicated and dead rows and queries tying; one tiled launch; D past the flush."""
    from semanticlens_tpu_torch import scores
    from semanticlens_tpu_torch.ops import cosine as k1

    g = torch.Generator(device=cuda_device).manual_seed(q + n + d + k)
    bank = torch.randn(n, d, generator=g, device=cuda_device)
    queries = torch.randn(q, d, generator=g, device=cuda_device)
    bank[4::3] = bank[1]
    bank[2::3] = 0.0
    queries[0], queries[1] = bank[1], 0.0
    assert k1.takes_k1b(cuda_device, q, n, d, k)
    k1.reset_launch_counts()
    vals, idx = scores.topk_cosine_search(queries, bank, k)
    torch.cuda.synchronize()
    assert k1.launch_counts() == {"streaming": 0, "tiled": 1, "total": 1}
    ref_vals, ref_idx = scores._chunked_topk(queries, bank, k, 1024)
    assert torch.equal(vals, ref_vals) and torch.equal(idx, ref_idx)
    assert idx[1].tolist() == list(range(k))  # a dead query ties everywhere: the first k columns


@pytest.mark.cuda
def test_cuda_nvjpeg_fixtures_within_bounds(cuda_device):
    """nvJPEG's planes through planes_to_rgb and the float32 resize, against the JAX package's PIL
    arrays of the committed fixtures: mean |Δ| ≤ 1.5 levels and PSNR ≥ 40 dB (chip_smoke's bounds)."""
    from semanticlens_tpu_torch.data import ImageFolder

    ref = np.load(FIXTURES / "pil_224.npz")
    ds = ImageFolder(FIXTURES, image_size=224)
    batch = ds.get_batch(0, len(ds))
    torch.cuda.synchronize()
    for i, (path, _) in enumerate(ds.samples):
        diff = batch[i].cpu().numpy().astype(np.float64) - ref[path.name]
        psnr = 10 * np.log10(255.0**2 / max((diff**2).mean(), 1e-12))
        assert np.abs(diff).mean() <= 1.5 and psnr >= 40, (path.name, np.abs(diff).mean(), psnr)
        np.testing.assert_array_equal(batch[i].cpu().numpy(), ds[i][0])


@pytest.mark.cuda
def test_cuda_format_fixtures_decode(cuda_device):
    """Every committed PNG, BMP and CMYK / YCCK / RGB-coded JPEG fixture decoded on the card at full
    resolution against PIL's array: PNG and BMP exactly, JPEG within chip_smoke's DECODE_BOUNDS (nvJPEG's
    IDCT is not libjpeg's); the PNG under a .JPEG name decodes as a PNG."""
    from semanticlens_tpu_torch.data import image_decode
    from semanticlens_tpu_torch.data.native_decoder import NvJpegDecoder

    folder = FIXTURES.parent / "torch_formats"
    ref = np.load(folder / "pil_full.npz")
    decoder = NvJpegDecoder(cuda_device)
    for name in ref.files:
        data = (folder / name).read_bytes()
        got = image_decode.decode(data, name, cuda_device, nvjpeg=decoder)
        assert got.device.type == "cuda", name
        got = got.cpu().numpy()
        if image_decode.sniff(data) == "jpeg":
            diff = got.astype(np.float64) - ref[name]
            psnr = 10 * np.log10(255.0**2 / max((diff**2).mean(), 1e-12))
            assert np.abs(diff).mean() <= 1.5 and psnr >= 40, (name, np.abs(diff).mean(), psnr)
        else:
            np.testing.assert_array_equal(got, ref[name], err_msg=name)


@pytest.mark.cuda
def test_cuda_webp_fixtures_decode(cuda_device):
    """Every committed WebP fixture decoded on the card at full resolution: the SHA-256 of PIL's array,
    exactly (the bitstreams are decoded on the host, the colour conversion runs on the card)."""
    import hashlib
    import json

    from semanticlens_tpu_torch.data import image_decode

    folder = FIXTURES.parent / "torch_formats"
    refs = json.loads((folder / "pil_webp_sha256.json").read_text())
    assert len(refs) >= 19
    for name, ref in refs.items():
        got = image_decode.decode((folder / name).read_bytes(), name, cuda_device)
        assert got.device.type == "cuda", name
        got = np.ascontiguousarray(got.cpu().numpy())
        assert list(got.shape) == ref["shape"] and hashlib.sha256(got.tobytes()).hexdigest() == ref["sha256"], name


@pytest.mark.cuda
def test_cuda_nvjpeg_refuses_truncated_file_with_thumbnail(cuda_device):
    """A truncated file whose EXIF thumbnail holds an EOI marker: nvJPEG would decode it, the check before
    it refuses it as libjpeg and PIL do; the whole file decodes."""
    from semanticlens_tpu_torch.data.native_decoder import JpegError, NvJpegDecoder

    main, thumb = ((FIXTURES / name).read_bytes() for name in ("a_420_500x375.jpg", "e_small_160x120.jpg"))
    tiff = (b"II*\x00" + struct.pack("<IHI", 8, 0, 14)  # IFD0: no entries; IFD1 at 14 locates the thumbnail at 44
            + struct.pack("<HHHIIHHIII", 2, 0x0201, 4, 1, 44, 0x0202, 4, 1, len(thumb), 0) + thumb)
    payload = b"Exif\x00\x00" + tiff
    whole = main[:2] + b"\xff\xe1" + struct.pack(">H", 2 + len(payload)) + payload + main[2:]
    scan = whole.rfind(b"\xff\xda")
    decoder = NvJpegDecoder(cuda_device)
    assert decoder.decode(whole).shape == (375, 500, 3)
    with pytest.raises(JpegError, match="cut.jpg: truncated"):
        decoder.decode(whole[: scan + (len(whole) - scan) // 2], "cut.jpg")


@pytest.mark.cuda
@pytest.mark.parametrize("composite, atol", [("epsilon_plus_flat", 1e-3), ("epsilon", 5e-2), ("gradient", 5e-2)])
def test_cuda_attribution_matches_cpu(cuda_device, composite, atol):
    """float32 ResNet-18 heatmaps at 64×64 on the card (TF32 off) against the port on the CPU, within
    chip_smoke's bounds per composite; the crop boxes derived from them are equal."""
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.relevance import make_attribution_fn
    from semanticlens_tpu_torch.utils import render

    torch.backends.cudnn.allow_tf32 = False
    x = np.random.default_rng(0).random((4, 64, 64, 3)).astype(np.float32)
    heats = []
    for device in (cuda_device, torch.device("cpu")):
        model = ResNet(depth=18, num_classes=10, dtype=torch.float32, device=device)
        heat = make_attribution_fn(model, "layer3", composite=composite)(model.init(seed=0), x, 7)
        heats.append(heat.cpu())
    np.testing.assert_allclose(heats[0].numpy(), heats[1].numpy(), atol=atol)
    boxes = [render._square_crop_boxes(render._filtered_heat(h, 51), 0.01) for h in heats]
    assert boxes[0] == boxes[1]


@pytest.mark.cuda
def test_cuda_batched_attribution_equals_single(cuda_device):
    """float32 ResNet-50 on the card (TF32 off): K components over their own images in one backward
    equal K single calls, rtol 1e-4, atol 1e-5 (the JAX package's bound)."""
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.relevance import make_attribution_fn, make_batched_attribution_fn

    torch.backends.cudnn.allow_tf32 = False
    model = ResNet(depth=50, dtype=torch.float32, device=cuda_device)
    params = model.init(seed=0)
    imgs = np.random.default_rng(1).integers(0, 255, (3, 2, 96, 96, 3), dtype=np.uint8)
    got = make_batched_attribution_fn(model, "layer3")(params, imgs, [4, 9, 4])
    single = make_attribution_fn(model, "layer3")
    for k, comp in enumerate((4, 9, 4)):
        np.testing.assert_allclose(got[k].cpu().numpy(), single(params, imgs[k], comp).cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_sae_steps_match_cpu(cuda_device):
    """Five float32 TopK + AuxK steps on the card (TF32 off) against the CPU from the same initial
    parameters and rows: parameters and metrics within 1e-5 of their scale (the bound of
    ``chip_smoke.py``'s float32 SAE gate), ``last_fired`` and ``step`` equal."""
    from semanticlens_tpu_torch import sae

    cfg = sae.SAEConfig(d_in=64, n_latents=512, k=8, aux_k=64, dead_steps=2, batch_rows=256)
    rows = np.random.default_rng(0).normal(size=(1024, 64)).astype(np.float32)
    init = {n: v.numpy() for n, v in sae.init_sae(torch.Generator().manual_seed(0), cfg, device="cpu").items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {d: sae.train_sae_from_rows(rows, cfg, steps=5, params=init, device=d) for d in (cuda_device, "cpu")}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (gp, gs, gm), (cp, cs, cm) = out[cuda_device], out["cpu"]
    for n in cp:
        if n != "k":
            scale = float(cp[n].abs().max())
            assert float((gp[n].cpu() - cp[n]).abs().max()) <= 1e-5 * scale, n
    for n in cm:
        assert abs(gm[n] - cm[n]) <= 1e-5 * max(abs(cm[n]), 1e-12), n
    assert gm["l0"] == cm["l0"] == 8.0
    assert torch.equal(gs["last_fired"].cpu(), cs["last_fired"]) and torch.equal(gs["step"].cpu(), cs["step"])
