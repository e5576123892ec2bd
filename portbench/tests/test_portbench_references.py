"""Each plain reference against the port, on the same weights and inputs, at small sizes on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import clip, preprocess, resnet, siglip, topk, vit, weights

CPU = torch.device("cpu")
IMAGENET = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))


def _images(n, h, w, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("shape, size", [((256, 256), 224), ((224, 224), 224), ((72, 96), 64), ((50, 40), 64)])
def test_preprocess_matches_port(shape, size):
    from semanticlens_tpu_torch.ops.preprocess import preprocess_images

    imgs = _images(3, *shape)
    got = preprocess_images(imgs, size=size, crop=size, **IMAGENET).permute(0, 3, 1, 2)
    want = preprocess.preprocess(imgs, size=size, crop=size, **IMAGENET)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)  # 0.01 of a grey level after normalization


def test_resize_matrix_rows_sum_to_one():
    m = preprocess.resize_matrix(256, 224)
    torch.testing.assert_close(m.sum(1), torch.ones(224, dtype=torch.float64))


def test_resnet50_taps_match_port():
    from semanticlens_tpu_torch.models import ResNet

    cfg = {"depth": 50, "num_classes": 1000}
    sd = resnet.served(cfg, dict(size=64, crop=64, **IMAGENET), 3, CPU, torch.float32)
    model = ResNet(depth=50, dtype=torch.float32, device="cpu")
    x = preprocess.preprocess(_images(4, 64, 64), size=64, crop=64, **IMAGENET)
    with torch.no_grad():
        _, taps = model.apply(model.load_torch_state_dict(sd), x.permute(0, 2, 3, 1), ("layer3", "layer4"))
        want = resnet.forward(sd, x, ("layer3", "layer4"), cfg)
    for name in ("layer3", "layer4"):
        got = taps[name].permute(0, 3, 1, 2)
        torch.testing.assert_close(got, want[name], atol=1e-4 * float(want[name].abs().max()), rtol=0)


def test_resnet_calibration_normalizes_each_bn():
    cfg = {"depth": 50, "num_classes": 10}
    pre = dict(size=32, crop=32, **IMAGENET)
    sd = resnet.served(cfg, pre, 5, CPU, torch.float32)
    drawn = weights.draw(resnet.param_specs(cfg), 5, weights.STREAMS["subject"], CPU)
    assert not torch.equal(sd["layer4.2.bn3.running_var"], drawn["layer4.2.bn3.running_var"])
    torch.testing.assert_close(sd["layer4.2.conv3.weight"], drawn["layer4.2.conv3.weight"])


def _tiny_clip():
    return {"name": "ViT-B-32", "quick_gelu": True, "embed_dim": 32,
            "vision": {"image_size": 64, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
            "text": {"context_length": 16, "vocab_size": 1000, "width": 32, "heads": 2, "layers": 1}}


def test_clip_image_tower_matches_port():
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.foundation_models.clip import CLIPConfig, TextCfg, VisionCfg

    f = _tiny_clip()
    sd = weights.draw(clip.param_specs(f), 1, weights.STREAMS["fm"], CPU)
    cfg = CLIPConfig(embed_dim=32, vision=VisionCfg(**f["vision"]), text=TextCfg(**f["text"]), quick_gelu=True)
    fm = OpenClip("ViT-B-32", params=sd, cfg=cfg, dtype=torch.float32, device="cpu")
    imgs = _images(3, 72, 80)
    pre = dict(size=64, crop=64, mean=(0.48145466, 0.4578275, 0.40821073), std=(0.26862954, 0.26130258, 0.27577711))
    with torch.no_grad():
        got = fm.encode_image(fm.preprocess(imgs))
        want = clip.encode_image(sd, preprocess.preprocess(imgs, **pre), f)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_vit_taps_match_port():
    from semanticlens_tpu_torch.models import VisionTransformer

    s = {"image_size": 64, "patch_size": 16, "width": 64, "depth": 2, "heads": 2, "num_classes": 10}
    sd = weights.draw(vit.param_specs(s), 2, weights.STREAMS["subject"], CPU)
    model = VisionTransformer(image_size=64, patch_size=16, width=64, depth=2, heads=2, num_classes=10,
                              dtype=torch.float32, device="cpu")
    x = preprocess.preprocess(_images(3, 64, 64), size=64, crop=64, **IMAGENET)
    names = ("blocks.1.mlp.fc1", "blocks.1.attn.heads", "blocks.0.attn.heads")
    with torch.no_grad():
        _, taps = model.apply(model.load_torch_state_dict(sd), x.permute(0, 2, 3, 1), names)
        want = vit.forward(sd, x, names, s)
    for name in names:
        torch.testing.assert_close(taps[name], want[name], atol=1e-4, rtol=1e-4)


def test_siglip_image_tower_matches_port():
    from semanticlens_tpu_torch.foundation_models import create
    from semanticlens_tpu_torch.foundation_models.siglip import SigLIPConfig

    f = {"embed_dim": 64, "vision": {"image_size": 64, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
         "text": {"context_length": 16, "vocab_size": 1000, "width": 64, "heads": 2, "layers": 1}}
    sd = weights.draw(siglip.param_specs(f), 4, weights.STREAMS["fm"], CPU)
    cfg = SigLIPConfig(embed_dim=64, image_size=64, patch_size=16, vision_width=64, vision_layers=2, vision_heads=2,
                       text_width=64, text_layers=1, text_heads=2, vocab_size=1000, context_length=16)
    fm = create("siglip2", params=sd, cfg=cfg, dtype=torch.float32, device="cpu")
    imgs = _images(3, 64, 64)
    with torch.no_grad():
        got = fm.encode_image(fm.preprocess(imgs))
        want = siglip.encode_image(sd, preprocess.preprocess(imgs, size=64, crop=64, mean=(0.5,) * 3, std=(0.5,) * 3), f)
    # the port's LayerNorms use eps 1e-5 where timm's SigLIP uses 1e-6: below float32 noise at these scales
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_collect_topk_values_match_port():
    from semanticlens_tpu_torch.ops.topk import init_topk, topk_update

    acts = torch.randn(8, 300, generator=torch.Generator().manual_seed(0))  # (C, N), a quarter negative
    acts[0] = -1.0  # a component no image enters
    state = init_topk(8, 5, "cpu")
    for s in range(0, 300, 64):
        state = topk_update(state, acts[:, s : s + 64].t(), torch.arange(s, min(s + 64, 300), dtype=torch.int32))
    want = topk.ranked_values(acts.to(torch.bfloat16).float(), 5)
    torch.testing.assert_close(state.values.float(), want, atol=0, rtol=0)
    assert (state.ids[0] == -1).all()


def test_search_matches_port():
    from semanticlens_tpu_torch import scores

    gen = torch.Generator().manual_seed(1)
    bank, q = torch.randn(3000, 32, generator=gen), torch.randn(20, 32, generator=gen)
    got_v, got_i = scores.topk_cosine_search(q, bank, 7, chunk_size=1024, device="cpu")
    want_v, want_i, at_picked = topk.search(q, bank, 7, query_block=8, picked=got_i)
    torch.testing.assert_close(got_v, want_v, atol=1e-6, rtol=0)
    assert torch.equal(got_i.long(), want_i)
    torch.testing.assert_close(at_picked, want_v, atol=0, rtol=0)


def test_int8_rounding_is_coarser_than_float32():
    x = torch.randn(4, 256, generator=torch.Generator().manual_seed(2))
    from portbench.reference.ops import int8_round

    err = (int8_round(x, -1) - x).abs().max()
    assert 0 < err <= x.abs().max() / 127 / 2 + 1e-7
