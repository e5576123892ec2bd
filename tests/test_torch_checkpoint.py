"""Checkpoint and resume of the port's three sweeps, and the data helpers they use.

- Within the port (CPU): an interrupted collect, fused or embed sweep resumes
  to a result identical to an uninterrupted one (bit for bit); a gap in the
  embedding chunks raises; a stale uncommitted chunk is dropped; the
  checkpoint directory is cleared after success.
- Across packages: a checkpoint the JAX engine wrote resumes in the port and
  the reverse. The files are the same key for key; the sample ids are equal
  and the top-k values within one bf16 rounding step (the two packages'
  float32 aggregates may differ in the last bits, ROADMAP queue 3).
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from semanticlens_tpu.collect.engine import CollectEngine as JEngine
from semanticlens_tpu.data import ArrayDataset as JDataset
from semanticlens_tpu.data import iter_batches as j_iter_batches
from semanticlens_tpu.data.dataset import Subset as JSubset
from semanticlens_tpu.models.base import SubjectModel as JSubject
from semanticlens_tpu.models.base import TapCollector as JTap
from semanticlens_tpu.models.layers import conv2d as jconv2d
from semanticlens_tpu.ops.aggregators import aggregate_conv_mean as j_mean
from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
from semanticlens_tpu_torch.collect import engine as tengine
from semanticlens_tpu_torch.collect.engine import CollectEngine as TEngine
from semanticlens_tpu_torch.data import ArrayDataset, Subset, iter_batches, prefetch_batches
from semanticlens_tpu_torch.models.base import SubjectModel, TapCollector
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean as t_mean
from semanticlens_tpu_torch.utils import safetensors_io

torch.set_num_threads(2)

W = np.random.default_rng(0).normal(size=(1, 1, 3, 6)).astype(np.float32)  # HWIO
IMAGES = np.random.default_rng(1).normal(size=(40, 8, 8, 3)).astype(np.float32)
PROJ = np.random.default_rng(5).normal(size=(3, 7)).astype(np.float32)


class OneConv(SubjectModel):
    """A 1×1 conv with 6 output channels, tapped as ``c`` (NHWC)."""

    module_names = ("c",)
    device = torch.device("cpu")

    def apply(self, params, x, tap_names=()):
        tap = TapCollector(tap_names)
        return tap("c", F.conv2d(x.permute(0, 3, 1, 2), params["w"]).permute(0, 2, 3, 1)), tap.taps


class JOneConv(JSubject):
    module_names = ("c",)

    def apply(self, params, x, tap_names=()):
        tap = JTap(tap_names)
        return tap("c", jconv2d(x, params["w"])), tap.taps


T_PARAMS = {"w": torch.from_numpy(W.transpose(3, 2, 0, 1).copy())}
J_PARAMS = {"w": jnp.asarray(W)}


def _engine():
    return TEngine(model=OneConv(), layer_names=("c",), aggregation_fn=t_mean, n_collect=5)


def _jengine():
    return JEngine(model=JOneConv(), layer_names=("c",), aggregation_fn=j_mean, n_collect=5)


def _embed(batch):
    return batch.float().mean(dim=(1, 2)) @ torch.from_numpy(PROJ)


def _jembed(batch):
    return jnp.mean(batch.astype(jnp.float32), axis=(1, 2)) @ jnp.asarray(PROJ)


class Preempted(RuntimeError):
    pass


class PreemptedDataset:
    """A dataset whose batch assembly raises at sample ``crash_at`` (a preempted sweep)."""

    def __init__(self, images, crash_at):
        self.array, self.crash_at = images, crash_at

    def __len__(self):
        return len(self.array)

    def __getitem__(self, i):
        return self.array[i], 0

    def get_batch(self, start, stop):
        if start <= self.crash_at < stop:
            raise Preempted(f"sample {self.crash_at}")
        return self.array[start:stop]


def _assert_states_equal(a, b):
    for layer in a:
        assert torch.equal(a[layer].ids, b[layer].ids)
        assert torch.equal(a[layer].values, b[layer].values)


# --------------------------------------------------------------------------- #
# Within the port
# --------------------------------------------------------------------------- #
def test_engine_crash_resume_is_bit_identical(tmp_path):
    ref, n = _engine().run(T_PARAMS, ArrayDataset(IMAGES), 8)
    with pytest.raises(Preempted):
        _engine().run(T_PARAMS, PreemptedDataset(IMAGES, 28), 8, checkpoint_dir=tmp_path, checkpoint_every=2)
    progress = json.loads((tmp_path / "progress.json").read_text())
    assert progress == {"next_start": 16, "layers": ["c"]}
    resumed, n2 = _engine().run(T_PARAMS, ArrayDataset(IMAGES), 8, checkpoint_dir=tmp_path, checkpoint_every=2)
    assert n2 == n
    _assert_states_equal(resumed, ref)


def test_fused_crash_resume_is_bit_identical_and_writes_the_jax_layout(tmp_path):
    ref_states, ref_embeds, n = _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES), 8, _embed)
    ckpt = tmp_path / "fused"
    with pytest.raises(Preempted):
        _engine().run_fused(T_PARAMS, PreemptedDataset(IMAGES, 27), 8, _embed, checkpoint_dir=ckpt,
                            checkpoint_every=1)
    assert json.loads((ckpt / "progress.json").read_text())["next_start"] == 24
    assert [p.name for p in sorted(ckpt.glob("embeds-*"))] == [f"embeds-{r:012d}.safetensors" for r in (0, 8, 16)]
    header = safetensors_io.load_file(ckpt / "state-c.safetensors")
    assert header["values"].dtype == torch.bfloat16 and header["ids"].dtype == torch.int32
    assert safetensors_io.load_file(ckpt / "embeds-000000000008.safetensors")["embeds"].shape == (8, 7)

    states, embeds, n2 = _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES), 8, _embed, checkpoint_dir=ckpt,
                                             checkpoint_every=1)
    assert n2 == n
    np.testing.assert_array_equal(embeds, ref_embeds)
    _assert_states_equal(states, ref_states)
    TEngine.clear_checkpoint(ckpt)
    assert not ckpt.exists()


def test_embed_flush_interleaves_with_checkpoints(tmp_path, monkeypatch):
    """A drain budget below one batch drains after every batch, between commits every
    3 batches: no row is duplicated or lost."""
    _, plain, _ = _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES), 8, _embed)
    monkeypatch.setattr(tengine, "EMBED_FLUSH_BYTES", 100)
    _, drained, _ = _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES), 8, _embed,
                                        checkpoint_dir=tmp_path, checkpoint_every=3)
    np.testing.assert_array_equal(drained, plain)
    assert [p.name for p in sorted(tmp_path.glob("embeds-*"))] == ["embeds-000000000000.safetensors"]
    assert json.loads((tmp_path / "progress.json").read_text())["next_start"] == 24


def test_gap_raises_stale_chunk_is_dropped(tmp_path):
    _, ref_embeds, _ = _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES), 8, _embed)
    ckpt = tmp_path / "fused"
    _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES[:16]), 8, _embed, checkpoint_dir=ckpt, checkpoint_every=1)
    stale = safetensors_io.load_file(ckpt / "embeds-000000000000.safetensors")["embeds"]
    safetensors_io.save_file({"embeds": torch.full_like(stale, 777.0)}, ckpt / "embeds-000000000016.safetensors")
    _, embeds, _ = _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES), 8, _embed, checkpoint_dir=ckpt,
                                       checkpoint_every=1)
    assert embeds.shape == ref_embeds.shape, "the stale chunk duplicated rows"
    np.testing.assert_array_equal(embeds, ref_embeds)

    (ckpt / "embeds-000000000008.safetensors").unlink()
    with pytest.raises(RuntimeError, match="gap"):
        _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES), 8, _embed, checkpoint_dir=ckpt, checkpoint_every=1)
    (ckpt / "notes.txt").write_text("not a checkpoint file")
    TEngine.clear_checkpoint(ckpt)
    assert [p.name for p in ckpt.iterdir()] == ["notes.txt"]


class FakeVLM:
    """A deterministic stand-in foundation model: mean pixel projected to 7 dims."""

    name = "fake-vlm"
    device = torch.device("cpu")

    def __init__(self, crash_after=None):
        self.calls, self.crash_after = 0, crash_after

    def preprocess(self, img):
        return torch.as_tensor(img).float()

    def encode_image(self, img):
        self.calls += 1
        if self.crash_after is not None and self.calls > self.crash_after:
            raise Preempted("encode")
        return _embed(img)


def _visualizer(cache_dir, dataset_fm=None, dataset=None):
    model = OneConv()
    model.name = "one-conv"
    dataset = dataset or ArrayDataset(IMAGES, name="imgs")
    return ActivationComponentVisualizer(model, dataset, dataset_fm or dataset, ["c"], 5, aggregate_fn=t_mean,
                                         cache_dir=str(cache_dir), params=T_PARAMS)


def test_visualizer_fused_sweep_resumes_and_clears(tmp_path):
    ref = _visualizer(tmp_path / "ref")._compute_concept_db(FakeVLM(), batch_size=8, checkpoint=16)
    cv = _visualizer(tmp_path / "run")
    with pytest.raises(Preempted):
        cv._compute_concept_db(FakeVLM(crash_after=3), batch_size=8, checkpoint=16)
    ckpt = cv.storage_dir / "_checkpoint-fused"
    assert json.loads((ckpt / "progress.json").read_text())["next_start"] == 16
    db = _visualizer(tmp_path / "run")._compute_concept_db(FakeVLM(), batch_size=8, checkpoint=16)
    np.testing.assert_array_equal(db["c"], ref["c"])
    assert not ckpt.exists(), "the checkpoint must clear after success"
    assert (cv.storage_dir / cv.actmax_cache._layer_fname("c")).exists()


def test_visualizer_two_sweep_embed_resumes_and_collect_clears(tmp_path):
    """Separate datasets: the collect sweep, then the FM embed sweep, crashed and resumed."""
    fm_dataset = ArrayDataset(IMAGES.copy(), name="fm-copy")
    ref = _visualizer(tmp_path / "ref", fm_dataset)._compute_concept_db(FakeVLM(), batch_size=10, checkpoint=10)
    cv = _visualizer(tmp_path / "run", fm_dataset)
    with pytest.raises(Preempted):
        cv._compute_concept_db(FakeVLM(crash_after=2), batch_size=10, checkpoint=10)
    ckpt = cv.storage_dir / "_checkpoint-embed"
    assert json.loads((ckpt / "progress.json").read_text()) == {"next_start": 20}
    assert not (cv.storage_dir / "_checkpoint-collect").exists()
    again = cv._compute_concept_db(FakeVLM(), batch_size=10, checkpoint=10)
    np.testing.assert_array_equal(again["c"], ref["c"])
    assert not ckpt.exists()


def test_visualizer_collect_sweep_resumes(tmp_path):
    ref = _visualizer(tmp_path / "ref").run(batch_size=8, checkpoint=8)
    crashing = PreemptedDataset(IMAGES, 20)
    crashing.name = "imgs"
    cv = _visualizer(tmp_path / "run", dataset=crashing)
    with pytest.raises(Preempted):
        cv.run(batch_size=8, checkpoint=8)
    ckpt = cv.storage_dir / "_checkpoint-collect"
    assert json.loads((ckpt / "progress.json").read_text())["next_start"] == 16
    out = _visualizer(tmp_path / "run").run(batch_size=8, checkpoint=8)
    np.testing.assert_array_equal(out["c"].sample_ids, ref["c"].sample_ids)
    assert torch.equal(out["c"].activations, ref["c"].activations)
    assert not ckpt.exists()


def test_embed_sweep_table_equals_per_batch_readback(tmp_path, monkeypatch):
    """The FM embed sweep keeps rows on the device and drains by EMBED_FLUSH_BYTES; its
    table is identical to copying every batch to the host as it comes (the old path)."""
    fm, fm_dataset = FakeVLM(), ArrayDataset(IMAGES[:37], name="fm")
    old = torch.cat([fm.encode_image(fm.preprocess(b.images)) for b in iter_batches(fm_dataset, 8)]).numpy()[:37]
    cv = _visualizer(tmp_path, fm_dataset, ArrayDataset(IMAGES[:37], name="imgs"))
    np.testing.assert_array_equal(cv._embed_vision_dataset(fm, 8, checkpoint=0), old)
    monkeypatch.setattr(tengine, "EMBED_FLUSH_BYTES", 300)  # a drain every second batch
    np.testing.assert_array_equal(cv._embed_vision_dataset(fm, 8, checkpoint=0), old)
    np.testing.assert_array_equal(cv._embed_vision_dataset(fm, 8, checkpoint=16), old)


# --------------------------------------------------------------------------- #
# Across packages
# --------------------------------------------------------------------------- #
def _host(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _assert_close_states(a, b):
    """Equal ids; values within one bf16 rounding step (2^-7 relative)."""
    for layer in b:
        np.testing.assert_array_equal(_host(a[layer].ids), _host(b[layer].ids))
        np.testing.assert_allclose(_host(a[layer].values), _host(b[layer].values), rtol=2**-7)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    ref, ref_embeds, _ = _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES), 8, _embed)
    _jengine().run_fused(J_PARAMS, JDataset(IMAGES[:16]), 8, _jembed, checkpoint_dir=tmp_path, checkpoint_every=1)
    states, embeds, _ = _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES), 8, _embed, checkpoint_dir=tmp_path,
                                            checkpoint_every=1)
    _assert_close_states(states, ref)
    np.testing.assert_allclose(embeds, ref_embeds, atol=1e-6)
    np.testing.assert_array_equal(embeds[16:], ref_embeds[16:])  # rows the port computed itself


def test_port_checkpoint_resumes_in_jax(tmp_path):
    j_ref, j_embeds, _ = _jengine().run_fused(J_PARAMS, JDataset(IMAGES), 8, _jembed)
    _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES[:24]), 8, _embed, checkpoint_dir=tmp_path, checkpoint_every=1)
    j_states, embeds, _ = _jengine().run_fused(J_PARAMS, JDataset(IMAGES), 8, _jembed, checkpoint_dir=tmp_path,
                                               checkpoint_every=1)
    t_ref, _, _ = _engine().run_fused(T_PARAMS, ArrayDataset(IMAGES), 8, _embed)
    _assert_close_states(t_ref, j_states)
    np.testing.assert_allclose(embeds, j_embeds, atol=1e-6)
    # collect-only engines read each other's states too
    ckpt = tmp_path / "collect"
    _engine().run(T_PARAMS, ArrayDataset(IMAGES[:16]), 8, checkpoint_dir=ckpt, checkpoint_every=1)
    loaded = _jengine().load_checkpoint(ckpt)
    assert loaded[1] == 16
    np.testing.assert_array_equal(np.asarray(loaded[0]["c"].ids), _engine().load_checkpoint(ckpt)[0]["c"].ids.numpy())


# --------------------------------------------------------------------------- #
# Subset, prefetch_batches, iter_batches hooks
# --------------------------------------------------------------------------- #
def test_subset_matches_jax():
    base = ArrayDataset(IMAGES, np.arange(40), name="imgs")
    sub, jsub = Subset(base, 8, 21), JSubset(JDataset(IMAGES, np.arange(40), name="imgs"), 8, 21)
    assert len(sub) == len(jsub) == 13 and sub.name == jsub.name == "imgs[8:21]"
    np.testing.assert_array_equal(sub.images, jsub.images)
    assert sub[3][1] == jsub[3][1] == 11
    with pytest.raises(IndexError):
        sub[13]
    with pytest.raises(ValueError, match="invalid subset"):
        Subset(base, 30, 50)
    for tb, jb in zip(iter_batches(sub, 4), j_iter_batches(jsub, 4)):
        np.testing.assert_array_equal(tb.images, jb.images)
        np.testing.assert_array_equal(tb.valid, jb.valid)
    slow = Subset(PreemptedDataset(IMAGES, 99), 4, 12)  # get_batch, shifted by the start
    np.testing.assert_array_equal(next(iter_batches(slow, 8)).images, IMAGES[4:12])


def test_prefetch_batches_keeps_order_and_raises_producer_errors():
    assert list(prefetch_batches(iter(range(20)), depth=3)) == list(range(20))

    def boom():
        yield 1
        raise RuntimeError("decode failed")

    it = prefetch_batches(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_iter_batches_uses_a_datasets_own_stream():
    class Streams:
        def __len__(self):
            return 10

        def iter_batches(self, batch_size, pad_last=True, start_index=0):
            yield ("own", batch_size, pad_last, start_index)

    assert list(iter_batches(Streams(), 4, start_index=8)) == [("own", 4, True, 8)]
    assert [b.start_index for b in iter_batches(ArrayDataset(IMAGES[:10]), 4, start_index=4)] == [4, 8]
