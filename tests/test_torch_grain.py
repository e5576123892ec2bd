"""Port parity: ``data/grain_adapter.py`` — ``GrainDataset`` over a list and a ``grain.MapDataset``.

Each package's ``data.iter_batches`` over the same wrapped source must give
the same batches (images, start indices, valid masks), the last one padded;
``grain_shard_range`` equals the JAX function at every process.
"""

import grain
import numpy as np
import pytest
import torch

from semanticlens_tpu.data import GrainDataset as JGrainDataset
from semanticlens_tpu.data import iter_batches as jiter_batches
from semanticlens_tpu.data.grain_adapter import grain_shard_range as jgrain_shard_range
from semanticlens_tpu_torch.data import GrainDataset, iter_batches
from semanticlens_tpu_torch.data.grain_adapter import grain_shard_range

torch.set_num_threads(2)

IMAGES = np.random.default_rng(0).integers(0, 256, size=(11, 8, 8, 3), dtype=np.uint8)


def _records():
    return [{"image": IMAGES[i], "label": i % 3} for i in range(len(IMAGES))]


def _to_image(record):
    return record["image"], record["label"]


SOURCES = {"list": lambda: _records(), "map_dataset": lambda: grain.MapDataset.source(_records())}


@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("start_index", [0, 4])
def test_iter_batches_equal_the_jax_package(source, start_index):
    tds = GrainDataset(SOURCES[source](), transform=_to_image, name="grain-toy")
    jds = JGrainDataset(SOURCES[source](), transform=_to_image, name="grain-toy")
    assert len(tds) == len(jds) == 11 and tds.name == jds.name == "grain-toy"
    assert repr(tds) == repr(jds)
    tb = list(iter_batches(tds, 4, start_index=start_index))
    jb = list(jiter_batches(jds, 4, start_index=start_index))
    assert len(tb) == len(jb) == (3 if start_index == 0 else 2)
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(np.asarray(t.images), np.asarray(j.images))
        assert t.start_index == j.start_index
        np.testing.assert_array_equal(np.asarray(t.valid), np.asarray(j.valid))
    assert not np.asarray(tb[-1].valid)[3]  # 11 rows: the last batch padded


def test_records_pass_through_without_a_transform():
    ds = GrainDataset(list(IMAGES))
    np.testing.assert_array_equal(ds[3], IMAGES[3])
    assert not hasattr(ds, "name") and repr(ds) == "GrainDataset(n=11, source=list)"
    assert repr(ds) == repr(JGrainDataset(list(IMAGES)))


@pytest.mark.parametrize("n", [0, 7, 10, 11])
@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_grain_shard_range_equals_jax(n, count):
    spans = [grain_shard_range(n, process_index=i, process_count=count) for i in range(count)]
    assert spans == [jgrain_shard_range(n, process_index=i, process_count=count) for i in range(count)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert grain_shard_range(n) == (0, n)  # no process group: the whole range
