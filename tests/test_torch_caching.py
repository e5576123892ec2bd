"""Cache files cross-load between the JAX package and the port, both ways.

The port writes the safetensors layout with its own small writer; these
tests hold it to the ``safetensors`` package's bytes and to the JAX
package's ``ActMaxCache`` and concept-DB loaders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes
from safetensors.numpy import load_file as st_load, save_file as st_save

from semanticlens_tpu.collect.activation_caching import ActMaxCache as JCache
from semanticlens_tpu.ops.aggregators import aggregate_conv_mean as j_mean
from semanticlens_tpu_torch.collect.activation_caching import ActMaxCache as TCache
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean as t_mean
from semanticlens_tpu_torch.utils import safetensors_io

torch.set_num_threads(2)


def _acts(seed, n=10, c=6):
    return np.random.default_rng(seed).normal(size=(n, 3, 3, c)).astype(np.float32)


def _fill(cache, acts, to_array):
    for s in range(0, len(acts), 4):
        cache.update_layer("layer4", to_array(acts[s : s + 4]))


def _assert_same_state(jcache, tcache):
    j, t = jcache["layer4"], tcache["layer4"]
    np.testing.assert_array_equal(t.sample_ids, np.asarray(j.sample_ids))
    np.testing.assert_array_equal(t.activations.float().numpy(), np.asarray(j.activations, np.float32))


def _split(path):
    import json
    import struct

    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    return json.loads(raw[8 : 8 + n]), raw[8 + n :]


def test_writer_bytes_match_safetensors_package(tmp_path):
    """Byte-identical without metadata; with metadata the header parses equal
    (the safetensors package writes metadata keys in hash order)."""
    rng = np.random.default_rng(0)
    arrays = {
        "activations": rng.normal(size=(4, 3)).astype(ml_dtypes.bfloat16),
        "sample_ids": rng.integers(-1, 9, size=(4, 3)).astype(np.int64),
        "embeds": rng.normal(size=(2, 5)).astype(np.float32),
        "scalar": np.asarray(1.5, np.float32),
        "ids32": rng.integers(0, 9, size=(5,)).astype(np.int32),
    }
    tensors = {
        k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16) if v.dtype == ml_dtypes.bfloat16
        else torch.from_numpy(np.array(v))
        for k, v in arrays.items()
    }
    st_save(arrays, str(tmp_path / "ref.safetensors"))
    safetensors_io.save_file(tensors, tmp_path / "ours.safetensors")
    assert (tmp_path / "ours.safetensors").read_bytes() == (tmp_path / "ref.safetensors").read_bytes()

    meta = {"n_collect": "3", "aggregation_fn_name": "aggregate_conv_mean"}
    st_save(arrays, str(tmp_path / "ref_meta.safetensors"), metadata=meta)
    safetensors_io.save_file(tensors, tmp_path / "ours_meta.safetensors", metadata=meta)
    assert _split(tmp_path / "ours_meta.safetensors") == _split(tmp_path / "ref_meta.safetensors")

    loaded = safetensors_io.load_file(tmp_path / "ref_meta.safetensors")
    for k, v in arrays.items():
        np.testing.assert_array_equal(loaded[k].float().numpy(), np.asarray(v, np.float32))
    assert safetensors_io.read_metadata(tmp_path / "ref_meta.safetensors") == meta


def test_port_writes_jax_reads(tmp_path):
    acts = _acts(1)
    tcache = TCache(["layer4"], t_mean, n_collect=5, device="cpu")
    _fill(tcache, acts, torch.from_numpy)
    tcache.store(tmp_path)
    jcache = JCache(["layer4"], j_mean, n_collect=5)
    jcache.load(tmp_path)
    ref = JCache(["layer4"], j_mean, n_collect=5)
    _fill(ref, acts, jnp.asarray)
    _assert_same_state(jcache, tcache)
    _assert_same_state(ref, tcache)


def test_jax_writes_port_reads(tmp_path):
    acts = _acts(2)
    jcache = JCache(["layer4"], j_mean, n_collect=4)
    _fill(jcache, acts, jnp.asarray)
    jcache.store(tmp_path)
    tcache = TCache(["layer4"], t_mean, n_collect=4, device="cpu")
    tcache.load(tmp_path)
    _assert_same_state(jcache, tcache)
    assert tcache["layer4"].n_latents == 6
    # Mismatched n_collect is a cache miss, as in the JAX package.
    with pytest.raises(FileNotFoundError):
        TCache(["layer4"], t_mean, n_collect=7, device="cpu").load(tmp_path)


def test_concept_db_file_cross_loads(tmp_path):
    db = {"layer4": np.random.default_rng(3).normal(size=(4, 5, 8)).astype(np.float32)}
    safetensors_io.save_file({k: torch.from_numpy(v) for k, v in db.items()}, tmp_path / "a.safetensors")
    np.testing.assert_array_equal(st_load(str(tmp_path / "a.safetensors"))["layer4"], db["layer4"])
    st_save(db, str(tmp_path / "b.safetensors"))
    np.testing.assert_array_equal(safetensors_io.load_file(tmp_path / "b.safetensors")["layer4"].numpy(),
                                  db["layer4"])


def test_lambda_aggregation_rejected():
    with pytest.raises(ValueError):
        TCache(["layer4"], lambda x: x, n_collect=3, device="cpu")


def test_act_cache_captures_the_raw_taps_as_jax():
    """``collect.ActCache`` (JAX ``activation_caching.py:128-150``): host float32 arrays of the requested taps."""
    from semanticlens_tpu.collect import ActCache as JActCache
    from semanticlens_tpu.models.resnet import ResNet as JResNet
    from semanticlens_tpu_torch.collect import ActCache
    from semanticlens_tpu_torch.models import ResNet

    tmodel = ResNet(depth=18, dtype=torch.float32, device="cpu")
    weights = tmodel.init_jax_layout(0)
    params = tmodel.load_jax_params(weights)
    jmodel = JResNet(depth=18, dtype=jnp.float32)
    x = np.random.default_rng(4).random((2, 32, 32, 3)).astype(np.float32)
    cache = ActCache(["layer1", "layer4", "fc"])
    got = cache.capture(tmodel, params, torch.from_numpy(x))
    want = JActCache(["layer1", "layer4", "fc"]).capture(jmodel, {k: jnp.asarray(v) for k, v in weights.items()},
                                                         jnp.asarray(x))
    for name in want:
        assert isinstance(got[name], np.ndarray) and got[name].dtype == np.float32
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=1e-4 * float(np.abs(want[name]).max()))
    assert cache.cache is got
    cache.clear()
    assert cache.cache == {}
