"""The concept DB's one-pass gather against the two numpy lines it replaces.

``gather_concept_db(table, ids)`` must give, bit for bit, what
``db = table[ids]; db[ids < 0] = 0.0`` gives: every (component, sample) row
of the (N, D) float32 embedding table, and a zero row for each −1 sentinel.
The result is a C-contiguous, writeable float32 numpy array that owns its
memory. Where the numpy lines raise (an empty dataset leaves only sentinels
over a table of no rows; an id past the table) the gather raises the same
IndexError.
"""

import re

import numpy as np
import pytest
import torch

from semanticlens_tpu_torch.collect.activation_based import gather_concept_db

torch.set_num_threads(2)


def _table(rng, n, d):
    return rng.standard_normal((n, d), dtype=np.float32)


def _scattered(rng):
    ids = rng.integers(0, 64, size=(40, 7))
    ids[rng.random(ids.shape) < 0.2] = -1
    return _table(rng, 64, 24), ids


def _sentinel_row(rng):
    ids = rng.integers(0, 30, size=(10, 5))
    ids[3] = -1  # a component with no filled slot
    ids[9, 2:] = -1  # and one filled only in part, as the top-k leaves it
    return _table(rng, 30, 16), ids


def _threaded(rng):
    # 100,000 rows of 32 floats, far above torch's grain size: the copy is split over the pool
    ids = rng.integers(-1, 512, size=(12_500, 8))
    return _table(rng, 512, 32), ids


CASES = {
    "sentinels_scattered": _scattered,
    "component_of_sentinels": _sentinel_row,
    "one_row_table": lambda rng: (_table(rng, 1, 16), rng.integers(-1, 1, size=(9, 4))),
    "one_column_table": lambda rng: (_table(rng, 50, 1), rng.integers(-1, 50, size=(12, 6))),
    "no_components": lambda rng: (_table(rng, 8, 16), np.zeros((0, 4), np.int64)),
    "threaded_512_rows": _threaded,
    "empty_dataset": lambda rng: (np.zeros((0, 16), np.float32), np.full((6, 4), -1, np.int64)),
    "id_past_the_table": lambda rng: (_table(rng, 8, 16), np.array([[0, 3, -1], [8, 2, 1]])),
}
RAISES = {"empty_dataset", "id_past_the_table"}


def _numpy_gather(table, ids):
    db = table[ids]
    db[ids < 0] = 0.0
    return db


@pytest.mark.parametrize("case", list(CASES))
def test_gather_is_the_fancy_index_with_zero_sentinel_rows(case):
    table, ids = CASES[case](np.random.default_rng(sorted(CASES).index(case)))
    if case in RAISES:
        with pytest.raises(IndexError) as numpy_err:
            _numpy_gather(table, ids)
        with pytest.raises(IndexError, match=re.escape(str(numpy_err.value))):
            gather_concept_db(table, ids)
        return
    if case == "threaded_512_rows":
        assert ids.size >= 100_000 and torch.get_num_threads() > 1
    want = _numpy_gather(table, ids)
    got = gather_concept_db(table, ids)
    assert got.shape == want.shape == (*ids.shape, table.shape[1])
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))  # bitwise: +0.0 sentinels, rows as stored
    assert got.flags.c_contiguous and got.flags.writeable and got.flags.owndata
    assert not np.shares_memory(got, table)
