"""A run with its timed path broken underneath comes out not correct.

Each test drives the rest of a run of a tiny cell on the CPU (the look for
a card is the only part skipped) with one fault of ``harness/faults.py``
planted in the program:

- a step that returns its state unchanged;
- half of each batch left out (the rest still taken);
- an answer altered where it is produced (image embeddings; aggregated
  activations; search values).

The exchange between chips is no fault these cells can have: every cell
runs on one card.
"""

from __future__ import annotations

import pytest

from conftest import run_cell

from portbench.harness.faults import planted


def _sound(tiny_root, workload):
    line, _ = run_cell(tiny_root, workload)
    assert line["correct"], line["checks"]


def _faulty(tiny_root, workload, fault):
    with planted(fault):
        return run_cell(tiny_root, workload)[0]


@pytest.mark.parametrize("workload", ["tiny-rn.sweep", "tiny-vit.sweep"])
def test_sweep_state_unchanged(tiny_root, workload):
    line = _faulty(tiny_root, workload, "sweep-state-unchanged")
    assert not line["correct"] and line["failed"] == 1


@pytest.mark.parametrize("workload", ["tiny-rn.sweep", "tiny-vit.sweep"])
def test_sweep_half_of_each_batch_left_out(tiny_root, workload):
    assert not _faulty(tiny_root, workload, "sweep-half-batch")["correct"]


def test_sweep_embedding_altered(tiny_root):
    line = _faulty(tiny_root, "tiny-rn.sweep", "sweep-clip-embedding-altered")
    assert not line["correct"] and line["checks"]["embed_cos_dist"]["value"] > line["checks"]["embed_cos_dist"]["limit"]


def test_sweep_siglip_embedding_altered(tiny_root):
    assert not _faulty(tiny_root, "tiny-vit.sweep", "sweep-siglip-embedding-altered")["correct"]


@pytest.mark.parametrize("workload, fault", [("tiny-rn.sweep", "sweep-conv-activation-altered"),
                                             ("tiny-vit.sweep", "sweep-token-activation-altered")])
def test_sweep_activation_altered(tiny_root, workload, fault):
    assert not _faulty(tiny_root, workload, fault)["correct"]


def test_search_state_unchanged(tiny_root):
    assert not _faulty(tiny_root, "tiny-rn.search", "search-state-unchanged")["correct"]


def test_search_half_of_each_block_left_out(tiny_root):
    assert not _faulty(tiny_root, "tiny-rn.search", "search-half-block")["correct"]


def test_search_value_altered(tiny_root):
    assert not _faulty(tiny_root, "tiny-rn.search", "search-value-altered")["correct"]


@pytest.mark.parametrize("workload", ["tiny-rn.sweep", "tiny-vit.sweep", "tiny-rn.search"])
def test_sound_runs_are_correct(tiny_root, workload):
    _sound(tiny_root, workload)
