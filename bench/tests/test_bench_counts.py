"""Bytes and FLOPs of the references' ``work``, the batch statistics they
rest on, and the least time at the peaks, against small cases worked by
hand."""
import torch

from bench import harness
from bench.reference import dlrm, widedeep
from bench.roofline import least_time

PEAKS = {"flops": {"bfloat16": 1e3, "float32": 1e2}, "bytes_per_s": 1e3}


def test_dlrm_by_hand():
    sizes = {"vocab_sizes": [5, 7], "pooling": [2, 3], "embed_dim": 4,
             "table_dtype": "bfloat16", "dtype": "bfloat16", "row_pad": 4,
             "n_dense": 3, "bottom_mlp": [8, 4], "top_mlp": [6]}
    ids = torch.tensor([[[0, 1, -1], [2, -1, -1]],
                        [[1, -1, -1], [0, 6, 6]]], dtype=torch.int32)
    # rows 0, 1 | 5 + 2 = 7 | 1 | 5 + 0, 5 + 6 twice: {0, 1, 5, 7, 11}
    stats = harness.batch_stats(sizes, {"sparse_ids": ids})
    assert stats == {"items": 2, "live": 7, "distinct": 5}
    w = dlrm.work(sizes, stats)
    # ids 2*2*3*4 = 48, offsets 2*8, rows 5*4*2 = 40, out 2*2*4*2 = 32
    assert w["k1"] == [{"bytes": 136, "flops": {"float32": 28}}]
    # bottom 3-8-4: 2*(24+32) = 112; top 7-6-1: 2*(42+6) = 96; dots 2*3*4
    assert w["step"]["flops"] == {"float32": 28, "bfloat16": 2 * 232}
    # ids 48 + rows 40 + dense 24 + weights 136 + 110 + scores 4
    assert w["step"]["bytes"] == 362
    assert least_time(w["step"], PEAKS) == 0.464 + 0.28


def test_widedeep_by_hand():
    sizes = {"vocab_sizes": [5, 7], "pooling": [1, 1], "embed_dim": 4,
             "table_dtype": "float32", "dtype": "float32", "row_pad": 4,
             "n_dense": 3, "top_mlp": [6, 2], "n_tasks": 2}
    ids = torch.tensor([[[0], [2]], [[0], [6]]], dtype=torch.int32)
    stats = harness.batch_stats(sizes, {"sparse_ids": ids})
    assert stats == {"items": 2, "live": 4, "distinct": 3}
    w = widedeep.work(sizes, stats)
    assert w["k1"] == [{"bytes": 16 + 16 + 48 + 64, "flops": {"float32": 16}},
                       {"bytes": 16 + 16 + 12 + 16, "flops": {"float32": 4}}]
    # deep 11-6-2: 2*78; heads 2 * 2*2; wide dense 2*3: 170 an item
    assert w["step"]["flops"] == {"float32": 20 + 340}
    # ids 16 + rows 3*5*4 + dense 24 + weights 95*4 + scores 16
    assert w["step"]["bytes"] == 496
    assert least_time(w["step"], PEAKS) == 3.6


def test_least_time_takes_the_larger_bound():
    assert least_time({"bytes": 5000, "flops": {"float32": 10}}, PEAKS) == 5.0
    assert least_time({"bytes": 0, "flops": {"bfloat16": 500,
                                             "float32": 50}}, PEAKS) == 1.0
