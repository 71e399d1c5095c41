"""The port's ``CheckpointManager`` and ``Trainer`` (``repro_torch.train``):
the reference's ``TestCheckpoint`` cases (tests/test_fault_tolerance.py)
on the port, a bf16 leaf round-tripped bitwise, a saved state that the
next in-place step cannot reach, checkpoints carried between the port and
the reference (f32 and integer leaves, either way), a crashed and resumed
run ending bitwise an uninterrupted one, and a short run of
``launch.train_dlrm`` whose loss falls.  Everything on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.launch import train_dlrm
from repro_torch.launch.steps import build_cell
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig

CPU = torch.device("cpu")


def _batches(cell, start=0):
    """The reference test's batches (one seeded stream, whatever the
    start): ids in {0, 1}, masks true, the rest normal."""
    r = np.random.default_rng(0)

    def mk(spec):
        if spec.dtype == torch.int32:
            return torch.from_numpy(r.integers(0, 2, spec.shape).astype(
                np.int32))
        if spec.dtype == torch.bool:
            return torch.ones(spec.shape, dtype=torch.bool)
        return torch.from_numpy(r.normal(size=spec.shape).astype(np.float32))

    while True:
        yield {k: mk(v) for k, v in cell.batch_specs.items()}


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        state = {"a": torch.arange(6.0).reshape(2, 3),
                 "b": {"c": torch.ones(4)}}
        mgr.save(7, state, blocking=True)
        assert mgr.latest_step() == 7
        out = mgr.restore(7, tree_map(torch.zeros_like, state))
        torch.testing.assert_close(out["a"], state["a"])
        torch.testing.assert_close(out["b"]["c"], state["b"]["c"])

    def test_gc_keeps_max(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
        s = {"x": torch.zeros(2)}
        for i in (1, 2, 3, 4):
            mgr.save(i, s, blocking=True)
        assert mgr.all_steps() == [3, 4]

    def test_crash_restart_resumes(self, tmp_path):
        cell = build_cell("dlrm-rm2", "train_batch", device="cpu")
        cfg = TrainerConfig(total_steps=12, ckpt_every=5,
                            ckpt_dir=str(tmp_path), log_every=1)
        t = Trainer(cell.run, cell.init_state, lambda s: _batches(cell, s),
                    cfg)
        with pytest.raises(RuntimeError, match="injected crash"):
            t.run(torch.Generator().manual_seed(0), crash_at=8)
        # restart: resumes from step 5, finishes
        t2 = Trainer(cell.run, cell.init_state, lambda s: _batches(cell, s),
                     cfg)
        state, hist = t2.run(torch.Generator().manual_seed(0))
        assert t2.ckpt.latest_step() == 12
        assert hist[0]["step"] == 6  # resumed after step-5 commit


def test_bf16_and_int_leaves_bitwise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    rng = np.random.default_rng(1)
    state = {"w": torch.from_numpy(rng.standard_normal((5, 7)).astype(
                 np.float32)).to(torch.bfloat16),
             "tiny": torch.tensor([1e-40, -0.0, float("inf")],
                                  dtype=torch.bfloat16),
             "step": torch.tensor(3, dtype=torch.int32),
             "ids": torch.arange(-4, 4, dtype=torch.int64)}
    mgr.save(1, state, blocking=True)
    target = tree_map(torch.zeros_like, state)
    out = mgr.restore(1, target)
    assert out is target
    for k in state:
        assert out[k].dtype == state[k].dtype
        assert torch.equal(out[k].view(torch.int16) if k in ("w", "tiny")
                           else out[k], state[k].view(torch.int16)
                           if k in ("w", "tiny") else state[k])
    manifest = (tmp_path / "step-000000001" / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest


def test_save_copies_before_returning(tmp_path):
    """The state is updated in place: what is written is the state as it
    was when ``save`` returned, not after the next step."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"p": torch.ones(1000)}
    fut = mgr.save(1, state)
    state["p"].mul_(3.0)                  # the next step, in place
    fut.result()
    out = mgr.restore(1, {"p": torch.zeros(1000)})
    assert torch.equal(out["p"], torch.ones(1000))
    with pytest.raises(ValueError, match="shardings"):
        mgr.restore(1, state, shardings={"p": None})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, {"p": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(1, {"q": torch.zeros(1000)})


def test_checkpoints_carry_between_port_and_reference(tmp_path):
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.integers(-9, 9, (5,)).astype(np.int32),
                  "d": [rng.standard_normal(2).astype(np.float32)]}}
    # the reference writes, the port reads
    jmgr = JCheckpointManager(str(tmp_path / "ref"))
    jmgr.save(3, jax.tree.map(jnp.asarray, tree), blocking=True)
    target = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(
        a).dtype), tree)
    out = CheckpointManager(str(tmp_path / "ref")).restore(3, target)
    tree_map(lambda t, a: np.testing.assert_array_equal(t.numpy(), a),
             out, tree)
    # the port writes, the reference reads
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(4, tree_map(torch.from_numpy, tree), blocking=True)
    back = JCheckpointManager(str(tmp_path / "port")).restore(
        4, jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, tree)))
    jax.tree.map(lambda b, a: np.testing.assert_array_equal(np.asarray(b), a),
                 back, tree)


SMALL_DLRM = dataclasses.replace(
    train_dlrm.make_model(),
    embedding=EmbeddingConfig(vocab_sizes=(3000,) * 8, dim=32,
                              pooling=(16,) * 8))


def test_resumed_run_bitwise_uninterrupted(tmp_path):
    """A run crashed before step 11 and resumed from its step-8 commit
    ends bitwise where an uninterrupted run ends (batches are a function
    of the step; the last step is a commit step, written once)."""
    def trainer(d):
        return train_dlrm.make_trainer(16, 64, tmp_path / d, CPU,
                                       ckpt_every=4, log_every=1,
                                       cfg=SMALL_DLRM)

    whole, hist = trainer("a").run(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="injected crash at step 11"):
        trainer("b").run(torch.Generator().manual_seed(0), crash_at=11)
    t = trainer("b")
    resumed, rhist = t.run(torch.Generator().manual_seed(0))
    assert rhist[0]["step"] == 9 and rhist[-1]["step"] == 16
    assert t.ckpt.all_steps() == [8, 12, 16]
    assert rhist[-1]["loss"] == hist[-1]["loss"]
    assert _equal_trees(resumed["model"].tree(), whole["model"].tree())
    assert _equal_trees(resumed["opt"], whole["opt"])
    # the committed last step restores bitwise into a fresh state
    fresh = t.init_state_fn(torch.Generator().manual_seed(5))
    assert not _equal_trees(fresh["model"].tree(), whole["model"].tree())
    t.ckpt.restore(16, fresh)
    assert _equal_trees(fresh["model"].tree(), whole["model"].tree())
    assert _equal_trees(fresh["opt"], whole["opt"])


def test_train_dlrm_loss_falls(tmp_path, capsys):
    assert train_dlrm.main(["--steps", "20", "--batch", "64", "--device",
                            "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "loss improved" in out and "M parameters on cpu" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [20]
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_dlrm.main(["--steps", "1", "--ckpt-dir",
                             str(tmp_path / "x")])
