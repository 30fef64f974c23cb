"""The port's checkpoints (``repro_torch.checkpoint``): atomic roundtrip,
hash verify, gc, torn steps, target-free trees; and the files of either
package loading in the other.

The reference's checkpoint tests run against the port (the mesh restore
is ``tests/test_torch_sharding.py::test_elastic_restore_onto_mesh``),
the exact resume through the port's trainer.  Leaves restore as tensors
on ``device="cpu"``."""
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint_tree as ref_load_tree
from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint_tree,
                                    restore_checkpoint, save_checkpoint)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32),
            "b": {"c": torch.arange(6, dtype=torch.int32)}}


def _assert_tree_equal(got, want):
    """Same containers and keys; every leaf a tensor equal to ``want``'s."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t, {"note": "hi"})
    restored, manifest = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert manifest["step"] == 3 and manifest["metadata"]["note"] == "hi"
    _assert_tree_equal(restored, t)
    assert restored["a"].dtype == torch.float32
    assert restored["b"]["c"].dtype == torch.int32
    assert restored["a"].device.type == "cpu"


def test_latest_pointer_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4
    _, manifest = mgr.restore(t, device="cpu")
    assert manifest["step"] == 4


def test_torn_step_dir_is_invisible(tmp_path):
    """A step dir without a manifest (interrupted two-phase writer) is
    never listed, never latest, never restored, even when the LATEST
    pointer names it."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    mgr.save(5, t)
    torn = tmp_path / "step_000009"
    torn.mkdir()
    np.savez(torn / "arrays.npz", leaf_00000=np.zeros(3))  # no manifest
    (tmp_path / "LATEST").write_text("step_000009")

    assert mgr.steps() == [5]
    assert mgr.latest_step() == 5
    _, manifest = mgr.restore(t, device="cpu")
    assert manifest["step"] == 5


def test_gc_sweeps_torn_artifacts(tmp_path):
    """save() garbage-collects interrupted writers' leftovers: orphaned
    two-phase tmp dirs and manifest-less step dirs."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    torn = tmp_path / "step_000002"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"partial")
    orphan = tmp_path / ".tmp_ckpt_dead"
    orphan.mkdir()
    (orphan / "arrays.npz").write_bytes(b"partial")

    mgr.save(7, _tree())
    assert not torn.exists()
    assert not orphan.exists()
    assert mgr.steps() == [7]


def test_load_checkpoint_tree_target_free(tmp_path):
    """Dict-nested checkpoints restore WITHOUT a shape-matching target
    (the crash-recovery path); non-dict trees refuse."""
    t = {"x": np.arange(5, dtype=np.float32), "sub": {"y": np.eye(3)}}
    save_checkpoint(str(tmp_path), 2, t, {"tag": "wal"})
    tree, manifest = load_checkpoint_tree(str(tmp_path))
    assert manifest["metadata"]["tag"] == "wal"
    np.testing.assert_array_equal(tree["x"], t["x"])
    np.testing.assert_array_equal(tree["sub"]["y"], t["sub"]["y"])

    save_checkpoint(str(tmp_path / "tup"), 1, (np.zeros(2), np.ones(2)))
    with pytest.raises(ValueError):
        load_checkpoint_tree(str(tmp_path / "tup"))


def test_corruption_detected(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 1, t)
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["leaf_00000"] = data["leaf_00000"] + 1
    np.savez(npz, **data)
    with pytest.raises(IOError):
        restore_checkpoint(str(tmp_path), t, device="cpu")


def test_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = {"a": torch.zeros((9, 4)),
           "b": {"c": torch.zeros(6, dtype=torch.int32)}}
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), bad, device="cpu")


def test_exact_resume_equivalence(tmp_path):
    """train 6 steps == train 3, checkpoint, restore, train 3 more."""
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.models import ModelConfig, model
    from repro_torch.sharding.rules import ExecConfig
    from repro_torch.train.optim import AdamWConfig, AdamWState, adamw_init
    from repro_torch.train.step import make_train_step

    cfg = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=64,
                      param_dtype="float32", dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, ExecConfig(), opt_cfg)
    pipe = DataPipeline(SyntheticCorpus(64), seq_len=16, global_batch=2)

    def fresh():
        m = model.init(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
        return m, adamw_init(m, opt_cfg)

    def run(m, opt, s0, s1):
        for s in range(s0, s1):
            opt, _ = step(m, opt, pipe.batch_at(s))
        return opt

    def tree(m, opt):
        return ({k: p.detach() for k, p in m.named_parameters()},
                (opt.count, opt.m, opt.v))

    mA, oA = fresh()
    oA = run(mA, oA, 0, 6)
    mB, oB = fresh()
    oB = run(mB, oB, 0, 3)
    save_checkpoint(str(tmp_path), 3, tree(mB, oB))
    mB, oB = fresh()
    (params, (count, m, v)), _ = restore_checkpoint(
        str(tmp_path), tree(mB, oB), device="cpu")
    with torch.no_grad():
        for k, p in mB.named_parameters():
            p.copy_(params[k])
    oB = run(mB, AdamWState(count=count, m=m, v=v), 3, 6)
    assert int(oA.count) == int(oB.count) == 6
    for k, p in mA.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   mB.get_parameter(k).detach().numpy(),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# files written by one package, read by the other
# ---------------------------------------------------------------------------

def _np_tree(seed=0):
    """A mixed tree: job-like subtrees whose keys sort as strings ("0",
    "1", "10", "2"), lists, tuples, None, several dtypes and scalars."""
    rng = np.random.default_rng(seed)
    jobs = {str(i): {"x": rng.random(3 + i).astype(np.float32),
                     "allowed": rng.random(5) > 0.5}
            for i in (0, 1, 2, 10)}
    return {"meta_json": np.frombuffer(b'{"v": 1}', np.uint8).copy(),
            "device": {"rows": rng.normal(size=(2, 3, 4)).astype(np.float32),
                       "ns": np.arange(4, dtype=np.int32),
                       "idx": np.arange(7, dtype=np.int64)},
            "jobs": jobs, "scalar": np.float64(2.5)}


def _manifest(root, step):
    with open(os.path.join(root, f"step_{step:06d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("tree", [
    _np_tree(0),
    [np.zeros(3, np.float32), (np.ones(2), np.int32(4)), None,
     {"z": np.eye(2), "a": [np.arange(3)]}],
    (np.zeros(1),),
    {"only": np.arange(3, dtype=np.int16), "empty": {}, "none": None},
], ids=["service-like", "lists-tuples-none", "one-tuple", "empty-subtrees"])
def test_same_tree_same_manifest_in_both_packages(tmp_path, tree):
    """One tree saved by each package: the same leaf order (dict keys
    sorted as strings), ``treedef`` text, ``leaf_paths``, shapes, dtypes
    and content hash, and the same npz entries bitwise."""
    ref_save(str(tmp_path / "ref"), 4, tree, {"by": "x"})
    save_checkpoint(str(tmp_path / "port"), 4, tree, {"by": "x"})
    mr, mp = _manifest(tmp_path / "ref", 4), _manifest(tmp_path / "port", 4)
    assert mp == mr
    ar = np.load(tmp_path / "ref" / "step_000004" / "arrays.npz")
    ap = np.load(tmp_path / "port" / "step_000004" / "arrays.npz")
    assert sorted(ar.files) == sorted(ap.files)
    for k in ar.files:
        assert ar[k].dtype == ap[k].dtype
        np.testing.assert_array_equal(ar[k], ap[k])


def test_reference_checkpoint_loads_in_port(tmp_path):
    """A tree the reference wrote restores in the port, target-free and
    into a target (tensors of the target's dtypes), hash verified."""
    tree = _np_tree(3)
    ref_save(str(tmp_path), 9, tree, {"from": "repro"})
    got, manifest = load_checkpoint_tree(str(tmp_path))
    assert manifest["metadata"] == {"from": "repro"}
    assert got.keys() == tree.keys()
    for key in ("0", "1", "2", "10"):
        np.testing.assert_array_equal(got["jobs"][key]["x"],
                                      tree["jobs"][key]["x"])
        np.testing.assert_array_equal(got["jobs"][key]["allowed"],
                                      tree["jobs"][key]["allowed"])
    np.testing.assert_array_equal(got["device"]["rows"],
                                  tree["device"]["rows"])
    restored, _ = restore_checkpoint(str(tmp_path), tree, device="cpu")
    _assert_tree_equal(restored, tree)
    assert restored["device"]["idx"].dtype == torch.int64
    assert restored["jobs"]["10"]["allowed"].dtype == torch.bool


def test_port_checkpoint_loads_in_reference(tmp_path):
    """A tree the port wrote (tensor and numpy leaves) restores in the
    reference, target-free and into a target, hash verified."""
    t = _tree(5)
    tree = {"t": t, "n": _np_tree(6)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, tree)
    mgr.save(2, tree, {"from": "repro_torch"})
    got, manifest = ref_load_tree(str(tmp_path))
    assert manifest["step"] == 2
    assert manifest["metadata"] == {"from": "repro_torch"}
    np.testing.assert_array_equal(got["t"]["a"], t["a"].numpy())
    np.testing.assert_array_equal(got["t"]["b"]["c"], t["b"]["c"].numpy())
    np.testing.assert_array_equal(got["n"]["jobs"]["10"]["x"],
                                  tree["n"]["jobs"]["10"]["x"])
    target = {"t": {"a": np.zeros((8, 4), np.float32),
                    "b": {"c": np.zeros(6, np.int32)}},
              "n": _np_tree(6)}
    restored, _ = ref_restore(str(tmp_path), target)
    np.testing.assert_array_equal(np.asarray(restored["t"]["a"]),
                                  t["a"].numpy())
