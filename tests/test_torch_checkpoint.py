"""Checkpoints, resume, preemption and deadlines of the port's GBT and
random forest (learners/gbt.py, utils/snapshot.py; counterparts of
tests/test_checkpoint.py and tests/test_max_duration.py): the snapshot
files byte for byte the JAX package's, a corrupt or torn payload falling
back to the previous snapshot, chunked training equal to one run, kill
and resume and a preempted run resumed equal to an uninterrupted one
(binary with the look-ahead stop, DART, MHLD with changing row
weights), a mismatched resume and a JAX snapshot refused, a real
SIGTERM in a subprocess ending in TrainingPreempted with a resumable
snapshot, and deadlines keeping a prefix of the trees.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    from ydf_tpu.utils import snapshot as jax_snapshot
except ImportError:
    jax_snapshot = None

import ydf_tpu_torch
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.utils import failpoints
from ydf_tpu_torch.utils.snapshot import Snapshots

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def data(n=3000, seed=0):
    """A binary frame: six normal features (one with NaNs) and a label
    from a non-linear logit."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    logit = x[:, 0] - 0.5 * x[:, 1] + np.sin(2 * x[:, 2]) + x[:, 3] * x[:, 4]
    d = {f"f{i}": x[:, i] for i in range(6)}
    d["f5"] = np.where(rng.uniform(size=n) < 0.05, np.nan,
                       d["f5"]).astype(np.float32)
    d["label"] = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(
        np.int64)
    return d


def same_forest(a, b):
    """Every forest array of a == b's, bitwise."""
    fa, fb = a.forest.to_numpy(), b.forest.to_numpy()
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k
    return True


def gbt(**kw):
    hp = dict(label="label", num_trees=12, max_depth=3, device="cpu")
    hp.update(kw)
    return ydf_tpu_torch.GradientBoostedTreesLearner(**hp)


# ---- the snapshot files ----------------------------------------------


def test_snapshot_protocol_and_files_match_jax(tmp_path, monkeypatch):
    """The protocol (latest, pruning to max_kept, the index) and the
    files: the same arrays and metadata written by both packages give
    the same bytes (npz members carry the write time: it is pinned)."""
    if jax_snapshot is None:
        pytest.skip("needs the JAX package, the reference")
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    dirs = {}
    for name, mod in (("port", Snapshots), ("jax", jax_snapshot.Snapshots)):
        d = str(tmp_path / name)
        s = mod(d, max_kept=2)
        assert s.latest() is None
        for i, k in ((5, 1), (10, 2), (15, 3)):
            s.save(i, {"a": np.arange(i, dtype=np.float32),
                       "b": np.full((2, 3), k, np.int64)},
                   meta={"k": k, "chunk_starts": [0, 5]})
        idx, arrays, meta = s.latest()
        assert idx == 15 and meta["k"] == 3 and len(arrays["a"]) == 15
        assert not os.path.isfile(os.path.join(d, "snapshot_5.npz"))
        assert s.indices() == [5, 10, 15]
        dirs[name] = d
    files = sorted(os.listdir(dirs["port"]))
    assert files == sorted(os.listdir(dirs["jax"]))
    for f in files:
        with open(os.path.join(dirs["port"], f), "rb") as a, \
                open(os.path.join(dirs["jax"], f), "rb") as b:
            assert a.read() == b.read(), f


def test_snapshot_corrupt_or_torn_payload_falls_back(tmp_path):
    s = Snapshots(str(tmp_path))
    s.save(1, {"a": np.arange(2)}, meta={})
    s.save(2, {"a": np.arange(3)}, meta={})
    with open(str(tmp_path / "snapshot_2.npz"), "wb") as f:
        f.write(b"garbage")
    idx, arrays, _ = s.latest()
    assert idx == 1 and len(arrays["a"]) == 2
    # The torn_write failpoint: the payload lands half written behind its
    # index entry, and latest() falls back past it.
    with failpoints.active("snapshot.save=torn_write"):
        with pytest.raises(failpoints.FailpointError):
            s.save(3, {"a": np.arange(4)}, meta={})
        assert failpoints.fired_sites() == ["snapshot.save"]
    assert 3 in s.indices()
    idx, arrays, _ = s.latest()
    assert idx == 1


# ---- chunking, kill and resume, preemption ----------------------------

RESUME_CASES = {
    # The look-ahead stop over the validation split (the defaults).
    "binary": dict(num_trees=40, early_stopping_num_trees_look_ahead=5),
    "dart": dict(dart_dropout=0.2, validation_ratio=0.0),
    # MHLD with the row weights changing every iteration (path ii).
    "mhld_subsample": dict(split_axis="MHLD_OBLIQUE", subsample=0.5,
                           validation_ratio=0.0),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_chunked_training_equals_one_run(tmp_path, case):
    d = data()
    base = gbt(**RESUME_CASES[case]).train(d)
    chunked = gbt(working_dir=str(tmp_path),
                  resume_training_snapshot_interval_trees=5,
                  **RESUME_CASES[case]).train(d)
    assert same_forest(base, chunked)
    assert chunked.training_logs["num_trees"] == (
        base.training_logs["num_trees"])


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_kill_and_resume_equals_uninterrupted(tmp_path, case):
    d = data()
    kw = dict(working_dir=str(tmp_path),
              resume_training_snapshot_interval_trees=5,
              **RESUME_CASES[case])
    base = gbt(**RESUME_CASES[case]).train(d)
    learner = gbt(**kw)
    learner._abort_after_chunks = 1
    with pytest.raises(port_gbt._TrainingAborted):
        learner.train(d)
    assert Snapshots(str(tmp_path)).latest()[2]["completed_iters"] == 5
    resumed = gbt(resume_training=True, **kw).train(d)
    assert same_forest(base, resumed)


def test_preemption_hook_then_resume(tmp_path):
    """_preempt_after_chunks takes the real signal's path: the loop
    stops right after the snapshot with TrainingPreempted (exit code
    75), and resume_training continues to the uninterrupted trees."""
    d = data()
    kw = dict(working_dir=str(tmp_path),
              resume_training_snapshot_interval_trees=3, num_trees=12,
              validation_ratio=0.0)
    base = gbt(num_trees=12, validation_ratio=0.0).train(d)
    learner = gbt(**kw)
    learner._preempt_after_chunks = 2
    with pytest.raises(port_gbt.TrainingPreempted, match="SIGTERM") as e:
        learner.train(d)
    assert e.value.exit_code == 75
    assert Snapshots(str(tmp_path)).latest()[2]["completed_iters"] == 6
    resumed = gbt(resume_training=True, **kw).train(d)
    assert same_forest(base, resumed)


def test_resume_refuses_mismatched_config_and_jax_snapshots(tmp_path):
    d = data()
    kw = dict(working_dir=str(tmp_path / "a"),
              resume_training_snapshot_interval_trees=5, num_trees=10,
              validation_ratio=0.0)
    learner = gbt(**kw)
    learner._abort_after_chunks = 1
    with pytest.raises(port_gbt._TrainingAborted):
        learner.train(d)
    with pytest.raises(ValueError, match="different data or "
                       "hyperparameters; refusing to resume"):
        gbt(resume_training=True, **dict(kw, max_depth=4)).train(d)
    # A snapshot of the JAX package (no port format in its metadata).
    other = str(tmp_path / "b")
    Snapshots(other).save(5, {"carry_0": np.zeros(3)},
                          meta={"completed_iters": 5, "num_carry": 1,
                                "fingerprint": "x", "chunk_starts": [0]})
    with pytest.raises(ValueError, match="not written by ydf_tpu_torch"):
        gbt(resume_training=True, **dict(kw, working_dir=other)).train(d)


def test_resume_refuses_another_histogram_mode(tmp_path, monkeypatch):
    """A snapshot taken with YDF_TPU_HIST_QUANT=int8 is refused by a
    resume under the default f32 (the mode decides the trees)."""
    d = data()
    kw = dict(working_dir=str(tmp_path / "a"),
              resume_training_snapshot_interval_trees=5, num_trees=10,
              validation_ratio=0.0)
    monkeypatch.setenv("YDF_TPU_HIST_QUANT", "int8")
    learner = gbt(**kw)
    learner._abort_after_chunks = 1
    with pytest.raises(port_gbt._TrainingAborted):
        learner.train(d)
    monkeypatch.delenv("YDF_TPU_HIST_QUANT")
    with pytest.raises(ValueError, match="refusing to resume"):
        gbt(resume_training=True, **kw).train(d)


def test_the_fingerprint_hashes_the_mode_only_off_f32(monkeypatch):
    """Under the default f32 the histogram mode is left out of the
    fingerprint, so snapshots written before the mode was hashed still
    resume; every other mode is hashed, and the three differ."""
    import types

    seen = []
    real = port_gbt.hashlib.sha1

    class Recorder:
        def __init__(self):
            self.h = real()

        def update(self, b):
            seen.append(bytes(b))
            self.h.update(b)

        def hexdigest(self):
            return self.h.hexdigest()

    monkeypatch.setattr(port_gbt.hashlib, "sha1", Recorder)
    binner = types.SimpleNamespace(boundaries=np.zeros((2, 3), np.float32))
    labels, weights = np.zeros(4, np.float32), np.ones(4, np.float32)
    fps = {}
    for quant in ("f32", "int8", "bf16x2"):
        seen.clear()
        fps[quant] = gbt()._fingerprint(labels, weights, binner, 4, 0, quant)
        assert (quant.encode() in seen) == (quant != "f32")
    assert len(set(fps.values())) == 3


def test_real_sigterm_in_a_subprocess(tmp_path):
    """A SIGTERM delivered by the OS while the checkpointed loop runs:
    the process ends with TrainingPreempted (the script exits with its
    exit_code) and leaves a resumable snapshot, which resumes to the
    uninterrupted trees."""
    wd = str(tmp_path / "wd")
    script = textwrap.dedent(f"""
        import os, sys, time
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {os.path.join(REPO, "tests")!r})
        from test_torch_checkpoint import data, gbt
        from ydf_tpu_torch.learners import gbt as port_gbt
        note = port_gbt._note_chunk

        def slow(*a, **k):
            note(*a, **k)
            open({wd + ".chunk"!r}, "a").close()
            time.sleep(0.5)

        port_gbt._note_chunk = slow
        try:
            gbt(working_dir={wd!r}, resume_training_snapshot_interval_trees=2,
                num_trees=24, validation_ratio=0.0).train(data())
        except port_gbt.TrainingPreempted as e:
            print("preempted", e)
            sys.exit(e.exit_code)
        print("finished")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen([sys.executable, "-c", script], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    import time

    t0 = time.monotonic()
    while not os.path.exists(wd + ".chunk"):
        assert p.poll() is None, p.communicate()
        assert time.monotonic() - t0 < 120, "no chunk in 120 s"
        time.sleep(0.05)
    p.send_signal(15)  # SIGTERM
    out, err = p.communicate(timeout=120)
    assert p.returncode == 75, (p.returncode, out, err)
    assert "preempted by SIGTERM" in out
    done = Snapshots(wd).latest()[2]["completed_iters"]
    assert 0 < done < 24
    kw = dict(working_dir=wd, resume_training_snapshot_interval_trees=2,
              num_trees=24, validation_ratio=0.0)
    resumed = gbt(resume_training=True, **kw).train(data())
    base = gbt(num_trees=24, validation_ratio=0.0).train(data())
    assert same_forest(base, resumed)


# ---- deadlines ---------------------------------------------------------


def test_gbt_deadline_keeps_a_prefix():
    """A deadline already past when the first chunk ends keeps that
    chunk's 25 trees, the first 25 of the full run's."""
    d = data()
    kw = dict(num_trees=40, validation_ratio=0.0, early_stopping="NONE")
    full = gbt(**kw).train(d)
    cut = gbt(maximum_training_duration=1e-6, **kw).train(d)
    assert cut.training_logs["num_trees"] == 25
    fc, ff = cut.forest.to_numpy(), full.forest.to_numpy()
    for k in fc:
        assert fc[k].tobytes() == ff[k][:25].tobytes(), k
    assert np.isfinite(np.asarray(cut.predict(d))).all()


def test_gbt_generous_deadline_changes_nothing():
    d = data(800)
    kw = dict(num_trees=10, validation_ratio=0.0, early_stopping="NONE")
    assert same_forest(gbt(**kw).train(d),
                       gbt(maximum_training_duration=3600.0, **kw).train(d))


@pytest.mark.parametrize("limit", [1e-6, 3600.0])
def test_rf_deadline_keeps_a_prefix(limit):
    """The random forest stops at the first chunk of 25 trees past the
    deadline; a generous one keeps all 40; either way a prefix of the
    full forest, tree for tree."""
    d = data(1000)
    kw = dict(label="label", num_trees=40, max_depth=6, device="cpu")
    full = ydf_tpu_torch.RandomForestLearner(**kw).train(d)
    cut = ydf_tpu_torch.RandomForestLearner(
        maximum_training_duration=limit, **kw).train(d)
    T = cut.forest.num_trees
    assert T == (25 if limit < 1 else 40)
    fc, ff = cut.forest.to_numpy(), full.forest.to_numpy()
    for k in fc:
        assert fc[k].tobytes() == ff[k][:T].tobytes(), k


@pytest.mark.gpu
def test_resume_and_deadline_on_card(tmp_path):
    """On the card: kill and resume equals the uninterrupted card run,
    and a deadline keeps a prefix of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    d = data()
    kw = dict(label="label", num_trees=12, max_depth=3,
              validation_ratio=0.0)
    base = ydf_tpu_torch.GradientBoostedTreesLearner(**kw).train(d)
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(
        working_dir=str(tmp_path), resume_training_snapshot_interval_trees=5,
        **kw)
    learner._abort_after_chunks = 1
    with pytest.raises(port_gbt._TrainingAborted):
        learner.train(d)
    resumed = ydf_tpu_torch.GradientBoostedTreesLearner(
        working_dir=str(tmp_path), resume_training=True,
        resume_training_snapshot_interval_trees=5, **kw).train(d)
    assert same_forest(base, resumed)
