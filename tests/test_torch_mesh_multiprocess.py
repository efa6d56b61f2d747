"""Training on a mesh across two processes on ydf_tpu_torch (the
counterpart of tests/test_multihost.py): two OS processes joined by
init_distributed over torch.distributed's gloo backend on localhost,
each holding two data shards on the CPU (four in all), train the same
GBT and random forest; every tree and prediction equals the one-process
run, on one device and on a mesh of four shards. The layer histograms
merge across the processes by an all-gather summed in rank order, the
leaf ids by an all-gather in rank order.

The card's counterpart (NCCL with a process a card, or gloo with both
processes on one card) runs in chip_smoke.py's phase 19.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import ydf_tpu_torch
from ydf_tpu_torch.parallel import mesh as pmesh
from test_torch_mesh import binary_data, tree_hashes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOCAL_SHARDS = 2
GBT_HP = dict(label="y", num_trees=4, max_depth=4, random_seed=7)
RF_HP = dict(label="y", num_trees=4, max_depth=5, random_seed=31)

_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[4])
    import ydf_tpu_torch
    from ydf_tpu_torch.parallel import mesh as pmesh
    from test_torch_mesh import binary_data, tree_hashes

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    assert pmesh.init_distributed(f"127.0.0.1:{{port}}", {world}, rank,
                                  backend="gloo") == rank
    # Idempotent: a second call is a no-op.
    assert pmesh.init_distributed() == rank
    mesh = pmesh.make_mesh(["cpu"] * {local})
    assert (mesh.rank, mesh.world, mesh.data_shards) == (rank, {world},
                                                         {world} * {local})
    d = binary_data(n=1001, seed=5)   # the same data in every process
    res = {{}}
    for name, cls, hp in (
            ("gbt", ydf_tpu_torch.GradientBoostedTreesLearner, {gbt}),
            ("rf", ydf_tpu_torch.RandomForestLearner, {rf})):
        m = cls(mesh=mesh, **hp).train(d)
        res[name] = {{"hashes": tree_hashes(m),
                     "pred": m.predict(d).tolist()}}
    with open(out, "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
""").format(world=WORLD, local=LOCAL_SHARDS, gbt=GBT_HP, rf=RF_HP)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_mesh_equals_one_process(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    outs = [tmp_path / f"rank{r}.json" for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(outs[r]),
         os.path.join(REPO, "tests")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = [json.loads(o.read_text()) for o in outs]
    d = binary_data(n=1001, seed=5)
    one_mesh = pmesh.make_mesh(["cpu"] * (WORLD * LOCAL_SHARDS))
    for name, cls, hp in (
            ("gbt", ydf_tpu_torch.GradientBoostedTreesLearner, GBT_HP),
            ("rf", ydf_tpu_torch.RandomForestLearner, RF_HP)):
        single = cls(device="cpu", **hp).train(d)
        meshed = cls(mesh=one_mesh, **hp).train(d)
        want = tree_hashes(single)
        assert tree_hashes(meshed) == want, name
        for r in range(WORLD):
            assert got[r][name]["hashes"] == want, (name, r)
            assert np.array_equal(
                np.asarray(got[r][name]["pred"], np.float32),
                single.predict(d)), (name, r)


def test_init_distributed_refuses_what_it_cannot_do():
    """No backend, no cluster facts, NCCL without CUDA or with more
    processes than cards on one host: each raises naming its cause."""
    with pytest.raises(ValueError, match="backend='nccl' or backend='gloo'"):
        pmesh.init_distributed("127.0.0.1:1", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="nothing detects a cluster"):
        pmesh.init_distributed(backend="gloo")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.init_distributed("127.0.0.1:1", 2, 0, backend="nccl")
    elif torch.cuda.device_count() < 8:
        with pytest.raises(ValueError, match="one card a process"):
            pmesh.init_distributed("127.0.0.1:1", 8, 0, backend="nccl")
