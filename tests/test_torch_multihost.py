"""The port's per-rank input pipeline (`train.multihost`), its multi-process
scripts (`scripts/multihost_sim.py`, `eval/scaling_bench.py`) and
`train_cli --mesh_data` on the CPU.

`process_local_rows`, `global_pad_width` and `collate(pad_to=)` against the
JAX package's. One spawn of two gloo processes (`tests/torch_dist_jobs.py`)
runs, each over its own FileStore group: `multihost_sim` (the JAX script's
rows; one replicated and one ZeRO-1 step), which must agree across the
ranks and with the one-process run on the whole batch (loss 1e-6 apart
between ranks, 2e-5 against one process, parameter checksums 1e-5
relative); `scaling_bench` at 2 ranks (a tiny DiT, its JSON lines);
`train_cli --mesh_data 2` on the prepared tiny corpus, whose checkpoint
must equal the one `train_cli` writes in one process at twice the frame
budget and warm-up (within 2e-5).
"""

import re

import numpy as np
import pytest
import torch

from f5tts_tpu.train import dataset as jds
from f5tts_tpu.train import multihost as jmh
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.parallel.mesh import Mesh
from f5tts_tpu_torch.scripts import multihost_sim
from f5tts_tpu_torch.train import dataset as tds
from f5tts_tpu_torch.train import multihost as tmh
from f5tts_tpu_torch.train import train_cli
from f5tts_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_torch_dit import one_torch_thread  # noqa: F401
from tests.test_torch_train_cli import _yaml, data_root  # noqa: F401
from tests.torch_dist_jobs import spawn

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RESULT = re.compile(
    r"RESULT loss=([\d.eE+-]+) cksum=([\d.eE+-]+) rows=(\d+):(\d+) devices=(\d+)"
    r" z_loss=([\d.eE+-]+) z_cksum=([\d.eE+-]+) z_dist=(\d) z_local=(\d+)")
SCALING_ARCH = dict(dim=128, heads=2, depth=2, text_dim=64, conv_layers=1)


@pytest.fixture(scope="module")
def ranks(data_root, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("multihost")
    cfg = _yaml(tmp / "mesh.yaml", tmp / "ckpt_mesh")
    payload = {"scaling_arch": SCALING_ARCH,
               "train_cli_argv": ["--config", cfg, "--data_root", str(data_root),
                                  "--max_updates", "2"]}
    return spawn("multihost", 2, tmp, payload), tmp


def test_process_local_rows_and_pad_width_match_jax():
    from f5tts_tpu.parallel.mesh import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    jrows = jmh.process_local_rows(NamedSharding(make_mesh(data=4, model=2), P("data")), 8)
    assert tmh.process_local_rows(None, 8) == jrows == slice(0, 8)
    assert tmh.process_local_rows(Mesh(1, 2, 1), 8) == slice(0, 8)
    got = [tmh.process_local_rows(Mesh(4, 2, r), 8) for r in range(8)]
    assert got == [slice(r // 2 * 2, r // 2 * 2 + 2) for r in range(8)]
    with pytest.raises(ValueError, match="do not split"):
        tmh.process_local_rows(Mesh(3, 1, 0), 8)
    for est, kw in (([100.2, 317.9], {}), ([64.0], {}), ([1000.0], {"max_frames": 512}),
                    ([0.5, 63.1], {"bucket_frames": 32})):
        assert tmh.global_pad_width(est, **kw) == jmh.global_pad_width(est, **kw)


def test_resolve_device_takes_torchrun_local_rank(monkeypatch):
    """Under torchrun each process trains on card LOCAL_RANK."""
    from f5tts_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert resolve_device() == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device() == torch.device("cuda", 3)
    assert resolve_device("cpu") == torch.device("cpu")


def test_collate_pad_to_matches_jax():
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((t, 4)).astype(np.float32) for t in (50, 70, 3)]
    for pad_to in (128, 64, None):
        want = jds.collate([jds.Sample(mel=m, text=str(i)) for i, m in enumerate(mels)],
                           pad_to=pad_to)
        got = tds.collate([tds.Sample(mel=m, text=str(i)) for i, m in enumerate(mels)],
                          pad_to=pad_to)
        np.testing.assert_array_equal(got["mel"], want["mel"])
        np.testing.assert_array_equal(got["mel_lengths"], want["mel_lengths"])
        assert got["text"] == want["text"]


def test_multihost_sim_two_processes_match_one(ranks, capsys):
    results = [RESULT.search(out["sim_line"]) for out in ranks[0]]
    assert all(results)
    assert sorted((int(r.group(3)), int(r.group(4))) for r in results) == [(0, 4), (4, 8)]
    assert {r.group(5) for r in results} == {"2"}
    losses = [float(r.group(1)) for r in results]
    cksums = [float(r.group(2)) for r in results]
    assert losses[0] == pytest.approx(losses[1], abs=1e-6)
    assert cksums[0] == pytest.approx(cksums[1], rel=1e-6)
    for r in results:  # ZeRO-1: each process holds half the moments
        assert r.group(8) == "1"
        assert float(r.group(6)) == pytest.approx(losses[0], abs=2e-5)
        assert float(r.group(7)) == pytest.approx(cksums[0], rel=1e-5)
    multihost_sim.main(["--device", "cpu"])  # the one-process oracle, its CLI
    oracle = RESULT.search(capsys.readouterr().out)
    assert oracle and oracle.group(5) == "1" and (oracle.group(3), oracle.group(4)) == ("0", "8")
    assert losses[0] == pytest.approx(float(oracle.group(1)), abs=2e-5)
    assert cksums[0] == pytest.approx(float(oracle.group(2)), rel=1e-5)
    assert int(results[0].group(9)) * 2 == int(oracle.group(9))
    assert oracle.group(8) == "0"


def test_scaling_bench_two_ranks(ranks):
    lines, other = ranks[0][0]["scaling"], ranks[0][1]["scaling"]
    assert other == [] and [line["mode"] for line in lines] == ["sample", "train"]
    for line in lines:
        assert line["devices"] == 2 and line["batch"] == 4 and line["device"] == "cpu"
        assert line["wall_s"] > 0 and line["throughput_1"] > 0
        assert isinstance(line["scaling_efficiency"], float) and line["scaling_efficiency"] > 0
        assert line["arch_overrides"] == SCALING_ARCH


def test_train_cli_mesh_data_2_writes_the_one_process_checkpoint(ranks, data_root,  # noqa: F811
                                                                 tmp_path):
    _, tmp = ranks
    cfg = _yaml(tmp_path / "one.yaml", tmp_path / "ckpt_one")
    train_cli.main(["--config", cfg, "--data_root", str(data_root), "--max_updates", "2",
                    "--device", "cpu", "datasets.batch_size_per_gpu=600",
                    "optim.num_warmup_updates=4"])
    one = CheckpointManager(str(tmp_path / "ckpt_one")).restore(device="cpu")
    two = CheckpointManager(str(tmp / "ckpt_mesh")).restore(device="cpu")
    assert (two.step, two.count) == (one.step, one.count) == (2, 2)
    for name in ("params", "mu", "nu", "ema"):
        for a, b in zip(tm.tree_leaves(getattr(two, name)), tm.tree_leaves(getattr(one, name))):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5, err_msg=name)
    assert isinstance(torch.load(tmp / "ckpt_mesh" / "last" / "model_2.pt",
                                 weights_only=True)["params"], dict)
