"""The port's multi-process helpers (``sonar_tpu_torch.parallel.multihost``),
the counterpart of ``tests/unit/test_multihost.py``.

Two worker processes (``tests/torch_port_mesh_worker.py``) join one gloo
group through ``initialize(init_method="file://...")``, take their share
of a work list, assemble a global batch from their local rows, encode it
with the toy encoder over the 2 x 1 mesh they span and mine with the bank
split over it; each result is held against the single-device port. In this
process: ``initialize()`` is a no-op without a launcher, and the launcher
detection reads the SLURM, Open MPI, PMI and torchrun variables.
"""

from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from torch_port_mesh_worker import run_world  # noqa: E402

from sonar_tpu.models.sonar_text import SonarTextEncoder, sonar_text_encoder_archs  # noqa: E402
from sonar_tpu_torch.assets.checkpoint import save_params  # noqa: E402
from sonar_tpu_torch.assets.convert import text_encoder_from_numpy  # noqa: E402
from sonar_tpu_torch.data.collate import SequenceBatch  # noqa: E402
from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder  # noqa: E402
from sonar_tpu_torch.models.sonar_text import (  # noqa: E402
    sonar_text_encoder_archs as port_archs,
)
from sonar_tpu_torch.parallel import mining, multihost as mh  # noqa: E402

LAUNCH_VARS = ("WORLD_SIZE", "RANK", "SLURM_NTASKS", "SLURM_NPROCS", "SLURM_PROCID",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "PMI_SIZE", "PMI_RANK")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One world of two gloo ranks for the module's cases, and its inputs."""
    tmp = tmp_path_factory.mktemp("multihost")
    params = jax.tree_util.tree_map(np.asarray, SonarTextEncoder(
        sonar_text_encoder_archs.get("toy")).init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    data = {"seqs": rng.integers(4, 1000, size=(4, 8)).astype(np.int32),
            "lens": np.asarray([8, 5, 8, 3], np.int32),
            "x_bank": rng.normal(size=(16, 8)).astype(np.float32),
            "y_bank": rng.normal(size=(24, 8)).astype(np.float32)}
    save_params(tmp / "inputs.npz", {"encoder": params, "data": data})
    return {"ranks": run_world("multihost", 2, tmp), "params": params, **data}


def test_multihost_workers_coordinate(world):
    seqs, lens, x_bank, y_bank = (world[k] for k in ("seqs", "lens", "x_bank", "y_bank"))
    emb = TorchTextEncoder(text_encoder_from_numpy(world["params"], port_archs.get("toy")),
                           device="cpu").encode_batch(
        SequenceBatch(seqs=seqs, seq_lens=lens, true_batch=4))
    scores, idx = mining.cosine_topk(x_bank, y_bank, 4, device="cpu")
    mined = mining.mine_bitexts(x_bank, y_bank, k=4, device="cpu")
    local = [np.full((2, 4), float(2 * r), np.float32) + np.arange(2)[:, None] for r in range(2)]
    for rank, out in enumerate(world["ranks"]):
        np.testing.assert_array_equal(out["shard"], list(range(10))[rank::2])
        np.testing.assert_array_equal(out["global"], np.concatenate(local))
        np.testing.assert_array_equal(out["seqs"], seqs)
        np.testing.assert_allclose(out["emb"], emb, atol=1e-6)
        np.testing.assert_array_equal(out["topk_idx"], idx.numpy())
        np.testing.assert_allclose(out["topk_scores"], scores.numpy(), atol=1e-6)
        for got, want in zip((out["mine"]["src"], out["mine"]["tgt"], out["mine"]["sc"]), mined):
            np.testing.assert_allclose(got, want, atol=1e-6)
        assert len(out["mine"]["src"]) > 0


def test_replicate_gives_every_rank_rank_zeros_leaves(world):
    # Each rank starts from leaves of its own (rank + 1 in every element);
    # after replicate every rank holds rank 0's, in every dtype.
    for out in world["ranks"]:
        rep = out["replicated"]
        np.testing.assert_array_equal(rep["a"]["b"], np.ones((3,), np.float32))
        np.testing.assert_array_equal(rep["a"]["half"], np.ones((2, 2), np.float32))
        np.testing.assert_array_equal(rep["c"], np.arange(4))
        assert rep["c"].dtype == np.int64


def test_initialize_noop_without_coordinator(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    mh.initialize()
    assert not torch.distributed.is_initialized()
    assert mh.shard_for_host([1, 2, 3]) == [1, 2, 3]


@pytest.mark.parametrize("size,rank", [
    ("WORLD_SIZE", "RANK"), ("SLURM_NTASKS", "SLURM_PROCID"), ("SLURM_NPROCS", "SLURM_PROCID"),
    ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"), ("PMI_SIZE", "PMI_RANK")])
def test_multiprocess_cluster_env_detection(monkeypatch, size, rank):
    for var in LAUNCH_VARS + ("TPU_WORKER_HOSTNAMES",):
        monkeypatch.delenv(var, raising=False)
    assert not mh._multiprocess_cluster_env()
    # A Cloud TPU pod's hostnames are a TPU launcher's: not read here.
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host-0,host-1")
    assert not mh._multiprocess_cluster_env()
    # A single-task launch exports the variables too: not a cluster.
    monkeypatch.setenv(size, "1")
    assert not mh._multiprocess_cluster_env()
    monkeypatch.setenv(size, "4")
    monkeypatch.setenv(rank, "3")
    assert mh._multiprocess_cluster_env()
    assert mh._cluster_rank_world() == (3, 4)
    monkeypatch.setenv(size, "not a number")
    assert not mh._multiprocess_cluster_env()
