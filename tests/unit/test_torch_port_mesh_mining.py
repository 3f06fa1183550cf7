"""The port's sharded mining against ``sonar_tpu`` and the single-device port.

One gloo world of 4 ranks (``tests/torch_port_mesh_worker.py``) splits the
bank over the data axis of (4, 1) and (2, 2) and over the model axis of
(1, 4); this process computes JAX's dense and sharded results (on its
1-D mesh of 8 CPU devices) and the single-device port's.

- ``sharded_cosine_topk``: a bank of 102 rows (4 blocks of 26, two rows of
  padding) and a bank whose rows 5, 31 and 57 are equal, the same offset
  in three blocks, so the candidates tie across blocks: scores within 1e-5,
  indices equal (the lower block wins a tie, as in ``lax.top_k``);
- ``sharded_xsim`` / ``sharded_xsim_pp``: equal to dense xsim / xsim++
  (fp32, and int8 with ``approx``);
- ``mine_bitexts(mesh=)``: forward, intersection and union within 1e-5 of
  the single-device port.
"""

from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from torch_port_mesh_worker import run_world  # noqa: E402

from sonar_tpu.parallel import mining as jmining  # noqa: E402
from sonar_tpu_torch.assets.checkpoint import save_params  # noqa: E402
from sonar_tpu_torch.parallel import mining  # noqa: E402

CASES = [("4x1", "data"), ("1x4", "model"), ("2x2", "data")]
NAMES = [name for name, _ in CASES]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_mining")
    rng = np.random.default_rng(1)
    ragged_q = rng.normal(size=(16, 32)).astype(np.float32)
    ragged_bank = rng.normal(size=(102, 32)).astype(np.float32)
    ties_bank = rng.normal(size=(102, 32)).astype(np.float32)
    ties_bank[31] = ties_bank[57] = ties_bank[5]
    ties_q = (ties_bank[[5] * 4 + [10, 40, 70, 99]] + 0.05 * rng.normal(size=(8, 32))).astype(
        np.float32)
    base = rng.normal(size=(64, 32)).astype(np.float32)
    xsim_x = base + 0.1 * rng.normal(size=base.shape).astype(np.float32)
    xsim_y = base + 0.1 * rng.normal(size=base.shape).astype(np.float32)
    pp_base = rng.normal(size=(48, 16)).astype(np.float32)
    pp_x = pp_base + 0.05 * rng.normal(size=(48, 16)).astype(np.float32)
    pp_y = pp_base + 0.05 * rng.normal(size=(48, 16)).astype(np.float32)
    pp_y[:4] = rng.normal(size=(4, 16)).astype(np.float32)
    pp_d = rng.normal(size=(16, 16)).astype(np.float32)
    mine_x = rng.normal(size=(24, 32)).astype(np.float32)
    mine_y = rng.normal(size=(40, 32)).astype(np.float32)
    data = {"ragged_q": ragged_q, "ragged_bank": ragged_bank, "ties_q": ties_q,
            "ties_bank": ties_bank, "xsim_x": xsim_x, "xsim_y": xsim_y, "pp_x": pp_x,
            "pp_y": pp_y, "pp_d": pp_d, "mine_x": mine_x, "mine_y": mine_y}
    save_params(tmp / "inputs.npz", {"data": data})
    ranks = run_world("mining", 4, tmp)

    mesh1d = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("data",))
    jax_ref = {}
    for case in ("ragged", "ties"):
        q, bank = data[f"{case}_q"], data[f"{case}_bank"]
        jax_ref[case] = [np.asarray(t) for t in jmining.cosine_topk(q, bank, 5)]
        jax_ref[f"{case}_sharded"] = [np.asarray(t) for t in jmining.sharded_cosine_topk(
            q, bank, 5, mesh1d)]
    jax_ref["xsim"] = jmining.xsim(xsim_x, xsim_y)
    jax_ref["xsim_pp"] = jmining.xsim_pp(pp_x, pp_y, pp_d)
    port = {case: [t.numpy() for t in mining.cosine_topk(
        data[f"{case}_q"], data[f"{case}_bank"], 5, device="cpu")] for case in ("ragged", "ties")}
    port["xsim"] = mining.xsim(xsim_x, xsim_y, device="cpu")
    port["xsim_pp"] = mining.xsim_pp(pp_x, pp_y, pp_d, device="cpu")
    for strategy in ("forward", "intersection", "union"):
        port[strategy] = mining.mine_bitexts(mine_x, mine_y, k=3, strategy=strategy,
                                             device="cpu")
    return {"ranks": ranks, "jax": jax_ref, "port": port}


def test_the_tie_case_ties_across_blocks(world):
    """The planted rows give equal top scores (the tie reaches the merge)."""
    scores, idx = world["port"]["ties"]
    assert (scores[:4, 0] == scores[:4, 1]).all() and (scores[:4, 1] == scores[:4, 2]).all()
    np.testing.assert_array_equal(idx[:4, :3], [[5, 31, 57]] * 4)


@pytest.mark.parametrize("case", ["ragged", "ties"])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_cosine_topk_matches_dense(world, name, case):
    for rank, out in enumerate(world["ranks"]):
        got_s, got_i = out[name][f"{case}_scores"], out[name][f"{case}_idx"]
        for ref in (case, f"{case}_sharded"):
            want_s, want_i = world["jax"][ref]
            np.testing.assert_allclose(got_s, want_s, atol=1e-5, err_msg=f"{rank} {ref}")
            np.testing.assert_array_equal(got_i, want_i, err_msg=f"{rank} {ref}")
        want_s, want_i = world["port"][case]
        np.testing.assert_allclose(got_s, want_s, atol=1e-5)
        np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_xsim_matches_dense(world, name):
    for out in world["ranks"]:
        assert float(out[name]["xsim"]) == world["jax"]["xsim"] == world["port"]["xsim"]
        assert float(out[name]["xsim_int8"]) == world["jax"]["xsim"]


@pytest.mark.parametrize("name", NAMES)
def test_sharded_xsim_pp_matches_dense(world, name):
    assert world["jax"]["xsim_pp"] > 0.0
    for out in world["ranks"]:
        assert float(out[name]["xsim_pp"]) == world["jax"]["xsim_pp"] == world["port"]["xsim_pp"]
        assert float(out[name]["xsim_pp_int8"]) == world["jax"]["xsim_pp"]


@pytest.mark.parametrize("strategy", ["forward", "intersection", "union"])
@pytest.mark.parametrize("name", NAMES)
def test_mine_bitexts_sharded_matches_single_device(world, name, strategy):
    want = world["port"][strategy]
    for out in world["ranks"]:
        got = out[name][f"mine_{strategy}"]
        for u, v in zip((got["src"], got["tgt"], got["sc"]), want):
            assert u.shape == v.shape
            np.testing.assert_allclose(u, v, atol=1e-5)
