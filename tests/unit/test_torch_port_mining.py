"""The port's single-device mining against ``sonar_tpu.parallel.mining``.

Seeded numpy banks (a few hundred rows, D 64; a third of the queries noisy
copies of bank rows; optionally 30 bank rows duplicated in a later block,
so that ties are real) go through both packages on the CPU, at block sizes
that leave a zero-padded tail. Tolerances:

- fp32: scores within 1e-5 (two frameworks summing 64 products in another
  order); indices equal except in rows whose top k + 1 JAX scores hold two
  within 1e-6 but not equal (a near tie either may break);
- int8: indices identical, scores within 1e-6 (the int8 codes are identical;
  the row scales may differ in the last bit of the norm);
- bf16: scores within 1e-2, indices as recall >= 0.99;
- ``approx=True`` as the same mode without it, against JAX's
  ``approx=True`` (exact off a TPU);
- in every mode, equal scores in one of the port's rows come in ascending
  bank order (``lax.top_k``'s tie order);
- ``xsim`` / ``xsim_pp``: equal error rates; ``mine_bitexts``: identical
  pairs, scores within 1e-5.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.parallel import mining as jm  # noqa: E402
from sonar_tpu_torch.ops.topk import top_k  # noqa: E402
from sonar_tpu_torch.parallel import mining as tm  # noqa: E402

D, K = 64, 5
JAX_DOT = {"fp32": None, "bf16": jnp.bfloat16, "int8": "int8"}
PORT_DOT = {"fp32": None, "bf16": torch.bfloat16, "int8": "int8"}


def _banks(duplicated: bool, n: int = 120, m: int = 300, seed: int = 0):
    rng = np.random.default_rng(seed)
    bank = rng.normal(size=(m, D)).astype(np.float32)
    if duplicated:
        bank[200:230] = bank[0:30]  # rows of block 0 again in block 3 (block size 64)
    q = rng.normal(size=(n, D)).astype(np.float32)
    planted = rng.integers(0, m, n // 3)
    q[: n // 3] = bank[planted] + 0.3 * rng.normal(size=(n // 3, D)).astype(np.float32)
    if duplicated:
        q[n // 3: n // 3 + 10] = bank[0:10]  # exact copies of duplicated rows
    return q, bank


def _jax_topk(q, bank, k, block, mode, approx):
    s, i = jm.cosine_topk(jnp.asarray(q), jnp.asarray(bank), k, block_size=block,
                          dot_dtype=JAX_DOT[mode], approx=approx)
    return np.asarray(s), np.asarray(i)


def _assert_tie_order(scores: np.ndarray, idx: np.ndarray) -> None:
    tied = scores[:, 1:] == scores[:, :-1]
    assert (idx[:, 1:][tied] > idx[:, :-1][tied]).all()


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("duplicated", [False, True], ids=["random", "duplicated-rows"])
@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
def test_cosine_topk_matches_jax(mode, duplicated, approx):
    q, bank = _banks(duplicated)
    block = 64  # 300 rows: four full blocks and a tail of 44 rows
    js, ji = _jax_topk(q, bank, K, block, mode, approx)
    ts, ti = tm.cosine_topk(q, bank, K, block_size=block, dot_dtype=PORT_DOT[mode],
                            approx=approx, device="cpu")
    assert ts.dtype == torch.float32 and ti.dtype == torch.int64
    ts, ti = ts.numpy(), ti.numpy()
    _assert_tie_order(ts, ti)
    if mode == "fp32":
        np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
        ref, _ = _jax_topk(q, bank, K + 1, block, mode, approx)
        gaps = np.diff(-ref, axis=1)
        near = ((gaps > 0) & (gaps <= 1e-6)).any(axis=1)  # exact ties must break alike
        np.testing.assert_array_equal(ti[~near], ji[~near])
        assert near.sum() <= 2
    elif mode == "int8":
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(ts, js, atol=1e-2, rtol=0)
        recall = np.mean([len(set(a) & set(b)) / K for a, b in zip(ti, ji)])
        assert recall >= 0.99, recall


@pytest.mark.parametrize("block,n_bank,k", [
    (64, 300, 5), (128, 300, 5), (1000, 300, 5), (4, 30, 5), (16, 3, 5), (7, 50, 1)],
    ids=["tail44", "tail44-wide", "one-block", "k-over-block", "k-over-bank", "top1-tail1"])
def test_cosine_topk_block_sizes_match_jax(block, n_bank, k):
    """Blocks narrower than k (each block's top min(k, block)), a bank
    smaller than k (-inf scores fill the list, JAX's index order kept), and
    a one-row tail; int8, whose scores are exact, so indices must match."""
    q, bank = _banks(True, n=40, m=300)
    bank = bank[:n_bank]
    js, ji = _jax_topk(q, bank, k, block, "int8", False)
    ts, ti = tm.cosine_topk(q, bank, k, block_size=block, dot_dtype="int8", device="cpu")
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-6, rtol=0)


@pytest.mark.parametrize("select", ["_top_k_exact", "_block_top_k"])
def test_selection_is_lax_top_k(select):
    """Both selectors against ``lax.top_k``: rows full of ties and -inf;
    rows of distinct values but for ties inside the top k (the k-th value
    unique: ``_block_top_k`` orders ``torch.topk``'s k without falling back);
    and signed zeros (``lax.top_k`` ranks -0.0 below +0.0). Without signed
    zeros both are also the port's sort-based ``top_k``."""
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, size=(64, 200)).astype(np.float32) / 4.0
    x[1::7, 150:] = -np.inf
    x[2] = -np.inf
    inner = rng.permutation(64 * 200).reshape(64, 200).astype(np.float32)
    top = inner.argmax(axis=1)
    inner[np.arange(64), (top + 7) % 200] = inner.max(axis=1)  # the top value three times
    inner[np.arange(64), (top + 150) % 200] = inner.max(axis=1)
    signed = x.copy()
    signed[::5, ::3] = -0.0
    for k in (1, 5, 40, 200):
        for rows in (x, inner, signed):
            want_v, want_i = jax.lax.top_k(jnp.asarray(rows), k)
            got_v, got_i = getattr(tm, select)(torch.tensor(rows), k)
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
            assert (np.signbit(got_v.numpy()) == np.signbit(np.asarray(want_v))).all()
        for rows in (x, inner):
            np.testing.assert_array_equal(getattr(tm, select)(torch.tensor(rows), k)[1].numpy(),
                                          top_k(torch.tensor(rows), k)[1].numpy())


def test_exact_selection_in_chunks(monkeypatch):
    """``_top_k_exact`` makes its int64 keys a few rows at a time: the same
    result when every chunk is 1, 3 or 64 rows."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.integers(-3, 4, size=(64, 200)).astype(np.float32))
    want = tm._top_k_exact(x, 7)
    for keys in (200, 600, 64 * 200):
        monkeypatch.setattr(tm, "_SELECT_KEYS", keys)
        got = tm._top_k_exact(x, 7)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_normalize_and_int8_codes_match_jax():
    _, bank = _banks(False)
    want = jm.l2_normalize(jnp.asarray(bank))
    got = tm.l2_normalize(torch.tensor(bank))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=0)
    wq, ws = jm._quant_rows_int8(want)
    gq, gs = tm._quant_rows_int8(got)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)


def _parallel(n=150, extra=30, noise=0.6, seed=5):
    """x [n, D] and y [n + extra, D]: y's first n rows noisy translations of
    x's, shuffled by ``perm`` for mining, the rest unrelated."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = x + noise * rng.normal(size=(n, D)).astype(np.float32)
    other = rng.normal(size=(extra, D)).astype(np.float32)
    return x, y, other


@pytest.mark.parametrize("margin", ["ratio", "distance", "absolute"])
@pytest.mark.parametrize("k", [4, 1, 500], ids=["k4", "k1", "k-over-rows"])
def test_xsim_and_xsim_pp_match_jax(margin, k):
    x, y, distractors = _parallel(noise=2.0)  # ~10% of rows misaligned at k 4
    want = jm.xsim(x, y, k=k, margin=margin)
    assert tm.xsim(x, y, k=k, margin=margin, device="cpu") == want
    want_pp = jm.xsim_pp(x, y, distractors, k=k, margin=margin)
    assert tm.xsim_pp(x, y, distractors, k=k, margin=margin, device="cpu") == want_pp
    assert want > 0.0 and want_pp > 0.0


@pytest.mark.parametrize("threshold", [None, "median"])
@pytest.mark.parametrize("margin", ["ratio", "distance", "absolute"])
@pytest.mark.parametrize("strategy", ["forward", "backward", "intersection", "union"])
def test_mine_bitexts_matches_jax(strategy, margin, threshold):
    x, y, other = _parallel(noise=1.0)
    perm = np.random.default_rng(9).permutation(len(y) + len(other))
    y = np.concatenate([y, other])[perm]
    want = jm.mine_bitexts(x, y, k=4, margin=margin, strategy=strategy)
    thr = None if threshold is None else float(np.median(want[2]))
    if thr is not None:
        want = jm.mine_bitexts(x, y, k=4, margin=margin, strategy=strategy, threshold=thr)
    got = tm.mine_bitexts(x, y, k=4, margin=margin, strategy=strategy, threshold=thr,
                          device="cpu")
    assert 0 < len(want[0]) and (thr is None or len(want[0]) < len(x) + len(y))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    assert got[0].dtype == got[1].dtype == np.int64


def test_mine_bitexts_int8_approx_matches_jax():
    """The large-bank throughput mode (int8 products, approx selection)."""
    x, y, _ = _parallel(noise=1.0)
    want = jm.mine_bitexts(x, y, dot_dtype="int8", approx=True)
    got = tm.mine_bitexts(x, y, dot_dtype="int8", approx=True, device="cpu")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)


def test_mine_bitexts_rejects_what_it_does_not_have():
    x, y, _ = _parallel(n=8, extra=0)
    from sonar_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="unknown mesh axis"):
        tm.mine_bitexts(x, y, mesh=make_mesh(1, 1), axis="rows", device="cpu")
    with pytest.raises(ValueError, match="unknown strategy"):
        tm.mine_bitexts(x, y, strategy="both", device="cpu")
    with pytest.raises(ValueError, match="unknown margin"):
        tm.mine_bitexts(x, y, margin="cosine", device="cpu")
    with pytest.raises(ValueError, match="dot_dtype"):
        tm.cosine_topk(x, y, 2, dot_dtype=torch.int32, device="cpu")


def test_inputs_may_be_tensors():
    q, bank = _banks(False, n=20, m=100)
    want = tm.cosine_topk(q, bank, K, block_size=32, device="cpu")
    got = tm.cosine_topk(torch.tensor(q, dtype=torch.float64), torch.tensor(bank), K,
                         block_size=32, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
