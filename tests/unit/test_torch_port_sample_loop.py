"""The port's sampling draw and loop against ``sonar_tpu``'s, with no noise hook.

- ``ops.cuda.gumbel_max``'s plain draw (``threefry_bits`` /
  ``threefry_gumbel``) against ``jax.random.bits`` / ``jax.random.gumbel``
  of ``fold_in(PRNGKey(seed), step)`` in JAX's default partitionable threefry
  mode: the bits equal, the noise within 1e-6 (JAX's ``log`` and
  ``torch.log`` differ in the last bit on some elements), over seeds that
  wrap to 32 bits as JAX's key does, steps and widths up to NLLB's 256,206;
- the plain Gumbel-max against ``jax.random.categorical`` on top-k- and
  top-p-filtered rows: the same tokens;
- ``TorchTextDecoder.generate_sample(seed=s)`` against
  ``JitTextDecoder.generate_sample(seed=s)`` with no hook, on the toy and
  ``wide`` decoders of ``test_torch_port_sampling.py`` (3 rows, padded to
  4 by both): tokens and lengths equal and scores within 1e-5, or, where a
  row's tokens differ, a tie: the row's two best noisy scores at the first
  differing step within 1e-5;
- a body step on a done state changes no bit of it;
- a data-2 gloo world (``tests/torch_port_mesh_worker.py``, suite
  ``sample``), each rank drawing its own rows, samples the single rank's
  tokens.
"""

import dataclasses
from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent))
from test_torch_port_sampling import SAMPLERS, _runtimes  # noqa: E402
from torch_port_mesh_worker import run_world  # noqa: E402

from sonar_tpu.generation import sampling as jsampling  # noqa: E402
from sonar_tpu.generation.decoder_runtime import JitTextDecoder  # noqa: E402
from sonar_tpu.models.sonar_text import sonar_text_decoder_archs as jax_archs  # noqa: E402
from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder as JaxDecoder  # noqa: E402
from sonar_tpu_torch.assets.checkpoint import save_params  # noqa: E402
from sonar_tpu_torch.assets.convert import text_decoder_from_numpy  # noqa: E402
from sonar_tpu_torch.generation import sampling  # noqa: E402
from sonar_tpu_torch.generation.beam_search import run_chunks  # noqa: E402
from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder  # noqa: E402
from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs  # noqa: E402
from sonar_tpu_torch.ops.cuda import gumbel_max  # noqa: E402

SEEDS = [0, 2, 123456, 2**32 + 5, -1]


def _jax_key(seed, step):
    return jax.random.fold_in(jax.random.PRNGKey(seed), step)


@pytest.mark.parametrize("v", [1000, 4099, 256206])
@pytest.mark.parametrize("step", [0, 1, 47])
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_gumbel_is_jax_draw(seed, step, v):
    """Rows 1-3 of a [4, V] draw (``row0`` 1): the uniform bits equal to the
    bit, the noise within 1e-6."""
    assert jax.config.jax_threefry_partitionable
    key = _jax_key(seed, step)
    want_bits = np.asarray(jax.random.bits(key, (4, v), jnp.uint32))[1:].astype(np.int64)
    want = np.asarray(jax.random.gumbel(key, (4, v), jnp.float32))[1:]
    words = gumbel_max.prng_key(seed)
    assert words.tolist() == np.asarray(jax.random.PRNGKey(seed)).astype(np.int64).tolist()
    np.testing.assert_array_equal(gumbel_max.threefry_bits(words, step, 1, 3, v).numpy(),
                                  want_bits)
    got = gumbel_max.threefry_gumbel(words, torch.tensor(step), 1, 3, v).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [3, 2**32 + 5])
@pytest.mark.parametrize("jax_sampler,port_sampler", [
    (jsampling.TopKSampler(7), sampling.TopKSampler(7)),
    (jsampling.TopPSampler(0.9), sampling.TopPSampler(0.9)),
    (jsampling.TopPSampler(0.6, max_candidates=40), sampling.TopPSampler(0.6, max_candidates=40)),
], ids=["top_k", "top_p", "top_p_candidates"])
def test_plain_gumbel_max_is_jax_categorical(seed, jax_sampler, port_sampler):
    """The plain Gumbel-max on filtered log-probabilities [8, 4099] samples
    ``jax.random.categorical``'s tokens at steps 0-5."""
    rng = np.random.default_rng(seed % 1000)
    lp = np.log(rng.dirichlet(np.ones(4099) * 0.2, size=8)).astype(np.float32)
    filtered = np.asarray(jax_sampler.filter_logprobs(jnp.asarray(lp)))
    np.testing.assert_array_equal(port_sampler.filter_logprobs(torch.tensor(lp)).numpy(),
                                  filtered)
    for step in range(6):
        want = np.asarray(jax.random.categorical(_jax_key(seed, step), filtered, axis=-1))
        got = gumbel_max.gumbel_max(torch.tensor(filtered), gumbel_max.prng_key(seed),
                                    torch.tensor(step))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


class _Recording:
    """A sampler that keeps each step's filtered log-probabilities."""

    def __init__(self, sampler):
        self.sampler, self.filtered = sampler, []
        self.temperature = getattr(sampler, "temperature", 1.0)

    def filter_logprobs(self, lp):
        out = self.sampler.filter_logprobs(lp)
        self.filtered.append(out.clone())
        return out


def _agree(got, want, filtered, seed, b_pad):
    """Tokens and lengths equal and scores within 1e-5, or, where a row's
    tokens differ, the row's two best noisy scores at the first differing
    step within 1e-5 (a tie either package may break its own way)."""
    (gt, gs, gl), (wt, ws, wl) = got, want
    key = gumbel_max.prng_key(seed)
    for r in range(gt.shape[0]):
        diff = np.flatnonzero(gt[r] != wt[r])
        if diff.size == 0:
            assert gl[r] == wl[r]
            assert abs(gs[r] - ws[r]) <= 1e-5, (r, gs[r], ws[r])
            continue
        step = int(diff[0])
        noisy = filtered[step][r].double() + gumbel_max.threefry_gumbel(
            key, step, 0, b_pad, filtered[step].shape[1])[r].double()
        top2 = torch.topk(noisy, 2).values
        assert float(top2[0] - top2[1]) <= 1e-5, f"row {r} differs from step {step}"


@pytest.mark.parametrize("seed", [11, 2**32 + 5, -1])
@pytest.mark.parametrize("case", SAMPLERS, ids=lambda c: c[0])
@pytest.mark.parametrize("name", ["toy", "wide"])
def test_generate_sample_from_a_seed_matches_jax(name, case, seed):
    """No hook: the port draws JAX's noise itself, over the batch of 3
    padded to 4 as JAX pads it."""
    _, kwargs, gen = case
    jrun, trun = _runtimes(name)
    cls = "TopKSampler" if "k" in kwargs else "TopPSampler"
    rec = _Recording(getattr(sampling, cls)(**kwargs))
    memory = np.random.default_rng(6).normal(size=(3, 1, trun.model.config.model_dim))
    memory = memory.astype(np.float32) * 2.0
    want = jrun.generate_sample(memory, [3, 7], getattr(jsampling, cls)(**kwargs), max_gen_len=9,
                                seed=seed, **gen)
    got = trun.generate_sample(memory, [3, 7], rec, max_gen_len=9, seed=seed, **gen)
    assert got[0].shape == (3, 10) and got[0].dtype == np.int32 and got[2].dtype == np.int32
    _agree(got, want, rec.filtered, seed, 4)
    if gen.get("min_gen_len"):
        assert all(3 not in got[0][r, :2].tolist() for r in range(3))


def test_a_step_on_a_done_state_changes_nothing():
    """Once ``done``, more body steps leave every tensor of the state as it
    was, ``step`` and ``done`` included, though the decoder runs and the
    cache index moves on."""
    _, trun = _runtimes("wide")
    memory = torch.tensor(np.random.default_rng(7).normal(size=(4, 1, 128)), dtype=torch.float32)
    prefix = torch.tensor([[3, 7]] * 4)
    with torch.inference_mode():
        start, step = trun._sample_program(sampling.TopPSampler(0.9), 2, 6, 2)
        state = start(memory, prefix, gumbel_max.prng_key(5))
        run_chunks(state, step, 1)
        assert bool(state.done)
        fields = ("tokens", "scores", "lens", "finished", "step", "logprobs", "done", "key")
        before = {f: getattr(state, f).clone() for f in fields}
        index = int(state.cache.index)
        for _ in range(3):
            step(state)
    assert int(state.cache.index) == index + 3
    for f in fields:
        assert torch.equal(getattr(state, f), before[f]), f


def test_chunked_loop_equals_the_loop_step_by_step():
    """The eager loop reads ``done`` once a chunk: chunks of 1, 3 and 8 give
    the same outputs bit for bit, and the device ran the steps taken
    rounded up to the chunk."""
    _, trun = _runtimes("toy")
    memory = np.random.default_rng(8).normal(size=(5, 1, 32)).astype(np.float32) * 2.0
    outs, ran = {}, {}
    for chunk in (1, 3, 8):
        trun.decode_steps = trun.device_steps = 0
        outs[chunk] = trun._sample_eager(torch.tensor(memory), [3, 7], sampling.TopPSampler(0.95),
                                         9, seed=4, chunk=chunk)
        steps = trun.decode_steps - 2
        assert trun.device_steps - 2 == -(-steps // chunk) * chunk
    for chunk in (3, 8):
        for got, want in zip(outs[chunk], outs[1]):
            np.testing.assert_array_equal(got, want)


VOCAB, GEN = 1022, 6


def test_data_split_draws_each_ranks_rows(tmp_path):
    """A (data 2, model 1) gloo world samples 3 rows (padded to 4: 2 a rank,
    rank 1 drawing rows 2 and 3 of the padded batch) from a seed: the single
    rank's tokens and lengths, scores within 1e-5 (products over 2 rows and
    over 4 may round differently), and JAX's tokens and lengths."""
    toy_j, toy_t = jax_archs.get("toy"), sonar_text_decoder_archs.get("toy")
    jcfg = dataclasses.replace(toy_j, vocab_info=dataclasses.replace(toy_j.vocab_info,
                                                                      size=VOCAB))
    tcfg = dataclasses.replace(toy_t, vocab_info=dataclasses.replace(toy_t.vocab_info,
                                                                      size=VOCAB))
    params = jax.tree_util.tree_map(np.array, JaxDecoder(jcfg).init_params(jax.random.PRNGKey(1)))
    memory = np.random.default_rng(6).normal(size=(3, 1, tcfg.model_dim)).astype(np.float32) * 2
    seeds = np.asarray([11, 2**32 + 5], np.int64)
    save_params(tmp_path / "inputs.npz", {"decoder": params, "data": {
        "vocab": np.asarray(VOCAB), "memory": memory, "prefix": np.asarray([3, 7]),
        "seeds": seeds, "gen": np.asarray(GEN)}})
    ranks = run_world("sample", 2, tmp_path)
    single = TorchTextDecoder(text_decoder_from_numpy(params, tcfg), device="cpu")
    jrun = JitTextDecoder(JaxDecoder(jcfg), params, quantize=False)
    for seed in seeds.tolist():
        for name, (port_s, jax_s), min_len in (
                ("top_p", (sampling.TopPSampler(p=0.9), jsampling.TopPSampler(p=0.9)), 1),
                ("top_k", (sampling.TopKSampler(k=10), jsampling.TopKSampler(k=10)), 3)):
            want = single.generate_sample(memory, [3, 7], port_s, max_gen_len=GEN,
                                          min_gen_len=min_len, seed=seed)
            jt, _, jl = jrun.generate_sample(memory, [3, 7], jax_s, max_gen_len=GEN,
                                             min_gen_len=min_len, seed=seed)
            np.testing.assert_array_equal(want[0], jt)
            np.testing.assert_array_equal(want[2], jl)
            for rank, out in enumerate(ranks):
                got = out[f"{name}_{seed}"]
                np.testing.assert_array_equal(got["tokens"], want[0])
                np.testing.assert_array_equal(got["lens"], want[2])
                np.testing.assert_allclose(got["scores"], want[1], rtol=0, atol=1e-5)


def test_sample_lax_is_the_runtime_loop():
    """``sampling.sample_lax`` over a bare ``step_fn`` (JAX's signature, the
    key from ``prng_key``) gives ``generate_sample``'s outputs bit for bit
    on a batch of 4 (a power of two: no padding)."""
    _, trun = _runtimes("wide")
    memory = np.random.default_rng(9).normal(size=(4, 1, 128)).astype(np.float32) * 2.0
    sampler, vocab = sampling.TopKSampler(k=10, temperature=0.7), trun.vocab_info

    def step_fn(tokens, cache):
        logits, cache = trun.model.step(tokens, cache)
        return torch.log_softmax(logits.float(), dim=-1), cache

    with torch.inference_mode():
        mem = torch.tensor(memory)
        got = sampling.sample_lax(step_fn, trun.model.init_cache(mem, 2 + 9 + 1),
                                  torch.tensor([[3, 7]] * 4), vocab.eos_idx, vocab.size, sampler,
                                  gumbel_max.prng_key(11), 9, min_gen_len=2)
    want = trun.generate_sample(memory, [3, 7], sampler, max_gen_len=9, min_gen_len=2, seed=11)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
