"""NLLB-200 MoE on the port (``models/nllb_moe``, ``nn/moe.py``) against the
benchmark's plain reference (``perfbench/reference/nllb_moe.py``), on the CPU
at the ``toy`` size: 4 + 4 layers, every 2nd sparse, 8 experts of which a
tree holds 4, D 64, 4 heads, fp32, weights drawn by the benchmark's drawer
(``perfbench/harness/weights_nllb_moe.py``).

Tolerance: 1e-4 absolute on the encoder's output and on log-probabilities
(read 1e-6 to 3e-6). Both sides compute in fp32 on the same weights; they
differ only in the order of the products' sums (batched and padded against
one sentence at a time, grouped expert GEMMs against one expert at a time)
over 4 + 4 layers, which moves the last bits. Every planted fault reads 0.05
or more, hundreds of times the tolerance. A routing decision could flip on a
near-tie at that rounding: the seeds here have none (the counters and the
reference agree on every route).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench.harness import tokenizer as tokens  # noqa: E402
from perfbench.harness import weights_nllb_moe as weights  # noqa: E402
from perfbench.reference import nllb_moe as ref  # noqa: E402
from perfbench.reference import spm  # noqa: E402
from sonar_tpu_torch.generation.beam_search import BeamSearchConfig  # noqa: E402
from sonar_tpu_torch.generation.decoder_runtime import (  # noqa: E402
    TorchEncoderDecoder,
    memory_bucket,
)
from sonar_tpu_torch.inference_pipelines.text import TextToTextModelPipeline  # noqa: E402
from sonar_tpu_torch.models.nllb_moe import NllbMoeModel, nllb_moe_archs  # noqa: E402
from sonar_tpu_torch.nn import moe, transformer  # noqa: E402

ATOL = 1e-4
VOCAB = {"size": 1024, "unk_idx": 1, "bos_idx": 2, "eos_idx": 3, "pad_idx": 1}
CFG = {"model_dim": 64, "num_encoder_layers": 4, "num_decoder_layers": 4,
       "num_encoder_attn_heads": 4, "num_decoder_attn_heads": 4, "ffn_inner_dim": 128,
       "num_experts": 4, "experts_first": 0, "router_experts": 8, "encoder_sparse_step": 2,
       "decoder_sparse_step": 2, "max_seq_len": 128, "vocab_info": VOCAB}
SEED = 2**31 + 11


def _cfg(first=0, held=4):
    return dict(CFG, experts_first=first, num_experts=held)


def _tree(cfg=None, seed=SEED):
    return weights.nllb_moe(torch, cfg or CFG, seed, torch.float32, torch.device("cpu"))


def _model(tree, cfg=None):
    cfg = cfg or CFG
    arch = nllb_moe_archs.get("toy").holding(cfg["experts_first"],
                                             cfg["experts_first"] + cfg["num_experts"])
    return NllbMoeModel(arch, tree)


def _batch(lists, pad=1):
    s = max(map(len, lists))
    out = torch.full((len(lists), s), pad, dtype=torch.long)
    for i, ids in enumerate(lists):
        out[i, :len(ids)] = torch.tensor(ids)
    return out, torch.tensor([len(x) for x in lists])


def _ids(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(4, 1000, n)] for n in lengths]


SOURCES = _ids(1, (7, 12, 3))
TARGETS = _ids(2, (5, 9, 4))


def test_toy_arch_and_the_published_one():
    big = nllb_moe_archs.get("nllb_moe_54b")
    assert (big.model_dim, big.num_encoder_layers, big.num_decoder_layers, big.ffn_inner_dim,
            big.num_experts, big.encoder_sparse_step, big.vocab_info.size) == (
                2048, 24, 24, 8192, 128, 4, 256206)
    assert big.held == (0, 128) and big.holding(16, 32).held == (16, 32)
    plan = transformer.layer_plan(24, 4)
    assert [i for i, (s, _) in enumerate(plan) if s] == [3, 7, 11, 15, 19, 23]
    assert plan[23] == (True, 5) and plan[22] == (False, 17)
    assert memory_bucket(1) == 1 and memory_bucket(17) == 128 and memory_bucket(129) == 256


def test_encoder_matches_the_reference():
    tree = _tree()
    model = _model(tree)
    seqs, lens = _batch(SOURCES)
    with torch.no_grad():
        got = model.encode(seqs, lens)
    for i, want in enumerate(ref.encode(tree, CFG, SOURCES)):
        torch.testing.assert_close(got[i, :len(SOURCES[i])], want, atol=ATOL, rtol=0)
    c = model.read_counters()
    # padding tokens reach no expert: each real token sends 2 pairs, held or not
    assert c["rows"][:2].sum() <= 2 * sum(map(len, SOURCES))


def test_teacher_forced_decoder_matches_the_reference():
    tree = _tree()
    model = _model(tree)
    seqs, lens = _batch(SOURCES)
    tgt, tlens = _batch(TARGETS)
    with torch.no_grad():
        lp = torch.log_softmax(model(tgt, tlens, model.encode(seqs, lens), lens), dim=-1)
    for i, want in enumerate(ref.log_probs(tree, CFG, SOURCES, TARGETS)):
        torch.testing.assert_close(lp[i, :len(TARGETS[i])], want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("beam", [None, 3])
def test_cached_decoder_steps_match_the_reference(beam):
    """Plain mode steps each row's cache; beam mode keeps the source K/V once
    a sentence and its beams (here all fed the same tokens) read it together."""
    tree = _tree()
    model = _model(tree)
    seqs, lens = _batch(SOURCES)
    tgt = [t[:4] for t in TARGETS]
    with torch.no_grad():
        memory = model.encode(seqs, lens)
        k = beam or 1
        cache = model.init_cache(memory, 8, beam_size=beam, memory_lens=lens)
        assert cache.beams_share_memory == (beam is not None)
        assert cache.cross_k.shape[1] == len(SOURCES) and cache.cross_out is None
        anc = (torch.arange(k)[None, :, None].expand(len(SOURCES), k, 8).reshape(-1, 8)
               .to(torch.int32) if beam else None)
        steps = []
        for j in range(4):
            toks = torch.tensor([t[j] for t in tgt]).repeat_interleave(k)
            logits, cache = model.step(toks, cache, ancestry=anc, beam_size=beam)
            steps.append(torch.log_softmax(logits, dim=-1).reshape(len(SOURCES), k, -1))
    got = torch.stack(steps, dim=2)  # [B, K, 4, V]
    for i, want in enumerate(ref.log_probs(tree, CFG, SOURCES, tgt)):
        for b in range(k):
            torch.testing.assert_close(got[i, b], want, atol=ATOL, rtol=0)


def _tokenizer(seed=7):
    pieces = tokens.draw(seed, VOCAB["size"])
    pieces.symbols[pieces.symbols.index("lng000_Latn")] = "fra_Latn"
    return pieces, tokens.program_tokenizer(pieces)


def test_beam_search_through_the_pipeline_scores_as_the_reference():
    tree = _tree()
    pieces, tok = _tokenizer()
    texts = [" ".join(pieces.words[i:i + n]) for i, n in ((0, 3), (40, 9), (90, 1), (7, 5),
                                                           (300, 12))]
    pipe = TextToTextModelPipeline(_model(tree), None, tok, device="cpu")
    assert isinstance(pipe.decoder, TorchEncoderDecoder) and pipe.model is pipe.decoder
    seen = []
    inner = pipe.decoder.materialize_beam
    pipe.decoder.materialize_beam = lambda h: seen.append(inner(h)) or seen[-1]
    out = pipe.predict(texts, source_lang="eng_Latn", target_lang="fra_Latn", batch_size=2,
                       beam_size=3, max_gen_len=6)
    assert len(out) == len(texts) and len(seen) == 3
    rtok = spm.Tokenizer(pieces.pieces, pieces.scores, pieces.types, pieces.symbols)
    prefix = list(tok.create_encoder(lang="fra_Latn", mode="target").prefix_indices)
    # a list is decoded sorted by length and handed back in its own order
    order = np.argsort([len(t) for t in texts], kind="stable")
    sources, seqs, scores, rows = [], [], [], 0
    for toks, sc, lens in seen:
        for r in range(toks.shape[0]):
            i = int(order[rows + r])
            src = rtok.encode_source(texts[i], "eng_Latn")
            assert rtok.decode([int(x) for x in toks[r, 0, :lens[r, 0]]]) == out[i]
            for h in range(toks.shape[1]):
                hyp = [int(x) for x in toks[r, h, :lens[r, h]]]
                sources.append(src)
                seqs.append((prefix + hyp[:-1], hyp))
                scores.append(float(sc[r, h]))
        rows += toks.shape[0]
    tables = ref.log_probs(tree, CFG, sources, [s for s, _ in seqs])
    for (_, hyp), score, lp in zip(seqs, scores, tables):
        assert abs(ref.hypothesis_score(lp, len(prefix), hyp) - score) <= ATOL
        assert float(ref.candidate_gaps(lp, len(prefix), hyp[:-1], 6).max()) <= ATOL


def _layer(tree, i=0):
    """Sparse encoder layer ``i``'s FFN params and a layer-normed input."""
    stack = tree["encoder"]["sparse_layers"]
    ffn = {k: (v[i] if not isinstance(v, dict) else {kk: vv[i] for kk, vv in v.items()})
           for k, v in stack["ffn"].items()}
    x = torch.randn(37, CFG["model_dim"], generator=torch.Generator().manual_seed(3))
    return ffn, x


def test_the_shares_of_a_sparse_layer_add_up_to_the_whole_layer():
    whole, x = _layer(_tree(_cfg(0, 8)))
    parts = [_layer(_tree(_cfg(first, 4)))[0] for first in (0, 4)]
    with torch.no_grad():
        total = sum(moe.moe_ffn(p, x) for p in parts)
        want = ref.experts_ffn(x, ref._weights({"f": {k: (v[None] if torch.is_tensor(v) else
                                                          {kk: vv[None] for kk, vv in v.items()})
                                                      for k, v in whole.items()}}, 0)["f"],
                               (0, 8), None)
    # the residual, counted once, added to both sides
    torch.testing.assert_close(x + total, x + want, atol=ATOL, rtol=0)
    torch.testing.assert_close(x + moe.moe_ffn(whole, x), x + want, atol=ATOL, rtol=0)


def test_a_router_that_sends_every_token_to_one_expert_drops_nothing():
    ffn, x = _layer(_tree())
    u = torch.nn.functional.normalize(torch.ones(x.shape[1]), dim=0)
    x = x + 10.0 * u  # every token leans along u
    router = torch.zeros_like(ffn["router"]["kernel"])
    router[:, 2] = 5.0 * u  # expert 2 first for every token
    router[:, 5] = 2.0 * u  # 5, held elsewhere, second
    ffn = dict(ffn, router={"kernel": router},
               rows=torch.zeros(4, dtype=torch.long), hits=torch.zeros(4, dtype=torch.long))
    experts, _ = ref.route(x, router)
    assert (experts[:, 0] == 2).all()
    with torch.no_grad():
        got = moe.moe_ffn(ffn, x)
    want = ref.experts_ffn(x, {k: v for k, v in ffn.items()
                               if k not in ("rows", "hits")}, (0, 4), None)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert ffn["rows"].tolist() == [0, 0, x.shape[0], 0]
    assert ffn["hits"].tolist() == [0, 0, 1, 0]


def test_the_sonar_decoder_keeps_its_length_1_memory():
    """The SONAR decoder's cache keeps its precomputed cross-attention
    (``cross_out``) and the per-row layout: a length-1 memory's path is the
    one it was."""
    from sonar_tpu_torch.models.sonar_text.config import sonar_text_decoder_archs
    from sonar_tpu_torch.nn.conditional_decoder import ConditionalTransformerDecoder
    from perfbench.harness import weights as sonar_weights

    cfg = sonar_text_decoder_archs.get("toy")
    tcfg = {"model_dim": cfg.model_dim, "ffn_inner_dim": cfg.ffn_inner_dim,
            "num_decoder_layers": cfg.num_decoder_layers,
            "vocab_info": {"size": cfg.vocab_info.size, "pad_idx": cfg.vocab_info.pad_idx}}
    tree = sonar_weights.text_decoder(torch, tcfg, 5, torch.float32, torch.device("cpu"))
    dec = ConditionalTransformerDecoder(cfg, tree)
    mem = torch.randn(6, 1, cfg.model_dim, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        cache = dec.init_cache(mem, 6, beam_size=3)
        assert cache.cross_out is not None and not cache.beams_share_memory
        assert cache.cross_mask is None and cache.cross_k.shape[-2] == 0
        toks = torch.tensor([3, 7, 9, 11])
        anc = torch.arange(3)[None, :, None].expand(2, 3, 6).reshape(6, 6).to(torch.int32)
        steps = []
        for t in toks:
            logits, cache = dec.step(t.repeat(6), cache, ancestry=anc, beam_size=3)
            steps.append(logits)
        full = dec(toks[None].expand(6, -1), None, mem)
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=1e-4, rtol=0)


# -- planted faults: each must read far outside the tolerance --------------------


def _top1(x_route):
    def route(router, x):
        ids, gates = x_route(router, x)
        return ids, torch.stack([torch.ones_like(gates[:, 0]), torch.zeros_like(gates[:, 1])], 1)
    return route


def _unnormalised(x_route):
    def route(router, x):
        ids, _ = x_route(router, x)
        probs = torch.softmax(x.float() @ router["kernel"].float(), dim=-1)
        return ids, probs.gather(-1, ids)
    return route


def _stepped_gap(tree):
    """The largest gap between the beam-mode cached steps' log-probabilities
    and the reference's, the path the captured search runs."""
    model = _model(tree)
    seqs, lens = _batch(SOURCES)
    tgt, k = [t[:4] for t in TARGETS], 3
    with torch.no_grad():
        cache = model.init_cache(model.encode(seqs, lens), 8, beam_size=k, memory_lens=lens)
        anc = torch.arange(k)[None, :, None].expand(len(SOURCES), k, 8).reshape(-1, 8).int()
        steps = []
        for j in range(4):
            toks = torch.tensor([t[j] for t in tgt]).repeat_interleave(k)
            logits, cache = model.step(toks, cache, ancestry=anc, beam_size=k)
            steps.append(torch.log_softmax(logits, dim=-1).reshape(len(SOURCES), k, -1))
    got = torch.stack(steps, dim=2)
    return max(float((got[i] - want).abs().max())
               for i, want in enumerate(ref.log_probs(tree, CFG, SOURCES, tgt)))


@pytest.mark.parametrize("fault", ["top1", "unnormalised", "skipped_experts", "unmasked_source"])
def test_a_planted_fault_reads_far_outside_the_tolerance(fault, monkeypatch):
    tree = _tree()
    assert _stepped_gap(tree) <= ATOL
    if fault in ("top1", "unnormalised"):
        make = _top1 if fault == "top1" else _unnormalised
        monkeypatch.setattr(moe, "route", make(moe.route))
    elif fault == "skipped_experts":
        slot = tree["decoder"]["sparse_layers"]["ffn"]["expert_slot"]
        slot[0] = CFG["num_experts"]  # the first sparse decoder layer holds none
    else:
        attend = transformer._beam_cross_attend
        monkeypatch.setattr(transformer, "_beam_cross_attend",
                            lambda p, x, k, v, mask, h, b: attend(p, x, k, v, None, h, b))
    assert _stepped_gap(tree) > 500 * ATOL
