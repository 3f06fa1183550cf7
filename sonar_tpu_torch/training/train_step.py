"""Training and fine-tuning steps of the port (``sonar_tpu.training.train_step``).

- ``translation_loss``: teacher-forced cross-entropy of the conditional
  decoder on (source -> pooled embedding -> target), the SONAR objective;
- ``distillation_loss``: a student encoder's pooled embedding regressed on
  fixed teacher embeddings (``"mse"``, the recipe behind the speech
  encoders, or ``"cosine"``);
- ``classifier_loss``: an MLP head on pooled embeddings, the encoder frozen
  by default;
- ``make_train_step``: zero the gradients, compute the loss, ``backward``,
  ``optimizer.step()``.

The losses call the models' ``forward_with`` on an explicit parameter tree,
never the runtimes, which run under ``torch.inference_mode()``. On the card
every kernel gate takes the plain version while autograd records
(``ops.gates``), so a step launches no kernel; a frozen encoder's forward
runs under ``torch.no_grad()`` and may. Dropout (the embedding frontends'
only, as in the JAX package) draws from a ``torch.Generator`` on the
parameters' device, or is off without one.

The JAX package's ``TrainState`` holds an optax state and ``make_train_step``
takes the optax transformation; a torch optimizer is bound to the tensors
it steps and holds its own state, so here the state holds the optimizer
(built by ``init_train_state`` over the tree's leaves, in sorted key order)
and the step reads it there. The optax <-> torch correspondences the tests
hold:

- ``optax.adam(lr)`` is ``torch.optim.Adam(leaves, lr, eps=1e-8)``;
- ``optax.adamw(lr, weight_decay=w)`` is ``torch.optim.AdamW(leaves, lr,
  weight_decay=w)``: their default decays differ (1e-4 against 1e-2), so
  always pass it.

A leaf that gets no gradient (a frozen encoder's) keeps its value under a
torch optimizer, which skips it; ``optax.adamw`` would still decay it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from sonar_tpu_torch.nn.core import Params, tree_leaves
from sonar_tpu_torch.ops.precision import matmul_precision_for
import torch
import torch.nn.functional as F

Batch = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Batch, Optional[torch.Generator]], torch.Tensor]


@dataclass
class TrainState:
    """params: the nested dict of leaf tensors being trained (each
    ``requires_grad``); optimizer: a ``torch.optim.Optimizer`` over
    ``tree_leaves(params)``; step: the number of steps taken."""

    params: Params
    optimizer: torch.optim.Optimizer
    step: int


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked token-mean CE in fp32: logits [B, S, V], labels [B, S], mask
    [B, S]; the mean is over max(mask.sum(), 1) tokens."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, labels.long()[..., None])[..., 0]
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def translation_loss(encoder: Any, decoder: Any, enc_params: Params, dec_params: Params,
                     batch: Batch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """source ids -> pooled embedding -> teacher-forced decode of the target.

    ``encoder`` a ``SonarTextEncoder``, ``decoder`` a
    ``ConditionalTransformerDecoder``; batch: src_tokens [B, S], src_lens
    [B], tgt_in [B, T] (the decoder's input, prefix first), tgt_out [B, T]
    (the labels, shifted), tgt_lens [B]. ``generator`` draws both frontends'
    dropout masks, one after the other (the JAX loss splits its key in two).
    """
    with matmul_precision_for(encoder.dtype):
        emb = encoder.forward_with(enc_params, batch["src_tokens"], batch["src_lens"],
                                   generator=generator).sentence_embeddings
        logits = decoder.forward_with(dec_params, batch["tgt_in"], batch["tgt_lens"],
                                      emb[:, None, :], generator=generator)
        tgt_out = batch["tgt_out"]
        pos = torch.arange(tgt_out.shape[1], device=tgt_out.device)
        return cross_entropy(logits, tgt_out, pos[None, :] < batch["tgt_lens"][:, None])


OBJECTIVES = ("mse", "cosine")


def distillation_loss(student_encoder: Any, params: Params, batch: Batch,
                      generator: Optional[torch.Generator] = None, *,
                      objective: str = "mse") -> torch.Tensor:
    """Teacher-student embedding distillation into a fixed SONAR space.

    A student encoder (a speech Conformer, or a text encoder) is trained so
    that its pooled embedding matches the teacher's embedding of the same
    sentence, computed once beforehand. batch: ``inputs`` (fbank [B, T, C]
    for a speech student, token ids [B, S] for a text one), ``lens`` [B],
    ``teacher_emb`` [B, D] (a constant). ``objective``: ``"mse"`` (summed
    over D, mean over B) or ``"cosine"`` (1 - cosine). The speech encoder
    has no dropout, so ``generator`` is passed on only when it is given.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective: {objective}")
    kwargs = {"generator": generator} if generator is not None else {}
    with matmul_precision_for(student_encoder.dtype):
        emb = student_encoder.forward_with(params, batch["inputs"], batch["lens"],
                                           **kwargs).sentence_embeddings.float()
        teacher = batch["teacher_emb"].float().detach()
        if objective == "mse":
            return (emb - teacher).square().sum(dim=-1).mean()
        dot = (emb * teacher).sum(dim=-1)
        denom = torch.linalg.norm(emb, dim=-1) * torch.linalg.norm(teacher, dim=-1)
        return (1.0 - dot / torch.clamp(denom, min=1e-9)).mean()


def classifier_loss(encoder: Any, head: Any, params: Params, batch: Batch,
                    generator: Optional[torch.Generator] = None, *,
                    freeze_encoder: bool = True) -> torch.Tensor:
    """An MLP head fine-tuned on pooled sentence embeddings.

    ``params = {"encoder": ..., "head": ...}``; ``head.forward_with(params,
    emb)`` gives [B, C] logits (``MutoxClassifier``'s). With
    ``freeze_encoder`` (the default) the encoder runs under
    ``torch.no_grad()``: its leaves get no gradient (the JAX loss's
    ``stop_gradient`` gives them zeros) and, being inference, its forward
    may take the kernels. batch: ``tokens`` [B, S], ``lens`` [B],
    ``labels`` [B]; C = 1 is a sigmoid BCE on {0, 1} labels, C > 1 a softmax
    CE on class ids. The head computes true fp32 products, as the JAX
    head's scope does.
    """
    with matmul_precision_for(encoder.dtype):
        with torch.no_grad() if freeze_encoder else contextlib.nullcontext():
            emb = encoder.forward_with(params["encoder"], batch["tokens"], batch["lens"],
                                       generator=generator).sentence_embeddings
    with matmul_precision_for(torch.float32):
        logits = head.forward_with(params["head"], emb).float()
    labels = batch["labels"]
    if logits.shape[-1] == 1:
        return F.binary_cross_entropy_with_logits(logits[:, 0], labels.float())
    return F.cross_entropy(logits, labels.long())


def make_train_step(loss_fn: LossFn) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """``loss_fn(params, batch, generator) -> scalar``. Returns
    ``step(state, batch, generator=None) -> (state, loss)``: the gradients
    zeroed (set to None), the loss and its ``backward`` inside the fp32
    precision scope (every fp32 product of the step, forward and backward,
    without TF32, whatever the caller's flags), one ``optimizer.step()``;
    the parameters change in place and the returned state counts one step
    more."""

    def step(state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None) -> Tuple[TrainState, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        with matmul_precision_for(torch.float32):
            loss = loss_fn(state.params, batch, generator)
            loss.backward()
        state.optimizer.step()
        return TrainState(state.params, state.optimizer, state.step + 1), loss.detach()

    return step


def init_train_state(params: Params,
                     make_optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer]
                     ) -> TrainState:
    """Mark every leaf of ``params`` as requiring grad (in place) and build
    the optimizer over them, e.g. ``lambda leaves: torch.optim.AdamW(leaves,
    lr=1e-4, weight_decay=1e-2)``. Every leaf must be floating point (an
    int8 tree is not trained)."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        if not leaf.is_floating_point():
            raise ValueError(f"a {leaf.dtype} leaf cannot be trained")
        leaf.requires_grad_(True)
    return TrainState(params, make_optimizer(leaves), 0)
