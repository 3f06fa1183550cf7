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

Over a ``parallel.mesh.Mesh`` (``make_train_step(loss_fn, mesh)``, the
state from ``init_train_state(..., mesh=mesh)``), which JAX gets from
GSPMD, every rank takes the global batch and keeps its data coordinate's
rows; its leaves are ``shard_params``'s slices, the layers split their heads,
FFN columns and vocabulary over the model group (``nn.transformer``), and:

- the losses are global means: their sums and counts are summed over the
  data group (a mean of the ranks' means differs whenever the ranks hold
  different token counts);
- after ``backward`` each leaf's gradient (its rows' part) is summed over
  the data group, once, before ``optimizer.step()``; a leaf without a
  gradient (a frozen encoder's) takes part in no collective;
- dropout draws from one generator per data coordinate, shared by its
  model group: ranks that compute one replicated residual stream must drop
  the same elements, and different rows must not share a stream.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from sonar_tpu_torch.nn.core import Params, tree_leaves
from sonar_tpu_torch.ops.precision import matmul_precision_for
from sonar_tpu_torch.parallel.comm import (
    all_sum,
    all_sum_coalesced,
    data_group,
    data_parallel,
    model_parallel,
    sum_over_group,
)
from sonar_tpu_torch.parallel.mesh import (
    SINGLE_MESH,
    Mesh,
    data_sharding,
    expect_axis,
    shard_params,
)
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


def _mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / max(count, 1)``, both summed over the data group in force
    (``parallel.comm.data_parallel``): the mean over the global batch on
    every rank, whose gradient on each rank is its own rows' part (*g*)."""
    group = data_group()
    if group is not None:
        total = sum_over_group(total, group)
        count = all_sum(count.detach(), group)
    return total / torch.clamp(count, min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked token-mean CE in fp32: logits [B, S, V], labels [B, S], mask
    [B, S]; the mean is over max(mask.sum(), 1) tokens (of the global batch
    under a data split)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, labels.long()[..., None])[..., 0]
    mask = mask.float()
    return _mean((nll * mask).sum(), mask.sum())


def _row_mean(per_row: torch.Tensor) -> torch.Tensor:
    """The mean over the batch's rows (the global batch under a data split)."""
    if data_group() is None:
        return per_row.mean()
    return _mean(per_row.sum(), per_row.new_tensor(float(per_row.shape[0])))


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
            return _row_mean((emb - teacher).square().sum(dim=-1))
        dot = (emb * teacher).sum(dim=-1)
        denom = torch.linalg.norm(emb, dim=-1) * torch.linalg.norm(teacher, dim=-1)
        return _row_mean(1.0 - dot / torch.clamp(denom, min=1e-9))


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
        return _row_mean(F.binary_cross_entropy_with_logits(
            logits[:, 0], labels.float(), reduction="none"))
    return _row_mean(F.cross_entropy(logits, labels.long(), reduction="none"))


def _rank_generator(generator: Optional[torch.Generator],
                    mesh: Mesh) -> Optional[torch.Generator]:
    """The dropout generator of this rank's data coordinate. ``generator``
    is seeded alike on every rank; one seed is drawn from it each step, so
    it advances alike, and mixed with the data coordinate. Under ``data=1``
    it is used as it is (the masks of one process alone)."""
    if generator is None or mesh.data == 1:
        return generator
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    return torch.Generator(device=generator.device).manual_seed(
        (seed * 1_000_003 + mesh.data_index) % 2 ** 63)


def make_train_step(loss_fn: LossFn,
                    mesh: Optional[Mesh] = None) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """``loss_fn(params, batch, generator) -> scalar``. Returns
    ``step(state, batch, generator=None) -> (state, loss)``: the gradients
    zeroed (set to None), the loss and its ``backward`` inside the fp32
    precision scope (every fp32 product of the step, forward and backward,
    without TF32, whatever the caller's flags), one ``optimizer.step()``;
    the parameters change in place and the returned state counts one step
    more.

    The batch is the global one: each tensor's leading axis is its rows,
    which must divide by the mesh's ``data``, as JAX's sharding requires.
    Without ``mesh`` the step runs on ``SINGLE_MESH``, this process alone;
    over a mesh it runs as the module docstring says, and the loss returned
    is the global batch's. A mesh whose second axis is not ``model``
    raises ``ValueError``."""
    mesh = SINGLE_MESH if mesh is None else mesh
    expect_axis(mesh, "model")

    def step(state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None) -> Tuple[TrainState, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        batch = {k: v[data_sharding(mesh, v.shape[0])] for k, v in batch.items()}
        with matmul_precision_for(torch.float32), model_parallel(mesh.model_group), \
                data_parallel(mesh.data_group):
            loss = loss_fn(state.params, batch, _rank_generator(generator, mesh))
            loss.backward()
        all_sum_coalesced([leaf.grad for leaf in tree_leaves(state.params)
                           if leaf.grad is not None], mesh.data_group)
        state.optimizer.step()
        return TrainState(state.params, state.optimizer, state.step + 1), loss.detach()

    return step


def init_train_state(params: Params,
                     make_optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                     mesh: Optional[Mesh] = None) -> TrainState:
    """Mark every leaf of ``params`` as requiring grad (in place) and build
    the optimizer over them, e.g. ``lambda leaves: torch.optim.AdamW(leaves,
    lr=1e-4, weight_decay=1e-2)``. Every leaf must be floating point (an
    int8 tree is not trained). With ``mesh`` the state holds this rank's
    slice of the whole tree ``params`` (``parallel.mesh.shard_params``)."""
    params = shard_params(params, SINGLE_MESH if mesh is None else mesh)
    leaves = tree_leaves(params)
    for leaf in leaves:
        if not leaf.is_floating_point():
            raise ValueError(f"a {leaf.dtype} leaf cannot be trained")
        leaf.requires_grad_(True)
    return TrainState(params, make_optimizer(leaves), 0)
