"""Transformer encoder and decoder stacks (``sonar_tpu.nn.transformer``).

Layer semantics of fairseq2's ``StandardTransformerEncoderLayer`` and
``StandardTransformerDecoderLayer`` as SONAR instantiates them: pre-LN (or
post-LN) residual blocks, MHA with biased q/k/v/output projections, FFN =
inner_proj -> activation -> output_proj. The decoder runs over the full
sequence (the attention poolers, teacher-forced scoring) or one position
at a time against a preallocated KV cache (``DecoderCache``,
``decoder_step``), in plain mode or in beam mode, where self-attention reads
the un-reordered cache through an ancestry table (``_beam_self_attend``,
whose core is the ``beam_masked_attend`` kernel).

Parameters are nested dicts in the JAX layout; the per-layer tensors of a
stack carry a leading L axis, and ``encoder_stack`` loops over it.

The kernel gates are the JAX package's, on shapes and dtypes and the
caller's choice, and take the plain version whenever autograd records
(``ops.gates.kernels_allowed``: the kernels have no backward; a
``no_cuda_kernels()`` scope turns every gate off; ``set_ffn_impl("plain")``
the standalone fused FFN); each kernel wrapper then runs its plain version
for CPU tensors and its CUDA kernel for CUDA tensors. The whole-block int8
kernels take S >= 8 with >= 2048 tokens and no upper bound: their attention
step is the one-pass core to S 128 and #5's two-pass core past it (which
``set_attention_impl("plain")`` keeps off), and on an H100 the block beat
the eager int8 projections at every S from 192 to 512. The other
thresholds (short attention S 8..128, flash S >= 256) were tuned on a TPU;
re-tuning them on the H100 is open work. ``encoder_stack`` /
``decoder_stack(remat=True)`` recompute each layer's activations in the
backward pass (``torch.utils.checkpoint``).

Under a model split (``parallel.comm.model_parallel``, the parameters being
``parallel.mesh.shard_params``'s slices) each rank runs its H / model heads
and its share of the FFN columns: *f* (``copy_to_group``) before each
column-parallel projection, a sum over the model group after each
row-parallel one (``nn.core.row_linear``, the bias added once). The
kernels of #1 (short attention), #5 (flash) and #8 (beam attend) run on the
rank's heads; the whole-block int8 kernels (#2, #3) end in the row-parallel
projection and the residual, which need the sum first, so their gates read
a model split as ineligible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from sonar_tpu_torch.nn.core import (
    Params,
    get_activation,
    layer_norm,
    linear,
    row_linear,
    tree_leaves,
)
from sonar_tpu_torch.ops.attention import dispatch_sdpa
from sonar_tpu_torch.ops.cuda.attn_block import ONE_PASS_MAX
from sonar_tpu_torch.ops.gates import attention_impl, ffn_impl, kernels_allowed
from sonar_tpu_torch.ops.gates import set_ffn_impl as set_ffn_impl
from sonar_tpu_torch.parallel.comm import Group, copy_to_group, model_group
import torch
import torch.utils.checkpoint

F32_MIN = torch.finfo(torch.float32).min


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def local_heads(num_heads: int, group: Optional[Group]) -> int:
    """This rank's share of ``num_heads`` under a model split."""
    if group is None:
        return num_heads
    if num_heads % group.size:
        raise ValueError(f"{num_heads} heads do not split over model={group.size}")
    return num_heads // group.size


def _key_bias(bias: Optional[torch.Tensor]) -> bool:
    return bias is None or (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1)


def mha(
    params: Params,
    x: torch.Tensor,
    kv: torch.Tensor,
    bias: Optional[torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    if "qkv_proj" in params and x is kv:
        group = model_group()
        heads = local_heads(num_heads, group)
        qkv = linear(params["qkv_proj"], copy_to_group(x, group))
        if _key_bias(bias) and 8 <= qkv.shape[1] <= 128 and kernels_allowed(qkv):
            # Short-sequence attention straight from the fused QKV layout.
            from sonar_tpu_torch.ops.cuda.short_attn import short_qkv_attention

            out = short_qkv_attention(
                qkv, None if bias is None else bias[:, 0, 0, :], heads
            )
            return row_linear(params["output_proj"], out, group)
        q, k, v = (_split_heads(t, heads) for t in qkv.chunk(3, dim=-1))
        out = dispatch_sdpa(q, k, v, bias=bias)
        return row_linear(params["output_proj"], _merge_heads(out), group)
    k, v = mha_project_kv(params, kv, num_heads)
    return mha_attend(params, x, k, v, bias, num_heads)


def mha_project_kv(params: Params, kv: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, ...]:
    """Project memory once for reuse across decode steps: -> ([B,H,S,Dh], x2),
    the rank's heads under a model split."""
    group = model_group()
    heads = local_heads(num_heads, group)
    kv = copy_to_group(kv, group)
    k = _split_heads(linear(params["k_proj"], kv), heads)
    v = _split_heads(linear(params["v_proj"], kv), heads)
    return k, v


def mha_attend(params: Params, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """Attention with pre-projected K/V (shared by full and incremental paths)."""
    group = model_group()
    q = _split_heads(linear(params["q_proj"], copy_to_group(x, group)),
                     local_heads(num_heads, group))
    out = dispatch_sdpa(q, k, v, bias=bias)
    return row_linear(params["output_proj"], _merge_heads(out), group)


def fuse_qkv(params: Params, keep_split: bool = True) -> Params:
    """Concatenate the q/k/v projections of every ``self_attn`` into one
    ``qkv_proj`` along the output axis (q | k | v), as a runtime copy.

    The full-sequence paths read ``qkv_proj``; incremental decoding reads
    the separate projections, which are kept unless ``keep_split`` is False.
    A tree to train drops them: an optimizer steps ``qkv_proj`` only, and a
    kept copy would go stale.
    """

    def transform(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        out: Dict[str, Any] = {}
        for key, value in node.items():
            if (
                key == "self_attn"
                and isinstance(value, dict)
                and {"q_proj", "k_proj", "v_proj"} <= set(value)
            ):
                names = ("q_proj", "k_proj", "v_proj")
                fused = {k: v for k, v in value.items() if keep_split or k not in names}
                fused["qkv_proj"] = {
                    "kernel": torch.cat([value[p]["kernel"] for p in names], dim=-1)
                }
                if "bias" in value["q_proj"]:
                    fused["qkv_proj"]["bias"] = torch.cat(
                        [value[p]["bias"] for p in names], dim=-1
                    )
                out[key] = fused
            else:
                out[key] = transform(value)
        return out

    return transform(params)


def ffn(params: Params, x: torch.Tensor, activation: str,
        token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer's FFN: dense, or sparse when its parameters hold a router
    (``nn.moe.moe_ffn``, whose experts are ReLU FFNs; ``token_mask`` keeps
    padding tokens out of them)."""
    if "router" in params:
        from sonar_tpu_torch.nn.moe import moe_ffn

        return moe_ffn(params, x, token_mask)
    inner, out = params["inner_proj"], params["output_proj"]
    n_tokens = x.numel() // x.shape[-1]
    group = model_group()
    if (
        ffn_impl() == "auto"
        and group is None
        and activation == "relu"
        and "kernel_q" in inner
        and "kernel_q" in out
        and "bias" in inner
        and "bias" in out
        and inner["kernel_q"].shape[1] % 256 == 0
        and inner["kernel_q"].shape[0] % 128 == 0
        and n_tokens >= 2048
        and kernels_allowed(x, *tree_leaves(params))
    ):
        from sonar_tpu_torch.ops.cuda.ffn import fused_int8_ffn

        shape = x.shape
        y = fused_int8_ffn(
            x.reshape(-1, shape[-1]),
            inner["kernel_q"], inner["scale"], inner["bias"],
            out["kernel_q"], out["scale"], out["bias"],
        )
        return y.reshape(shape)
    act = get_activation(activation)
    return row_linear(out, act(linear(inner, copy_to_group(x, group))), group)


def _residual_block(params_ln: Params, x: torch.Tensor, fn, norm_order: str) -> torch.Tensor:
    """PRE: x + fn(LN(x));  POST: LN(x + fn(x))."""
    if norm_order == "pre":
        return x + fn(layer_norm(params_ln, x))
    return layer_norm(params_ln, x + fn(x))


def _block_kernels_eligible(params: Params, x: torch.Tensor, bias, num_heads: int,
                            activation: str, norm_order: str) -> bool:
    """Whole-block kernels: pre-LN int8 layers with a fused QKV projection,
    ReLU FFN, key-padding bias, S >= 8, enough tokens, no model split, and
    ``kernels_allowed`` (nothing that autograd records, no
    ``no_cuda_kernels()`` scope). No upper bound on S: #2's attention step
    takes any key count, past ``ONE_PASS_MAX`` (S 128) in #5's two-pass
    core, which ``set_attention_impl("plain")`` keeps off there, as JAX's
    block gate, ending at S 128, leaves such layers to plain attention."""
    if norm_order != "pre" or activation != "relu" or not _key_bias(bias):
        return False
    if model_group() is not None:
        return False
    if not kernels_allowed(x, *tree_leaves(params)):
        return False
    sa, f = params["self_attn"], params["ffn"]
    if not ("qkv_proj" in sa and "kernel_q" in sa["qkv_proj"]
            and "kernel_q" in sa.get("output_proj", {})
            and "kernel_q" in f.get("inner_proj", {})
            and "kernel_q" in f.get("output_proj", {})):
        return False
    b, s, d = x.shape
    fdim = f["inner_proj"]["kernel_q"].shape[1]
    if s > ONE_PASS_MAX and attention_impl() == "plain":
        return False
    return s >= 8 and d % 128 == 0 and fdim % 256 == 0 and b * s >= 2048


def encoder_layer(
    params: Params,
    x: torch.Tensor,
    bias: Optional[torch.Tensor],
    num_heads: int,
    activation: str,
    norm_order: str = "pre",
    token_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One encoder layer; ``token_mask`` [B, S] (True for a real token)
    keeps padding out of a sparse FFN's experts."""
    if _block_kernels_eligible(params, x, bias, num_heads, activation, norm_order):
        from sonar_tpu_torch.ops.cuda.attn_block import fused_attn_block
        from sonar_tpu_torch.ops.cuda.ffn import fused_int8_ffn_ln

        sa, f = params["self_attn"], params["ffn"]
        x = fused_attn_block(
            x,
            None if bias is None else bias[:, 0, 0, :],
            params["self_attn_layer_norm"]["weight"],
            params["self_attn_layer_norm"]["bias"],
            sa["qkv_proj"]["kernel_q"], sa["qkv_proj"]["scale"], sa["qkv_proj"]["bias"],
            sa["output_proj"]["kernel_q"], sa["output_proj"]["scale"],
            sa["output_proj"]["bias"],
            num_heads,
        )
        shape = x.shape
        y = fused_int8_ffn_ln(
            x.reshape(-1, shape[-1]),
            params["ffn_layer_norm"]["weight"],
            params["ffn_layer_norm"]["bias"],
            f["inner_proj"]["kernel_q"], f["inner_proj"]["scale"], f["inner_proj"]["bias"],
            f["output_proj"]["kernel_q"], f["output_proj"]["scale"], f["output_proj"]["bias"],
        )
        return x + y.reshape(shape)
    x = _residual_block(
        params["self_attn_layer_norm"], x,
        lambda h: mha(params["self_attn"], h, h, bias, num_heads), norm_order,
    )
    return _residual_block(
        params["ffn_layer_norm"], x,
        lambda h: ffn(params["ffn"], h, activation, token_mask), norm_order,
    )


def layer_slices(stacked: Any) -> List[Params]:
    """Every layer of a stacked tree (views, no copies), from one ``unbind``
    of each tensor: under autograd its backward is one ``stack`` of the
    layers' gradients, where indexing layer i alone would give each layer a
    zero-filled gradient of the whole stack to add up. A list of layer
    trees (a stack whose layers differ, ``layer_plan``) is its own slices."""
    if isinstance(stacked, list):
        return stacked
    parts = {k: layer_slices(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in stacked.items()}
    n = len(next(iter(parts.values())))
    return [{k: part[i] for k, part in parts.items()} for i in range(n)]


def num_stacked_layers(stacked: Any) -> int:
    if isinstance(stacked, list):
        return len(stacked)
    node: Any = stacked
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.shape[0]


def layer_plan(num_layers: int, sparse_step: int) -> List[Tuple[bool, int]]:
    """(sparse, index in its group) of each layer of a stack in which every
    ``sparse_step``-th layer, (i + 1) % sparse_step == 0, has a sparse FFN
    (NLLB-MoE's ``encoder_sparse_step`` / ``decoder_sparse_step``); 0 means
    none. A stack keeps two stacked groups, ``layers`` and
    ``sparse_layers``, walked in this order."""
    plan, counts = [], [0, 0]
    for i in range(num_layers):
        sparse = sparse_step > 0 and (i + 1) % sparse_step == 0
        plan.append((sparse, counts[sparse]))
        counts[sparse] += 1
    return plan


def planned_layers(dense: Params, sparse: Optional[Params],
                   plan: List[Tuple[bool, int]]) -> List[Params]:
    """The layer trees of a two-group stack in ``plan``'s order (views)."""
    groups = (layer_slices(dense), layer_slices(sparse) if sparse is not None else [])
    return [groups[s][i] for s, i in plan]


def run_layers(stacked: Any, x: torch.Tensor,
               layer_fn: Callable[[Params, torch.Tensor], torch.Tensor],
               remat: bool = False) -> torch.Tensor:
    """``x`` through ``layer_fn(layer_params, x)`` for each of the L stacked
    layers in order. With ``remat`` each layer keeps only its input for the
    backward pass and recomputes the rest there (the counterpart of the JAX
    package's ``jax.checkpoint`` of the scan body): the same gradients, less
    activation memory."""
    for p in layer_slices(stacked):
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer_fn, p, x, use_reentrant=False)
        else:
            x = layer_fn(p, x)
    return x


def encoder_stack(
    stacked_params: Params,
    x: torch.Tensor,
    bias: Optional[torch.Tensor],
    num_heads: int,
    activation: str,
    norm_order: str = "pre",
    remat: bool = False,
    token_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the L stacked encoder layers (or a list of layer trees) in order."""
    return run_layers(stacked_params, x, lambda p, h: encoder_layer(
        p, h, bias, num_heads, activation, norm_order, token_mask), remat)


def decoder_layer(
    params: Params,
    x: torch.Tensor,
    self_bias: Optional[torch.Tensor],
    memory: torch.Tensor,
    memory_bias: Optional[torch.Tensor],
    num_heads: int,
    activation: str,
    norm_order: str = "pre",
    token_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention, cross-attention on ``memory``, FFN; each residual."""
    x = _residual_block(
        params["self_attn_layer_norm"], x,
        lambda h: mha(params["self_attn"], h, h, self_bias, num_heads), norm_order,
    )
    x = _residual_block(
        params["encoder_decoder_attn_layer_norm"], x,
        lambda h: mha(params["encoder_decoder_attn"], h, memory, memory_bias, num_heads),
        norm_order,
    )
    return _residual_block(
        params["ffn_layer_norm"], x,
        lambda h: ffn(params["ffn"], h, activation, token_mask), norm_order,
    )


def decoder_stack(
    stacked_params: Params,
    x: torch.Tensor,
    self_bias: Optional[torch.Tensor],
    memory: torch.Tensor,
    memory_bias: Optional[torch.Tensor],
    num_heads: int,
    activation: str,
    norm_order: str = "pre",
    remat: bool = False,
    token_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the L stacked decoder layers (or a list of layer trees) in order."""
    return run_layers(stacked_params, x, lambda p, h: decoder_layer(
        p, h, self_bias, memory, memory_bias, num_heads, activation, norm_order, token_mask),
        remat)


# ---------------------------------------------------------------------------
# Incremental decoding with a preallocated KV cache
# ---------------------------------------------------------------------------


@dataclass
class DecoderCache:
    """KV cache of the whole decoder stack (``sonar_tpu.nn.transformer``).

    self_k / self_v: [L, B, H, S_max, Dh]; in beam mode
    (``init_decoder_cache(beam_size=K)``) [L, B, H, K, S_max, Dh], the layout
    ``_beam_self_attend`` reads through the ancestry table without a
    transpose. ``decoder_step`` writes them IN PLACE (the JAX package
    returns updated copies): a cache is a buffer of one generation run.
    cross_k / cross_v: [L, B, H, S_mem, Dh], projected once from memory;
    in beam mode over a sequence memory [L, B / K, H, S_mem, Dh], once a
    sentence, which its K beams read together (``_beam_cross_attend``).
    cross_mask: [B or B / K, 1, 1, S_mem] bool (True for a real source
    position) or None (every position real).
    cross_out: [L, B, 1, D] or None. For a length-1 unmasked memory (the
    SONAR embedding bottleneck) the cross-attention block is exactly
    ``output_proj(v_proj(memory))`` (softmax over one position is 1), so
    it is precomputed and cross_k / cross_v are empty.
    index: the next write position, a 0-d int64 tensor on the cache's
    device that ``decoder_step`` advances in place, so that a step reads
    nothing back to the host and can be captured in a CUDA graph.
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    index: torch.Tensor
    cross_out: Optional[torch.Tensor] = None
    cross_mask: Optional[torch.Tensor] = None
    beams_share_memory: bool = False


def init_decoder_cache(
    stacked_params: Params,
    memory: torch.Tensor,
    num_heads: int,
    max_len: int,
    batch: int,
    model_dim: int,
    dtype: torch.dtype,
    beam_size: Optional[int] = None,
    memory_lens: Optional[torch.Tensor] = None,
) -> DecoderCache:
    """Allocate the cache (its index a 0-d tensor on ``memory.device``) and
    project the cross-attention K/V of every layer (or, for a length-1
    memory, the constant ``cross_out``). In beam mode a sequence memory
    holds one row a sentence ([batch / beam_size, S_mem, D]), and its K/V
    are projected and kept once a sentence; ``memory_lens`` masks its
    padding."""
    n_layers = num_stacked_layers(stacked_params)
    head_dim = model_dim // num_heads
    group = model_group()
    heads = local_heads(num_heads, group)
    dev = memory.device
    layers = [p["encoder_decoder_attn"] for p in layer_slices(stacked_params)]
    cross_mask = None
    if memory_lens is not None:
        from sonar_tpu_torch.ops.masks import length_mask

        cross_mask = length_mask(memory_lens, memory.shape[1])[:, None, None, :]
    if memory.shape[1] == 1 and cross_mask is None:
        mem = copy_to_group(memory, group)
        cross_out = torch.stack(
            [row_linear(p["output_proj"], linear(p["v_proj"], mem), group) for p in layers]
        ).to(dtype)
        cross_k = cross_v = torch.zeros((n_layers, batch, heads, 0, head_dim),
                                        dtype=dtype, device=dev)
    else:
        kv = [mha_project_kv(p, memory, num_heads) for p in layers]
        cross_k = torch.stack([k for k, _ in kv]).to(dtype)
        cross_v = torch.stack([v for _, v in kv]).to(dtype)
        cross_out = None
    if beam_size is not None:
        shape = (n_layers, batch // beam_size, heads, beam_size, max_len, head_dim)
    else:
        shape = (n_layers, batch, heads, max_len, head_dim)
    return DecoderCache(
        self_k=torch.zeros(shape, dtype=dtype, device=dev),
        self_v=torch.zeros(shape, dtype=dtype, device=dev),
        cross_k=cross_k,
        cross_v=cross_v,
        index=torch.zeros((), dtype=torch.long, device=dev),
        cross_out=cross_out,
        cross_mask=cross_mask,
        beams_share_memory=beam_size is not None and memory.shape[0] * beam_size == batch
        and cross_out is None,
    )


def valid_bias(max_len: int, idx: Any, device: Any) -> torch.Tensor:
    """[S_max] fp32: 0 at positions <= idx (a host int or a 0-d tensor), -1e30
    after (the beam kernels' additive position mask)."""
    pos = torch.arange(max_len, device=device)
    return torch.where(pos <= idx, 0.0, -1e30).float()


def _beam_self_attend(
    params: Params,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    anc_b: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    beam_size: int,
) -> torch.Tensor:
    """Beam-decode self-attention reading the cache through the ancestry
    table instead of reordering it (``sonar_tpu.nn.transformer``).

    x: [N, 1, D], N = B*K; k_cache / v_cache: [B, H, K, S, Dh] un-reordered;
    anc_b: [B, K, S] int32, for (query beam, position) the cache row that
    holds the winning token; bias: [S] fp32 ``valid_bias`` of this step
    (positions past the step's index carry -1e30). The core is the
    ``beam_masked_attend`` kernel (its plain version on the CPU and inside
    ``no_cuda_kernels()``); it keeps P in fp32 for P @ V, where the JAX
    einsum rounds P to the model dtype first, so in bf16 the two differ by
    that rounding.
    """
    from sonar_tpu_torch.ops.cuda.beam_attend import beam_masked_attend, beam_masked_attend_plain

    b, h, k, s, dh = k_cache.shape
    n = b * beam_size
    group = model_group()
    q = linear(params["q_proj"], copy_to_group(x, group)).reshape(b, beam_size, h, dh)
    qbh = q.permute(0, 2, 1, 3).reshape(b * h, beam_size, dh).contiguous()
    attend = (beam_masked_attend if kernels_allowed(qbh, k_cache, v_cache)
              else beam_masked_attend_plain)
    out = attend(
        qbh, k_cache.reshape(b * h, k, s, dh), v_cache.reshape(b * h, k, s, dh),
        anc_b, bias, local_heads(num_heads, group),
    )
    out = out.reshape(b, h, beam_size, dh).permute(0, 2, 1, 3).reshape(n, 1, h * dh)
    return row_linear(params["output_proj"], out, group)


def _beam_cross_attend(params: Params, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor], num_heads: int,
                       beam_size: int) -> torch.Tensor:
    """Beam-decode cross-attention over a memory kept once a sentence: x
    [N, 1, D], N = B*K; k / v [B, H, S, Dh]; mask [B, 1, 1, S] bool or None.
    The K beams of a sentence are its query rows, so the sentence's K/V are
    read once for all of them, in the model dtype (torch's fused
    ``scaled_dot_product_attention``, which keeps the softmax in fp32)."""
    b, h, _, dh = k.shape
    group = model_group()
    q = linear(params["q_proj"], copy_to_group(x, group))
    q = q.reshape(b, beam_size, h, dh).transpose(1, 2)
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    out = out.transpose(1, 2).reshape(b * beam_size, 1, h * dh)
    return row_linear(params["output_proj"], out, group)


def decoder_step(
    stacked_params: Params,
    x: torch.Tensor,
    cache: DecoderCache,
    memory_bias: Optional[torch.Tensor],
    num_heads: int,
    activation: str,
    ancestry: Optional[torch.Tensor] = None,
    beam_size: Optional[int] = None,
) -> Tuple[torch.Tensor, DecoderCache]:
    """One incremental step of the whole stack: x [B, 1, D] at position
    ``cache.index`` -> (output [B, 1, D], the same cache, its index advanced
    by one in place).

    Writes this position's K/V (the rank's heads under a model split) into
    the cache in place, at the device index (``index_copy_``): nothing is
    read back to the host. As JAX's ``dynamic_update_slice`` does, a write
    position past the cache is clamped to its last slot (a step that beam
    search takes after its exit test, whose outputs it discards, may land
    there). ``ancestry``
    [N, S_max] int32 in [0, beam_size) selects beam mode: self-attention
    reads the un-reordered cache through it (``_beam_self_attend``).
    """
    idx = cache.index
    max_len = cache.self_k.shape[-2]
    at = idx.clamp(max=max_len - 1).reshape(1)
    if ancestry is None:
        pos = torch.arange(max_len, device=x.device)
        self_bias = torch.where(pos <= idx, 0.0, F32_MIN).float()[None, None, None, :]
        anc_b = None
    else:
        if beam_size is None:
            raise ValueError("beam mode needs beam_size")
        anc_b = ancestry.reshape(ancestry.shape[0] // beam_size, beam_size, max_len)
        anc_b = anc_b.to(torch.int32).contiguous()
        beam_bias = valid_bias(max_len, idx, x.device)
    if cache.cross_out is not None and memory_bias is not None:
        raise ValueError(
            "cache was built for an unmasked length-1 memory (cross_out set); "
            "memory_bias is not applicable"
        )
    if memory_bias is None and cache.cross_mask is not None and not cache.beams_share_memory:
        from sonar_tpu_torch.ops.masks import additive_bias

        memory_bias = additive_bias(cache.cross_mask)
    for layer, p in enumerate(layer_slices(stacked_params)):
        sk, sv = cache.self_k[layer], cache.self_v[layer]
        h = layer_norm(p["self_attn_layer_norm"], x)
        k_new, v_new = mha_project_kv(p["self_attn"], h, num_heads)  # [N, H, 1, Dh]
        if anc_b is not None:
            b, hh, kk, _, dh = sk.shape
            for cache_t, new_t in ((sk, k_new), (sv, v_new)):
                cache_t.index_copy_(3, at, new_t.reshape(b, kk, hh, 1, dh).transpose(1, 2)
                                    .to(cache_t.dtype))
            y = x + _beam_self_attend(p["self_attn"], h, sk, sv, anc_b, beam_bias,
                                      num_heads, beam_size)
        else:
            sk.index_copy_(2, at, k_new.to(sk.dtype))
            sv.index_copy_(2, at, v_new.to(sv.dtype))
            y = x + mha_attend(p["self_attn"], h, sk, sv, self_bias, num_heads)
        if cache.cross_out is not None:
            y = y + cache.cross_out[layer]
        elif cache.beams_share_memory:
            h = layer_norm(p["encoder_decoder_attn_layer_norm"], y)
            y = y + _beam_cross_attend(p["encoder_decoder_attn"], h, cache.cross_k[layer],
                                       cache.cross_v[layer], cache.cross_mask, num_heads,
                                       beam_size)
        else:
            h = layer_norm(p["encoder_decoder_attn_layer_norm"], y)
            y = y + mha_attend(p["encoder_decoder_attn"], h, cache.cross_k[layer],
                               cache.cross_v[layer], memory_bias, num_heads)
        h = layer_norm(p["ffn_layer_norm"], y)
        x = y + ffn(p["ffn"], h, activation)
    cache.index.add_(1)
    return x, cache
