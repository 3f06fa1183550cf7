"""Checkpoint conversion: torch state dicts -> parameter trees in the JAX layout.

The port's own copy of ``sonar_tpu.assets.checkpoint`` (numpy only: the
layer stacking is ``np.stack``, not a jax tree map).

Handles both published formats (reference logic:
``sonar/models/sonar_text/handler.py:52-94`` (encoder), ``:122-172``
(decoder)):

1. fairseq2-native checkpoints (``{"model": {...}}`` with
   ``encoder_frontend.embed.weight`` keys) — direct layout conversion;
2. legacy fairseq1 checkpoints (``{"state_dict": {...}}`` with
   ``layers.N.self_attn.q_proj`` keys) — regex key remap + the
   (BOS, PAD, EOS, UNK) -> (PAD, UNK, BOS, EOS) control-token embedding row
   permutation (rows [0,1,2,3] <- [1,3,0,2]).

Layout conversion to JAX:
- torch Linear ``weight`` [out, in] -> ``kernel`` [in, out] (transposed),
- per-layer tensors are stacked along a leading L axis (scan layout),
- everything lands as numpy fp32; device placement happens at model build.

Torch is used on the host only, for unpickling ``.pt`` files.

``save_params`` / ``load_params`` write and read the JAX package's flat
``.npz`` native format (what ``scripts/convert_checkpoint.py`` writes).
"""

from __future__ import annotations

from pathlib import Path
import re
from typing import Any, Dict, List, Union

import numpy as np

# -- generic helpers ----------------------------------------------------------


def load_torch_state_dict(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Load a .pt checkpoint into {flat_key: np.ndarray} (host-side torch)."""
    import torch

    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt and isinstance(ckpt["model"], dict):
        state = ckpt["model"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        state = ckpt["state_dict"]
    else:
        state = ckpt
    out = {}
    for k, v in state.items():
        if hasattr(v, "detach"):
            # np.array(copy=True) detaches from torch-owned memory: numpy
            # transpose-copies out of torch buffers are pathologically
            # slow (~70x measured), which would make 600M-param
            # conversions take hours.
            out[k] = np.array(
                v.detach().to(torch.float32).cpu().numpy(), copy=True
            )
    return out


def remap_fairseq_keys(state: Dict[str, np.ndarray], key_map: Dict[str, str]) -> Dict[str, np.ndarray]:
    """Apply regex prefix remapping (fairseq2 ``convert_fairseq_checkpoint``)."""
    out = {}
    for key, value in state.items():
        new_key = key
        for pat, repl in key_map.items():
            m = re.match(pat, key)
            if m:
                new_key = re.sub(pat, repl, key)
                break
        out[new_key] = value
    return out


def permute_control_tokens(embed: np.ndarray) -> np.ndarray:
    """(BOS, PAD, EOS, UNK) -> (PAD, UNK, BOS, EOS): rows [0..3] <- [1,3,0,2].

    Reference: ``sonar/models/sonar_text/handler.py:89-92,166-171``.
    """
    out = embed.copy()
    out[[0, 1, 2, 3]] = embed[[1, 3, 0, 2]]
    return out


def _linear(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    p: Dict[str, np.ndarray] = {"kernel": np.ascontiguousarray(flat[prefix + ".weight"].T)}
    if prefix + ".bias" in flat:
        p["bias"] = flat[prefix + ".bias"]
    return p


def _layer_norm(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"weight": flat[prefix + ".weight"], "bias": flat[prefix + ".bias"]}


def _stack(layer_dicts: List[Dict]) -> Dict:
    """List of per-layer nested dicts -> stacked leaves with leading L axis."""
    first = layer_dicts[0]
    return {
        k: _stack([ld[k] for ld in layer_dicts]) if isinstance(first[k], dict)
        else np.stack([ld[k] for ld in layer_dicts])
        for k in first
    }


def _mha(flat, prefix) -> Dict:
    return {
        "q_proj": _linear(flat, f"{prefix}.q_proj"),
        "k_proj": _linear(flat, f"{prefix}.k_proj"),
        "v_proj": _linear(flat, f"{prefix}.v_proj"),
        "output_proj": _linear(flat, f"{prefix}.output_proj"),
    }


def _ffn(flat, prefix) -> Dict:
    return {
        "inner_proj": _linear(flat, f"{prefix}.inner_proj"),
        "output_proj": _linear(flat, f"{prefix}.output_proj"),
    }


def _num_layers(flat: Dict[str, np.ndarray], stem: str) -> int:
    pat = re.compile(re.escape(stem) + r"\.(\d+)\.")
    idxs = {int(m.group(1)) for k in flat if (m := pat.match(k))}
    return max(idxs) + 1 if idxs else 0


# -- fairseq1 -> fairseq2 key maps (facts pinned by the reference handlers) ---

FS1_TEXT_ENCODER_KEY_MAP = {
    r"^layers\.([0-9]+)\.self_attn\.q_proj\.": r"encoder.layers.\1.self_attn.q_proj.",
    r"^layers\.([0-9]+)\.self_attn\.v_proj\.": r"encoder.layers.\1.self_attn.v_proj.",
    r"^layers\.([0-9]+)\.self_attn\.k_proj\.": r"encoder.layers.\1.self_attn.k_proj.",
    r"^layers\.([0-9]+)\.self_attn\.out_proj\.": r"encoder.layers.\1.self_attn.output_proj.",
    r"^layers\.([0-9]+)\.self_attn_layer_norm\.": r"encoder.layers.\1.self_attn_layer_norm.",
    r"^layers\.([0-9]+)\.fc1\.": r"encoder.layers.\1.ffn.inner_proj.",
    r"^layers\.([0-9]+)\.fc2\.": r"encoder.layers.\1.ffn.output_proj.",
    r"^layers\.([0-9]+)\.final_layer_norm\.": r"encoder.layers.\1.ffn_layer_norm.",
    r"^embed_tokens\.": r"encoder_frontend.embed.",
    r"^layer_norm\.": r"layer_norm.",
}

FS1_TEXT_DECODER_KEY_MAP = {
    r"^layers\.([0-9]+)\.self_attn\.k_proj\.": r"decoder.layers.\1.self_attn.k_proj.",
    r"^layers\.([0-9]+)\.self_attn\.v_proj\.": r"decoder.layers.\1.self_attn.v_proj.",
    r"^layers\.([0-9]+)\.self_attn\.q_proj\.": r"decoder.layers.\1.self_attn.q_proj.",
    r"^layers\.([0-9]+)\.self_attn\.out_proj\.": r"decoder.layers.\1.self_attn.output_proj.",
    r"^layers\.([0-9]+)\.self_attn_layer_norm\.": r"decoder.layers.\1.self_attn_layer_norm.",
    r"^layers\.([0-9]+)\.ffn\.inner_proj\.": r"decoder.layers.\1.ffn.inner_proj.",
    r"^layers\.([0-9]+)\.ffn\.output_proj\.": r"decoder.layers.\1.ffn.output_proj.",
    r"^layers\.([0-9]+)\.ffn_layer_norm\.": r"decoder.layers.\1.ffn_layer_norm.",
    r"^layers\.([0-9]+)\.encoder_attn\.k_proj\.": r"decoder.layers.\1.encoder_decoder_attn.k_proj.",
    r"^layers\.([0-9]+)\.encoder_attn\.v_proj\.": r"decoder.layers.\1.encoder_decoder_attn.v_proj.",
    r"^layers\.([0-9]+)\.encoder_attn\.q_proj\.": r"decoder.layers.\1.encoder_decoder_attn.q_proj.",
    r"^layers\.([0-9]+)\.encoder_attn\.out_proj\.": r"decoder.layers.\1.encoder_decoder_attn.output_proj.",
    r"^layers\.([0-9]+)\.encoder_attn_layer_norm\.": r"decoder.layers.\1.encoder_decoder_attn_layer_norm.",
    r"^layers\.([0-9]+)\.fc1\.": r"decoder.layers.\1.ffn.inner_proj.",
    r"^layers\.([0-9]+)\.fc2\.": r"decoder.layers.\1.ffn.output_proj.",
    r"^layers\.([0-9]+)\.final_layer_norm\.": r"decoder.layers.\1.ffn_layer_norm.",
    r"^output_projection\.": r"final_proj.",
    r"^embed_tokens\.": r"decoder_frontend.embed.",
    r"^layer_norm\.": r"decoder.layer_norm.",
}

_DROP_KEYS = ("version", "embed_positions._float_tensor")


def _is_fairseq2_format(flat: Dict[str, np.ndarray], marker: str) -> bool:
    return marker in flat


def convert_text_encoder_state(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Normalize either checkpoint flavor to fairseq2-style flat keys."""
    if _is_fairseq2_format(flat, "encoder_frontend.embed.weight"):
        return flat
    flat = {k: v for k, v in flat.items() if k not in _DROP_KEYS}
    out = remap_fairseq_keys(flat, FS1_TEXT_ENCODER_KEY_MAP)
    out["encoder_frontend.embed.weight"] = permute_control_tokens(
        out["encoder_frontend.embed.weight"]
    )
    return out


def convert_text_decoder_state(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    if _is_fairseq2_format(flat, "decoder_frontend.embed.weight"):
        return flat
    flat = {k: v for k, v in flat.items() if k not in _DROP_KEYS}
    out = remap_fairseq_keys(flat, FS1_TEXT_DECODER_KEY_MAP)
    out["decoder_frontend.embed.weight"] = permute_control_tokens(
        out["decoder_frontend.embed.weight"]
    )
    return out


# -- flat fairseq2 keys -> SONAR-TPU pytrees ----------------------------------


def text_encoder_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    flat = convert_text_encoder_state(flat)
    n = _num_layers(flat, "encoder.layers")
    layers = []
    for i in range(n):
        p = f"encoder.layers.{i}"
        layers.append(
            {
                "self_attn": _mha(flat, f"{p}.self_attn"),
                "self_attn_layer_norm": _layer_norm(flat, f"{p}.self_attn_layer_norm"),
                "ffn": _ffn(flat, f"{p}.ffn"),
                "ffn_layer_norm": _layer_norm(flat, f"{p}.ffn_layer_norm"),
            }
        )
    params: Dict[str, Any] = {
        "encoder_frontend": {"embed": {"weight": flat["encoder_frontend.embed.weight"]}},
        "encoder": {"layers": _stack(layers)},
        "layer_norm": _layer_norm(flat, "layer_norm"),
    }
    if "encoder.layer_norm.weight" in flat:
        params["encoder"]["layer_norm"] = _layer_norm(flat, "encoder.layer_norm")
    if "pooler.projection_out.weight" in flat:
        params["pooler"] = _attention_pooler_params(flat, "pooler")
    return params


def _attention_pooler_params(flat, stem: str) -> Dict[str, Any]:
    n = _num_layers(flat, f"{stem}.decoder.layers")
    layers = []
    for i in range(n):
        p = f"{stem}.decoder.layers.{i}"
        layers.append(
            {
                "self_attn": _mha(flat, f"{p}.self_attn"),
                "self_attn_layer_norm": _layer_norm(flat, f"{p}.self_attn_layer_norm"),
                "encoder_decoder_attn": _mha(flat, f"{p}.encoder_decoder_attn"),
                "encoder_decoder_attn_layer_norm": _layer_norm(
                    flat, f"{p}.encoder_decoder_attn_layer_norm"
                ),
                "ffn": _ffn(flat, f"{p}.ffn"),
                "ffn_layer_norm": _layer_norm(flat, f"{p}.ffn_layer_norm"),
            }
        )
    pooler: Dict[str, Any] = {
        "decoder_frontend": {
            "embed": {"weight": flat[f"{stem}.decoder_frontend.embed.weight"]}
        },
        "decoder": {"layers": _stack(layers)},
        "projection_out": _linear(flat, f"{stem}.projection_out"),
    }
    if f"{stem}.decoder.layer_norm.weight" in flat:
        pooler["decoder"]["layer_norm"] = _layer_norm(flat, f"{stem}.decoder.layer_norm")
    return pooler


def text_decoder_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    flat = convert_text_decoder_state(flat)
    n = _num_layers(flat, "decoder.layers")
    layers = []
    for i in range(n):
        p = f"decoder.layers.{i}"
        layers.append(
            {
                "self_attn": _mha(flat, f"{p}.self_attn"),
                "self_attn_layer_norm": _layer_norm(flat, f"{p}.self_attn_layer_norm"),
                "encoder_decoder_attn": _mha(flat, f"{p}.encoder_decoder_attn"),
                "encoder_decoder_attn_layer_norm": _layer_norm(
                    flat, f"{p}.encoder_decoder_attn_layer_norm"
                ),
                "ffn": _ffn(flat, f"{p}.ffn"),
                "ffn_layer_norm": _layer_norm(flat, f"{p}.ffn_layer_norm"),
            }
        )
    return {
        "decoder_frontend": {
            "embed": {"weight": flat["decoder_frontend.embed.weight"]}
        },
        "decoder": {
            "layers": _stack(layers),
            "layer_norm": _layer_norm(flat, "decoder.layer_norm"),
        },
        # final_proj is tied to decoder_frontend.embed (factory.py:303-315);
        # a stored final_proj.weight is redundant and intentionally dropped.
    }


# -- native save/load ---------------------------------------------------------
#
# The flat ``.npz`` "native format" of the JAX package
# (``scripts/convert_checkpoint.py`` writes it): one array per leaf, keyed by
# its path through the tree joined with "/".


def _as_numpy(leaf: Any) -> np.ndarray:
    """A numpy array of a leaf; a tensor is detached and copied to the host
    (bf16, which numpy lacks, as fp32)."""
    if hasattr(leaf, "detach"):
        import torch

        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def flatten_params(params: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}."""
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = _as_numpy(v)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict:
    """{"a/b/c": array} -> nested dict (the inverse of ``flatten_params``)."""
    root: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def save_params(path: Union[str, Path], params: Dict) -> None:
    np.savez(path, **flatten_params(params))


def load_params(path: Union[str, Path]) -> Dict:
    """The tree of numpy arrays that ``save_params`` (of either package)
    wrote; ``convert.*_from_numpy`` builds a model of it."""
    with np.load(path) as z:
        return unflatten_params({k: z[k] for k in z.files})
