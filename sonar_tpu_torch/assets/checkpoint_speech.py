"""Speech (w2v-BERT Conformer) checkpoint conversion.

Key-map facts pinned by the reference converter
(``sonar/models/sonar_speech/handler.py:46-110``): fairseq1 w2v-BERT keys
(``encoder.w2v_model.*``, ``decoder.*``) -> fairseq2 names, ``mask_emb`` and
``pos_conv`` deleted, and the accidental post-Conformer LayerNorm relocated
to the model level (the pre-LN pretraining artifact).

Layout conversion:
- torch Conv1d pointwise [out, in, 1] -> kernel [in, out] (matmul form),
- depthwise [D, 1, K] -> [K, 1, D] (lax.conv WIO layout),
- Linear [out, in] -> [in, out]; per-layer tensors stacked (scan layout).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from sonar_tpu_torch.assets.checkpoint import (
    _layer_norm,
    _linear,
    _mha,
    _num_layers,
    _stack,
    remap_fairseq_keys,
)

FS1_SPEECH_KEY_MAP = {
    r"^encoder\.w2v_model\.layer_norm\.": r"encoder_frontend.post_extract_layer_norm.",
    r"^encoder\.w2v_model\.post_extract_proj\.": r"encoder_frontend.model_dim_proj.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.conv_module\.batch_norm\.": r"encoder.layers.\1.conv.batch_norm.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.conv_module\.depthwise_conv\.": r"encoder.layers.\1.conv.depthwise_conv.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.conv_module\.layer_norm\.": r"encoder.layers.\1.conv_layer_norm.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.conv_module\.pointwise_conv1\.": r"encoder.layers.\1.conv.pointwise_conv1.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.conv_module\.pointwise_conv2\.": r"encoder.layers.\1.conv.pointwise_conv2.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.ffn(1|2)\.layer_norm\.": r"encoder.layers.\1.ffn\2_layer_norm.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.ffn(1|2)\.w_1\.": r"encoder.layers.\1.ffn\2.inner_proj.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.ffn(1|2)\.w_2\.": r"encoder.layers.\1.ffn\2.output_proj.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.self_attn_layer_norm\.": r"encoder.layers.\1.self_attn_layer_norm.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.self_attn\.linear_q\.": r"encoder.layers.\1.self_attn.q_proj.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.self_attn\.linear_k\.": r"encoder.layers.\1.self_attn.k_proj.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.self_attn\.linear_v\.": r"encoder.layers.\1.self_attn.v_proj.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.self_attn\.linear_out\.": r"encoder.layers.\1.self_attn.output_proj.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.self_attn\.linear_pos\.": r"encoder.layers.\1.self_attn.sdpa.r_proj.",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.self_attn\.pos_bias_u": r"encoder.layers.\1.self_attn.sdpa.u_bias",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.self_attn\.pos_bias_v": r"encoder.layers.\1.self_attn.sdpa.v_bias",
    r"^encoder\.w2v_model\.encoder\.layers\.([0-9]+)\.final_layer_norm\.": r"encoder.layers.\1.layer_norm.",
    # Conformer pretraining artifact: relocate the encoder-final LN to the
    # model level (handler.py:102-108).
    r"^encoder\.w2v_model\.encoder\.layer_norm\.": r"layer_norm.",
    r"^decoder\.embed_tokens\.": r"encoder_pooler.decoder_frontend.embed.",
    r"^decoder\.layers\.([0-9]+)\.self_attn_layer_norm\.": r"encoder_pooler.decoder.layers.\1.self_attn_layer_norm.",
    r"^decoder\.layers\.([0-9]+)\.self_attn\.out_proj\.": r"encoder_pooler.decoder.layers.\1.self_attn.output_proj.",
    r"^decoder\.layers\.([0-9]+)\.self_attn\.": r"encoder_pooler.decoder.layers.\1.self_attn.",
    r"^decoder\.layers\.([0-9]+)\.encoder_attn_layer_norm\.": r"encoder_pooler.decoder.layers.\1.encoder_decoder_attn_layer_norm.",
    r"^decoder\.layers\.([0-9]+)\.encoder_attn\.out_proj\.": r"encoder_pooler.decoder.layers.\1.encoder_decoder_attn.output_proj.",
    r"^decoder\.layers\.([0-9]+)\.encoder_attn\.": r"encoder_pooler.decoder.layers.\1.encoder_decoder_attn.",
    r"^decoder\.layers\.([0-9]+)\.fc1\.": r"encoder_pooler.decoder.layers.\1.ffn.inner_proj.",
    r"^decoder\.layers\.([0-9]+)\.fc2\.": r"encoder_pooler.decoder.layers.\1.ffn.output_proj.",
    r"^decoder\.layers\.([0-9]+)\.final_layer_norm\.": r"encoder_pooler.decoder.layers.\1.ffn_layer_norm.",
    r"^decoder\.embed_out": r"encoder_pooler.projection_out.weight",
}

_DROP = (
    "encoder.w2v_model.mask_emb",
    "encoder.w2v_model.encoder.pos_conv.0.bias",
    "encoder.w2v_model.encoder.pos_conv.0.weight_g",
    "encoder.w2v_model.encoder.pos_conv.0.weight_v",
)


def convert_speech_state(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    if "encoder_frontend.model_dim_proj.weight" in flat:
        return flat
    flat = {k: v for k, v in flat.items() if k not in _DROP and "num_batches_tracked" not in k}
    return remap_fairseq_keys(flat, FS1_SPEECH_KEY_MAP)


def _conv_module(flat, prefix: str) -> Dict[str, Any]:
    pw1 = flat[f"{prefix}.pointwise_conv1.weight"]  # [2D, D, 1]
    pw2 = flat[f"{prefix}.pointwise_conv2.weight"]  # [D, D, 1]
    dw = flat[f"{prefix}.depthwise_conv.weight"]    # [D, 1, K]
    return {
        "pointwise_conv1": {"kernel": np.ascontiguousarray(pw1[:, :, 0].T)},
        "pointwise_conv2": {"kernel": np.ascontiguousarray(pw2[:, :, 0].T)},
        "depthwise_conv": {"kernel": np.ascontiguousarray(dw.transpose(2, 1, 0))},
        "batch_norm": {
            "weight": flat[f"{prefix}.batch_norm.weight"],
            "bias": flat[f"{prefix}.batch_norm.bias"],
            "running_mean": flat[f"{prefix}.batch_norm.running_mean"],
            "running_var": flat[f"{prefix}.batch_norm.running_var"],
        },
    }


def speech_encoder_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    flat = convert_speech_state(flat)
    n = _num_layers(flat, "encoder.layers")
    layers = []
    for i in range(n):
        p = f"encoder.layers.{i}"
        layers.append(
            {
                "ffn1_layer_norm": _layer_norm(flat, f"{p}.ffn1_layer_norm"),
                "ffn1": {
                    "inner_proj": _linear(flat, f"{p}.ffn1.inner_proj"),
                    "output_proj": _linear(flat, f"{p}.ffn1.output_proj"),
                },
                "self_attn_layer_norm": _layer_norm(flat, f"{p}.self_attn_layer_norm"),
                "self_attn": {
                    **_mha(flat, f"{p}.self_attn"),
                    "sdpa": {
                        "r_proj": _linear(flat, f"{p}.self_attn.sdpa.r_proj"),
                        "u_bias": flat[f"{p}.self_attn.sdpa.u_bias"],
                        "v_bias": flat[f"{p}.self_attn.sdpa.v_bias"],
                    },
                },
                "conv_layer_norm": _layer_norm(flat, f"{p}.conv_layer_norm"),
                "conv": _conv_module(flat, f"{p}.conv"),
                "ffn2_layer_norm": _layer_norm(flat, f"{p}.ffn2_layer_norm"),
                "ffn2": {
                    "inner_proj": _linear(flat, f"{p}.ffn2.inner_proj"),
                    "output_proj": _linear(flat, f"{p}.ffn2.output_proj"),
                },
                "layer_norm": _layer_norm(flat, f"{p}.layer_norm"),
            }
        )
    params: Dict[str, Any] = {
        "encoder_frontend": {
            "post_extract_layer_norm": _layer_norm(
                flat, "encoder_frontend.post_extract_layer_norm"
            ),
            "model_dim_proj": _linear(flat, "encoder_frontend.model_dim_proj"),
        },
        "encoder": {"layers": _stack(layers)},
        "layer_norm": _layer_norm(flat, "layer_norm"),
        "encoder_pooler": _pooler_params(flat),
    }
    return params


def _pooler_params(flat) -> Dict[str, Any]:
    stem = "encoder_pooler"
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
                "ffn": {
                    "inner_proj": _linear(flat, f"{p}.ffn.inner_proj"),
                    "output_proj": _linear(flat, f"{p}.ffn.output_proj"),
                },
                "ffn_layer_norm": _layer_norm(flat, f"{p}.ffn_layer_norm"),
            }
        )
    pooler: Dict[str, Any] = {
        "decoder_frontend": {
            "embed": {"weight": flat[f"{stem}.decoder_frontend.embed.weight"]}
        },
        "decoder": {"layers": _stack(layers)},
        "projection_out": {
            "kernel": np.ascontiguousarray(flat[f"{stem}.projection_out.weight"].T)
        },
    }
    if f"{stem}.decoder.layer_norm.weight" in flat:
        pooler["decoder"]["layer_norm"] = _layer_norm(flat, f"{stem}.decoder.layer_norm")
    return pooler
