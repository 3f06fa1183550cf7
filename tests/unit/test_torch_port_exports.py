"""The port exports what ``sonar_tpu`` exports, and stays light to import.

The lists of names are read from the JAX package (these tests may import
both); the port itself never reads them.
"""

import subprocess
import sys

import pytest

pytest.importorskip("torch")

import sonar_tpu  # noqa: E402
import sonar_tpu.huggingface  # noqa: E402
import sonar_tpu.inference_pipelines  # noqa: E402
import sonar_tpu.parallel.pipeline  # noqa: E402
import sonar_tpu.parallel.sequence  # noqa: E402
import sonar_tpu_torch  # noqa: E402
import sonar_tpu_torch.huggingface  # noqa: E402
import sonar_tpu_torch.inference_pipelines  # noqa: E402


@pytest.mark.parametrize("name", sonar_tpu._PIPELINES + sonar_tpu._HUB)
def test_top_level_name_resolves(name):
    assert callable(getattr(sonar_tpu_torch, name))


def _pipeline_names():
    mod = sonar_tpu.inference_pipelines
    return sorted(n for n, v in vars(mod).items()
                  if isinstance(v, type) and v.__module__.startswith(mod.__name__))


@pytest.mark.parametrize("name", _pipeline_names())
def test_pipeline_name_resolves(name):
    got = getattr(sonar_tpu_torch.inference_pipelines, name)
    assert isinstance(got, type) and got.__name__ == name
    assert got.__module__.startswith("sonar_tpu_torch.inference_pipelines.")


def _public_names(mod):
    return sorted(n for n in vars(mod) if not n.startswith("_")
                  and not isinstance(vars(mod)[n], type(sys)))


@pytest.mark.parametrize("name", _public_names(sonar_tpu.huggingface))
def test_huggingface_name_resolves(name):
    """``sonar_tpu_torch.huggingface`` exports every name that
    ``sonar_tpu.huggingface`` does, each the port's own."""
    got = getattr(sonar_tpu_torch.huggingface, name)
    assert got.__name__ == name
    assert got.__module__.startswith("sonar_tpu_torch.huggingface.")


def test_pipeline_names_cover_the_reference():
    assert len(_pipeline_names()) >= 8  # the five model pipelines, two data pipelines, MuTox


@pytest.mark.parametrize("sub,names", [
    ("nn", ["ConditionalTransformerDecoder", "ConformerConfig", "conformer_stack",
            "embedding_lookup", "layer_norm", "linear", "EmbeddingFrontend", "bilstm_stack",
            "Pooling", "static_pool", "SinusoidalPositionEncoder", "LearnedPositionEncoder",
            "decoder_stack", "encoder_stack", "fuse_qkv", "dropout", "tree_leaves"]),
    ("ops", ["dispatch_sdpa", "sdpa_xla", "FbankConfig", "batched_fbank", "additive_bias",
             "length_mask", "quantize_params_int8", "records_grad", "set_attention_impl",
             "set_ffn_impl", "no_cuda_kernels", "cuda_kernels_disabled", "kernel_gate_scope",
             "kernels_allowed", "kernel_settings"]),
    ("models", ["ConfigRegistry", "SonarEncoderOutput", "VocabularyInfo"]),
    ("parallel", ["l2_normalize", "cosine_topk", "xsim", "xsim_pp", "mine_bitexts",
                  "sharded_cosine_topk", "sharded_xsim", "sharded_xsim_pp", "Mesh", "SINGLE_MESH",
                  "make_mesh",
                  "param_shardings", "shard_params", "replicate", "data_sharding",
                  "initialize", "shard_for_host", "host_batch_sharding",
                  "global_batch_from_local"]),
    ("training", ["TrainState", "cross_entropy", "translation_loss", "distillation_loss",
                  "classifier_loss", "make_train_step", "init_train_state",
                  "save_train_state", "restore_train_state"]),
])
def test_subpackage_names_resolve(sub, names):
    import importlib

    mod = importlib.import_module(f"sonar_tpu_torch.{sub}")
    for name in names:
        assert getattr(mod, name) is not None
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name")


@pytest.mark.parametrize("jax_name,port_name", [
    ("sonar_tpu.ops.attention:no_tpu_kernels", "no_cuda_kernels"),
    ("sonar_tpu.ops.attention:tpu_kernels_disabled", "cuda_kernels_disabled"),
    ("sonar_tpu.ops.attention:kernel_gate_scope", "kernel_gate_scope"),
    ("sonar_tpu.ops.attention:set_attention_impl", "set_attention_impl"),
    ("sonar_tpu.nn.transformer:set_ffn_impl", "set_ffn_impl"),
])
def test_kernel_selection_names_have_counterparts(jax_name, port_name):
    """The JAX package's kernel-selection API under the port's CUDA names,
    each the port's own (``sonar_tpu_torch.ops.gates``); ``kernels_off_for``
    has none (``sonar_tpu_torch.ops``' docstring says why)."""
    import importlib

    import sonar_tpu_torch.ops

    module, _, name = jax_name.partition(":")
    assert callable(getattr(importlib.import_module(module), name))
    got = getattr(sonar_tpu_torch.ops, port_name)
    assert callable(got) and got.__module__ == "sonar_tpu_torch.ops.gates"
    assert "kernels_off_for" not in sonar_tpu_torch.ops.__all__
    assert "kernels_off_for" in sonar_tpu_torch.ops.__doc__


def _module_functions(mod):
    """A module's ``__all__``, or else the public functions it defines."""
    if hasattr(mod, "__all__"):
        return sorted(mod.__all__)
    return sorted(n for n, v in vars(mod).items() if not n.startswith("_") and callable(v)
                  and getattr(v, "__module__", None) == mod.__name__)


@pytest.mark.parametrize("name", _module_functions(sonar_tpu.parallel.pipeline)
                         + _module_functions(sonar_tpu.parallel.sequence))
def test_pipeline_and_sequence_names_resolve(name):
    """Every public name of the JAX package's ``parallel.pipeline`` and
    ``parallel.sequence`` is the port's own on ``sonar_tpu_torch.parallel``."""
    import sonar_tpu_torch.parallel

    got = getattr(sonar_tpu_torch.parallel, name)
    assert got.__name__ == name
    assert got.__module__ in ("sonar_tpu_torch.parallel.pipeline",
                              "sonar_tpu_torch.parallel.sequence")


def test_import_stays_light():
    """``import sonar_tpu_torch`` (and its subpackages) loads neither the
    kernels' builder nor a model; the first use of an export does."""
    code = (
        "import sys\n"
        "import sonar_tpu_torch, sonar_tpu_torch.inference_pipelines, sonar_tpu_torch.nn\n"
        "import sonar_tpu_torch.ops, sonar_tpu_torch.models, sonar_tpu_torch.training\n"
        "heavy = [m for m in ('sonar_tpu_torch.ops._build', 'sonar_tpu_torch.ops.cuda',\n"
        "                     'sonar_tpu_torch.inference_pipelines.text') if m in sys.modules]\n"
        "assert not heavy, heavy\n"
        "sonar_tpu_torch.load_text_encoder\n"
        "assert 'sonar_tpu_torch.assets.hub' in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True)
