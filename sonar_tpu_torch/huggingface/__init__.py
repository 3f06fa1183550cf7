"""HuggingFace ``datasets`` batch layer over the port's pipelines.

The port's copy of ``sonar_tpu.huggingface``, with the same names. Every
pipeline it builds runs on ``PipelineConfig.device``, the GPU (``"cuda"``)
unless the config says ``"cpu"``. ``datasets`` is imported only inside the
functions that need it, so this package imports where it is absent.
"""

from sonar_tpu_torch.huggingface.pipeline import (  # noqa: F401
    DatasetConfig,
    Pipeline,
    PipelineConfig,
)
from sonar_tpu_torch.huggingface.text import (  # noqa: F401
    HFEmbeddingToTextPipeline,
    HFEmbeddingToTextPipelineConfig,
    HFTextToEmbeddingPipeline,
    HFTextToEmbeddingPipelineConfig,
    TextSegmentationPipeline,
    TextSegmentationPipelineConfig,
    split_sentences,
)
