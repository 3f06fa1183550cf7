"""Model definitions of the PyTorch port.

Exports the counterparts of ``sonar_tpu.models``'s names, resolved on first use.
"""

from sonar_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "ConfigRegistry": "common",
    "SonarEncoderOutput": "common",
    "VocabularyInfo": "common",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
