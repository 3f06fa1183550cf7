"""Asset store: model registry, download cache, card resolution.

The port's own copy of ``sonar_tpu.assets.store``, with the same registry
(``cards/registry.yaml``) and cache. PyYAML is imported only when a registry
is read, so the port imports without it.

Counterpart of fairseq2's AssetCard system as used by SONAR
(``sonar/__init__.py:48-150``, ``sonar/cards/*.yaml``): a single YAML
registry maps model names -> (family, arch, checkpoint URL, tokenizer).
Checkpoints are cached under ``$SONAR_TPU_CACHE`` (default
``~/.cache/sonar_tpu``); pre-seeded caches work fully offline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import os
from pathlib import Path
from typing import Dict, List, Optional
import urllib.request

_CARDS_DIR = Path(__file__).parent / "cards"


@dataclass
class ModelCard:
    name: str
    family: str
    arch: str
    checkpoint: Optional[str] = None
    tokenizer: Optional[str] = None
    langs: List[str] = field(default_factory=list)
    extra: Dict = field(default_factory=dict)


@dataclass
class TokenizerCard:
    name: str
    family: str
    model: str
    default_lang: Optional[str] = None


class AssetStore:
    def __init__(self, registry_paths: Optional[List[Path]] = None):
        self.models: Dict[str, ModelCard] = {}
        self.tokenizers: Dict[str, TokenizerCard] = {}
        self.text_languages: List[str] = []
        paths = list(registry_paths or [])
        default = _CARDS_DIR / "registry.yaml"
        if default.exists():
            paths.insert(0, default)
        extra_dir = os.environ.get("SONAR_TPU_CARDS")
        if extra_dir:
            paths.extend(sorted(Path(extra_dir).glob("*.yaml")))
        for p in paths:
            self._load_registry(p)

    def _load_registry(self, path: Path) -> None:
        import yaml

        data = yaml.safe_load(path.read_text())
        if not data:
            return
        self.text_languages = data.get("text_languages", self.text_languages)
        for name, spec in (data.get("models") or {}).items():
            known = {"family", "arch", "checkpoint", "tokenizer", "langs"}
            self.models[name] = ModelCard(
                name=name,
                family=spec["family"],
                arch=spec.get("arch", "basic"),
                checkpoint=spec.get("checkpoint"),
                tokenizer=spec.get("tokenizer"),
                langs=spec.get("langs", []),
                extra={k: v for k, v in spec.items() if k not in known},
            )
        for name, spec in (data.get("tokenizers") or {}).items():
            self.tokenizers[name] = TokenizerCard(
                name=name,
                family=spec["family"],
                model=spec["model"],
                default_lang=spec.get("default_lang"),
            )

    def model_card(self, name: str) -> ModelCard:
        if name not in self.models:
            raise KeyError(
                f"unknown model '{name}'; known: {sorted(self.models)[:8]}..."
            )
        return self.models[name]

    def tokenizer_card(self, name: str) -> TokenizerCard:
        if name not in self.tokenizers:
            raise KeyError(f"unknown tokenizer '{name}'")
        return self.tokenizers[name]

    def register_model(self, card: ModelCard) -> None:
        """In-process card registration (the reference test pattern:
        ``tests/unit_tests/test_tied_weights.py:21-37``)."""
        self.models[card.name] = card


def cache_dir() -> Path:
    d = Path(os.environ.get("SONAR_TPU_CACHE", "~/.cache/sonar_tpu")).expanduser()
    d.mkdir(parents=True, exist_ok=True)
    return d


# Leaf filenames too generic to identify an asset: several registry URLs
# end in the same name (both BLASER checkpoints are HF ".../resolve/main/
# model.pt"), which would collide in the flat cache directory and silently
# serve the wrong weights.
_GENERIC_LEAF_NAMES = frozenset(
    {"model.pt", "model.bin", "model.safetensors", "pytorch_model.bin",
     "checkpoint.pt"}
)
_URL_PATH_NOISE = frozenset({"resolve", "blob", "raw", "main", "master"})


def cache_filename(url: str) -> str:
    """Deterministic cache filename for a URL: the basename, qualified
    with the repository segment when the basename alone is generic
    (e.g. ``.../blaser-2.0-qe/resolve/main/model.pt`` ->
    ``blaser-2.0-qe-model.pt``)."""
    tail = url.split("://", 1)[-1]
    parts = [p for p in tail.split("/")[1:] if p]
    if not parts:  # no path segment: fall back to the hostname
        return tail.split("/", 1)[0] or "asset"
    name = parts[-1]
    if name in _GENERIC_LEAF_NAMES:
        qual = next(
            (p for p in reversed(parts[:-1]) if p not in _URL_PATH_NOISE),
            "",
        )
        if qual:
            name = f"{qual}-{name}"
    return name


def cached_path(url_or_path: str) -> Path:
    """Resolve a URL (download+cache) or local/file:// path to a local file."""
    if url_or_path.startswith("file://"):
        return Path(url_or_path[7:])
    if "://" not in url_or_path:
        return Path(url_or_path)
    fname = cache_filename(url_or_path)
    target = cache_dir() / fname
    if target.exists():
        return target
    # Per-process temp name + atomic os.replace: concurrent cold starts
    # (several server processes downloading the same checkpoint) must not
    # share a ".part" inode — the first finisher's rename would otherwise
    # publish a file the laggard is still writing into.
    tmp = target.with_suffix(target.suffix + f".part.{os.getpid()}")
    try:
        urllib.request.urlretrieve(url_or_path, tmp)
        os.replace(tmp, target)
    except OSError as e:
        raise RuntimeError(
            f"cannot download {url_or_path} (offline?). Pre-seed the cache at "
            f"{target} to use this asset without network access."
        ) from e
    finally:
        tmp.unlink(missing_ok=True)  # no stale .part after a failed download
    return target


_default_store: Optional[AssetStore] = None


def default_store() -> AssetStore:
    global _default_store
    if _default_store is None:
        _default_store = AssetStore()
    return _default_store
