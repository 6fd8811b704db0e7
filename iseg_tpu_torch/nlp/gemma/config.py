"""Gemma configs/presets (reference ``nlp/gemma/gemma_presets.py``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 256000
    num_layers: int = 18
    num_heads: int = 8
    num_kv_heads: int = 1
    hidden_dim: int = 2048
    intermediate_dim: int = 16384
    head_dim: int = 256
    layer_norm_epsilon: float = 1e-6
    rope_max_wavelength: float = 10000.0
    dropout: float = 0.0


GEMMA_PRESETS: dict[str, GemmaConfig] = {
    "gemma_2b_en": GemmaConfig(
        num_layers=18, num_heads=8, num_kv_heads=1,
        hidden_dim=2048, intermediate_dim=16384, head_dim=256,
    ),
    "gemma_7b_en": GemmaConfig(
        num_layers=28, num_heads=16, num_kv_heads=16,
        hidden_dim=3072, intermediate_dim=24576, head_dim=256,
    ),
    # instruct variants share the base architectures (reference
    # gemma_presets.py — the difference is the published weights)
    "gemma_instruct_2b_en": GemmaConfig(
        num_layers=18, num_heads=8, num_kv_heads=1,
        hidden_dim=2048, intermediate_dim=16384, head_dim=256,
    ),
    "gemma_instruct_7b_en": GemmaConfig(
        num_layers=28, num_heads=16, num_kv_heads=16,
        hidden_dim=3072, intermediate_dim=24576, head_dim=256,
    ),
    # tiny config for tests
    "gemma_test": GemmaConfig(
        vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
        hidden_dim=64, intermediate_dim=128, head_dim=16,
    ),
}


def get_preset(name: str) -> GemmaConfig:
    if name not in GEMMA_PRESETS:
        raise KeyError(f"unknown Gemma preset {name!r}; have {sorted(GEMMA_PRESETS)}")
    return GEMMA_PRESETS[name]
