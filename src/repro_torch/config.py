"""Model configuration for the PyTorch port (own copy of ``repro.config``).

Only the fields the ported path serves are kept.  A :class:`ModelConfig`
describes an architecture by a *block pattern* of layer kinds tiled over
the depth; this slice runs the attention kinds ``"attn"`` and ``"global"``
and refuses every other kind at model construction (see
``repro_torch.models.model.check_supported``).
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from dataclasses import dataclass

ALL_KINDS = ("attn", "local", "global", "rglru", "mlstm", "slstm")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  All sizes are in elements, not bytes."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    block_pattern: tuple = ("attn",)
    window_size: int = 0             # sliding-window size for "local" layers
    rope_theta: float = 10000.0
    rope_scaling: float = 1.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    use_qk_norm: bool = False
    logit_softcap: float = 0.0
    scale_embeddings: bool = False
    max_position_embeddings: int = 131072
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: q heads {self.num_heads} not "
                             f"divisible by kv heads {self.num_kv_heads}")
        for k in self.block_pattern:
            if k not in ALL_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")

    def layer_kinds(self) -> tuple:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def param_count(self) -> int:
        """Total parameters of a dense attention decoder."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, Hk, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        per_layer = D * H * Dh + 2 * D * Hk * Dh + H * Dh * D + 2 * D
        if self.use_qk_norm:
            per_layer += 2 * Dh
        if F > 0:
            per_layer += 3 * D * F
        total = V * D + D + self.num_layers * per_layer
        return total if self.tie_embeddings else total + D * V


_REGISTRY: dict = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all_configs() -> None:
    from repro_torch import configs as _pkg
    for m in pkgutil.iter_modules(_pkg.__path__):
        importlib.import_module(f"repro_torch.configs.{m.name}")


def get_arch(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all_configs()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def reduced_config(cfg: ModelConfig, *, num_layers: int = 0,
                   d_model: int = 64, vocab: int = 128) -> ModelConfig:
    """A tiny config of the same family for CPU tests; the same shrinking
    rule as ``repro.config.reduced_config``, so both packages build the
    same shapes from the same arch."""
    period = len(cfg.block_pattern)
    if num_layers == 0:
        num_layers = period + max(1, period // 2)
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(heads, cfg.num_kv_heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=max(8, d_model // heads),
        d_ff=0 if cfg.d_ff == 0 else 4 * d_model,
        vocab_size=vocab,
        window_size=min(cfg.window_size, 32) if cfg.window_size else 0,
        max_position_embeddings=4096,
    )
