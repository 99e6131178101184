"""Model configuration for the PyTorch port (own copy of ``repro.config``).

Only the fields the ported paths serve are kept.  A :class:`ModelConfig`
describes an architecture by a *block pattern* of layer kinds tiled over
the depth; the port runs the attention kinds (``"attn"``, ``"local"``,
``"global"``) and the Griffin recurrent kind ``"rglru"``, and refuses the
xLSTM kinds (``"mlstm"``, ``"slstm"``) at model construction (see
``repro_torch.models.model.check_supported``).
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from dataclasses import dataclass

ATTN_KINDS = ("attn", "local", "global")       # consume / produce KV
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")  # carry O(1) state a row
ALL_KINDS = ATTN_KINDS + RECURRENT_KINDS


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
    d_rnn: int = 0                   # recurrent width (0 -> d_model)
    conv_width: int = 4              # temporal-conv width, recurrent blocks
    max_position_embeddings: int = 131072
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.d_rnn == 0:
            object.__setattr__(self, "d_rnn", self.d_model)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: q heads {self.num_heads} not "
                             f"divisible by kv heads {self.num_kv_heads}")
        for k in self.block_pattern:
            if k not in ALL_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")

    def layer_kinds(self) -> tuple:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def recurrent_layer_count(self) -> int:
        return sum(1 for k in self.layer_kinds() if k in RECURRENT_KINDS)

    def param_count(self) -> int:
        """Total parameters (embedding counted once when tied), layer by
        layer as ``repro.config.ModelConfig.param_count`` counts them."""
        total = self.vocab_size * self.d_model + self.d_model  # + final norm
        if not self.tie_embeddings:
            total += self.d_model * self.vocab_size
        return total + sum(self._layer_params(k) for k in self.layer_kinds())

    def _layer_params(self, kind: str) -> int:
        D, F, Dr = self.d_model, self.d_ff, self.d_rnn
        H, Hk, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        mlp = 3 * D * F if F > 0 else 0
        if kind in ATTN_KINDS:
            n = D * H * Dh + 2 * D * Hk * Dh + H * Dh * D + 2 * D
            return n + (2 * Dh if self.use_qk_norm else 0) + mlp
        if kind == "rglru":
            # in-projections, conv, block-diagonal gates, 2 * Dr for Lambda
            # and the biases (the JAX package's count), out-projection, two
            # norms, the MLP
            return (2 * D * Dr + self.conv_width * Dr
                    + 2 * (Dr * Dr // max(H, 1)) + 2 * Dr
                    + Dr * D + 2 * D + mlp)
        if kind == "mlstm":
            return 2 * D * Dr + 3 * Dr * Dr // max(H, 1) + 3 * Dr + Dr * D + D
        return 4 * D * Dr + 4 * (Dr * Dr // max(H, 1)) + 4 * Dr + Dr * D + D


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
        d_rnn=d_model,
        max_position_embeddings=4096,
    )
