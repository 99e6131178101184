"""Model configuration for the PyTorch port (own copy of ``repro.config``).

Only the fields the ported paths serve are kept.  A :class:`ModelConfig`
describes an architecture by a *block pattern* of layer kinds tiled over
the depth: the attention kinds (``"attn"``, ``"local"``, ``"global"``), the
Griffin recurrent kind ``"rglru"`` and the xLSTM kinds (``"mlstm"``,
``"slstm"``).  An attention layer's FFN is a mixture of experts when
``moe`` is set (:class:`MoEConfig`), else a SwiGLU of width ``d_ff``.
The input is tokens, or precomputed embeddings projected into the
residual stream (``frontend``): audio frames instead of tokens, or
``num_patch_tokens`` vision patches ahead of the text, rotated by M-RoPE.
``param_count`` counts the frame / patch projections as the JAX package
does: not at all.

The workload shapes (:class:`ShapeConfig`, ``SHAPES``) and the device
meshes (:class:`MeshConfig`, ``SINGLE_POD``, ``MULTI_POD``) are the JAX
package's TPU-pod tables, copied value for value as data that the dry run
and the examples read; nothing on the card is sized by them.
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from dataclasses import dataclass
from typing import Optional

ATTN_KINDS = ("attn", "local", "global")       # consume / produce KV
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")  # carry O(1) state a row
ALL_KINDS = ATTN_KINDS + RECURRENT_KINDS


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN: top-k routing over ``num_experts`` SwiGLU
    experts of width ``d_expert``, each taking at most ``capacity_factor``
    times its even share of a call's token slots."""

    num_experts: int
    experts_per_token: int          # top-k
    d_expert: int                   # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    normalize_router_weights: bool = True  # qwen3 renormalises top-k probs


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
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    rope_scaling: float = 1.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    use_qk_norm: bool = False
    frontend: str = "token"          # token | audio_frames | vision_patches
    num_patch_tokens: int = 0        # vlm: patch tokens prepended to the text
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

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> tuple:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def attention_layer_count(self) -> int:
        return sum(1 for k in self.layer_kinds() if k in ATTN_KINDS)

    def recurrent_layer_count(self) -> int:
        return sum(1 for k in self.layer_kinds() if k in RECURRENT_KINDS)

    def is_subquadratic(self) -> bool:
        """True when long-context decode memory does not grow with a full
        attention cache in every layer: no full-attention layer, or at most
        a third of the layers (SSM, hybrid, sliding window)."""
        kinds = self.layer_kinds()
        full = sum(1 for k in kinds if k in ("attn", "global"))
        return full == 0 or (full / len(kinds)) <= 0.34

    def param_count(self) -> int:
        """Total parameters (embedding counted once when tied), layer by
        layer as ``repro.config.ModelConfig.param_count`` counts them."""
        total = self.vocab_size * self.d_model + self.d_model  # + final norm
        if not self.tie_embeddings:
            total += self.d_model * self.vocab_size
        return total + sum(self._layer_params(k) for k in self.layer_kinds())

    def active_param_count(self) -> int:
        """Parameters one token touches: all but the experts it is not
        routed to (``repro.config``'s count, which takes every layer of
        an MoE arch as an MoE layer)."""
        total = self.param_count()
        if self.moe is None:
            return total
        inactive = self.moe.num_experts - self.moe.experts_per_token
        return total - (inactive * 3 * self.d_model * self.moe.d_expert
                        * self.num_layers_with_moe())

    def num_layers_with_moe(self) -> int:
        return self.num_layers if self.moe is not None else 0

    def _layer_params(self, kind: str) -> int:
        D, F, Dr = self.d_model, self.d_ff, self.d_rnn
        H, Hk, Dh = self.num_heads, self.num_kv_heads, self.head_dim
        mlp = 3 * D * F if F > 0 else 0
        if kind in ATTN_KINDS:
            n = D * H * Dh + 2 * D * Hk * Dh + H * Dh * D + 2 * D
            if self.moe is not None:        # router, then the experts
                E = self.moe.num_experts
                mlp = D * E + E * 3 * D * self.moe.d_expert
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

    def kv_bytes_per_token_per_layer(self, dtype_bytes: int = 2) -> int:
        return 2 * self.num_kv_heads * self.head_dim * dtype_bytes

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV bytes a token over every attention layer (the JAX package's
        count: a local layer counts as a full one)."""
        return self.attention_layer_count() * \
            self.kv_bytes_per_token_per_layer(dtype_bytes)


@dataclass(frozen=True)
class ShapeConfig:
    """A benchmark / dry-run workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token a sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    """A device topology: axis sizes and names."""

    name: str
    shape: tuple
    axes: tuple

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig("single_pod", (16, 16), ("data", "model"))
MULTI_POD = MeshConfig("multi_pod", (2, 16, 16), ("pod", "data", "model"))


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


def list_archs() -> list:
    _load_all_configs()
    return sorted(_REGISTRY)


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
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=4,
                        experts_per_token=min(2, cfg.moe.experts_per_token),
                        d_expert=2 * d_model, capacity_factor=2.0,
                        normalize_router_weights=(
                            cfg.moe.normalize_router_weights))
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
        moe=moe,
        d_rnn=d_model,
        num_patch_tokens=min(cfg.num_patch_tokens, 4),
        max_position_embeddings=4096,
    )
