"""Sharding rules: parameters, caches, batches and optimizer state to a
spec per leaf for a device mesh (own copy of ``repro.distributed.sharding``).

A spec is a plain tuple with one entry for each dim of its leaf: a mesh
axis name, a tuple of names (one dim split over several axes), or None
(not split).  A leaf a pipeline places on one stage carries one more
entry in front, ``"pod"``: the JAX package stacks the stages' layers on a
leading dim it splits over the pod axis, and the port's per-layer leaf is
one element of that dim.  ``per_device_bytes`` divides each leaf by its
spec's axis sizes, so the stage entry gives each pod its stages' share.

The rules are the JAX package's, on the port's trees (``models.model``:
one dict a layer under ``"layers"``, an MoE layer's experts under
``"moe"``; dense, paged (``serving.kv_cache``) and pipeline
(``core.pipeline.init_pipeline_caches``) caches).  On the single-pod mesh
``("data", "model")`` (the multi-pod mesh adds ``"pod"``):

  * TP ("model"): attention heads (packed q / kv output dims), FFN hidden,
    MoE experts (expert parallelism), vocab (embedding / unembedding) and
    the recurrent width.  A dim is split only when the axis size divides
    it; otherwise it stays whole (no ragged shards).
  * FSDP ("data", only when asked): the other matmul dim of every large
    matrix.  Serving keeps the weights whole over "data".
  * KV caches: batch over "data"; kv heads over "model" when divisible,
    else the sequence over "model" (sequence-parallel KV); the pipeline's
    stage caches always split the sequence (``seq_kv``).
  * Pipeline ("pod"): a stage's layers live on its pod; only (mb, S, D)
    activations cross the slow link.

The port runs on one card, so nothing here places a tensor: the specs
feed the dry run's per-device byte counts (``launch.dryrun``).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

from repro_torch.config import ModelConfig
from repro_torch.core.pipeline import stage_ranges
from repro_torch.training.optimizer import AdamWState


def mesh_shape(mesh) -> dict:
    """Axis name -> size, from a ``config.MeshConfig`` or such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.axes, mesh.shape))


def _axis(ms: dict, name: Optional[str], dim: int) -> Optional[str]:
    """``name`` if the mesh has it and its size divides ``dim``."""
    if name is None or name not in ms:
        return None
    return name if dim > 0 and dim % ms[name] == 0 else None


def _keys(path) -> list:
    """The dict keys along a path of ``_walk``."""
    return [p for p in path if isinstance(p, str)]


def _walk(tree, fn, path=()):
    """``fn(path, leaf)`` over a nested dict / list / tuple /
    ``AdamWState``; a path step is a dict key (str) or a position (int).
    None stays None (the pipeline caches' empty places)."""
    if isinstance(tree, AdamWState):
        return AdamWState(*(_walk(c, fn, path + (f,))
                            for f, c in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(c, fn, path + (i,))
                          for i, c in enumerate(tree))
    return None if tree is None else fn(path, tree)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

# leaf name -> (tp_dim, fsdp_dim) of the leaf's own shape (None = do not
# split); tp takes "model", fsdp "data"
_PARAM_RULES = {
    "wq": (1, 0), "wk": (1, 0), "wv": (1, 0), "wo": (0, 1),
    "wg": (1, 0), "wu": (1, 0), "wd": (0, 1), "wg_mlp": (1, 0),
    # embeddings: vocab-TP only (the JAX package: FSDP on D as well makes
    # its gather unpartitionable)
    "tok": (0, None), "untok": (0, None),
    "frame_proj": (1, 0), "patch_proj": (1, 0),
    "wx": (1, 0), "conv_w": (1, None), "conv_b": (0, None),
    "gate_a_w": (0, None), "gate_x_w": (0, None),
    "gate_a_b": (0, None), "gate_x_b": (0, None), "lam": (0, None),
    "wm": (1, 0), "wz": (1, 0),
    "w_in": (2, 1), "b_in": (1, None), "r": (1, None),
    "w_i": (0, None), "w_f": (0, None), "b_i": (None, None),
    "b_f": (None, None),
    "router": (None, 0),
    "ln1": (None, None), "ln2": (None, None), "q_norm": (None, None),
    "k_norm": (None, None), "final_norm": (None, None),
}

# MoE expert tensors: the expert dim over "model" (EP), fsdp on dim 1 / 2
_MOE_RULES = {"wg": (0, 1), "wu": (0, 1), "wd": (0, 2)}


def _leaf_spec(name: str, shape: tuple, ms: dict, *, fsdp: bool,
               in_moe: bool) -> tuple:
    rules = _MOE_RULES if (in_moe and name in _MOE_RULES) else _PARAM_RULES
    tp_dim, fsdp_dim = rules.get(name, (None, None))
    spec = [None] * len(shape)
    if tp_dim is not None and tp_dim < len(shape):
        spec[tp_dim] = _axis(ms, "model", shape[tp_dim])
    if fsdp and fsdp_dim is not None and fsdp_dim < len(shape) \
            and spec[fsdp_dim] is None:
        spec[fsdp_dim] = _axis(ms, "data", shape[fsdp_dim])
    return tuple(spec)


def staged_layers(cfg: ModelConfig, n_stages: int) -> int:
    """How many leading layers the pipeline's stages hold (the rest are
    the epilogue), by ``core.pipeline.stage_ranges``' split."""
    return stage_ranges(cfg, n_stages)[-1][0]


def param_specs(params, cfg: ModelConfig, mesh, *, fsdp: bool = False,
                pipeline: bool = False):
    """A spec tree matching ``params``.  ``pipeline=True`` places each
    stage's layers on its pod (the stages are the mesh's pod axis): their
    leaves carry the leading ``"pod"`` entry."""
    ms = mesh_shape(mesh)
    n_staged = staged_layers(cfg, ms["pod"]) if pipeline else 0

    def spec_for(path, leaf):
        keys = _keys(path)
        spec = _leaf_spec(keys[-1], tuple(leaf.shape), ms, fsdp=fsdp,
                          in_moe="moe" in keys)
        staged = keys[0] == "layers" and path[1] < n_staged
        return ("pod",) + spec if staged else spec

    return _walk(params, spec_for)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _cache_leaf_spec(name: str, shape: tuple, cfg: ModelConfig, ms: dict,
                     seq_kv: bool = False) -> tuple:
    """Cache leaves: batch over data; kv heads over model when divisible,
    else the sequence over model.  ``seq_kv`` forces the sequence split
    (the JAX package's stage caches: its partitioner crashes expanding
    head-split KV groups inside the partly manual pod region)."""
    spec = [None] * len(shape)
    md = ms.get("model", 1)

    def set_dim(i, ax_name):
        ax = _axis(ms, ax_name, shape[i])
        if ax and spec[i] is None:
            spec[i] = ax

    head_shard = cfg.num_kv_heads % md == 0 and not seq_kv
    if name in ("k_scale", "v_scale"):        # (B, C, Hk)
        set_dim(0, "data")
        set_dim(2 if head_shard else 1, "model")
    elif name in ("k", "v"):                  # (B, C, Hk, Dh)
        set_dim(0, "data")
        set_dim(2 if head_shard else 1, "model")   # else sequence-parallel
        if spec[0] is None and spec[1] != "model":
            set_dim(1, "data")                # tiny batch: seq over data
    elif name in ("k_pages", "v_pages"):      # (P, page, Hk, Dh)
        set_dim(0, "data")                    # pages over data
        if head_shard:
            set_dim(2, "model")
    elif name == "pos":                       # (B, C)
        set_dim(0, "data")
        if not head_shard:
            set_dim(1, "model")
        elif spec[0] is None:
            set_dim(1, "data")
    elif name == "page_table":                # (B, max_pages)
        set_dim(0, "data")
    elif name in ("h", "conv"):               # rglru (B, Dr) / (B, cw-1, Dr)
        set_dim(0, "data")
        set_dim(len(shape) - 1, "model")
    elif name in ("c", "n", "m"):             # lstm states
        set_dim(0, "data")
        if len(shape) >= 2:
            if cfg.num_heads % md == 0:       # heads over model
                set_dim(1, "model")
            else:                             # else the last dim
                set_dim(len(shape) - 1, "model")
    return tuple(spec)


def cache_specs(caches, cfg: ModelConfig, mesh):
    """A spec tree for dense, paged or pipeline caches.  The pipeline's
    stage caches (under ``"stage"``) are told apart by their key, as in
    the JAX package (whose ``pipeline`` flag is unused): they split the
    sequence, and carry the leading ``"pod"`` entry on a mesh with a pod
    axis (on one without, every stage runs on the same devices)."""
    ms = mesh_shape(mesh)

    def spec_for(path, leaf):
        keys = _keys(path)
        stage = keys[0] == "stage"
        spec = _cache_leaf_spec(keys[-1], tuple(leaf.shape), cfg, ms,
                                seq_kv=stage)
        return ("pod",) + spec if stage and "pod" in ms else spec

    return _walk(caches, spec_for)


# ---------------------------------------------------------------------------
# Batches and optimizer state
# ---------------------------------------------------------------------------


def batch_specs(batch_shapes: dict, mesh, *, batch_axes=("data",),
                fold_pod: bool = True) -> dict:
    """Input batch specs: the leading batch dim over data (and pod, folded
    into data parallelism, when the mesh has it) when their sizes divide
    it; else whole."""
    ms = mesh_shape(mesh)
    group = tuple((["pod"] if fold_pod and "pod" in ms else [])
                  + [a for a in batch_axes if a in ms])
    total = 1
    for a in group:
        total *= ms[a]

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        if group and shape[0] % total == 0:
            first = group[0] if len(group) == 1 else group
            return (first,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return _walk(batch_shapes, spec_for)


def opt_state_specs(pspecs) -> AdamWState:
    """The moments take the parameters' specs; the step is whole."""
    return AdamWState(step=(), m=pspecs, v=pspecs)


# ---------------------------------------------------------------------------
# Bytes a device holds
# ---------------------------------------------------------------------------


def _split(spec: tuple, ms: dict) -> int:
    """The product of the sizes of the axes a spec names."""
    n = 1
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                n *= ms[ax]
    return n


def leaf_bytes(t) -> int:
    return t.numel() * t.element_size()


def per_device_bytes(tree, specs, mesh) -> int:
    """The bytes one device holds of ``tree``: each leaf's bytes over the
    product of its spec's axis sizes, summed (``specs`` as
    ``param_specs`` / ``cache_specs`` / ``batch_specs`` give them)."""
    ms = mesh_shape(mesh)
    total = Fraction(0)

    def visit(t, s):
        nonlocal total
        if isinstance(t, dict):
            for k in t:
                visit(t[k], s[k])
        elif isinstance(t, (list, tuple)):
            for a, b in zip(t, s, strict=True):
                visit(a, b)
        elif t is not None:
            total += Fraction(leaf_bytes(t), _split(s, ms))

    visit(tree, specs)
    return int(total)
