"""Runnable examples of the PyTorch port (counterparts of the JAX
package's ``examples/`` scripts), each a module with its own ``main``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.offline_serving \\
        [--backend pipelined --stages 2]
    PYTHONPATH=src python -m repro_torch.examples.networked_serving
    PYTHONPATH=src python -m repro_torch.examples.train_small [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.decentralized_market

Each runs on ``cuda`` unless ``--device`` asks for another, with the JAX
scripts' reduced configs and defaults, and prints what they print.  The
hand-written kernels take a head dim of 64, 128 or 256, and the JAX
scripts' reduced width (``reduced_config``'s ``d_model`` 64 over 4 heads:
16 a head) only the plain versions take, so on a CUDA device
``example_config`` widens ``d_model`` until a head is 64 wide.
"""

from repro_torch.config import ModelConfig, get_arch, reduced_config
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models.common import resolve_device


def example_config(arch: str, device=None, **reduce):
    """``(reduced_config(get_arch(arch), **reduce), device)``, the device
    resolved (``cuda`` unless asked); on a CUDA device ``d_model`` is
    widened to ``min(HEAD_DIMS)`` a head when the reduced heads are
    narrower."""
    device = resolve_device(device)
    cfg: ModelConfig = reduced_config(get_arch(arch), **reduce)
    if device.type == "cuda" and cfg.head_dim < min(HEAD_DIMS):
        cfg = reduced_config(get_arch(arch), **{
            **reduce, "d_model": min(HEAD_DIMS) * cfg.num_heads})
    return cfg, device
