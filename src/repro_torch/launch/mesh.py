"""Production mesh descriptions (counterpart of ``repro.launch.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` over fake host devices for
its dry run.  The port describes the mesh instead, as a
``config.MeshConfig`` (axis names and sizes), and builds no
``torch.distributed`` ``DeviceMesh``: that needs a process group of as
many ranks as the mesh has devices, and the port runs one process on one
card.  The dry run (``launch.dryrun``) reads the sizes to divide each
tensor by its spec (``distributed.sharding``).
"""

from __future__ import annotations

from repro_torch.config import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.distributed.elastic import ElasticPlanner


def make_production_mesh(*, multi_pod: bool = False) -> MeshConfig:
    """16 x 16 = 256 devices a pod; the multi-pod mesh prepends a 2-pod
    axis.

    Axis meanings:
      pod   — the slow, decentralised boundary (pipeline stages when
              serving, folded into data parallelism when training)
      data  — batch / FSDP axis (fast links)
      model — tensor / expert parallel axis (fast links)
    """
    return MULTI_POD if multi_pod else SINGLE_POD


def make_mesh_for(devices: int, *, model_parallel: int = 16) -> MeshConfig:
    """Elastic variant: the largest (data, model) mesh for ``devices``, by
    ``ElasticPlanner``'s plan (a pod axis once two whole pods are live)."""
    plan = ElasticPlanner(model_parallel=model_parallel).plan(devices)
    return MeshConfig(f"elastic_{devices}", plan.shape, plan.axes)
