"""The replica-sharded path of the port: a ``(data, model)`` mesh over torch
devices, in one process.

- ``mesh``    — the mesh (:func:`mesh.make_mesh`) and the pure layout
  functions ``hybrid_grid`` and ``fleet_placement``;
- ``sharded`` — the sharded round driver and ``TorchShardedBackend``:
  instances over ``data`` (no cross-talk), replicas over ``model``, each
  model shard a thread that runs the round body over its receivers, with a
  barrier-fenced all-gather of each step's wire values and a
  barrier-fenced sum of the termination counts;
- ``virtual`` — ``VirtualMeshBackend``, the same driver on CPU tensors
  (``virtual:DxM``).
"""

from byzantinerandomizedconsensus_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
