"""The parallel layer (counterpart of the JAX package's parallel/): data
parallelism over ``torch.distributed`` (``mesh``), multi-process init and
gathers (``multihost``), the one-model-per-device ensemble (``ensemble``),
and tensor, sequence and pipeline parallelism (``tp``, ``sp``, ``pp``)."""
from .mesh import create_mesh, replicate_tree, shard_batch
