"""The parallel layer on ``torch.distributed``: one process per rank, the
JAX package's named-axis collectives as methods of a ``Mesh``."""
