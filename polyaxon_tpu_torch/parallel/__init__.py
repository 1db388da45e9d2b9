"""Multi-GPU parallelism (counterpart of `polyaxon_tpu/parallel/`): the
named device mesh over the ranks of a `torch.distributed` world
(`mesh.py`), the sharding rules as DTensor placements (`sharding.py`),
differentiable collectives (`collectives.py`), and context-parallel
attention over the hand-written flash kernels (`ring.py`, `ulysses.py`)."""
