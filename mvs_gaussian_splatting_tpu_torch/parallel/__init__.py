"""The multi-device training modes on ``torch.distributed`` (counterpart of
the JAX package's ``parallel/``): camera batches (``data_parallel``), tile
sharding (``tile_stream``, ``tile_parallel``, ``tile_train``), both at once
(``grid_train``) and Gaussian sharding (``gauss_stream``, ``gauss_train``).

The JAX package drives a device mesh from one process and lets
``shard_map`` insert the collectives. The port runs one process per device
(SPMD, as ``torchrun`` starts them): every rank holds the replicated state,
draws the same random numbers, and the reductions that ``shard_map``'s
transpose makes implicit are explicit collectives here. At world size 1
every mode runs its sharded code with one shard and no process group.
"""
