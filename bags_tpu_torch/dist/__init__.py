"""Tile-parallel training over `torch.distributed` ranks (port of
`bags_tpu/dist/`): `mesh.py` the process-group helpers and collectives,
`sharded.py` the sharded render, loss and train step, `trainer.py` the
`ShardedTrainer` and `init_distributed`."""
