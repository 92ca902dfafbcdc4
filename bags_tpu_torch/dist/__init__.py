"""Tile-parallel training over `torch.distributed` ranks (port of
`bags_tpu/dist/`): `mesh.py` the process-group helpers and the counted
collectives, `sharded.py` the sharded render, loss and train step,
`calib.py` the sharded fisheye and cubemap steps, `trainer.py` the
`ShardedTrainer`, `ShardedCalibTrainer` and `init_distributed`."""
