"""Multi-device paths of the port over ``torch.distributed``: the rank grid
(``mesh``), collectives, the data-parallel train step and destination-
ownership edge sharding. The submodules are imported where they are used."""
