"""The (pod?, data, model) mesh over ``torch.distributed`` and the
sharding rules: the port's copy of ``repro/parallel/``."""
