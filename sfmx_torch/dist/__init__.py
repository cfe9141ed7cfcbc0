"""Multi-device paths over ``torch.distributed`` process groups: the
observation-sharded and point-sharded (block) bundle adjustment, halo
collectives, the launcher and the dry run."""
