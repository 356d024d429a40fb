"""Checkpoints of the trainer's state (``ckpt``): the JAX package's files,
so that either package reads the other's."""
from repro_torch.checkpoint.ckpt import (LazyRows, load_checkpoint,
                                         save_checkpoint, shard_bounds,
                                         treedef_str)

__all__ = ["LazyRows", "load_checkpoint", "save_checkpoint", "shard_bounds",
           "treedef_str"]
