"""Sharding over a 'lists' mesh on torch.distributed: process bring-up, the
sharded ROC codec and size accounting, the sharded IVF search."""
