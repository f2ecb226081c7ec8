"""`paddle.distributed.fleet` of the port: `utils.recompute` only."""
