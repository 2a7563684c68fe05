"""Wave sharding of the forward model over ``torch.distributed`` (the port
of the JAX package's ``parallel/``): ``mesh`` (the (data, wave) grid of
logical shards, the spectrum's gather, sharded k-tables), ``sharded`` (the
runtime line-by-line synthesis on wave shards with their line halos) and
``multihost`` (process-group start-up and the host-major layout)."""
