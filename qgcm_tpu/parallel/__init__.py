"""Device-mesh parallelism: spatial domain decomposition over devices."""
