"""Device kernels and tensor ops of the port (counterparts of the JAX package's ``ops``)."""
