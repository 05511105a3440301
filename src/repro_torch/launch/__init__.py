"""Launch-side helpers of the port: the topology cost model."""
