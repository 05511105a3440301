"""Launch-side helpers of the port: the topology cost model and the
training launcher (:mod:`.train`)."""
