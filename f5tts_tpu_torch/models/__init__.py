"""DiT modules, the DiT backbone and the flow-matching sampler."""
