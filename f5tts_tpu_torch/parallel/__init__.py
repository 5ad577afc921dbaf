"""Multi-GPU training and tensor parallelism over `torch.distributed`
(counterpart of f5tts_tpu/parallel): the (data, model) process mesh and
parameter / train-state sharding (`mesh`), and the collectives GSPMD
inserts in the JAX package (`collectives`)."""
