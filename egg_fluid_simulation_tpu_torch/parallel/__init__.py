"""Multi-device layers on ``torch.distributed``: the 1D particle-sharded
step (:mod:`.sharding`, replayed from a CUDA graph on a card:
:mod:`.sharding_graph`), the 2D spatial decomposition of the dense engine
(:mod:`.spatial`), its product surface (:mod:`.spatial_handler`), the mesh
of ranks and its collectives (:mod:`.mesh`) and their byte counts
(:mod:`.accounting`)."""
