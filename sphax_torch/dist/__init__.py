"""The multi-rank layer (torch twin of ``sphax.dist``): ranks over
``torch.distributed`` (``comm``), the slab decomposition (``wslab``) and
its host-side loop (``runner.SlabRun``)."""
