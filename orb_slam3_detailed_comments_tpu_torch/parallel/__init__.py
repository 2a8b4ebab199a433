"""Multi-process scaling: frame-parallel extraction (``batch_extract``) and
observation-sharded bundle adjustment (``dist_ba``) over a
``torch.distributed`` process group (the collectives are the package's
``comm``)."""
