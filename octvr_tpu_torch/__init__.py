"""octvr_tpu_torch: the panoramic stitcher on PyTorch and CUDA (Hopper).

A port of ``octvr_tpu`` beside it, standing on its own.  The offline
stage (camera models, rig compilation into a ``MapperTemplate``, seam
masks, vignettes, ``.dat`` and ``.npz`` templates) is the port's own
numpy copy of the original's host modules (``cameras``, ``template``,
``geometry``, ``vignette``, ``utils/raster``, the host resize in
``ops/resize``), held bit-equal to them by the tests.  The online
per-frame path (``stitch``: Mapper, FastMapper; ``parallel``: the
band-sharded ShardedMapper) is plain torch ops plus hand-written CUDA
kernels under ``csrc/``, and runs on the card unless asked for the CPU.

Importing this package (or any module in it) imports nothing of
``octvr_tpu``, ``jax`` or ``ml_dtypes``.
"""
