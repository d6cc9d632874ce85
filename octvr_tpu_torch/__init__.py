"""octvr_tpu_torch: the panoramic stitcher on PyTorch and CUDA (Hopper).

A port of ``octvr_tpu`` beside it.  The offline stage (rig compilation,
``MapperTemplate``, ``.dat`` templates) is shared with ``octvr_tpu``,
whose host modules import no JAX; the online per-frame path lives here
as plain torch ops plus hand-written CUDA kernels under ``csrc/``.

Importing this package (or any module in it) never imports ``jax``.
"""
