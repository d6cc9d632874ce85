"""Gaussian/Laplacian pyramid steps as banded matrix products
(octvr_tpu/ops/pyramid.py, its MXU path).

The separable 5-tap binomial filter [1,4,6,4,1]/16 with reflect-101
borders (down) and zero-stuffed 4x-gain upsampling (up) is expressed as
two dense banded products per step, built once per axis length on the
host.  These are plain large matrix products, which the JAX package
also leaves to XLA outside any Pallas kernel, so they go to
``torch.matmul``.

Both operands are taken to f32 and the product runs in full f32, as
JAX's ``preferred_element_type=float32`` does; bf16 operands are exact in
f32.  TF32 keeps about three decimal digits and would drift from the JAX
package's f32 products, so every product first reads the process's
matmul precision (``require_full_f32``) and raises if it is anything but
"highest", PyTorch's default.  The port never writes that setting: it
belongs to the host application.  Reading it is safe from any number of
threads (the upload and drain threads of an asynchronous runtime); a
set-and-restore around each product would not be, since two threads
interleaving their saves and restores can leave TF32 on under one
thread's products, and the application's own matmuls would change
precision for the window.  cuDNN is not used here.
"""

import numpy as np
import torch

__all__ = ["down_matrix", "pyr_down_mm", "pyr_up_mm", "require_full_f32", "up_matrix"]


def require_full_f32():
    """Raises RuntimeError unless float32 matrix products run in full
    f32 (``torch.get_float32_matmul_precision() == "highest"``, which
    also means ``torch.backends.cuda.matmul.allow_tf32`` is False)."""
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        raise RuntimeError(
            f"float32 matmul precision is {precision!r}: the port's f32 products "
            "need 'highest' (no TF32); call torch.set_float32_matmul_precision('highest')"
        )


def down_matrix(n: int) -> np.ndarray:
    """[n//2, n]: rows are the 5-tap kernel at stride 2 with reflect-101
    boundary folding."""
    K = np.zeros((n // 2, n), dtype=np.float32)
    w = np.array([1, 4, 6, 4, 1], dtype=np.float32) / 16.0
    for i in range(n // 2):
        for k in range(5):
            j = 2 * i + k - 2
            if j < 0:
                j = -j
            if j >= n:
                j = 2 * (n - 1) - j
            K[i, j] += w[k]
    return K


def up_matrix(n: int) -> np.ndarray:
    """[2n, n]: zero-stuffed upsample + 5-tap (x2 gain per axis), zero
    boundary."""
    K = np.zeros((2 * n, n), dtype=np.float32)
    w = np.array([1, 4, 6, 4, 1], dtype=np.float32) * 2.0 / 16.0
    for o in range(2 * n):
        for k in range(5):
            j = o + k - 2
            if 0 <= j < 2 * n and j % 2 == 0:
                K[o, j // 2] += w[k]
    return K


def _banded(x, kv, kh):
    """kv @ x[c] @ kh.T for every channel, in f32."""
    require_full_f32()
    v = torch.matmul(kv.float(), x.float())
    return torch.matmul(v, kh.float().T)


def pyr_down_mm(x, kv, kh):
    """[C, H, W] -> f32 [C, H/2, W/2].  kv: [H/2, H], kh: [W/2, W]."""
    return _banded(x, kv, kh)


def pyr_up_mm(x, kv, kh):
    """[C, h, w] -> f32 [C, 2h, 2w].  kv: [2h, h], kh: [2w, w]."""
    return _banded(x, kv, kh)
