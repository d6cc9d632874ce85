"""The port's offline stage: rig compilation into a ``MapperTemplate``
(``compile_rig``), distance seam masks and the template files, copied
from ``octvr_tpu.template`` as numpy code (no JAX, no torch)."""

from .compiler import MapperTemplate, TemplateInput, compile_rig
from .io import dump_dat, load_dat, load_npz, save_npz
from .seam import distance_seam_find

__all__ = [
    "MapperTemplate",
    "TemplateInput",
    "compile_rig",
    "dump_dat",
    "load_dat",
    "save_npz",
    "load_npz",
    "distance_seam_find",
]
