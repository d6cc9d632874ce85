"""Device ms per frame set of the matmul kernels (gemm, xmma, cutlass:
the banded pyramid and pooling products) in the traced segment."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["frames"] or not t["gemm_s"]:
        return None
    return t["gemm_s"] / t["frames"] * 1e3
