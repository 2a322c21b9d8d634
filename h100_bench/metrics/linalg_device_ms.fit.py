"""linalg_device_ms.fit: device time per loss+grad evaluation in the
dense linear algebra (cuSOLVER and cuBLAS: Cholesky, triangular solves and
inverses, GEMM and SYRK kernels, by name), over the traced window's
evaluations."""
import re

PATTERN = re.compile(r"potrf|trsm|trtri|lauum|gemm|syrk|herk|gemv|getrf|"
                     r"xmma|cutlass", re.IGNORECASE)


def read(ctx):
    fits = ctx.window.get("fits")
    if ctx.trace is None or not fits:
        return None
    count, seconds = ctx.trace.device_time(
        lambda name: bool(PATTERN.search(name)))
    if not count:
        return None
    return seconds * 1e3 / sum(f["nfev"] for f in fits)
