"""Device time of the traced steps' GEMMs per step, in ms: the device
operations whose names hold ``gemm`` (cuBLAS's and CUTLASS's, as
``sm80_xmma_gemm_*`` and ``cutlass_80_simt_sgemm_*``).  In the part
segmenter's cell they are its head's and its embedding's float32 Linear
layers, forward and backward; the program's conv products
(``pw_product_kernel``) do not match.  None where no operation matched."""


def read(rec):
    if rec["kind"] != "train" or "trace" not in rec or not rec["trace"]["n"]:
        return None
    t = rec["trace"]
    secs = [s for name, s in t["ops"].items() if "gemm" in name.lower()]
    if not secs:
        return None
    return 1e3 * sum(secs) / t["n"]
