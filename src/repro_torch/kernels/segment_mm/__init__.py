from .ops import CSR, coo_to_csr, segment_mm, segment_mm_csr  # noqa: F401
