"""SpMV in ELL layout: ``ops.spmv_ell`` (kernel wrapper),
``ref.spmv_ell_ref`` (plain version), and the packers ``ops.csr_to_ell``
and ``ops.pack_in_edges``."""
