"""SpMV in ELL layouts: ``ops.spmv_ell`` (row-major ELL) and
``ops.spmv_sell`` (sliced ELL, the pull step), the plain versions in
``ref``, and the packers ``ops.csr_to_ell`` and ``ops.pack_in_edges``."""
