"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their build
and their loader.  The Python wrappers live beside the code that calls them
(``sleqp_tpu_torch/ops/cyclic_reduction.py``, ``ops/pallas_tridiag.py``
and ``ops/pallas_chol_tridiag.py``)."""
