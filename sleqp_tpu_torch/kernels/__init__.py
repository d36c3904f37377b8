"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their build
and their loader.  The Python wrappers live beside the code that calls them
(``sleqp_tpu_torch/ops/cyclic_reduction.py``)."""
