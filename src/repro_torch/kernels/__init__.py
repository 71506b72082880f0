# Hand-written CUDA kernels for Hopper (csrc/), their wrappers (ops.py)
# and plain torch versions (ref.py), one package per TPU kernel ported.
