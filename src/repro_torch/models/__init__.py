# The LM side of the port: parameter declarations (params.py), the RMS
# norm (layers.py), the RWKV-6 block (rwkv6.py) and the decoder assembly
# with its train / prefill / decode forwards (lm.py).
