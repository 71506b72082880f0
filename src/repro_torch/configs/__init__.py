# Model configurations of the port: own copies of the reference's
# dataclasses (base.py), the rwkv6-3b, dense-attention and MoE configs
# and the reduced-config rule.
