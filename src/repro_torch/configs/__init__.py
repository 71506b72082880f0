# Model configurations of the port: own copies of the reference's
# dataclasses (base.py), the rwkv6-3b config and the reduced-config rule.
