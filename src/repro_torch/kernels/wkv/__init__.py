# WKV-6 forward kernel (csrc/wkv_fwd.cu), its wrapper (ops.py) and plain
# torch versions (ref.py).
from .ops import wkv_apply, wkv_forward  # noqa: F401
