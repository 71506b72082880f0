"""Device probes and the numeric context every entry point runs under.

The counterpart of `repro.kernels.platform`: the JAX package asks whether
a Pallas kernel can lower on the default device; the port asks whether a
hand-written `sm_90a` kernel can run on the device its tensors live on.

`resolve_device` is the one gate of every public entry point: the port
runs on the card unless the caller asks for the CPU in so many words, and
with no card and no such request it raises instead of carrying on slowly.
"""

from __future__ import annotations

import contextlib
import threading

import torch


def device_platform() -> str:
    """'cuda' when a CUDA device is visible, else 'cpu' — the platform
    an entry point lands on when the caller names no device."""
    return 'cuda' if torch.cuda.is_available() else 'cpu'


def on_hopper(device=None) -> bool:
    """True when `device` (default: the current CUDA device) is a CUDA
    device of compute capability 9.0 or newer, the target the kernels
    are compiled for (`sm_90a`)."""
    if not torch.cuda.is_available():
        return False
    dev = torch.device('cuda' if device is None else device)
    if dev.type != 'cuda':
        return False
    return torch.cuda.get_device_capability(dev) >= (9, 0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, or 'cuda' when None.

    Raises when that is a CUDA device and none is present: the port never
    falls back to the CPU on its own. Pass device='cpu' to run the plain
    versions of the kernels on the CPU (what the tests do). The meta
    device passes too: it allocates nothing, and the runtime loop builds
    a state's structure there before it restores a checkpoint."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'port on the CPU through the plain versions of its kernels')
    if dev.type not in ('cuda', 'cpu', 'meta'):
        raise ValueError(f'unsupported device {dev}; expected cuda or cpu')
    return dev


# full_f32's process-wide state: how many callers are inside it, and the
# precision to restore when the last one leaves.
_F32_LOCK = threading.Lock()
_F32_USERS = [0, None]


@contextlib.contextmanager
def full_f32():
    """Run the enclosed code with float32 matrix products in full float32.

    TF32 keeps about three decimal digits, which would round the score
    matvec p = Xw and move examples across the hinge margin, or reorder
    a served ranking. The precision 'highest' is what turns TF32 off for
    matmuls (`torch.backends.cuda.matmul.allow_tf32` follows it); the
    port runs no convolution, so cuDNN's own flag is left alone. The
    setting is process-wide, so it is made on entry and restored on exit,
    never at import. Threads share it (the serving layer scores from
    several): the first caller in sets it and the last one out restores
    it, under a lock, so no caller ever runs with it restored early."""
    with _F32_LOCK:
        if _F32_USERS[0] == 0:
            _F32_USERS[1] = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision('highest')
        _F32_USERS[0] += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_USERS[0] -= 1
            if _F32_USERS[0] == 0:
                torch.set_float32_matmul_precision(_F32_USERS[1])
