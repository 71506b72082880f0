"""Int8 error-feedback gradient compression for the data-parallel mean.

The counterpart of `repro.distributed.compression` on a mesh of ranks
(`launch.mesh.Mesh`). Compressing the wire format of the gradient
all-reduce 4x (float32 -> int8) shrinks the collective's bytes; error
feedback (1-bit SGD, EF-SGD) carries what the quantization dropped into
the next step, so its bias vanishes over steps:

  1. add the carried residual to the local gradient;
  2. reduce-scatter in int8: split into one chunk per rank (lane-aligned
     to ndev * 128 elements), quantize each chunk with a float32 scale
     (max-abs / 127), `all_to_all` the int8 chunks and their scales,
     dequantize and add the received chunks: each rank owns one reduced
     shard;
  3. all-gather the reduced shard, int8 again;
  4. keep residual = local gradient - dequant(sent) for the next call.

About 2 wire bytes an element (all_to_all and all_gather) against 8 for
a float32 ring all-reduce.

The reference takes leaves stacked (ndev, ...) from outside a shard_map,
row i being replica i's summand. Here each rank passes its own leaves
and gets back the mean (the same on every rank) and its own residual.
The received chunks are added in rank order, one after another,
rounding is to nearest even (`torch.round`, as `jnp.round`), and every
division is a true division on the card as on the CPU.
"""

from __future__ import annotations

import torch

f32 = torch.float32


def _quant(x):
    """int8 symmetric quantization with a float32 scale per row of x. The
    divisors are tensors on x's device: divided by a Python number, a
    CUDA tensor is multiplied by its reciprocal, which rounds otherwise
    than the CPU's (and the reference's) true division."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True)
                        / x.new_tensor(127.0), min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.to(f32) * scale


def _ef_allreduce_flat(g, err, mesh, axis: str):
    """Error-feedback compressed mean over `axis` for this rank's (n,)
    float32 g and residual err; returns (mean, new residual)."""
    ndev = mesh.size(axis)
    n = g.shape[0]
    pad = (-n) % (ndev * 128)              # lane-align the chunks
    local = g + err[:n]
    chunks = torch.nn.functional.pad(local, (0, pad)).view(ndev, -1)

    q, scale = _quant(chunks)              # (ndev, c) int8, (ndev, 1)
    # reduce-scatter: rank k receives chunk k of every peer, in rank order
    qx = mesh.all_to_all(q, axis)
    sx = mesh.all_to_all(scale, axis)
    recv = _dequant(qx, sx)
    shard = recv[0].clone()
    for row in recv[1:]:
        shard += row
    shard /= shard.new_tensor(float(ndev))

    # all-gather the reduced shard, int8 again
    q2, s2 = _quant(shard[None, :])
    qg = mesh.gather_stack(q2[0], axis)    # (ndev, c)
    sg = mesh.gather_stack(s2[0], axis)    # (ndev, 1)
    full = _dequant(qg, sg).reshape(-1)[:n]

    # error feedback: what this rank failed to send of its own summand
    sent = _dequant(q, scale).reshape(-1)[:n]
    return full, local - sent


def _leaves(tree):
    """(leaves, rebuild) of a tensor or a dict/list/tuple of tensors."""
    if torch.is_tensor(tree):
        return [tree], lambda out: out[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda out: dict(zip(keys, out))
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda out: type(tree)(out)
    raise TypeError('compressed_mean takes a tensor or a dict, list or '
                    f'tuple of tensors; got {type(tree).__name__}')


def compressed_mean(tree, mesh, axis: str = 'data', err=None):
    """Compressed mean over mesh axis `axis` with error feedback.

    Args:
      tree: this rank's summand: a tensor, or a dict, list or tuple of
        tensors.
      mesh: a `launch.mesh.Mesh`; without a process group (one rank) the
        collectives are the identity and the result is the one summand
        through the int8 round trip.
      err: this rank's residuals from the previous call, (size,) float32
        tensors in the same structure, or None (zeros).
    Returns (mean, new err): the mean in `tree`'s structure, shapes and
    dtypes, the same on every rank of the axis, and the rank's residuals.
    Collective: every rank of the axis calls it with the same structure.
    """
    leaves, rebuild = _leaves(tree)
    if err is None:
        errs = [torch.zeros(leaf.numel(), dtype=f32, device=leaf.device)
                for leaf in leaves]
    else:
        errs = _leaves(err)[0]
    outs, new_errs = [], []
    for leaf, e in zip(leaves, errs):
        out, ne = _ef_allreduce_flat(leaf.to(f32).reshape(-1), e, mesh, axis)
        outs.append(out.reshape(leaf.shape).to(leaf.dtype))
        new_errs.append(ne)
    return rebuild(outs), rebuild(new_errs)
